"""Train state: the EMA schedule and a holder for what a train step carries.

Counterpart of the video trainer's part of `v2a_tpu/train/train_state.py`:
`EMAConfig` and `ema_decay` (:88-107), ema_pytorch's warmup schedule. The
JAX `TrainState` pytree (step, params, opt_state, ema_params) becomes
`TrainState`: the step count, the optimizer (whose state is the optimizer
state) and the EMA weights; the parameters stay in their module.
`fused_clip_adamw` and the policy train step come with the policy-training
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    """`ema_params` (`config/libero/lb_tk8_65to72.py:146-152`) and
    ema_pytorch's warmup schedule."""

    update_after_step: int = 0
    inv_gamma: float = 1.0
    power: float = 0.75
    min_value: float = 0.0
    beta: float = 0.9999
    update_every: int = 1


def ema_decay(step: int, cfg: EMAConfig) -> float:
    """ema_pytorch warmup decay: 0 until `update_after_step`, then
    `1 - (1 + s/inv_gamma)^(-power)` clipped to [min_value, beta], in
    float32 as the JAX package computes it."""
    if step <= cfg.update_after_step:
        return 0.0
    s = np.float32(max(step - cfg.update_after_step - 1, 0))
    one = np.float32(1.0)
    value = one - (one + s / np.float32(cfg.inv_gamma)) ** np.float32(-cfg.power)
    return float(np.clip(value, np.float32(cfg.min_value), np.float32(cfg.beta)))


class TrainState:
    """step, optimizer and EMA weights of one module's training.

    `ema` starts as a copy of the module's parameters; `update_ema` applies
    e <- decay * e + (1 - decay) * p after an optimizer step, in place."""

    def __init__(self, module: torch.nn.Module, optimizer: torch.optim.Optimizer):
        self.step = 0
        self.optimizer = optimizer
        self.ema: Dict[str, torch.Tensor] = {
            k: p.detach().clone() for k, p in module.named_parameters()
        }

    @torch.no_grad()
    def update_ema(self, module: torch.nn.Module, decay: float) -> None:
        names = list(self.ema)
        params = dict(module.named_parameters())
        ema = [self.ema[k] for k in names]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [params[k].detach() for k in names], alpha=1.0 - decay)

    def state_dict(self, module: torch.nn.Module) -> dict:
        return dict(step=self.step, params=module.state_dict(),
                    opt_state=self.optimizer.state_dict(), ema_params=self.ema)

    def load_state_dict(self, module: torch.nn.Module, state: dict) -> None:
        self.step = int(state["step"])
        module.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        with torch.no_grad():
            for k, v in state["ema_params"].items():
                self.ema[k].copy_(v)
