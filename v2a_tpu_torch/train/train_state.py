"""Train state, the EMA schedule, and the policy train step.

Counterpart of `v2a_tpu/train/train_state.py`: `EMAConfig` and `ema_decay`
(:88-107), ema_pytorch's warmup schedule; `OptimizerConfig`,
`global_grad_norm`, `fused_clip_adamw` and `make_train_step` (:67-330), the
release recipe AdamW(lr 1e-4, betas (0.95, 0.999), eps 1e-8, wd 1e-6) with
a global-norm clip at 1.0 and an EMA of the weights. The JAX `TrainState`
pytree (step, params, opt_state, ema_params) becomes two holders: the video
trainer's `TrainState` (the step count, a `torch.optim` optimizer and the
EMA weights) and the policy step's `PolicyTrainState` (the step count, the
state of a `fused_clip_adamw` transformation and the EMA weights). The
parameters stay in their module and are updated in place, as are the Adam
moments: the JAX step donates its buffers for the same reason.

On a mesh (`parallel/sharding.py::ShardedParams`, explicit collectives, no
DTensor) the step is the single-process step on the global batch: each dp
rank's gradients (its rows; the loss draws the global batch's noise and
keeps its rows) are averaged over the dp group by `all_reduce` before the
clip; each tp rank keeps the 1/tp slice of every leaf the JAX rule shards,
and its Adam moments in that slice; the global norm sums a sharded leaf's
squares over the tp group and counts a replicated leaf once; AdamW runs on
each rank's slices; `all_gather_into_tensor` makes the parameters whole
for the forward and backward and for the EMA, which every rank keeps whole
and equal, and they are released after.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

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
    e <- decay * e + (1 - decay) * p after an optimizer step, in place. On a
    mesh (`shards`, the module's `ShardedParams`) the optimizer holds this
    rank's slices: `state_dict` gathers the parameters and the moments
    whole, in the layout of a run without a mesh (every rank takes part),
    and `load_state_dict` slices them, so a checkpoint loads with or
    without a mesh."""

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

    def state_dict(self, module: torch.nn.Module, shards=None) -> dict:
        opt = self.optimizer.state_dict()
        if shards is None:
            params = module.state_dict()
        else:
            with shards.whole():
                params = module.state_dict()
            opt["state"] = {i: {k: (shards.full(i, v) if torch.is_tensor(v) and v.ndim else v)
                                for k, v in st.items()} for i, st in opt["state"].items()}
        return dict(step=self.step, params=params, opt_state=opt, ema_params=self.ema)

    def load_state_dict(self, module: torch.nn.Module, state: dict, shards=None) -> None:
        self.step = int(state["step"])
        opt = state["opt_state"]
        if shards is None:
            module.load_state_dict(state["params"])
        else:
            with shards.whole(write_back=True):
                module.load_state_dict(state["params"])
            opt = dict(opt, state={i: {k: (shards.slice(i, v).clone()
                                           if torch.is_tensor(v) and v.ndim else v)
                                       for k, v in st.items()}
                                   for i, st in opt["state"].items()})
        self.optimizer.load_state_dict(opt)
        with torch.no_grad():
            for k, v in state["ema_params"].items():
                self.ema[k].copy_(v)


# -- the policy train step (`v2a_tpu/train/train_state.py:24-330`) ---------------

# storage dtype of the gradients between the backward pass and the update
# (the JAX package's V2A_GRAD_DTYPE, float32 by default: :31)
GRAD_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """`opt_params` + grad clip of the release config (:67-85).
    `moment_dtype`: the storage dtype of the Adam moments (the JAX
    package's V2A_MOMENT_DTYPE, :39); the update arithmetic is float32
    either way, and "bfloat16" is an opt-in that quantizes the moments."""

    lr: float = 1e-4
    b1: float = 0.95
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-6
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


class AdamState(NamedTuple):
    """optax's `ScaleByAdamState`: the update count and the moments, one per
    parameter in the order of the parameter list."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class GradientTransformation(NamedTuple):
    """optax's pair: `init(params) -> state`,
    `update(grads, state, params) -> (updates, state)`."""

    init: Callable
    update: Callable


def global_grad_norm(grads: List[torch.Tensor], shards=None) -> torch.Tensor:
    """The global L2 norm, squares summed in float32 whatever the leaves'
    dtype (:183-190). With `shards` (`ShardedParams`) `grads` are this
    rank's slices: a sharded leaf's squares are summed over the tp group."""
    squares = [torch.sum(torch.square(g.float())) for g in grads]
    if shards is not None:
        squares = shards.tp_sum(squares)
    return torch.sqrt(sum(squares))


def fused_clip_adamw(cfg: OptimizerConfig) -> GradientTransformation:
    """`optax.clip_by_global_norm(c)` then AdamW, as one float32 pass per
    parameter (:193-250). The clip scales the gradients by
    c / max(norm, c), optax's rule (`torch.nn.utils.clip_grad_norm_` would
    divide by norm + 1e-6 instead). The moments are updated in place in
    their storage dtype; `update` returns the parameter updates
    -lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p) in each parameter's
    dtype and the state with the count advanced."""
    mdtype = getattr(torch, cfg.moment_dtype)

    def init(params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p, dtype=mdtype) for p in params],
                         [torch.zeros_like(p, dtype=mdtype) for p in params])

    @torch.no_grad()
    def update(grads, state: AdamState, params, norm=None):
        """`norm`: the global norm when the caller has it (a mesh step's
        spans the tp group), else computed from `grads`."""
        if params is None:
            raise ValueError("fused_clip_adamw requires params")
        if norm is None:
            norm = global_grad_norm(grads)
        clip_scale = cfg.grad_clip / torch.clamp(norm, min=cfg.grad_clip)
        count = state.count + 1
        c1 = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** count
        c2 = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** count
        updates = []
        for g, mu, nu, p in zip(grads, state.mu, state.nu, params):
            g = g.float() * clip_scale
            m = cfg.b1 * mu.float() + (1.0 - cfg.b1) * g
            v = cfg.b2 * nu.float() + (1.0 - cfg.b2) * torch.square(g)
            upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            upd = upd + cfg.weight_decay * p.float()
            updates.append((-cfg.lr * upd).to(p.dtype))
            mu.copy_(m)
            nu.copy_(v)
        return updates, AdamState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


class PolicyTrainState:
    """The JAX `TrainState` (:110-126) of a module trained by
    `make_train_step`: the step count, `opt_state` of the transformation and
    the EMA parameters (a copy of the parameters at creation). The
    parameters are the module's own, in `named_parameters` order. With
    `ema_module` (a module of the same structure) the EMA parameters are
    that module's own: the module's values are copied into them, and the
    train step then updates that module in place. With `shards` (the
    module's `ShardedParams` on a mesh) `params` and the optimizer state are
    this rank's slices; `module_params` are the module's own either way."""

    def __init__(self, module: torch.nn.Module, tx: GradientTransformation,
                 ema_module: Optional[torch.nn.Module] = None, shards=None):
        self.names = [k for k, _ in module.named_parameters()]
        self.module_params = [p for _, p in module.named_parameters()]
        self.shards = shards
        self.params = self.module_params if shards is None else shards.local
        self.step = 0
        self.opt_state = tx.init(self.params)
        with torch.no_grad(), self.whole():
            if ema_module is None:
                self.ema_params = [p.detach().clone() for p in self.module_params]
            else:
                ema = dict(ema_module.named_parameters())
                self.ema_params = [ema[k] for k in self.names]
                for e, p in zip(self.ema_params, self.module_params):
                    e.copy_(p)

    def whole(self, write_back: bool = False):
        """The module's parameters whole inside the block (a no-op without
        a mesh; `ShardedParams.whole`)."""
        if self.shards is None:
            return contextlib.nullcontext()
        return self.shards.whole(write_back)


class StepOutput(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor


def make_train_step(loss_fn: Callable, tx: GradientTransformation,
                    ema_cfg: Optional[EMAConfig] = None, accumulate: int = 1) -> Callable:
    """The train step (:262-330): `loss_fn(batch, generator) -> scalar`
    through the state's module; returns `train_step(state, batch,
    generator=None) -> StepOutput(loss, grad_norm)`, which updates the
    state's parameters, optimizer state and EMA in place.

    With `accumulate > 1` (the reference's `gradient_accumulate_every`) every
    batch leaf carries a leading (accumulate, ...) axis of micro-batches:
    the loss and the gradients are averaged over them, each micro-batch's
    divided by `accumulate` and added in order, before ONE update. Gradients
    are stored in `GRAD_DTYPE`. The EMA decay is `ema_decay(step)` on the
    steps that are multiples of `update_every` and 0 (the EMA kept) on the
    others, computed in float32 as the JAX step computes it."""
    ema_cfg = ema_cfg or EMAConfig()

    def grads_of(state, batch, generator):
        loss = loss_fn(batch, generator)
        grads = torch.autograd.grad(loss, state.module_params)
        return loss.detach(), [g.to(GRAD_DTYPE) for g in grads]

    def micro(batch, i):
        if isinstance(batch, dict):
            return {k: micro(v, i) for k, v in batch.items()}
        return batch[i]

    def train_step(state: PolicyTrainState, batch, generator=None) -> StepOutput:
        shards = state.shards
        with state.whole():
            if accumulate == 1:
                loss, grads = grads_of(state, batch, generator)
            else:
                loss = torch.zeros((), dtype=torch.float32, device=state.params[0].device)
                grads = [torch.zeros_like(p, dtype=GRAD_DTYPE) for p in state.module_params]
                for i in range(accumulate):
                    l, g = grads_of(state, micro(batch, i), generator)
                    loss = loss + l.float() / accumulate
                    grads = [a + b / accumulate for a, b in zip(grads, g)]
        if shards is not None:  # the dp means, then this rank's slices
            shards.dp_mean([loss])
            grads = shards.local_grads(grads)
        grad_norm = global_grad_norm(grads, shards)
        updates, state.opt_state = tx.update(grads, state.opt_state, state.params,
                                             norm=grad_norm)
        with torch.no_grad():
            torch._foreach_add_(state.params, updates)
            state.step += 1
            one = np.float32(1.0)
            do_update = np.float32(state.step % ema_cfg.update_every == 0)
            decay = one - (one - np.float32(ema_decay(state.step, ema_cfg))) * do_update
            with state.whole():
                torch._foreach_mul_(state.ema_params, float(decay))
                torch._foreach_add_(state.ema_params, state.module_params,
                                    alpha=float(one - decay))
        return StepOutput(loss, grad_norm)

    return train_step
