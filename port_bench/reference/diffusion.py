"""The cosine schedule, the ancestral sampler step, the finish, the
denoising loss, and clipped Adam with the EMA, in plain float32 PyTorch.

A frozen copy of the port's `ops/schedules.py`, `ops/gaussian_diffusion.py`
(pred_v, min-SNR weights, ancestral steps with a clipped x0) and the video
trainer's optimizer (`train/video_trainer.py::apply_gradients`,
`train/train_state.py::ema_decay`): a global-norm clip, Adam with eps 1e-8
and bias correction, then e <- d e + (1 - d) p with ema_pytorch's warmup
decay. The sampler step keeps the port's order of float32 operations, so
that the same inputs give the same bits.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


class Schedule:
    """The (T,) float32 tables of the cosine schedule on `device`."""

    def __init__(self, timesteps: int, device):
        steps = timesteps + 1
        t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
        acp = np.cos((t + 0.008) / (1 + 0.008) * math.pi * 0.5) ** 2
        acp = acp / acp[0]
        betas = np.clip(1 - acp[1:] / acp[:-1], 0, 0.999)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.num_timesteps = timesteps
        self.sqrt_acp = f32(np.sqrt(acp))
        self.sqrt_1macp = f32(np.sqrt(1.0 - acp))
        self.coef1 = f32(betas * np.sqrt(acp_prev) / (1.0 - acp))
        self.coef2 = f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp))
        self.log_var = f32(np.log(np.clip(post_var, 1e-20, None)))
        snr = f32(acp / (1.0 - acp))
        self.loss_weight = torch.clamp(snr, max=5.0) / (snr + 1.0)

    @staticmethod
    def at(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return table[t].reshape(-1, 1, 1, 1, 1)

    def ancestral_step(self, x, t: int, v, noise):
        """x_t -> x_{t-1} from the model's v; `noise` is unused at t = 0."""
        tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        x0 = self.at(self.sqrt_acp, tt) * x - self.at(self.sqrt_1macp, tt) * v
        x0 = x0.clamp(-1.0, 1.0)
        mean = self.at(self.coef1, tt) * x0 + self.at(self.coef2, tt) * x
        if t == 0:
            return mean
        return mean + torch.exp(0.5 * self.at(self.log_var, tt)) * (noise * 1.0)

    @staticmethod
    def finish_u8(x):
        """The chain's last state -> the uint8 video (truncating)."""
        x01 = ((x + 1.0) * 0.5).clamp(0.0, 1.0)
        return (x01.clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    def weighted_losses(self, out, video01, t, noise):
        """Per-row min-SNR-weighted v-prediction losses; `out` the model's
        output on `noisy_input`'s x."""
        x0 = video01 * 2.0 - 1.0
        target = self.at(self.sqrt_acp, t) * noise - self.at(self.sqrt_1macp, t) * x0
        per_row = ((out - target) ** 2).reshape(out.shape[0], -1).mean(1)
        return per_row * self.loss_weight[t]

    def noisy(self, video01, t, noise):
        x0 = video01 * 2.0 - 1.0
        return self.at(self.sqrt_acp, t) * x0 + self.at(self.sqrt_1macp, t) * noise


def ema_decay(step: int) -> float:
    """ema_pytorch's warmup decay at the release settings (update after step
    0, inv_gamma 1, power 0.75, clipped to [0, 0.9999]), in float32."""
    if step <= 0:
        return 0.0
    s = np.float32(step - 1)
    value = np.float32(1.0) - (np.float32(1.0) + s) ** np.float32(-0.75)
    return float(np.clip(value, np.float32(0.0), np.float32(0.9999)))


class ClippedAdam:
    """The global-norm clip, Adam and the EMA over named float32 leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float,
                 clip: float):
        self.lr, self.b1, self.b2, self.clip = lr, b1, b2, clip
        self.step_count = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.ema = {k: p.detach().clone() for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """One update in place; returns the clipped gradients."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        scale = self.clip / torch.clamp(norm, min=self.clip)
        clipped = {k: g * scale for k, g in grads.items()}
        self.step_count += 1
        n = self.step_count
        bc1, bc2 = 1 - self.b1 ** n, 1 - self.b2 ** n
        for k, p in params.items():
            g = clipped[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + 1e-8
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
        d = ema_decay(n)
        for k, p in params.items():
            self.ema[k].mul_(d).add_(p, alpha=1.0 - d)
        return clipped


def uniform_timesteps(rng: np.random.Generator, batch: int, timesteps: int) -> List[int]:
    """The uniform timestep sampler's draw."""
    return rng.integers(0, timesteps, size=batch).astype(np.int32).tolist()
