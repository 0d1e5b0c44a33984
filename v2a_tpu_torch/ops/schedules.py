"""Diffusion noise schedules and their coefficient tables.

Counterpart of `v2a_tpu/ops/schedules.py`: betas in float64 numpy, tables
stored as float32 tensors on the caller's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from v2a_tpu_torch.device import DeviceLike


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """DDPM linear schedule rescaled by 1000/T (`goal_diffusion.py:308-315`)."""
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal, `goal_diffusion.py:317-327`)."""
    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = -3, end: float = 3, tau: float = 1
) -> np.ndarray:
    """Sigmoid schedule (arXiv 2212.11972, `goal_diffusion.py:329-342`)."""

    def _sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    v_start = _sigmoid(start / tau)
    v_end = _sigmoid(end / tau)
    alphas_cumprod = (-_sigmoid((t * (end - start) + start) / tau) + v_end) / (
        v_end - v_start
    )
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def squaredcos_cap_v2_beta_schedule(timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """The diffusers `squaredcos_cap_v2` schedule of the action policy."""

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.empty(timesteps, dtype=np.float64)
    for i in range(timesteps):
        betas[i] = min(1 - alpha_bar((i + 1) / timesteps) / alpha_bar(i / timesteps), max_beta)
    return betas


BETA_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
    "squaredcos_cap_v2": squaredcos_cap_v2_beta_schedule,
}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed (T,) float32 coefficient tables (`goal_diffusion.py:405-462`)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    snr: torch.Tensor
    num_timesteps: int

    @classmethod
    def create(
        cls,
        timesteps: int,
        beta_schedule: str = "cosine",
        schedule_kwargs: Optional[dict] = None,
        device: DeviceLike = "cpu",
    ) -> "DiffusionSchedule":
        if beta_schedule not in BETA_SCHEDULES:
            raise ValueError(f"unknown beta schedule {beta_schedule!r}")
        betas = BETA_SCHEDULES[beta_schedule](timesteps, **(schedule_kwargs or {}))
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(np.log(np.clip(post_var, 1e-20, None))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            snr=f32(acp / (1.0 - acp)),
            num_timesteps=int(timesteps),
        )

    def loss_weight(
        self, objective: str, min_snr_loss_weight: bool = False, min_snr_gamma: float = 5.0
    ) -> torch.Tensor:
        """Per-timestep min-SNR loss weights (`goal_diffusion.py:445-456`)."""
        snr = self.snr
        clipped = torch.clamp(snr, max=min_snr_gamma) if min_snr_loss_weight else snr
        if objective == "pred_noise":
            return clipped / snr
        if objective == "pred_x0":
            return clipped
        if objective == "pred_v":
            return clipped / (snr + 1.0)
        raise ValueError(f"unknown objective {objective!r}")


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] reshaped to broadcast against an `ndim`-d batch tensor
    (`goal_diffusion.py:302-306`)."""
    out = table[t]
    return out.reshape(tuple(out.shape) + (1,) * (ndim - 1))
