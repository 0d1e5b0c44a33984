"""Action-policy diffusion schedulers with HF-diffusers semantics.

Counterpart of `v2a_tpu/ops/action_scheduler.py`: `DDPMScheduler`
(fixed_small variance, clipped x0, epsilon prediction) and `DDIMScheduler`
(set_alpha_to_one, steps_offset 0, clipped x0 with the unclipped epsilon in
the direction term), with diffusers' "leading" timestep spacing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from v2a_tpu_torch.ops.schedules import BETA_SCHEDULES


def make_tables(num_train_timesteps: int, beta_schedule: str, beta_start: float,
                beta_end: float) -> Tuple[np.ndarray, np.ndarray]:
    if beta_schedule == "linear":  # diffusers' unscaled endpoints
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    elif beta_schedule == "squaredcos_cap_v2":
        betas = BETA_SCHEDULES["squaredcos_cap_v2"](num_train_timesteps)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule!r}")
    return betas, np.cumprod(1.0 - betas)


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int,
                      steps_offset: int = 0) -> np.ndarray:
    """Diffusers' "leading" spacing: T=100, n=8 -> [84, 72, ..., 12, 0]."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError("num_inference_steps must be <= num_train_timesteps")
    ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1].copy()
    return ts.astype(np.int64) + steps_offset


@dataclasses.dataclass(frozen=True)
class _Scheduler:
    alphas_cumprod: np.ndarray  # float32 table; steps read it on the host
    num_train_timesteps: int
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    prediction_type: str = "epsilon"

    def _acp(self, t: int, final: float) -> float:
        return float(self.alphas_cumprod[t]) if t >= 0 else final

    def _x0_eps(self, model_output, t, sample):
        a_t = self._acp(t, 1.0)
        b_t = 1.0 - a_t
        if self.prediction_type == "epsilon":
            x0 = (sample - b_t**0.5 * model_output) / a_t**0.5
            eps = model_output
        elif self.prediction_type == "sample":
            x0 = model_output
            eps = (sample - a_t**0.5 * x0) / b_t**0.5
        else:
            raise ValueError(f"unsupported prediction type {self.prediction_type!r}")
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)
        return x0, eps


@dataclasses.dataclass(frozen=True)
class DDPMScheduler(_Scheduler):
    """Ancestral DDPM steps (`diffusion_unet_image_policy.py:100-131`)."""

    variance_type: str = "fixed_small"

    @classmethod
    def create(cls, num_train_timesteps: int = 100, beta_start: float = 0.0001,
               beta_end: float = 0.02, beta_schedule: str = "squaredcos_cap_v2",
               clip_sample: bool = True, variance_type: str = "fixed_small",
               prediction_type: str = "epsilon") -> "DDPMScheduler":
        _, acp = make_tables(num_train_timesteps, beta_schedule, beta_start, beta_end)
        return cls(alphas_cumprod=acp.astype(np.float32),
                   num_train_timesteps=num_train_timesteps, clip_sample=clip_sample,
                   prediction_type=prediction_type, variance_type=variance_type)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return leading_timesteps(self.num_train_timesteps, num_inference_steps)

    def add_noise(self, x_start: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """The forward process at per-example timesteps t (B,):
        sqrt(acp[t]) x_start + sqrt(1 - acp[t]) noise, from the float32 table
        (`v2a_tpu/ops/action_scheduler.py:125-129`)."""
        acp = torch.as_tensor(self.alphas_cumprod, device=x_start.device)
        shape = (-1,) + (1,) * (x_start.ndim - 1)
        t = torch.as_tensor(t, device=x_start.device).long()
        return (torch.sqrt(acp)[t].reshape(shape) * x_start
                + torch.sqrt(1.0 - acp)[t].reshape(shape) * noise)

    def step(self, model_output: torch.Tensor, t: int, prev_t: int, sample: torch.Tensor,
             noise: Optional[torch.Tensor], var_temp: float = 1.0) -> torch.Tensor:
        """x_t -> x_{prev_t}; `noise` is standard normal (ignored at t == 0)."""
        if self.variance_type != "fixed_small":
            raise NotImplementedError(self.variance_type)
        a_t, a_prev = self._acp(t, 1.0), self._acp(prev_t, 1.0)
        b_t, b_prev = 1.0 - a_t, 1.0 - a_prev
        cur_alpha = a_t / a_prev
        cur_beta = 1.0 - cur_alpha
        x0, _ = self._x0_eps(model_output, t, sample)
        pred_prev = (a_prev**0.5 * cur_beta / b_t) * x0 + (cur_alpha**0.5 * b_prev / b_t) * sample
        if t <= 0:
            return pred_prev
        variance = max(b_prev / b_t * cur_beta, 1e-20)
        return pred_prev + variance**0.5 * noise * var_temp


@dataclasses.dataclass(frozen=True)
class DDIMScheduler(_Scheduler):
    """Deterministic DDIM steps at eta = 0 (the policy's 8-step rollout)."""

    set_alpha_to_one: bool = True
    steps_offset: int = 0

    @classmethod
    def create(cls, num_train_timesteps: int = 100, beta_start: float = 0.0001,
               beta_end: float = 0.02, beta_schedule: str = "squaredcos_cap_v2",
               clip_sample: bool = True, set_alpha_to_one: bool = True,
               steps_offset: int = 0, prediction_type: str = "epsilon") -> "DDIMScheduler":
        _, acp = make_tables(num_train_timesteps, beta_schedule, beta_start, beta_end)
        return cls(alphas_cumprod=acp.astype(np.float32),
                   num_train_timesteps=num_train_timesteps, clip_sample=clip_sample,
                   prediction_type=prediction_type, set_alpha_to_one=set_alpha_to_one,
                   steps_offset=steps_offset)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return leading_timesteps(self.num_train_timesteps, num_inference_steps,
                                 self.steps_offset)

    def step(self, model_output: torch.Tensor, t: int, prev_t: int, sample: torch.Tensor,
             eta: float = 0.0, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        final = 1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0])
        a_t, a_prev = self._acp(t, 1.0), self._acp(prev_t, final)
        x0, eps = self._x0_eps(model_output, t, sample)
        std = 0.0
        if eta > 0.0:
            std = eta * ((1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)) ** 0.5
        out = a_prev**0.5 * x0 + (1.0 - a_prev - std**2) ** 0.5 * eps
        if eta > 0.0:
            if noise is None:
                raise ValueError("noise required when eta > 0")
            out = out + std * noise
        return out
