"""Video-family Gaussian diffusion: the training loss and the samplers,
ancestral (DDPM) and DDIM, with classifier-free guidance and low-temperature
noise.

Counterpart of `v2a_tpu/ops/gaussian_diffusion.py` (the reference's
`GoalGaussianDiffusion`, `goal_diffusion.py:346-733`). The `lax.scan` over
timesteps becomes one step function, `sample_step`, that
`models/video_model.py::VideoSampleStream` drives over `sample_steps()`;
randomness comes from an explicit `torch.Generator`. Loop math is float32 whatever the model's compute dtype.

`model_fn(x, t, task_embed) -> out` takes x with the conditioning frame
already appended on the channel axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from v2a_tpu_torch.ops.schedules import DiffusionSchedule, extract

ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _concat_cond(x: torch.Tensor, x_cond: torch.Tensor) -> torch.Tensor:
    """Append the (broadcast) conditioning frame on the channel axis."""
    x_cond = x_cond.expand(tuple(x.shape[:-1]) + (x_cond.shape[-1],))
    return torch.cat([x, x_cond.to(x.dtype)], dim=-1)


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Sampler configuration bound to a schedule (`goal_diffusion.py:346-464`)."""

    schedule: DiffusionSchedule
    objective: str = "pred_v"
    sampling_timesteps: Optional[int] = None
    ddim_sampling_eta: float = 0.0
    guidance_weight: float = 0.0
    var_temp: float = 1.0
    loss_type: str = "l2"
    min_snr_loss_weight: bool = False
    min_snr_gamma: float = 5.0
    auto_normalize: bool = True

    def __post_init__(self):
        if self.objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"unknown objective {self.objective!r}")
        s = self.sampling_timesteps
        if s is not None and s > self.schedule.num_timesteps:
            raise ValueError("sampling_timesteps must be <= num_timesteps")

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    @property
    def effective_sampling_timesteps(self) -> int:
        return self.sampling_timesteps or self.num_timesteps

    @property
    def is_ddim_sampling(self) -> bool:
        # DDIM only when strictly fewer sampling steps (`goal_diffusion.py:419`)
        return self.effective_sampling_timesteps < self.num_timesteps

    # -- parameterization conversions (goal_diffusion.py:466-489) -------------

    def predict_start_from_noise(self, x_t, t, noise):
        s, nd = self.schedule, x_t.ndim
        return (
            extract(s.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(s.sqrt_recipm1_alphas_cumprod, t, nd) * noise
        )

    def predict_noise_from_start(self, x_t, t, x0):
        s, nd = self.schedule, x_t.ndim
        return (extract(s.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0) / extract(
            s.sqrt_recipm1_alphas_cumprod, t, nd
        )

    def predict_v(self, x_start, t, noise):
        s, nd = self.schedule, x_start.ndim
        return (
            extract(s.sqrt_alphas_cumprod, t, nd) * noise
            - extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * x_start
        )

    def predict_start_from_v(self, x_t, t, v):
        s, nd = self.schedule, x_t.ndim
        return (
            extract(s.sqrt_alphas_cumprod, t, nd) * x_t
            - extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * v
        )

    def q_posterior(self, x_start, x_t, t):
        s, nd = self.schedule, x_t.ndim
        mean = (
            extract(s.posterior_mean_coef1, t, nd) * x_start
            + extract(s.posterior_mean_coef2, t, nd) * x_t
        )
        return mean, extract(s.posterior_log_variance_clipped, t, nd)

    def q_sample(self, x_start, t, noise):
        s, nd = self.schedule, x_start.ndim
        return (
            extract(s.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * noise
        )

    # -- the denoiser, with classifier-free guidance (goal_diffusion.py:499-558)

    def model_predictions(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        t: torch.Tensor,
        x_cond: torch.Tensor,
        task_embed: torch.Tensor,
        clip_x_start: bool = False,
        rederive_pred_noise: bool = False,
    ) -> ModelPrediction:
        gw = self.guidance_weight
        x_in = _concat_cond(x, x_cond)

        def maybe_clip(z):
            return z.clamp(-1.0, 1.0) if clip_x_start else z

        if gw <= 0.0:
            out = model_fn(x_in, t, task_embed)
            if self.objective == "pred_noise":
                pred_noise = out
                x_start = maybe_clip(self.predict_start_from_noise(x, t, pred_noise))
                if clip_x_start and rederive_pred_noise:
                    pred_noise = self.predict_noise_from_start(x, t, x_start)
            elif self.objective == "pred_x0":
                x_start = maybe_clip(out)
                pred_noise = self.predict_noise_from_start(x, t, x_start)
            else:
                x_start = maybe_clip(self.predict_start_from_v(x, t, out))
                pred_noise = self.predict_noise_from_start(x, t, x_start)
            return ModelPrediction(pred_noise, x_start)

        # batch-doubled single forward; the second half is unconditioned
        out2 = model_fn(
            torch.cat([x_in, x_in], 0),
            torch.cat([t, t], 0),
            torch.cat([task_embed, torch.zeros_like(task_embed)], 0),
        )
        b = x.shape[0]
        out_c, out_u = out2[:b], out2[b:]
        if self.objective == "pred_noise":
            pred_noise = (1 + gw) * out_c - gw * out_u
            x_start = maybe_clip(self.predict_start_from_noise(x, t, pred_noise))
            if clip_x_start and rederive_pred_noise:
                pred_noise = self.predict_noise_from_start(x, t, x_start)
        elif self.objective == "pred_x0":
            x_start = maybe_clip((1 + gw) * out_c - gw * out_u)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:  # pred_v: guidance in epsilon space (goal_diffusion.py:536-548)
            cond_x0 = maybe_clip(self.predict_start_from_v(x, t, out_c))
            uncond_x0 = self.predict_start_from_v(x, t, out_u)
            pred_noise = (1 + gw) * self.predict_noise_from_start(x, t, cond_x0) - (
                gw * self.predict_noise_from_start(x, t, uncond_x0)
            )
            x_start = self.predict_start_from_noise(x, t, pred_noise)
        return ModelPrediction(pred_noise, x_start)

    # -- samplers --------------------------------------------------------------

    @staticmethod
    def _randn(shape, generator, device, shard=None):
        """Standard normal of `shape`; with `shard` (a dp `RowShard`: piece
        `index` of `count`) the draw is the global batch's, count times the
        rows, and this piece's rows are kept, so a dp rank draws what the
        single process draws for its rows."""
        if shard is None:
            return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        shape = (shape[0] * shard.count,) + tuple(shape[1:])
        full = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return full[shard.rows(shape[0])]

    def p_step(self, model_fn, img, t_scalar: int, x_cond, task_embed, noise):
        """One ancestral step x_t -> x_{t-1} with clipped x0
        (`goal_diffusion.py:560-580`); `noise` is standard normal."""
        t = torch.full((img.shape[0],), t_scalar, dtype=torch.long, device=img.device)
        preds = self.model_predictions(model_fn, img, t, x_cond, task_embed)
        x_start = preds.pred_x_start.clamp(-1.0, 1.0)
        mean, log_var = self.q_posterior(x_start, img, t)
        if t_scalar == 0:
            return mean
        return mean + torch.exp(0.5 * log_var) * (noise * self.var_temp)

    # -- the chain step by step: `VideoSampleStream` drives it, holding img
    # and generator between calls (x_T is `_randn(shape, generator, device)`)

    def sample_steps(self) -> list:
        """The chain's steps in order: DDIM's (t, t_next) pairs
        (`goal_diffusion.py:601-641`), else the ancestral t = T-1..0
        (`goal_diffusion.py:583-599`)."""
        if self.is_ddim_sampling:
            return [tuple(p) for p in self.ddim_time_pairs().tolist()]
        return list(range(self.num_timesteps - 1, -1, -1))

    def sample_step(self, model_fn, img, step, x_cond, task_embed, generator=None, shard=None):
        """One entry of `sample_steps()`, its noise drawn from `generator`
        (with `shard`, this dp rank's rows of the global draw)."""
        if self.is_ddim_sampling:
            return self._ddim_step(model_fn, img, step, x_cond, task_embed, generator, shard)
        return self._ancestral_step(model_fn, img, step, x_cond, task_embed, generator, shard)

    def sample_finish(self, img: torch.Tensor) -> torch.Tensor:
        """The chain's last state -> samples in [0, 1], clamped
        (`goal_diffusion.py:644-650`)."""
        return self._unnormalize(img).clamp(0.0, 1.0)

    def _ancestral_step(self, model_fn, img, t: int, x_cond, task_embed, generator, shard=None):
        """One ancestral step, its noise drawn first (none at t=0)."""
        noise = self._randn(tuple(img.shape), generator, img.device, shard) if t > 0 else None
        return self.p_step(model_fn, img, t, x_cond, task_embed, noise)

    def ddim_time_pairs(self) -> np.ndarray:
        """(S, 2) (t, t_next) pairs, t_next possibly -1 (`goal_diffusion.py:604-606`)."""
        total, s = self.num_timesteps, self.effective_sampling_timesteps
        times = list(reversed(np.linspace(-1, total - 1, s + 1).astype(int).tolist()))
        return np.asarray(list(zip(times[:-1], times[1:])), dtype=np.int64)

    def _ddim_step(self, model_fn, img, pair, x_cond, task_embed, generator, shard=None):
        """One (t, t_next) DDIM step, its noise drawn last."""
        time, time_next = pair
        acp = self.schedule.alphas_cumprod
        eta = self.ddim_sampling_eta
        t = torch.full((img.shape[0],), time, dtype=torch.long, device=img.device)
        pred_noise, x_start = self.model_predictions(
            model_fn, img, t, x_cond, task_embed,
            clip_x_start=False, rederive_pred_noise=True,
        )
        if time_next < 0:  # the reference returns x_start at the last pair
            return x_start
        alpha, alpha_next = acp[time], acp[time_next]
        sigma = eta * torch.sqrt(
            (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha)
        )
        c = torch.sqrt(torch.clamp(1.0 - alpha_next - sigma**2, min=0.0))
        img = x_start * torch.sqrt(alpha_next) + c * pred_noise
        if eta > 0.0:
            img = img + sigma * self._randn(tuple(img.shape), generator, img.device, shard)
        return img

    # -- training (goal_diffusion.py:690-733) -----------------------------------

    def p_losses(
        self,
        model_fn: ModelFn,
        x_start: torch.Tensor,
        x_cond: torch.Tensor,
        task_embed: torch.Tensor,
        t: Optional[torch.Tensor] = None,
        sample_weights: Optional[torch.Tensor] = None,
        return_per_sample: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ):
        """Weighted denoising loss. `x_start` in [0, 1], mapped to [-1, 1]
        when `auto_normalize` (`goal_diffusion.py:718-724`). `t` (B,) is drawn
        uniformly from `generator` when None, then the noise; `noise`
        overrides it (the tests pass the JAX package's). `sample_weights` (B,)
        multiplies the per-sample losses (a resampler's importance weights);
        `return_per_sample` also returns the unweighted per-sample losses."""
        b, dev = x_start.shape[0], x_start.device
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,), generator=generator, device=dev)
        x_start = self._normalize(x_start)
        if noise is None:
            noise = self._randn(tuple(x_start.shape), generator, dev)
        x = self.q_sample(x_start, t, noise)
        model_out = model_fn(_concat_cond(x, x_cond), t, task_embed)
        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:
            target = self.predict_v(x_start, t, noise)
        if self.loss_type == "l2":
            loss = (model_out - target) ** 2
        elif self.loss_type == "l1":
            loss = (model_out - target).abs()
        else:
            raise ValueError(f"invalid loss type {self.loss_type!r}")
        loss = loss.reshape(b, -1).mean(1)
        weight = self.schedule.loss_weight(
            self.objective, self.min_snr_loss_weight, self.min_snr_gamma
        )[t]
        weighted = loss * weight
        if sample_weights is not None:
            weighted = weighted * sample_weights
        if return_per_sample:
            return weighted.mean(), loss
        return weighted.mean()

    def _normalize(self, x):
        return x * 2.0 - 1.0 if self.auto_normalize else x

    def _unnormalize(self, x):
        return (x + 1.0) * 0.5 if self.auto_normalize else x
