"""Goal-conditioned action-diffusion policy: the training loss and action
sampling.

Counterpart of `v2a_tpu/models/policy.py` (the reference's
`DiffusionUnetImagePolicy`): the observation encoder runs once per
prediction, then DDIM-8 (or DDPM) steps over the action U-Net; `loss` is
the denoising objective `train/train_state.py::make_train_step` trains. The
policy runs on the card by default; `device="cpu"` is for tests. The
encoder runs one trunk per image key; the JAX package's `PERF_VMAP_ENC`
computes the same function through one vmapped trunk and is not ported.

Batch convention (channels-last):
    obs:    {key: (B, H, W, 3)} float32 in [0, 1]
    action: (B, horizon, action_dim) in action units
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from v2a_tpu_torch.device import DeviceLike, dtype_of, resolve_device
from v2a_tpu_torch.models.init import init_params
from v2a_tpu_torch.models.normalizer import (
    LimitsNormalizer, image_normalizer, lb_action_normalizer,
)
from v2a_tpu_torch.models.unet1d import ConditionalUnet1D
from v2a_tpu_torch.models.vision import MultiImageObsEncoder
from v2a_tpu_torch.ops.action_scheduler import DDIMScheduler, DDPMScheduler


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """The policy YAML surface (`lb_train_diffusion_unet_image_orn10.yaml`);
    the release run uses dtype 'bfloat16'."""

    action_dim: int = 7
    horizon: int = 16
    n_action_steps: int = 8
    n_obs_steps: int = 1
    obs_keys: Tuple[str, ...] = ("img_obs_1", "img_goal_1")
    image_size: Tuple[int, int] = (128, 128)
    num_train_timesteps: int = 100
    num_inference_steps: int = 100
    num_inference_steps_ddim: int = 8
    beta_schedule: str = "squaredcos_cap_v2"
    diffusion_step_embed_dim: int = 128
    down_dims: Tuple[int, ...] = (256, 512, 1024)
    kernel_size: int = 5
    n_groups: int = 8
    cond_predict_scale: bool = True
    obs_feature_dim: int = 64
    num_kp: int = 32
    prediction_type: str = "epsilon"
    action_orn01: bool = False
    dtype: str = "float32"
    vision_stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
    vision_stage_features: Tuple[int, ...] = (64, 128, 256, 512)
    ddpm_var_temp: float = 1.0
    # the trunks' max pool (`models/vision.py::POOLS`): "max" (the
    # release's), "packed" (bf16 only; V2A_PACKED_POOL=1) or "mask_bwd"
    # (V2A_POOL_MASK_BWD=1), the JAX package's experiment flags
    vision_pool: str = "max"

    @property
    def global_cond_dim(self) -> int:
        return self.obs_feature_dim * len(self.obs_keys) * self.n_obs_steps


class PolicyNets(nn.Module):
    """Obs encoder + action U-Net under one state dict."""

    def __init__(self, cfg: PolicyConfig):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        self.obs_encoder = MultiImageObsEncoder(
            tuple(cfg.obs_keys), cfg.obs_feature_dim, cfg.num_kp, dt,
            tuple(cfg.vision_stage_sizes), tuple(cfg.vision_stage_features), cfg.vision_pool,
        )
        self.unet = ConditionalUnet1D(
            input_dim=cfg.action_dim, global_cond_dim=cfg.global_cond_dim,
            down_dims=tuple(cfg.down_dims),
            diffusion_step_embed_dim=cfg.diffusion_step_embed_dim,
            kernel_size=cfg.kernel_size, n_groups=cfg.n_groups,
            cond_predict_scale=cfg.cond_predict_scale, dtype=dt,
        )


@dataclasses.dataclass
class DiffusionPolicy:
    """Nets + schedulers + normalizers."""

    config: PolicyConfig
    nets: PolicyNets
    ddpm: DDPMScheduler
    ddim: DDIMScheduler
    action_norm: LimitsNormalizer
    image_norm: LimitsNormalizer
    device: torch.device

    @classmethod
    def create(cls, config: Optional[PolicyConfig] = None,
               device: DeviceLike = None) -> "DiffusionPolicy":
        config = config or PolicyConfig()
        dev = resolve_device(device)
        kw = dict(num_train_timesteps=config.num_train_timesteps,
                  beta_schedule=config.beta_schedule, clip_sample=True,
                  prediction_type=config.prediction_type)
        return cls(
            config=config,
            nets=PolicyNets(config).to(dev).eval().requires_grad_(False),
            ddpm=DDPMScheduler.create(variance_type="fixed_small", **kw),
            ddim=DDIMScheduler.create(set_alpha_to_one=True, steps_offset=0, **kw),
            action_norm=lb_action_normalizer(config.action_orn01),
            image_norm=image_normalizer(),
            device=dev,
        )

    def init(self, seed: int = 0) -> "DiffusionPolicy":
        init_params(self.nets, torch.Generator(device=self.device).manual_seed(seed))
        return self

    def load_state_dict(self, state_dict) -> "DiffusionPolicy":
        """Weights as `convert/from_jax.py::policy_from_jax` returns them."""
        self.nets.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        return self

    def _encode(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        nobs = {k: self.image_norm.normalize(torch.as_tensor(v, device=self.device).float())
                for k, v in obs.items()}
        return self.nets.obs_encoder(nobs)

    @torch.no_grad()
    def encode_obs(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._encode(obs)

    def loss(self, batch: Dict, generator: Optional[torch.Generator] = None,
             timesteps: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None, shard=None) -> torch.Tensor:
        """The denoising loss (`v2a_tpu/models/policy.py:231-254`): the
        normalized observations through the encoder, the normalized actions
        noised by DDPM at uniform timesteps, and the mean squared error of
        the U-Net's prediction against the noise (epsilon) or the actions.

        batch: {"obs": {key: (B, H, W, 3) in [0, 1]}, "action": (B, horizon,
        Da) in action units}. `timesteps` (B,) and `noise` (B, horizon, Da)
        replace the draws from `generator` (timesteps first, as the JAX
        package draws them), so that a test can hand in the JAX draws. With
        `shard` (a dp `RowShard`) the batch is this rank's rows of the global
        batch: the draws are the global batch's and this rank keeps its
        rows, so the dp ranks' mean is the single process's loss.
        Differentiable through `nets` once its parameters require grad."""
        cfg = self.config
        nactions = self.action_norm.normalize(
            torch.as_tensor(batch["action"], device=self.device).float())
        b = nactions.shape[0]
        global_cond = self._encode(batch["obs"])
        n = b if shard is None else b * shard.count
        rows = slice(0, b) if shard is None else shard.rows(n)
        if timesteps is None:
            timesteps = torch.randint(0, cfg.num_train_timesteps, (n,), generator=generator,
                                      device=self.device)[rows]
        if noise is None:
            noise = torch.randn((n,) + tuple(nactions.shape[1:]), generator=generator,
                                device=self.device)[rows]
        timesteps = torch.as_tensor(timesteps, device=self.device)
        noise = torch.as_tensor(noise, device=self.device).float()
        noisy = self.ddpm.add_noise(nactions, noise, timesteps)
        pred = self.nets.unet(noisy, timesteps, global_cond)
        target = noise if cfg.prediction_type == "epsilon" else nactions
        return ((pred - target) ** 2).mean()

    @torch.no_grad()
    def predict_action(self, obs: Dict[str, torch.Tensor], use_ddim: bool = True,
                       generator: Optional[torch.Generator] = None,
                       init_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """{'action': (B, n_action_steps, Da), 'action_pred': (B, horizon, Da)}
        in action units. `init_noise` overrides the initial trajectory."""
        cfg = self.config
        global_cond = self.encode_obs(obs)
        b = global_cond.shape[0]
        shape = (b, cfg.horizon, cfg.action_dim)
        if init_noise is not None:
            traj = torch.as_tensor(init_noise, dtype=torch.float32, device=self.device)
        else:
            traj = torch.randn(shape, generator=generator, device=self.device)
        if use_ddim:
            ts = self.ddim.timesteps(cfg.num_inference_steps_ddim)
            ratio = cfg.num_train_timesteps // cfg.num_inference_steps_ddim
        else:
            ts = self.ddpm.timesteps(cfg.num_inference_steps)
            ratio = cfg.num_train_timesteps // cfg.num_inference_steps
        for t in ts.tolist():
            t_vec = torch.full((b,), t, dtype=torch.long, device=self.device)
            out = self.nets.unet(traj, t_vec, global_cond)
            if use_ddim:
                traj = self.ddim.step(out, t, t - ratio, traj)
            else:
                noise = torch.randn(shape, generator=generator, device=self.device)
                traj = self.ddpm.step(out, t, t - ratio, traj, noise,
                                      var_temp=cfg.ddpm_var_temp)
        action_pred = self.action_norm.unnormalize(traj)
        start = cfg.n_obs_steps - 1
        return {"action": action_pred[:, start:start + cfg.n_action_steps],
                "action_pred": action_pred}
