"""Video diffusion model trainer.

Counterpart of `v2a_tpu/train/video_trainer.py`: EMA'd diffusion training of
the video U-Net with gradient clipping, optional loss-aware timestep
resampling and milestone checkpoints, bf16 compute and float32 parameters.

- The trainer builds its own U-Net with the non-fused routing (the fused
  forward kernels have no backward) and, on the card at B <= 4, the
  `train_fused` routing (K1 forward and dgrad through `ops/conv_vjp.py`, K6
  as the wgrad with `wgrad_kernel`), loads the model's U-Net weights into it
  and trains it; the text tower stays frozen. The xattn backbone has no
  routing: its one plain path trains, as `train_fused` applies in the JAX
  trainer only where the network has it (:186). At the end the EMA weights go
  back into `model.unet`.
- The optimizer is the JAX package's `optax.chain(clip_by_global_norm(c),
  adam(lr, b1, b2))`: the global norm in float32, scale = c / max(norm, c),
  then `torch.optim.Adam` with eps 1e-8 (optax's eps_root 0).
- Batches, timesteps and weights come from one numpy generator, as in the
  JAX trainer, so one seed gives its batches and timesteps; the diffusion
  noise comes from a `torch.Generator`.

Not ported: `use_checkpoint` / `remat_policy` and the mesh trainer raise
`NotImplementedError` (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from v2a_tpu_torch.models.video_model import VideoPredModel
from v2a_tpu_torch.ops.resample import create_named_schedule_sampler
from v2a_tpu_torch.train import checkpoint as ckpt
from v2a_tpu_torch.train.metrics import MetricsLogger, Timer
from v2a_tpu_torch.train.train_state import EMAConfig, TrainState, ema_decay


@dataclasses.dataclass(frozen=True)
class VideoTrainerConfig:
    """The knobs of the AVDC `Trainer.__init__` (`goal_diffusion.py` ctor)
    that matter for training (`v2a_tpu/train/video_trainer.py:36-70`)."""

    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.99
    grad_clip: float = 1.0
    batch_size: int = 8
    n_train_steps: int = 200_000
    save_freq: int = 5000
    log_freq: int = 100
    n_saves: int = 5
    schedule_sampler: str = "uniform"  # or 'loss-second-moment'
    use_checkpoint: bool = False  # not ported: raises
    remat_policy: str = "blocks"
    # the differentiable K1 routing; None = on when the device is cuda, there
    # is no mesh, batch_size <= 4 and no checkpointing (:169-187)
    train_fused: Optional[bool] = None
    # K6 as the wgrad of the train_fused convs (the JAX package's
    # V2A_TRAIN_WGRAD_PALLAS=1, off by default there too)
    wgrad_kernel: bool = False


class VideoClipDataset:
    """Samples (x_cond, video, task) clips from HDF5 episode files with the
    layout of `data/h5_ingest.py`: a random episode, a random start frame,
    the next F frames subsampled with stride so clips span real motion.
    Imports h5py on construction only."""

    def __init__(self, h5path: str, tasks: Sequence[str], frames: int, stride: int = 4):
        import h5py

        self.h5 = h5py.File(h5path, "r")
        self.tasks = [t for t in tasks if t in self.h5]
        if not self.tasks:
            raise ValueError(f"none of the tasks exist in {h5path}")
        self.frames = frames
        self.stride = stride
        self._index: List[Tuple[str, str, int]] = []
        for t in self.tasks:
            for ep in self.h5[t]:
                n = self.h5[t][ep]["agentview_image"].shape[0]
                if n >= frames * stride + 1:
                    self._index.append((t, ep, n))

    def __len__(self):
        return len(self._index)

    def sample_batch(self, batch: int, rng: np.random.Generator):
        f, s = self.frames, self.stride
        conds, vids, tasks = [], [], []
        for _ in range(batch):
            t, ep, n = self._index[rng.integers(len(self._index))]
            start = int(rng.integers(0, n - f * s))
            imgs = self.h5[t][ep]["agentview_image"]
            conds.append(imgs[start])
            vids.append(imgs[start + s: start + s * (f + 1): s][:f])
            tasks.append(t)
        x_cond = np.stack(conds).astype(np.float32) / 255.0
        video = np.stack(vids).astype(np.float32) / 255.0
        return x_cond, video, tasks

    def close(self):
        self.h5.close()


class VideoModelTrainer:
    def __init__(
        self,
        model: VideoPredModel,
        dataset,
        config: Optional[VideoTrainerConfig] = None,
        workdir: str = "logs/video",
        ema_config: Optional[EMAConfig] = None,
        seed: int = 0,
        mesh=None,
    ):
        self.cfg = cfg = config or VideoTrainerConfig()
        if mesh is not None:
            raise NotImplementedError("the mesh (data/tensor-parallel) trainer is not ported")
        if cfg.use_checkpoint:
            raise NotImplementedError(
                f"use_checkpoint (remat_policy {cfg.remat_policy!r}) is not ported")
        self.model = model
        self.dataset = dataset
        self.workdir = workdir
        self.device = model.device
        self.metrics = MetricsLogger(workdir)
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sampler = create_named_schedule_sampler(
            cfg.schedule_sampler, model.diffusion.num_timesteps)
        self.ema_config = ema_config or EMAConfig()

        train_fused = cfg.train_fused
        if train_fused is None:
            train_fused = (self.device.type == "cuda" and mesh is None and cfg.batch_size <= 4
                           and not cfg.use_checkpoint)
        with torch.device(self.device):
            unet = model.build_unet(fused=False, train_fused=bool(train_fused),
                                    wgrad_kernel=cfg.wgrad_kernel)
        unet.load_state_dict(model.unet.state_dict())
        self.train_unet = unet.requires_grad_(True)
        self._params = list(unet.parameters())
        optimizer = torch.optim.Adam(self._params, lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8)
        self.state = TrainState(unet, optimizer)

    @property
    def step(self) -> int:
        return self.state.step

    def loss_and_grads(self, video, x_cond_n, task_embed, t, weights, noise=None):
        """(loss, per-sample losses) of one batch; leaves the pre-clip
        gradients in the parameters' `.grad`. video (B, F, H, W, 3) in
        [0, 1]; x_cond_n (B, 1, H, W, 3) in [-1, 1]; t (B,) int; weights (B,);
        `noise` overrides the generator's draw."""
        self.state.optimizer.zero_grad(set_to_none=True)
        loss, per_sample = self.model.diffusion.p_losses(
            self.train_unet, video, x_cond_n, task_embed, t=t, sample_weights=weights,
            return_per_sample=True, generator=self.generator, noise=noise,
        )
        loss.backward()
        return loss.detach(), per_sample.detach()

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """Clip by the global norm (optax's rule), Adam, then the EMA
        (`v2a_tpu/train/video_trainer.py:231-240`)."""
        for p in self._params:
            if p.grad is None:  # optax sees a zero gradient there
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._params]
        norm = torch.stack(torch._foreach_norm([g.float() for g in grads])).square().sum().sqrt()
        clip = self.cfg.grad_clip
        torch._foreach_mul_(grads, clip / torch.clamp(norm, min=clip))
        self.state.optimizer.step()
        self.state.step += 1
        self.state.update_ema(self.train_unet, ema_decay(self.state.step, self.ema_config))

    def train_step(self, video, x_cond_n, task_embed, t, weights, noise=None):
        """One step, the counterpart of `_train_step` (:220-250): returns
        (loss, per-sample losses)."""
        loss, per_sample = self.loss_and_grads(video, x_cond_n, task_embed, t, weights, noise)
        self.apply_gradients()
        return loss, per_sample

    def train(self, n_steps: Optional[int] = None):
        cfg = self.cfg
        n_steps = n_steps or cfg.n_train_steps
        timer = Timer()
        dev = self.device
        while self.step < n_steps:
            x_cond, video, tasks = self.dataset.sample_batch(cfg.batch_size, self.np_rng)
            t, weights = self.sampler.sample(cfg.batch_size, self.np_rng)
            task_embed = self.model.encode_batch_text(tasks)
            x_cond_n = (torch.as_tensor(x_cond, device=dev) * 2.0 - 1.0)[:, None]
            loss, per_sample = self.train_step(
                torch.as_tensor(video, device=dev), x_cond_n, task_embed,
                torch.as_tensor(t, dtype=torch.long, device=dev),
                torch.as_tensor(weights, device=dev),
            )
            self.sampler.update_with_losses(t, per_sample.cpu().numpy())
            step = self.step
            if step % cfg.save_freq == 0 or step == n_steps:
                self.save()
            if step % cfg.log_freq == 0 or step == 1:
                self.metrics.log({"video_train/loss": float(loss),
                                  "time/step_interval": timer()}, step)
        self.publish_ema()

    def publish_ema(self) -> None:
        """The trained EMA weights into `model.unet`."""
        self.model.unet.load_state_dict(self.state.ema)

    def save(self):
        freq = max(self.cfg.n_train_steps // self.cfg.n_saves, 1)
        ckpt.save_checkpoint(self.workdir, self.step // freq * freq,
                             self.state.state_dict(self.train_unet), extra={},
                             n_saves=self.cfg.n_saves)

    def load(self, label: Optional[int] = None):
        state, _ = ckpt.restore_checkpoint(self.workdir, label, map_location=self.device)
        self.state.load_state_dict(self.train_unet, state)

    def close(self):
        self.metrics.close()
