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
- `use_checkpoint` recomputes activations in the backward pass, with the
  JAX trainer's three policies (:188-217): "blocks" and "levels" are the
  U-Net's own (`models/video_unet.py`; the xattn backbone's is per block);
  "mxu" keeps the module plain and runs the whole call under one
  `torch.utils.checkpoint` whose selective-checkpoint policy saves only
  the outputs of `aten.convolution` / `aten.mm` / `aten.bmm` /
  `aten.addmm` and recomputes the rest. The hand kernels of `train_fused`
  launch through ctypes, below the dispatcher: that policy can neither see
  nor save them, and recomputes them (the JAX `mxu` is a policy of the
  plain path).
- `mesh` (`parallel.make_mesh`): the step is the single-process step on
  the global batch. Every rank samples the global batch, timesteps,
  weights and noise from the shared seeds and keeps its dp rows
  (`parallel/sharding.py`); gradients are averaged over dp before the
  clip, wide leaves and their Adam moments are tp-sharded
  (`ShardedParams`), the per-sample losses are all-gathered so every
  rank's loss-second-moment history folds in the whole batch (`merge`),
  and the EMA is whole and equal on every rank. Only rank 0 writes
  checkpoints and metrics; a checkpoint holds whole tensors in the layout
  of a run without a mesh and loads with or without one. `train_fused`
  stays off on a mesh unless asked for (the JAX rule, :169-187).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

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
    # gradient checkpointing and its policy: "blocks", "levels" or "mxu"
    use_checkpoint: bool = False
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


# the ops whose outputs the "mxu" policy saves (the JAX policy's
# conv_general_dilated / dot_general)
_MXU_OPS = (torch.ops.aten.convolution, torch.ops.aten.mm, torch.ops.aten.bmm,
            torch.ops.aten.addmm)


def _mxu_policy(ctx, op, *args, **kwargs):
    if op.overloadpacket in _MXU_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def mxu_checkpointed(net):
    """`net(x, t, e)` under one checkpoint that keeps only conv / matmul
    outputs for the backward (the "mxu" policy)."""
    def apply(x, t, e):
        return checkpoint(net, x, t, e, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(_mxu_policy))

    return apply


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
        from v2a_tpu_torch.parallel.mesh import check_mesh

        self.cfg = cfg = config or VideoTrainerConfig()
        self.mesh = check_mesh(mesh)
        self.rank0 = mesh is None or dist.get_rank() == 0
        self.model = model
        self.dataset = dataset
        self.workdir = workdir
        self.device = model.device
        self.metrics = MetricsLogger(workdir) if self.rank0 else None
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sampler = create_named_schedule_sampler(
            cfg.schedule_sampler, model.diffusion.num_timesteps)
        self.ema_config = ema_config or EMAConfig()

        train_fused = cfg.train_fused
        if train_fused is None:
            train_fused = (self.device.type == "cuda" and mesh is None and cfg.batch_size <= 4
                           and not cfg.use_checkpoint)
        ckpt_on = cfg.use_checkpoint
        if ckpt_on and model.config.backbone == "xattn" and cfg.remat_policy != "blocks":
            raise ValueError("the xattn backbone recomputes per block: remat_policy 'blocks'")
        with torch.device(self.device):
            unet = model.build_unet(fused=False, train_fused=bool(train_fused),
                                    wgrad_kernel=cfg.wgrad_kernel, use_checkpoint=ckpt_on,
                                    remat_policy=cfg.remat_policy)
        with model.whole():
            unet.load_state_dict(model.unet.state_dict())
        self.train_unet = unet.requires_grad_(True)
        self._train_apply = (mxu_checkpointed(unet) if ckpt_on and cfg.remat_policy == "mxu"
                             else unet)
        self.shards = self._rows = None
        if mesh is not None:
            from v2a_tpu_torch.parallel.sharding import batch_sharding, shard_train_state

            self._rows = batch_sharding(mesh)
            if cfg.batch_size % self._rows.count:
                raise ValueError(f"batch {cfg.batch_size} not divisible by dp={self._rows.count}")
            self.shards = shard_train_state(unet, mesh)
        self._params = list(unet.parameters()) if self.shards is None else self.shards.local
        optimizer = torch.optim.Adam(self._params, lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8)
        with self._whole():
            self.state = TrainState(unet, optimizer)

    def _whole(self):
        """The trained U-Net's parameters whole inside the block."""
        return contextlib.nullcontext() if self.shards is None else self.shards.whole()

    @property
    def step(self) -> int:
        return self.state.step

    def loss_and_grads(self, video, x_cond_n, task_embed, t, weights, noise=None):
        """(loss, per-sample losses) of one batch; leaves the pre-clip
        gradients in the parameters' `.grad`. video (B, F, H, W, 3) in
        [0, 1]; x_cond_n (B, 1, H, W, 3) in [-1, 1]; t (B,) int; weights (B,);
        `noise` overrides the generator's draw. On a mesh the arguments are
        the global batch: this rank computes its rows (the noise its rows of
        the global draw); the gradients are its rows' until
        `apply_gradients`, the loss the dp mean and the per-sample losses
        the whole batch's, all-gathered."""
        self.state.optimizer.zero_grad(set_to_none=True)
        self.train_unet.zero_grad(set_to_none=True)  # a mesh's whole parameters
        shard = self._rows
        if shard is not None:
            rows = shard.rows(video.shape[0])
            video, x_cond_n, task_embed, t, weights = (
                a[rows] for a in (video, x_cond_n, task_embed, t, weights))
            if noise is not None:
                noise = torch.as_tensor(noise)[rows]
            else:
                noise = self.model.diffusion._randn(tuple(video.shape), self.generator,
                                                    video.device, shard)
            self.shards.gather()
        loss, per_sample = self.model.diffusion.p_losses(
            self._train_apply, video, x_cond_n, task_embed, t=t, sample_weights=weights,
            return_per_sample=True, generator=self.generator, noise=noise,
        )
        loss.backward()
        loss, per_sample = loss.detach(), per_sample.detach()
        if shard is not None:
            from v2a_tpu_torch.parallel.sharding import all_gather_rows

            self.shards.dp_mean([loss])
            per_sample = all_gather_rows(per_sample, self.mesh)
        return loss, per_sample

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """Clip by the global norm (optax's rule), Adam, then the EMA
        (`v2a_tpu/train/video_trainer.py:231-240`). On a mesh: the dp mean
        of the gradients first, each rank's slices, the norm over the tp
        group."""
        module_params = list(self.train_unet.parameters())
        for p in module_params:
            if p.grad is None:  # optax sees a zero gradient there
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in module_params]
        if self.shards is not None:
            grads = self.shards.local_grads(grads)
            for p in module_params:
                p.grad = None
            for lt, g in zip(self.shards.local, grads):
                lt.grad = g
        norms = list(torch._foreach_norm([g.float() for g in grads]))
        if self.shards is not None:  # a sharded leaf's norm over its tp slices
            summed = self.shards.tp_sum([v.square() for v in norms])
            norms = [v if d is None else summed[i].sqrt()
                     for i, (v, d) in enumerate(zip(norms, self.shards.dims))]
        norm = torch.stack(norms).square().sum().sqrt()
        clip = self.cfg.grad_clip
        torch._foreach_mul_(grads, clip / torch.clamp(norm, min=clip))
        self.state.optimizer.step()
        self.state.step += 1
        with self._whole():
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
            self._fold_losses(t, per_sample.cpu().numpy())
            step = self.step
            if step % cfg.save_freq == 0 or step == n_steps:
                self.save()
            if self.rank0 and (step % cfg.log_freq == 0 or step == 1):
                self.metrics.log({"video_train/loss": float(loss),
                                  "time/step_interval": timer()}, step)
        self.publish_ema()

    def _fold_losses(self, t: np.ndarray, losses: np.ndarray) -> None:
        """The whole batch's (t, loss) pairs into the sampler, in row order:
        this rank's rows by `update_with_losses`, the other dp ranks' by
        `merge`, so every rank keeps the single process's history."""
        if self._rows is None:
            self.sampler.update_with_losses(t, losses)
            return
        for r, idx in enumerate(np.split(np.arange(len(t)), self._rows.count)):
            fold = (self.sampler.update_with_losses if r == self._rows.index
                    else getattr(self.sampler, "merge", None))
            if fold is not None:
                fold(t[idx], losses[idx])

    def publish_ema(self) -> None:
        """The trained EMA weights into `model.unet`."""
        self.model.unet.load_state_dict(self.state.ema)

    def save(self):
        """Every rank takes part (a mesh gathers the state whole); rank 0
        writes."""
        freq = max(self.cfg.n_train_steps // self.cfg.n_saves, 1)
        state = self.state.state_dict(self.train_unet, self.shards)
        if self.rank0:
            ckpt.save_checkpoint(self.workdir, self.step // freq * freq, state, extra={},
                                 n_saves=self.cfg.n_saves)
        if self.mesh is not None:
            dist.barrier()

    def load(self, label: Optional[int] = None):
        state, _ = ckpt.restore_checkpoint(self.workdir, label, map_location=self.device)
        self.state.load_state_dict(self.train_unet, state, self.shards)

    def close(self):
        if self.metrics is not None:
            self.metrics.close()
