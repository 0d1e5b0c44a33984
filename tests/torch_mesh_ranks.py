"""What the spawned gloo ranks of `tests/test_torch_parallel.py` run.

Each function is `fn(rank, out_dir, ...)`, started on every rank of one
process group by `v2a_tpu_torch.parallel.multihost.spawn_ranks`; it writes
what the test checks to `out_dir/<name>-<rank>.pt`. This module imports the
port and torch only (no jax, no test file), so a rank starts in seconds.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from v2a_tpu_torch.parallel.mesh import make_mesh
from v2a_tpu_torch.parallel.sharding import batch_sharding, shard_train_state


class Clips:
    """`sample_batch` / `__len__` over seeded uint8 episodes: (x_cond, video,
    tasks) in [0, 1], as `VideoClipDataset` returns them."""

    def __init__(self, hw=8, frames=2, tasks=("push the button", "open the drawer")):
        self.eps = np.random.RandomState(0).randint(0, 256, (4, 12, hw, hw, 3), np.uint8)
        self.frames, self.tasks = frames, list(tasks)

    def __len__(self):
        return len(self.eps)

    def sample_batch(self, batch, rng):
        e = rng.integers(len(self.eps), size=batch)
        s = rng.integers(0, 12 - self.frames - 1, size=batch)
        x_cond = np.stack([self.eps[i, j] for i, j in zip(e, s)]).astype(np.float32) / 255.0
        video = np.stack([self.eps[i, j + 1: j + 1 + self.frames]
                          for i, j in zip(e, s)]).astype(np.float32) / 255.0
        return x_cond, video, [self.tasks[i % len(self.tasks)] for i in e]


def _save(out_dir, name, rank, obj):
    torch.save(obj, os.path.join(out_dir, f"{name}-{rank}.pt"))


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def policy_step(rank, out_dir, cfg_kw, weights, batch, t, noise, lr, clip, min_size):
    """One policy step on a (dp=2, tp=2) mesh with the JAX draws handed in."""
    from v2a_tpu_torch.models.policy import DiffusionPolicy, PolicyConfig
    from v2a_tpu_torch.train.train_state import (
        EMAConfig, OptimizerConfig, PolicyTrainState, fused_clip_adamw, make_train_step,
    )

    mesh = make_mesh(("dp", "tp"), (2, 2), device="cpu")
    policy = DiffusionPolicy.create(PolicyConfig(**cfg_kw), device="cpu").load_state_dict(weights)
    policy.nets.requires_grad_(True)
    shards = shard_train_state(policy.nets, mesh, min_size=min_size)
    tx = fused_clip_adamw(OptimizerConfig(lr=lr, grad_clip=clip))
    state = PolicyTrainState(policy.nets, tx, shards=shards)
    rows = batch_sharding(mesh).rows(len(t))
    local = {"obs": {k: torch.from_numpy(v[rows]) for k, v in batch["obs"].items()},
             "action": torch.from_numpy(batch["action"][rows])}

    def loss_fn(b, gen):
        return policy.loss(b, gen, timesteps=torch.from_numpy(t[rows]),
                           noise=torch.from_numpy(noise[rows]))

    out = make_train_step(loss_fn, tx, EMAConfig())(state, local)
    with state.whole():
        params = _sd(policy.nets)
    mu = state.opt_state.mu
    _save(out_dir, "policy", rank, dict(
        loss=out.loss.item(), grad_norm=out.grad_norm.item(), params=params,
        ema={k: e.clone() for k, e in zip(state.names, state.ema_params)},
        sharded=[state.names[i] for i in shards.sharded],
        moments={state.names[i]: (mu[i].numel(), int(np.prod(shards.shapes[i])))
                 for i in shards.sharded},
        released=[state.names[i] for i in shards.sharded
                  if state.module_params[i].numel() == 0]))


def video_trainer(rank, out_dir, cfg_kw, weights, args, noise, tcfg_kw, wide_kw):
    """(a) one dp=2 step of `VideoModelTrainer` on a handed-in global batch
    and noise, then `train(2)` on `Clips`; (b) a (1, 2) tp mesh trainer of a
    wider U-Net: `train(1)`, its checkpoint, its gathered state, a reload."""
    from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    mesh = make_mesh(("dp",), (2,), device="cpu")
    tm = VideoPredModel(VideoModelConfig(**cfg_kw), device="cpu").load_state_dict(weights)
    tr = VideoModelTrainer(tm, Clips(), VideoTrainerConfig(**tcfg_kw),
                           workdir=os.path.join(out_dir, f"a{rank}"), seed=0, mesh=mesh)
    loss, per_sample = tr.train_step(*(torch.from_numpy(a) for a in args),
                                     noise=torch.from_numpy(noise))
    first = dict(loss=loss.item(), per_sample=per_sample.clone(), params=_sd(tr.train_unet),
                 ema={k: v.clone() for k, v in tr.state.ema.items()},
                 grads={k: p.grad.clone() for k, p in tr.train_unet.named_parameters()})
    tr.train(2)
    run = dict(params=_sd(tr.train_unet), history=tr.sampler._loss_history.copy(),
               counts=tr.sampler._loss_counts.copy())
    tr.close()

    wide = make_mesh(("dp", "tp"), (1, 2), device="cpu")
    wm = VideoPredModel(VideoModelConfig(**wide_kw), device="cpu").init(1)
    wt = VideoModelTrainer(wm, Clips(), VideoTrainerConfig(**dict(tcfg_kw, n_train_steps=1)),
                           workdir=os.path.join(out_dir, "b"), seed=0, mesh=wide)
    wt.train(1)
    state = wt.state.state_dict(wt.train_unet, wt.shards)
    if rank == 0:
        torch.save(state, os.path.join(out_dir, "b_state.pt"))
    local = [t.detach().clone() for t in wt.shards.local]
    moments = {i: {k: v.clone() for k, v in s.items()}
               for i, s in wt.state.optimizer.state_dict()["state"].items()}
    wt.load()
    reloaded = all(torch.equal(a, b) for a, b in zip(local, wt.shards.local)) and all(
        torch.equal(v, wt.state.optimizer.state_dict()["state"][i][k])
        for i, s in moments.items() for k, v in s.items())
    _save(out_dir, "video", rank, dict(
        first=first, run=run, wide_sharded=len(wt.shards.sharded), reloaded=reloaded,
        wide_params=state["params"] if rank == 1 else None))
    wt.close()


def sampler(rank, out_dir, cfg_kw, wide_kw, x_conds, tasks):
    """`shard_for_mesh` + `sample` on a dp=2 mesh (the small model) and on a
    (1, 2) tp mesh (a model with wide leaves)."""
    from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel

    out = {}
    for name, kw, axes, shape in (("dp", cfg_kw, ("dp",), (2,)),
                                  ("tp", wide_kw, ("dp", "tp"), (1, 2))):
        model = VideoPredModel(VideoModelConfig(**kw), device="cpu").init(3)
        model.shard_for_mesh(make_mesh(axes, shape, device="cpu"))
        video = model.sample(torch.from_numpy(x_conds), tasks,
                             generator=torch.Generator().manual_seed(5))
        shards = model._shards
        out[name] = dict(video=video, n_sharded=len(shards.sharded),
                         released=all(shards.params[i].numel() == 0 for i in shards.sharded))
    _save(out_dir, "sampler", rank, out)


def online_cycle(rank, out_dir, exp):
    """`build_experiment` with `mesh_axes=("auto_dp",)`: one guided cycle,
    each rank's buffer digest; then a tampered buffer on rank 1 must make
    the check raise on every rank."""
    from v2a_tpu_torch.train.build import build_experiment

    trainer, *_ = build_experiment(exp, os.path.join(out_dir, "w"), snapshot=False)
    trainer.train(exp.trainer.n_train_steps)
    digest = trainer.buffer_digest()
    cycles = trainer.cnt_vid_rollouts
    if rank == 1:
        ep = trainer.envBuf_vid.export_episodes()[0]
        trainer.envBuf_vid.add_episode(ep["task"], ep["cam"], ep["env_idx"], ep["imgs"],
                                       ep["acts"], is_success=ep["is_success"])
    try:
        trainer.check_buffers_equal()
        raised = False
    except RuntimeError:
        raised = True
    _save(out_dir, "online", rank, dict(digest=digest, rollouts=cycles, raised=raised))
