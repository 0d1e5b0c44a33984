"""The multi-rank dry run: the mesh's numerics on CPU ranks.

Counterpart of `__graft_entry__.py::dryrun_multichip` (:75-249), which
validates dp + tp sharding on a virtual CPU mesh. Here n gloo ranks are
spawned on the CPU (`parallel.multihost.spawn_ranks`) as a (dp, tp) mesh,
tp = 2 when n is even; they run

- one policy train step (`train/train_state.py::make_train_step`, the
  JAX dry run's policy with a two-stage vision trunk, leaves of 128 and
  more tp-sharded, the batch dp-split) against the
  single-process step on the same global batch and draws: the loss and the
  grad norm within rtol 2e-5, the post-step parameters' float64 sum of
  |values| within 1e-6 (the JAX dry run's tolerances);
- a dp-split DDIM chain of a small video U-Net (each rank its rows of the
  global draws, the rows all-gathered) against the single-process chain:
  pixel mean absolute error under 1e-5.

A divergence raises on rank 0 and fails the call.

    python -c "from v2a_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import copy
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def _policy_step(mesh, rank: int) -> None:
    from v2a_tpu_torch.models.policy import DiffusionPolicy, PolicyConfig
    from v2a_tpu_torch.parallel.sharding import batch_sharding, shard_train_state
    from v2a_tpu_torch.train.train_state import (
        EMAConfig, OptimizerConfig, PolicyTrainState, fused_clip_adamw, make_train_step,
    )

    cfg = PolicyConfig(image_size=(32, 32), down_dims=(64, 128), horizon=16, n_action_steps=8,
                       num_train_timesteps=10, num_inference_steps=10,
                       num_inference_steps_ddim=2, vision_stage_sizes=(1, 1),
                       vision_stage_features=(64, 128))
    ref_policy = DiffusionPolicy.create(cfg, device="cpu").init(0)
    policy = copy.deepcopy(ref_policy)
    n = dist.get_world_size()
    b = max(2 * n, mesh.shape["dp"])
    h, w = cfg.image_size
    rs = np.random.RandomState(0)
    host = {"obs": {k: rs.rand(b, h, w, 3).astype(np.float32) for k in cfg.obs_keys},
            "action": (rs.rand(b, cfg.horizon, cfg.action_dim) * 2 - 1).astype(np.float32)}
    tx = fused_clip_adamw(OptimizerConfig())

    def step_of(pol, shards, loss_fn, batch):
        pol.nets.requires_grad_(True)
        state = PolicyTrainState(pol.nets, tx, shards=shards)
        out = make_train_step(loss_fn, tx, EMAConfig())(
            state, batch, torch.Generator().manual_seed(1))
        with state.whole():
            total = sum(float(np.abs(p.detach().double().numpy()).sum())
                        for p in pol.nets.parameters())
        return float(out.loss), float(out.grad_norm), total

    rows = batch_sharding(mesh)
    sl = rows.rows(b)
    local = {"obs": {k: torch.from_numpy(v[sl]) for k, v in host["obs"].items()},
             "action": torch.from_numpy(host["action"][sl])}
    shards = shard_train_state(policy.nets, mesh, min_size=128)

    def mesh_loss(batch, gen):
        return policy.loss(batch, gen, shard=rows)

    got = step_of(policy, shards, mesh_loss, local)
    if rank == 0:
        batch = {"obs": {k: torch.from_numpy(v) for k, v in host["obs"].items()},
                 "action": torch.from_numpy(host["action"])}
        want = step_of(ref_policy, None, ref_policy.loss, batch)
        for what, g, r, tol in zip(("loss", "grad norm", "post-step params"), got, want,
                                   (2e-5, 2e-5, 1e-6)):
            if not np.isfinite(g) or abs(g - r) > tol * abs(r):
                raise AssertionError(f"sharded train-step {what} {g} diverged from the "
                                     f"single-process step's {r}")


def _video_chain(mesh, rank: int) -> None:
    from v2a_tpu_torch.models.init import init_params
    from v2a_tpu_torch.models.video_unet import VideoUNet
    from v2a_tpu_torch.ops.gaussian_diffusion import GaussianDiffusion
    from v2a_tpu_torch.ops.schedules import DiffusionSchedule
    from v2a_tpu_torch.parallel.sharding import all_gather_rows, batch_sharding

    unet = VideoUNet(in_channels=6, model_channels=32, out_channels=3, num_res_blocks=1,
                     attention_resolutions=(8,), channel_mult=(1, 2), num_head_channels=32,
                     task_token_dim=64).eval()
    init_params(unet, torch.Generator().manual_seed(2))
    diffusion = GaussianDiffusion(schedule=DiffusionSchedule.create(8, "cosine"),
                                  objective="pred_v", sampling_timesteps=4)
    f, hh, ww = 2, 16, 16
    vb = mesh.shape["dp"] * 2

    def chain(x_cond, emb, shard):
        gen = torch.Generator().manual_seed(3)
        img = diffusion._randn((x_cond.shape[0], f, hh, ww, 3), gen, "cpu", shard)
        with torch.no_grad():
            for step in diffusion.sample_steps():
                img = diffusion.sample_step(unet, img, step, x_cond, emb, gen, shard)
            return diffusion.sample_finish(img)

    x_cond, emb = torch.zeros(vb, 1, hh, ww, 3), torch.zeros(vb, 4, 64)
    rows = batch_sharding(mesh)
    sl = rows.rows(vb)
    vid = all_gather_rows(chain(x_cond[sl], emb[sl], rows), mesh)
    if tuple(vid.shape) != (vb, f, hh, ww, 3):
        raise AssertionError(f"dp-sharded video shape {tuple(vid.shape)}")
    if rank == 0:
        mae = float((vid - chain(x_cond, emb, None)).abs().mean())
        if not mae < 1e-5:
            raise AssertionError(f"dp-sharded sampled video diverged from the single process "
                                 f"(pixel MAE {mae})")


def _dryrun_rank(rank: int, n: int) -> None:
    from v2a_tpu_torch.parallel.mesh import make_mesh

    tp = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(("dp", "tp"), (n // tp, tp), device="cpu")
    _policy_step(mesh, rank)
    _video_chain(mesh, rank)


def dryrun_multichip(n_devices: int) -> None:
    """Spawn `n_devices` gloo ranks on the CPU and hold the (dp, tp) mesh's
    policy step and dp-split video chain against one process."""
    from v2a_tpu_torch.parallel.multihost import spawn_ranks

    with tempfile.TemporaryDirectory() as d:
        spawn_ranks(_dryrun_rank, n_devices, os.path.join(d, "store"), args=(n_devices,))


def video_step_rank(rank: int, out_dir: str, device: str, cfg_kw: dict, train_kw: dict,
                    problem: str) -> None:
    """One rank of a dp video train step on `device` ("cuda": one card a
    rank over NCCL): the U-Net weights and the global batch from the file
    `problem` (`torch.save` of {"unet", "batch", "noise"}), a dp mesh over
    the world, one `VideoModelTrainer.train_step`; rank 0 saves the loss,
    the per-sample losses and the post-step parameters to
    `out_dir/dp_step.pt`, every rank the launches of its step."""
    from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
    from v2a_tpu_torch.ops import resblock_kernels as rk
    from v2a_tpu_torch.parallel.mesh import make_mesh
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    mesh = make_mesh(("dp",), device=device)
    prob = torch.load(problem, map_location=mesh.device, weights_only=True)
    model = VideoPredModel(VideoModelConfig(**cfg_kw), device=device)
    model.unet.load_state_dict(prob["unet"])
    trainer = VideoModelTrainer(model, None, VideoTrainerConfig(**train_kw),
                                workdir=os.path.join(out_dir, "w"), mesh=mesh)
    before = dict(rk.launches)
    loss, per_sample = trainer.train_step(*prob["batch"], noise=prob["noise"])
    launches = {n: v - before[n] for n, v in rk.launches.items() if v != before[n]}
    torch.save(launches, os.path.join(out_dir, f"dp_launches-{rank}.pt"))
    if rank == 0:
        torch.save(dict(loss=loss.cpu(), per_sample=per_sample.cpu(),
                        params={k: v.cpu() for k, v in trainer.train_unet.state_dict().items()}),
                   os.path.join(out_dir, "dp_step.pt"))
    trainer.close()
