"""Experiment factory: config tree -> env list, policy, video model, trainer.

Counterpart of `v2a_tpu/train/build.py` (the composition the reference
spreads across `scripts/train_libero_dp.py:29-167`): the train entry, the
eval entry and the tests build experiments identically. The models go to
`cfg.device` (the card when None). With `cfg.n_env_workers > 0` the trainer
gets an `EnvWorkerPool` of that many spawned workers (`trainer.env_pool`),
which the caller closes. With `cfg.mesh_axes` the trainer trains on that
mesh (`make_experiment_mesh`), and a mesh with a tp axis shards the video
model's sampler (`VideoPredModel.shard_for_mesh`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from v2a_tpu_torch.config.experiment import ExperimentConfig, save_snapshot
from v2a_tpu_torch.envs.base import EnvList
from v2a_tpu_torch.models.policy import DiffusionPolicy
from v2a_tpu_torch.models.video_model import VideoPredModel
from v2a_tpu_torch.train.trainer import OnlineTrainer


def build_env_list(cfg: ExperimentConfig) -> EnvList:
    """Resolve `cfg.dataset` through the env registry; fall back to a fake
    list sized like the config when the name is unregistered and the
    backend is 'fake'."""
    from v2a_tpu_torch.envs.registration import _REGISTRY, make_env_list

    if cfg.dataset in _REGISTRY:
        return make_env_list(cfg.dataset)
    if cfg.env_backend == "fake":
        from v2a_tpu_torch.envs.fake import FakeEnvList

        return FakeEnvList(num_tasks=2, img_hw=tuple(cfg.policy.image_size))
    raise KeyError(
        f"env list {cfg.dataset!r} is not registered and backend is "
        f"{cfg.env_backend!r}"
    )


def make_video_model(cfg: ExperimentConfig) -> VideoPredModel:
    """The frozen video model (`lb_get_video_model_gcp_v2`,
    `diffuser/libero/lb_video_model_utils.py:13-66`): the converted
    reference checkpoint `<video_ckpt_dir>/torch-model-{milestone}.pt` when
    the directory holds one (`VideoPredModel.load_converted`, the tokenizer
    from `<video_ckpt_dir>/tokenizer`), else random weights from
    `cfg.seed`. A directory that holds only the JAX package's
    `jax-model-{milestone}.msgpack` raises: the port does not read that
    file, and the reference `.pt` converts with `python -m
    v2a_tpu_torch.scripts.convert_ckpt`."""
    model = VideoPredModel(cfg.video, device=cfg.device)
    ckpt = os.path.join(cfg.video_ckpt_dir, f"torch-model-{cfg.video_ckpt_milestone}.pt")
    jax_ckpt = os.path.join(cfg.video_ckpt_dir,
                            f"jax-model-{cfg.video_ckpt_milestone}.msgpack")
    if os.path.exists(ckpt):
        return model.load_converted(
            ckpt, tokenizer_dir=os.path.join(cfg.video_ckpt_dir, "tokenizer"), seed=cfg.seed)
    if os.path.exists(jax_ckpt):
        raise FileNotFoundError(
            f"{cfg.video_ckpt_dir} holds {os.path.basename(jax_ckpt)} but no "
            f"{os.path.basename(ckpt)}: the port reads its own converted file; convert the "
            "reference checkpoint with `python -m v2a_tpu_torch.scripts.convert_ckpt --kind "
            f"video --pt <model-{cfg.video_ckpt_milestone}.pt> --out {ckpt}`")
    return model.init(cfg.seed)


def build_experiment(
    cfg: ExperimentConfig,
    workdir: Optional[str] = None,
    with_video_model: bool = True,
    snapshot: bool = True,
) -> Tuple[OnlineTrainer, DiffusionPolicy, EnvList, Optional[VideoPredModel]]:
    workdir = workdir or cfg.savepath()
    env_list = build_env_list(cfg)
    policy = DiffusionPolicy.create(cfg.policy, device=cfg.device)
    video_model = None
    sampler = None
    if with_video_model:
        if cfg.video_model_kind == "oracle":
            # hermetic scripted goal-frame generator (the learning gate's
            # stand-in for the frozen pretrained model; fake env only)
            if cfg.env_backend != "fake":
                raise ValueError(
                    "video_model_kind='oracle' requires env_backend='fake'"
                )
            from v2a_tpu_torch.envs.fake_oracle import FakeOracleVideoModel

            video_model = sampler = FakeOracleVideoModel(
                env_list.task_to_task_idx,
                horizon=cfg.video.video_future_horizon,
            )
        else:
            video_model = make_video_model(cfg)
            sampler = _VideoSampleAdapter(video_model)

    mesh = make_experiment_mesh(cfg)
    if mesh is not None and "tp" in mesh.axis_names and isinstance(video_model, VideoPredModel):
        video_model.shard_for_mesh(mesh)  # the oracle is host-side

    env_pool = None
    if cfg.n_env_workers > 0:
        from v2a_tpu_torch.envs.subproc import EnvWorkerPool

        env_pool = EnvWorkerPool(cfg.dataset, cfg.n_env_workers)

    trainer = OnlineTrainer(
        policy=policy,
        env_list=env_list,
        config=cfg.trainer,
        workdir=workdir,
        video_model=sampler,
        explore_config=cfg.explore,
        opt_config=cfg.opt,
        ema_config=cfg.ema,
        seed=cfg.seed,
        env_pool=env_pool,
        mesh=mesh,
    )
    if snapshot:
        save_snapshot(cfg, workdir)
    return trainer, policy, env_list, video_model


def make_experiment_mesh(cfg: ExperimentConfig):
    """The config's mesh (JAX :90-106): None without `mesh_axes`,
    `("auto_dp",)` one dp axis over the world, else `make_mesh(mesh_axes,
    mesh_shape)` on the config's device. The process group is the caller's
    (`parallel.multihost.initialize_distributed`); a single process makes a
    one-rank mesh."""
    if not cfg.mesh_axes:
        return None
    from v2a_tpu_torch.parallel.mesh import make_mesh

    if tuple(cfg.mesh_axes) == ("auto_dp",):
        return make_mesh(("dp",), device=cfg.device)
    return make_mesh(tuple(cfg.mesh_axes), tuple(cfg.mesh_shape) if cfg.mesh_shape else None,
                     device=cfg.device)


class _VideoSampleAdapter:
    """Adapts `VideoPredModel` to the trainer's video-model protocol
    (`.sample_u8(generator, imgs01, tasks) -> (B, F, H, W, 3) uint8`, host
    arrays): one batched call on the model's device, quantized there; and
    `.sample_u8_stream(generator, imgs01, tasks, n_chunks)`, the same chain
    as a `VideoSampleStream` (its `result_u8()` on the device)."""

    def __init__(self, model: VideoPredModel):
        self.model = model

    def sample_u8(self, generator, imgs01: np.ndarray, tasks):
        return self.model.sample_u8(imgs01, list(tasks), generator=generator).cpu().numpy()

    def sample_u8_stream(self, generator, imgs01: np.ndarray, tasks, n_chunks: int):
        return self.model.sample_u8_stream(imgs01, list(tasks), generator=generator,
                                           n_chunks=n_chunks)
