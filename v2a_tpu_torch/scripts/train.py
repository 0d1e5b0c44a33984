"""Online-training entry point.

Counterpart of `scripts/train.py` (the reference's
`scripts/train_libero_dp.py:29-167`):

    python -m v2a_tpu_torch.scripts.train \
        --config v2a_tpu_torch/config/fake/fake_smoke.py \
        [--trainer.n_train_steps 1000] [--seed 3] [--device cpu] ...

Flow: load config module -> apply CLI overrides -> build experiment
(env list + policy + frozen video model + trainer) -> smoke-test one
loss/grad on random tensors -> optionally resume -> train. The config
snapshot written to the workdir is the contract eval reloads from. The
models run on the card unless `--device cpu` is given. With
`--n_env_workers N` the guided cycles run on N spawned env workers in
lock-step (closed when training ends).

A config whose `mesh_axes` is set trains on a mesh (`("auto_dp",)`: data
parallel over the world); launch one process per card with
`torchrun --nproc_per_node N -m v2a_tpu_torch.scripts.train --config ...`.
The process group starts first (`parallel.multihost.initialize_distributed`;
one process with no cluster environment runs a one-rank mesh).
"""

import sys

import numpy as np
import torch

from v2a_tpu_torch.config import apply_overrides, load_config_module, parse_cli
from v2a_tpu_torch.parallel.multihost import initialize_distributed
from v2a_tpu_torch.train.build import build_experiment


def main(argv=None):
    config_path, overrides = parse_cli(argv if argv is not None else sys.argv[1:])
    if not config_path:
        raise SystemExit("usage: train.py --config <config.py> [--key value]...")
    cfg = load_config_module(config_path)
    if overrides:
        cfg = apply_overrides(cfg, overrides)

    if cfg.mesh_axes:
        initialize_distributed(device=cfg.device)
    workdir = cfg.savepath()
    print(f"[train] workdir: {workdir}")
    trainer, policy, env_list, video_model = build_experiment(cfg, workdir)

    # smoke test: one loss+grad on random tensors before the loop
    # (`scripts/train_libero_dp.py:131-147`)
    h, w = cfg.policy.image_size
    rs = np.random.RandomState(0)
    dev = policy.device
    batch = {
        "obs": {
            k: torch.as_tensor(rs.rand(2, h, w, 3).astype(np.float32), device=dev)
            for k in cfg.policy.obs_keys
        },
        "action": torch.as_tensor(rs.uniform(
            -1, 1, (2, cfg.policy.horizon, cfg.policy.action_dim)
        ).astype(np.float32), device=dev),
    }
    with trainer.state.whole():
        loss = policy.loss(batch, torch.Generator(device=dev).manual_seed(0))
        grads = torch.autograd.grad(loss, trainer.state.module_params)
    loss = float(loss.detach())
    if not np.isfinite(loss):
        raise RuntimeError("smoke test produced non-finite loss")
    print(f"[train] smoke test loss: {loss:.4f}")
    del grads

    if cfg.do_train_resume:
        try:
            trainer.load()
            print(f"[train] resumed from step {trainer.step}")
        except FileNotFoundError:
            print("[train] no checkpoint found; starting fresh")

    try:
        trainer.train()
    finally:
        if trainer.env_pool is not None:
            trainer.env_pool.close()
    print(f"[train] done at step {trainer.step}")
    return trainer


if __name__ == "__main__":
    main()
