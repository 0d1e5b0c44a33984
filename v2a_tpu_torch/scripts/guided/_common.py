"""Shared plumbing for the guided-diffusion CLIs.

Counterpart of `scripts/guided/_common.py` (the glue the reference CLIs
pull from `dist_util` / `script_util`, `guided_diffusion/scripts/*.py`):
the train defaults, parameter init or restore, and npz sample writing. The
CLIs are modules of the package (`python -m
v2a_tpu_torch.scripts.guided.<name>`); each adds `--device` to the JAX
CLI's flags (`cuda` unless `--device cpu`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

from v2a_tpu_torch.device import resolve_device
from v2a_tpu_torch.guided.script_util import parser_from_defaults
from v2a_tpu_torch.models.init import init_params

TRAIN_DEFAULTS = dict(
    data_dir="",
    schedule_sampler="uniform",
    lr=1e-4,
    weight_decay=0.0,
    lr_anneal_steps=0,
    batch_size=1,
    microbatch=-1,
    ema_rate="0.9999",
    log_interval=10,
    save_interval=10_000,
    resume_checkpoint="",
    use_fp16=False,
    out_dir="guided_out",
    max_steps=0,  # 0 = run to lr_anneal_steps (reference runs unbounded)
    seed=0,
)


def parse(argv, *default_dicts: dict) -> argparse.Namespace:
    """The JAX CLI's flags (`parser_from_defaults`) plus `--device`; the
    device resolved (a missing card raises)."""
    parser = parser_from_defaults(*default_dicts)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def init_or_restore(model: nn.Module, resume_checkpoint: str, seed: int = 0) -> nn.Module:
    """Draw the parameters from `seed` (the JAX CLIs init from
    `PRNGKey(0)`), or load a `GuidedTrainLoop.save` snapshot strictly."""
    if resume_checkpoint:
        return load_params(model, resume_checkpoint)
    device = next(model.parameters()).device
    return init_params(model, torch.Generator(device=device).manual_seed(seed))


def load_params(model: nn.Module, path: str) -> nn.Module:
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device, weights_only=True), strict=True)
    return model


def frozen(model: nn.Module) -> nn.Module:
    """A net for sampling: eval mode, no parameter gradients."""
    return model.eval().requires_grad_(False)


def save_samples_npz(out_dir: str, images: np.ndarray, labels=None) -> str:
    """uint8 NHWC npz batch, the evaluator-CLI input format
    (`scripts/image_sample.py:69-88`, consumed by
    `scripts/evaluate_samples.py`)."""
    os.makedirs(out_dir, exist_ok=True)
    arr = np.clip((images + 1.0) * 127.5, 0, 255).astype(np.uint8)
    shape_str = "x".join(str(s) for s in arr.shape)
    path = os.path.join(out_dir, f"samples_{shape_str}.npz")
    if labels is not None:
        np.savez(path, arr, np.asarray(labels))
    else:
        np.savez(path, arr)
    print(f"saved {path}", flush=True)
    return path


def run_train_loop(loop, max_steps: int):
    steps = max_steps or None
    loop.run_loop(steps)
    return loop
