"""Checkpoints with `torch.save`: one directory per label.

Counterpart of `v2a_tpu/train/checkpoint.py:31-100` (Orbax there): the same
`model-{label}` names, `meta-{label}.json` beside them, the same label rule
(the trainer's `step // label_freq * label_freq`) and `n_saves` retention.
A checkpoint holds the train state as `TrainState.state_dict` gives it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

CKPT_PREFIX = "model-"
VERSION = 1


def _ckpt_dir(workdir: str, label: int) -> str:
    return os.path.join(os.path.abspath(workdir), f"{CKPT_PREFIX}{label}")


def available_labels(workdir: str) -> List[int]:
    if not os.path.isdir(workdir):
        return []
    labels = []
    for name in os.listdir(workdir):
        m = re.fullmatch(rf"{CKPT_PREFIX}(\d+)", name)
        if m:
            labels.append(int(m.group(1)))
    return sorted(labels)


def latest_label(workdir: str) -> Optional[int]:
    """`get_latest_epoch` counterpart (`diffuser/utils/serialization.py:25-34`)."""
    labels = available_labels(workdir)
    return labels[-1] if labels else None


def save_checkpoint(workdir: str, label: int, state: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None, n_saves: int = 5) -> None:
    """Saves the state dict and host-side counters; keeps the newest
    `n_saves` labels (`config/libero/lb_tk8_65to72.py:155-158`). A label
    saved again is overwritten (milestone bucketing rewrites a bucket)."""
    path = _ckpt_dir(workdir, label)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(state, os.path.join(path, "state.pt"))
    meta = {"version": VERSION, "label": int(label)}
    meta.update(extra or {})
    with open(os.path.join(workdir, f"meta-{label}.json"), "w") as f:
        json.dump(meta, f, indent=1)
    for old in available_labels(workdir)[:-n_saves]:
        shutil.rmtree(_ckpt_dir(workdir, old), ignore_errors=True)
        meta_path = os.path.join(workdir, f"meta-{old}.json")
        if os.path.exists(meta_path):
            os.remove(meta_path)


def restore_checkpoint(workdir: str, label: Optional[int] = None, map_location=None):
    """(state dict, extra) of `label`, the latest when None."""
    if label is None:
        label = latest_label(workdir)
        if label is None:
            raise FileNotFoundError(f"no checkpoints under {workdir}")
    state = torch.load(os.path.join(_ckpt_dir(workdir, label), "state.pt"),
                       map_location=map_location, weights_only=True)
    meta_path = os.path.join(workdir, f"meta-{label}.json")
    extra: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            extra = json.load(f)
    return state, extra
