"""Offline-dataset environment base (d4rl-style).

Counterpart of `environment/offline_env.py:47-199` (`OfflineEnv` +
`PybulletEnv`): resolve a dataset file path (local override or a per-name
data directory), load it as the standard episode HDF5, and run sanity
checks. The gym-space boilerplate of `PybulletEnv` collapses into plain
attributes — the framework's `EnvList` contract does not need gym.

A copy of `v2a_tpu/envs/offline.py`; it downloads nothing, and `h5py` is
imported where the file is read.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

DATA_DIR = os.path.expanduser(
    os.environ.get("V2A_DATASET_DIR", "~/.v2a_tpu/datasets")
)


def filepath_from_name(dataset_name: str) -> str:
    """`offline_env.py`'s URL→local-path convention minus the download (the
    deployment ships datasets; zero-egress environments cannot fetch)."""
    return os.path.join(DATA_DIR, f"{dataset_name}.hdf5")


class OfflineDataset:
    """Episode-HDF5 access with the sanity checks of
    `offline_env.py:81-126` (shape agreement, dtype, non-empty)."""

    def __init__(
        self,
        dataset_name: Optional[str] = None,
        h5path: Optional[str] = None,
    ):
        if h5path is None:
            if dataset_name is None:
                raise ValueError("need dataset_name or h5path")
            h5path = filepath_from_name(dataset_name)
        if not os.path.exists(h5path):
            raise FileNotFoundError(
                f"dataset not found at {h5path}; place the file there or "
                "pass h5path explicitly (no auto-download in zero-egress "
                "deployments)"
            )
        self.h5path = h5path

    def get_dataset(
        self, tasks: Optional[Sequence[str]] = None
    ) -> Dict[str, Dict[str, List[np.ndarray]]]:
        """Load {task: {'observations': [...], 'actions': [...]}} with
        validation."""
        import h5py

        out: Dict[str, Dict[str, List[np.ndarray]]] = {}
        with h5py.File(self.h5path, "r") as f:
            for task in tasks or list(f.keys()):
                if task not in f:
                    raise KeyError(f"task {task!r} not in {self.h5path}")
                obs_list, act_list = [], []
                for ep in f[task]:
                    g = f[task][ep]
                    imgs = g["agentview_image"][:]
                    acts = g["action"][:]
                    if imgs.dtype != np.uint8:
                        raise TypeError("images must be uint8")
                    if len(imgs) != len(acts) + 1:
                        raise ValueError(
                            f"{task}/{ep}: {len(imgs)} imgs vs {len(acts)} acts"
                        )
                    obs_list.append(imgs)
                    act_list.append(acts.astype(np.float32))
                if not obs_list:
                    raise ValueError(f"task {task!r} has no episodes")
                out[task] = {"observations": obs_list, "actions": act_list}
        return out
