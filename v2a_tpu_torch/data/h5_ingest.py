"""HDF5 random-action dataset ingestion.

A copy of `v2a_tpu/data/h5_ingest.py`. `h5py` is imported inside the
functions that open a file: without it they raise `ImportError` there, and
the module itself imports without it.

Layout written by the offline generator (and by the reference's
`environment/libero/lb_data/lb_randsam.py:86-106`):

    {task_language}/{ep_idx}/agentview_image  (T+1, H, W, 3) uint8
    {task_language}/{ep_idx}/action           (T, 7) float32
    {task_language}/{ep_idx}/ee_poses         (T+1, 3) float32 (optional)

Ingestion semantics mirror
`diffuser/libero/lb_online_trainer_v7.py:718-780`: per-episode action range
check with 0.012 slack against the configured bounds, then clip into range,
then push into the rand replay buffer. Images stay uint8.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from v2a_tpu_torch.data.replay_buffer import ReplayBuffer

RANGE_SLACK = 0.012


class H5IngestError(ValueError):
    pass


def load_episode(h5file, task: str, ep_idx: int) -> Tuple[np.ndarray, np.ndarray]:
    group = h5file[f"{task}/{ep_idx}"]
    imgs = group["agentview_image"][:]
    acts = group["action"][:]
    return imgs, acts


def validate_and_clip_actions(
    acts: np.ndarray, act_min: np.ndarray, act_max: np.ndarray
) -> np.ndarray:
    """Range check with slack then clip (`lb_online_trainer_v7.py:749-752`)."""
    if not (acts > act_min[None] - RANGE_SLACK).all():
        raise H5IngestError(
            f"action below bound: min {acts.min(axis=0)} vs {act_min}"
        )
    if not (acts < act_max[None] + RANGE_SLACK).all():
        raise H5IngestError(
            f"action above bound: max {acts.max(axis=0)} vs {act_max}"
        )
    return np.clip(acts, act_min[None], act_max[None]).astype(np.float32)


def num_episodes_per_task(h5file, task: str) -> int:
    return len(h5file[task]) if task in h5file else 0


def add_episodes_to_buffer(
    h5path: str,
    buffer: ReplayBuffer,
    task_list: Sequence[str],
    start_ep_idx: int,
    end_ep_idx: int,
    act_min: np.ndarray,
    act_max: np.ndarray,
    cam: str = "agentview_image",
    env_idx_per_task: Optional[dict] = None,
    count_env_steps: bool = True,
) -> int:
    """Load episodes [start, end) for each task into `buffer`.

    Returns the number of environment steps represented by the newly added
    episodes (the reference increments `num_steps_in_env` this way until the
    file has been fully visited once, `lb_online_trainer_v7.py:768-770`).
    """
    import h5py

    env_steps = 0
    with h5py.File(h5path, "r") as f:
        for task in task_list:
            n_avail = num_episodes_per_task(f, task)
            for ep_idx in range(start_ep_idx, end_ep_idx):
                if ep_idx >= n_avail:
                    break
                imgs, acts = load_episode(f, task, ep_idx)
                acts = validate_and_clip_actions(acts, act_min, act_max)
                env_idx = (env_idx_per_task or {}).get(task, 0)
                buffer.add_episode(
                    task=task, cam=cam, env_idx=env_idx,
                    imgs=imgs.astype(np.uint8), acts=acts,
                )
                if count_env_steps:
                    env_steps += len(acts)
    return env_steps


def write_randsam_file(
    h5path: str,
    episodes: dict,
    read_only: bool = True,
):
    """Write the random-action dataset file; `episodes` maps
    task -> list of (imgs uint8 (T+1,H,W,3), acts (T,7), ee_poses or None).
    Mirrors the writer at `environment/libero/lb_data/lb_randsam.py:86-109`.
    """
    import h5py
    import os

    if os.path.exists(h5path):
        # a previous run may have chmodded the file read-only
        os.chmod(h5path, 0o644)
    with h5py.File(h5path, "w") as f:
        for task, eps in episodes.items():
            for ep_idx, item in enumerate(eps):
                imgs, acts = item[0], item[1]
                ee = item[2] if len(item) > 2 else None
                g = f.create_group(f"{task}/{ep_idx}")
                g.create_dataset(
                    "agentview_image", data=imgs, compression="gzip",
                    compression_opts=2,
                )
                g.create_dataset("action", data=acts)
                if ee is not None:
                    g.create_dataset("ee_poses", data=ee)
    if read_only:
        os.chmod(h5path, 0o444)
