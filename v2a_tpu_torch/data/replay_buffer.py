"""Replay buffers for online goal-conditioned training (host side).

Counterpart of `v2a_tpu/data/replay_buffer.py`. One difference: both
backends draw a batch's (episode, start) pairs the native store's way, from
one seed taken from the caller's generator (`native_store.hindsight_draws`),
so the Python backend returns the batch the native store returns (and the
batch the JAX package's native backend returns) for the same episodes and
generator. The JAX package's Python backend draws them one by one from the
generator instead: the same distribution, another stream.

Re-design of `Global_EnvReplayBuffer_Img` / `EnvImg_UnitBuffer`
(`diffuser/datasets/env_img_replay_buffer.py:10-302`). The reference keeps
deques of per-step CHW float tensors and stacks them per sample; here each
episode is ONE contiguous uint8 array:

- images stay uint8 HWC until they reach the accelerator (4x less
  host->device bandwidth than fp32; the [0,1] scaling runs on device),
- hindsight (start, goal, action-window) sampling is vectorized numpy
  slicing over a preallocated batch, no per-element torch stacking,
- episode-level FIFO eviction and the same sampling distribution: uniform
  episode choice with replacement, uniform start index in
  [0, len - horizon - 1], goal = start + horizon
  (`env_img_replay_buffer.py:84,278-302`).

Randomness is an explicit `numpy.random.Generator`, mirroring the repo-wide
explicit-RNG discipline.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from v2a_tpu_torch.data.native_store import hindsight_draws


@dataclasses.dataclass
class EpisodeBuffer:
    """One executed episode: (T+1) images and T actions, plus identity.

    `imgs` is (T+1, H, W, 3) uint8; `acts` is (T, action_dim) float32.
    Mirrors `EnvImg_UnitBuffer` (`env_img_replay_buffer.py:219-302`) with
    the same `max_len` truncation (keep the most recent `max_len` frames)
    and continuity validation on appends.
    """

    task: str
    cam: str
    env_idx: int
    imgs: np.ndarray
    acts: np.ndarray
    max_len: int = 700
    is_success: bool = False

    def __post_init__(self):
        self._validate_pair(self.imgs, self.acts)
        self._truncate()

    @staticmethod
    def _validate_pair(imgs: np.ndarray, acts: np.ndarray):
        if imgs.dtype != np.uint8:
            raise TypeError(f"imgs must be uint8 HWC, got {imgs.dtype}")
        if imgs.ndim != 4 or imgs.shape[-1] != 3:
            raise ValueError(f"imgs must be (T+1,H,W,3), got {imgs.shape}")
        if len(imgs) != len(acts) + 1:
            raise ValueError(
                f"need len(imgs) == len(acts)+1, got {len(imgs)} vs {len(acts)}"
            )

    def _truncate(self):
        if len(self.imgs) > self.max_len:
            self.imgs = self.imgs[-self.max_len:]
            self.acts = self.acts[-(self.max_len - 1):]

    def append_seq(self, new_imgs: np.ndarray, new_acts: np.ndarray, atol: float = 1e-3):
        """Extend with a continuation whose first image must equal our last
        stored image (`env_img_replay_buffer.py:250-276`)."""
        self._validate_pair(new_imgs, new_acts)
        diff = np.abs(
            self.imgs[-1].astype(np.int16) - new_imgs[0].astype(np.int16)
        )
        n_diff = int((diff > atol * 255).sum())
        if n_diff > 0:
            raise ValueError(
                f"episode continuity violated: {n_diff} pixels differ between "
                "stored last frame and incoming first frame"
            )
        self.imgs = np.concatenate([self.imgs, new_imgs[1:]], axis=0)
        self.acts = np.concatenate([self.acts, new_acts], axis=0)
        self._truncate()

    def __len__(self) -> int:
        return len(self.imgs)


class ReplayBuffer:
    """Episode-level FIFO buffer with vectorized hindsight batch sampling.

    `backend`:
      - 'python': episodes as numpy arrays in `EpisodeBuffer` objects;
      - 'native': pixel/action payloads in the C++ slab store
        (`v2a_tpu_torch/native/replay_store.cpp`) with parallel-memcpy batch
        assembly; Python keeps only per-episode metadata;
      - 'auto' (default): native, built at first use; a failed build raises.
    Both backends return the same batch for the same episodes and generator.
    """

    def __init__(
        self,
        max_episodes: int,
        max_len: int = 700,
        min_len: int = 30,
        sample_act_seq_len: int = 16,
        backend: str = "auto",
    ):
        if max_episodes > 1e4:
            raise ValueError("max_episodes cap exceeded")
        self.episodes: Deque[EpisodeBuffer] = deque(maxlen=max_episodes)
        self.max_episodes = max_episodes
        self.max_len = max_len
        self.min_len = min_len
        self.sample_act_seq_len = sample_act_seq_len
        # total episodes ever added, incl. evicted — used by the exploration
        # throttle (`env_img_replay_buffer.py:39-41`)
        self.cnt_all_history_episodes = 0

        if backend == "auto":
            backend = "native"
        if backend not in ("native", "python"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._store = None  # lazy: created on first episode (needs shapes)
        # per-slot metadata mirrors the native ring: slot -> meta
        self._meta: List[Optional[dict]] = []

    def _ensure_store(self, imgs: np.ndarray, acts: np.ndarray):
        if self._store is not None or self.backend != "native":
            return
        from v2a_tpu_torch.data.native_store import NativeEpisodeStore

        self._store = NativeEpisodeStore(
            self.max_episodes, self.max_len,
            (imgs.shape[1], imgs.shape[2]), acts.shape[-1],
            channels=imgs.shape[3],
        )
        self._meta = [None] * self.max_episodes

    def __len__(self) -> int:
        if self.backend == "native" and self._store is not None:
            return len(self._store)
        return len(self.episodes)

    def add_episode(
        self,
        task: str,
        cam: str,
        env_idx: int,
        imgs: np.ndarray,
        acts: np.ndarray,
        is_success: bool = False,
    ) -> Optional[EpisodeBuffer]:
        imgs = np.ascontiguousarray(imgs)
        acts = np.asarray(acts, np.float32)
        EpisodeBuffer._validate_pair(imgs, acts)
        if min(len(imgs), self.max_len) < self.min_len:
            raise ValueError(
                f"episode too short: {len(imgs)} < min_len {self.min_len}"
            )
        self._ensure_store(imgs, acts)
        if self.backend == "native" and self._store is not None:
            slot = self._store.add_episode(imgs.astype(np.uint8), acts)
            self._meta[slot] = dict(
                task=task, cam=cam, env_idx=env_idx, is_success=is_success
            )
            self.cnt_all_history_episodes += 1
            return None
        ep = EpisodeBuffer(
            task=task, cam=cam, env_idx=env_idx,
            imgs=imgs, acts=acts,
            max_len=self.max_len, is_success=is_success,
        )
        self.episodes.append(ep)
        self.cnt_all_history_episodes += 1
        return ep

    def sample_batch(
        self,
        batch_size: int,
        rng: np.random.Generator,
        horizon: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Uniform-with-replacement episode sampling + uniform start index,
        drawn from one seed taken from `rng` (both backends); returns a dict
        of stacked host arrays:

            img_obs  (B, H, W, 3) uint8   start frames
            img_goal (B, H, W, 3) uint8   frames `horizon` steps later
            action   (B, horizon, Da) float32
            task     list[str], cam list[str], env_idx (B,) int32
        """
        horizon = horizon or self.sample_act_seq_len
        if self.backend == "native" and self._store is not None:
            seed = int(rng.integers(0, 2**63 - 1))
            obs, goal, acts, slots = self._store.sample_batch(
                batch_size, horizon, seed
            )
            metas = [self._meta[s] for s in slots]
            return {
                "img_obs": obs,
                "img_goal": goal,
                "action": acts,
                "task": [m["task"] for m in metas],
                "cam": [m["cam"] for m in metas],
                "env_idx": np.asarray(
                    [m["env_idx"] for m in metas], np.int32
                ),
            }
        if not self.episodes:
            raise RuntimeError("sampling from an empty replay buffer")
        seed = int(rng.integers(0, 2**63 - 1))
        lengths = [len(ep) for ep in self.episodes]
        ep_idxs, starts = hindsight_draws(
            seed, batch_size, len(self.episodes), lengths, horizon
        )

        img_shape = self.episodes[0].imgs.shape[1:]
        act_dim = self.episodes[0].acts.shape[-1]
        img_obs = np.empty((batch_size,) + img_shape, np.uint8)
        img_goal = np.empty((batch_size,) + img_shape, np.uint8)
        action = np.empty((batch_size, horizon, act_dim), np.float32)
        tasks: List[str] = []
        cams: List[str] = []
        env_idxs = np.empty((batch_size,), np.int32)

        for i, (e, start) in enumerate(zip(ep_idxs, starts)):
            ep = self.episodes[e]
            goal = start + horizon
            img_obs[i] = ep.imgs[start]
            img_goal[i] = ep.imgs[goal]
            action[i] = ep.acts[start:goal]
            tasks.append(ep.task)
            cams.append(ep.cam)
            env_idxs[i] = ep.env_idx

        return {
            "img_obs": img_obs,
            "img_goal": img_goal,
            "action": action,
            "task": tasks,
            "cam": cams,
            "env_idx": env_idxs,
        }

    # -- checkpointing (beyond the reference: its resume restarts buffer
    # filling, `lb_online_trainer_v7.py:367-407` never saves buffers) ------

    def _native_slot(self, live_idx: int) -> int:
        if len(self._store) == self.max_episodes:
            next_slot = self._store.total_added % self.max_episodes
            return (next_slot + live_idx) % self.max_episodes
        return live_idx

    def export_episodes(self) -> List[dict]:
        """All live episodes oldest-first as plain dicts."""
        out: List[dict] = []
        if self.backend == "native" and self._store is not None:
            for i in range(len(self._store)):
                imgs, acts = self._store.get_episode(i)
                meta = self._meta[self._native_slot(i)]
                out.append(dict(imgs=imgs, acts=acts, **meta))
        else:
            for ep in self.episodes:
                out.append(dict(
                    imgs=ep.imgs, acts=ep.acts, task=ep.task, cam=ep.cam,
                    env_idx=ep.env_idx, is_success=ep.is_success,
                ))
        return out

    def save(self, path: str):
        """Persist every live episode + metadata to one compressed npz."""
        import json

        eps = self.export_episodes()
        arrays = {}
        meta = []
        for i, ep in enumerate(eps):
            arrays[f"imgs_{i}"] = ep["imgs"]
            arrays[f"acts_{i}"] = ep["acts"]
            meta.append({
                "task": ep["task"], "cam": ep["cam"],
                "env_idx": int(ep["env_idx"]),
                "is_success": bool(ep["is_success"]),
            })
        arrays["meta_json"] = np.frombuffer(
            json.dumps(
                {"episodes": meta,
                 "cnt_all_history_episodes": self.cnt_all_history_episodes}
            ).encode(),
            np.uint8,
        )
        np.savez_compressed(path, **arrays)

    def load(self, path: str):
        """Restore episodes saved by `save` (appended in saved order)."""
        import json

        with np.load(path) as data:
            meta = json.loads(bytes(data["meta_json"]).decode())
            for i, m in enumerate(meta["episodes"]):
                self.add_episode(
                    m["task"], m["cam"], m["env_idx"],
                    data[f"imgs_{i}"], data[f"acts_{i}"],
                    is_success=m["is_success"],
                )
            self.cnt_all_history_episodes = meta["cnt_all_history_episodes"]

    def episode_lengths(self) -> np.ndarray:
        if self.backend == "native" and self._store is not None:
            return np.asarray(
                [self._store.episode_len(i) for i in range(len(self._store))],
                np.int32,
            )
        return np.asarray([len(ep) for ep in self.episodes], np.int32)


def merge_batches(
    batches: Sequence[Dict[str, np.ndarray]]
) -> Dict[str, np.ndarray]:
    """Concatenate sampled batches from multiple buffers (the rand/vid mixed
    sampling of `diffuser/models/train_utils.py:137-171`)."""
    out: Dict[str, np.ndarray] = {}
    for key in batches[0]:
        vals = [b[key] for b in batches]
        if isinstance(vals[0], list):
            out[key] = sum(vals, [])
        else:
            out[key] = np.concatenate(vals, axis=0)
    return out
