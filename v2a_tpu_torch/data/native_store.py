"""ctypes binding for the port's native episode store
(`v2a_tpu_torch/native/replay_store.cpp`).

Counterpart of `v2a_tpu/data/native_store.py`. `NativeEpisodeStore` keeps
every episode in one preallocated C++ slab and assembles hindsight batches
with parallel memcpy: the backend behind `ReplayBuffer(backend='native')`.
The library is built from the port's own source with g++ into
`v2a_tpu_torch/_build/` at first use (`ops/_build.py::load_host`); a failed
build raises with the compiler's message.

`hindsight_draws` computes in numpy the (episode, start) draws the store
makes from a seed, so the Python backend samples the same batch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

_lib = None
_lib_lock = threading.Lock()


def _declare(lib):
    lib.v2a_store_create.restype = ctypes.c_void_p
    lib.v2a_store_create.argtypes = [ctypes.c_int64] * 6
    lib.v2a_store_destroy.argtypes = [ctypes.c_void_p]
    lib.v2a_store_len.restype = ctypes.c_int64
    lib.v2a_store_len.argtypes = [ctypes.c_void_p]
    lib.v2a_store_total_added.restype = ctypes.c_int64
    lib.v2a_store_total_added.argtypes = [ctypes.c_void_p]
    lib.v2a_store_add_episode.restype = ctypes.c_int64
    lib.v2a_store_add_episode.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.v2a_store_sample_batch.restype = ctypes.c_int32
    lib.v2a_store_sample_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.v2a_store_episode_len.restype = ctypes.c_int64
    lib.v2a_store_episode_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.v2a_store_get_episode.restype = ctypes.c_int32
    lib.v2a_store_get_episode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def load_lib():
    """The store's library, built from the port's source on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from v2a_tpu_torch.ops import _build

            _lib = _declare(_build.load_host("replay_store"))
        return _lib


_MASK = np.uint64(2**64 - 1)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """`splitmix64` of the C++ store on uint64 arrays (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _bounded(r: np.ndarray, n) -> np.ndarray:
    """The store's `bounded`: (r * n) >> 64 for n < 2^32, without 128-bit
    integers: (r_hi * n + (r_lo * n >> 32)) >> 32, which cannot overflow."""
    n = np.asarray(n, np.uint64)
    lo = (r & np.uint64(0xFFFFFFFF)) * n
    hi = (r >> np.uint64(32)) * n
    return ((hi + (lo >> np.uint64(32))) >> np.uint64(32)).astype(np.int64)


def hindsight_draws(seed: int, batch: int, n_live: int, lengths: np.ndarray,
                    horizon: int) -> Tuple[np.ndarray, np.ndarray]:
    """(live episode index, start frame) per batch row, as
    `v2a_store_sample_batch` draws them from `seed`: row i's episode from
    splitmix64(seed ^ 2i), its start in [0, len - horizon - 1] from
    splitmix64(seed ^ (2i + 1)). `lengths[j]` is live episode j's frame
    count; an episode no longer than `horizon` raises, as in the store."""
    with np.errstate(over="ignore"):
        s = np.uint64(seed & (2**64 - 1))
        i = np.arange(batch, dtype=np.uint64)
        r1 = _splitmix64(s ^ (np.uint64(2) * i))
        r2 = _splitmix64(s ^ (np.uint64(2) * i + np.uint64(1)))
        live = _bounded(r1, n_live)
        n = np.asarray(lengths, np.int64)[live]
        if (n <= horizon).any():
            raise ValueError("an episode shorter than horizon+1 was drawn")
        start = _bounded(r2, (n - horizon).astype(np.uint64))
    return live, start


class NativeEpisodeStore:
    """One (image_shape, act_dim) store; thread-safe via a Python lock."""

    def __init__(
        self,
        max_episodes: int,
        max_len: int,
        img_hw: Tuple[int, int],
        act_dim: int,
        channels: int = 3,
        n_threads: int = 4,
    ):
        lib = load_lib()
        self._lib = lib
        self.h, self.w, self.c = img_hw[0], img_hw[1], channels
        self.act_dim = act_dim
        self.max_len = max_len
        self.n_threads = n_threads
        self._lock = threading.Lock()
        self._ptr = lib.v2a_store_create(
            max_episodes, max_len, self.h, self.w, self.c, act_dim
        )
        if not self._ptr:
            raise MemoryError("v2a_store_create failed")

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.v2a_store_destroy(ptr)
            self._ptr = None

    def __len__(self) -> int:
        return int(self._lib.v2a_store_len(self._ptr))

    @property
    def total_added(self) -> int:
        return int(self._lib.v2a_store_total_added(self._ptr))

    def add_episode(self, imgs: np.ndarray, acts: np.ndarray) -> int:
        imgs = np.ascontiguousarray(imgs, np.uint8)
        acts = np.ascontiguousarray(acts, np.float32)
        if imgs.shape[1:] != (self.h, self.w, self.c):
            raise ValueError(f"image shape {imgs.shape} != store shape")
        if acts.shape != (len(imgs) - 1, self.act_dim):
            raise ValueError("need (T, act_dim) actions for T+1 images")
        with self._lock:
            slot = self._lib.v2a_store_add_episode(
                self._ptr,
                imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                acts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(imgs),
            )
        if slot < 0:
            raise ValueError("add_episode rejected (need >= 2 images)")
        return int(slot)

    def sample_batch(self, batch: int, horizon: int, seed: int):
        """Returns (img_obs u8 (B,H,W,3), img_goal u8, action f32
        (B,horizon,Da), ep_slots i64 (B,))."""
        obs = np.empty((batch, self.h, self.w, self.c), np.uint8)
        goal = np.empty_like(obs)
        acts = np.empty((batch, horizon, self.act_dim), np.float32)
        slots = np.empty((batch,), np.int64)
        with self._lock:
            rc = self._lib.v2a_store_sample_batch(
                self._ptr, batch, horizon, ctypes.c_uint64(seed & (2**64 - 1)),
                obs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                goal.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                acts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self.n_threads,
            )
        if rc == -2:
            raise RuntimeError("sampling from an empty store")
        if rc == -3:
            raise ValueError("an episode shorter than horizon+1 was drawn")
        if rc != 0:
            raise RuntimeError(f"native sample_batch failed (rc={rc})")
        return obs, goal, acts, slots

    def episode_len(self, live_idx: int) -> int:
        return int(self._lib.v2a_store_episode_len(self._ptr, live_idx))

    def get_episode(self, live_idx: int):
        """Copy one episode out: (imgs uint8 (T+1,H,W,C), acts f32 (T,Da))."""
        n = self.episode_len(live_idx)
        if n < 0:
            raise IndexError(f"live index {live_idx} out of range")
        imgs = np.empty((n, self.h, self.w, self.c), np.uint8)
        acts = np.empty((n - 1, self.act_dim), np.float32)
        with self._lock:
            rc = self._lib.v2a_store_get_episode(
                self._ptr, live_idx,
                imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                acts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        if rc != 0:
            raise RuntimeError(f"get_episode failed (rc={rc})")
        return imgs, acts
