"""Subprocess environment workers for parallel exploration.

A copy of `v2a_tpu/envs/subproc.py`. The reference steps ONE MuJoCo env at
a time in-process because multiple EGL render contexts corrupt each other
(`environment/libero/lb_env_v3.py:355-357`); its exploration is therefore
serial: 8 tasks x (~280 sim steps + ~35 policy calls) per cycle, policy
batch 1 (`lb_online_trainer_v7.py:859-938`). Here each worker PROCESS owns
its own env backend (its own EGL context), so N rollouts step concurrently
while the coordinator batches all N policy predictions into single card
calls.

Protocol: the parent sends (method, args, kwargs) tuples over a pipe; the
worker applies them to its private EnvList and replies (ok, payload).
`step_k` amortizes the pipe round trip: the worker executes a whole action
chunk and returns every rendered frame plus the grasp-heuristic
observables.

Workers start by `spawn`, never `fork`: the parent holds a CUDA context,
which a forked child would inherit. This module and the env registry the
worker imports use numpy only, never torch, so a worker starts fast and
never touches the card. `spawn` would also re-run the parent's main module
in each worker (as `__mp_main__`), and the entry points import torch at
their top level: a worker is therefore spawned with the main module hidden
(`_bare_main`), and needs nothing of it.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import pickle
import sys
import threading
import types
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _worker_main(conn, env_factory_name: str, factory_kwargs: dict):
    from v2a_tpu_torch.envs.registration import make_env_list

    envs = make_env_list(env_factory_name, **factory_kwargs)
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        method, args, kwargs = msg
        try:
            if method == "step_k":
                payload = _step_k(envs, *args, **kwargs)
            elif method == "task_list":
                payload = envs.task_list
            elif method.startswith("attr:"):
                payload = getattr(envs, method[len("attr:"):])
            else:
                payload = getattr(envs, method)(*args, **kwargs)
            # lifecycle methods may return live env objects (e.g. LIBERO's
            # init_1_given_env returns the OffScreenRenderEnv, whose
            # MuJoCo/EGL handles cannot cross a pipe) — verify picklability
            # up front and ship None instead
            try:
                pickle.dumps(payload)
            except Exception:
                payload = None
            conn.send((True, payload))
        except Exception as e:  # surface worker errors to the parent
            conn.send((False, f"{type(e).__name__}: {e}"))
    conn.close()


def _step_k(envs, task, env_idx, actions, cam, grasp_cam=None,
            done_mode="any"):
    """Execute a chunk of actions, rendering after each step; optionally
    return the depth render + EE position for the grasp heuristic.

    `done_mode`: 'any' latches done across the chunk (the eval harness
    checks success after EVERY step, `lb_eval_helper.py:317-326`); 'last'
    reports only the final step's done (the explore executor reads done
    once per chunk, `lb_online_trainer_v7.py:1100-1111`)."""
    imgs = []
    done = False
    last_done = False
    for a in np.asarray(actions, np.float32):
        _, _, e_done, _ = envs.step_an_env(task, env_idx, a)
        imgs.append(envs.render_an_env(task, cam, env_idx))
        last_done = bool(e_done)
        done = last_done or done
    out: Dict[str, Any] = {
        "imgs": np.stack(imgs),
        "done": last_done if done_mode == "last" else done,
    }
    if grasp_cam is not None:
        _, depth = envs.render_an_env_with_depth(task, grasp_cam, env_idx)
        out["depth"] = np.asarray(depth)
        out["ee_pos"] = np.asarray(
            envs.get_an_env_obs(task, env_idx)["robot0_eef_pos"]
        )
    return out


# one swap of `__main__` at a time: two threads spawning at once would
# otherwise restore each other's stand-in
_MAIN_SWAP = threading.Lock()


@contextlib.contextmanager
def _bare_main():
    """Stand an empty module in for `__main__` while a worker is spawned.
    `spawn` records the main module's name or path for the child to re-run;
    an empty one gives it none, so the child imports only what unpickling
    `_worker_main` and the registry pull in."""
    with _MAIN_SWAP:
        main = sys.modules["__main__"]
        sys.modules["__main__"] = types.ModuleType("__main__")
        try:
            yield
        finally:
            sys.modules["__main__"] = main


class WorkerDied(RuntimeError):
    """The worker PROCESS is gone (EOF on the pipe) — distinct from an
    application error raised inside a live worker."""


# state-mutating env methods journaled for crash recovery
_JOURNALED = {"step_an_env", "step_k", "step_zero_act_1_env"}


class EnvWorker:
    """One env backend in one child process.

    Failure recovery: every state-mutating call since the last
    `init_1_given_env` is journaled (the init itself is rewritten to pin the
    worker's ACTUAL seed, so replays land in the same randomized scene).
    `respawn_and_replay()` restarts a dead process and replays the journal,
    reconstructing the deterministic env state — the pool uses it to retry
    in-flight chunks transparently. The reference's env-exception handling
    is a stub that always returns False (`lb_online_trainer_v7.py:981-991`);
    a worker death there kills the run.
    """

    def __init__(self, env_name: str, **factory_kwargs):
        self._env_name = env_name
        self._factory_kwargs = factory_kwargs
        self._journal: List[Tuple[str, tuple, dict]] = []
        self._last_sent: Optional[Tuple[str, tuple, dict]] = None
        self._spawn()

    def _spawn(self):
        ctx = mp.get_context("spawn")
        self._parent, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_worker_main,
            args=(child, self._env_name, self._factory_kwargs),
            daemon=True,
        )
        with _bare_main():
            self._proc.start()
        child.close()
        self._pending = False

    @property
    def alive(self) -> bool:
        return self._proc.is_alive()

    def respawn(self):
        self.close()
        self._spawn()

    def respawn_and_replay(self):
        """Restart the process and rebuild env state by replaying the
        journal (seed-pinned init + every mutating call since)."""
        journal = list(self._journal)
        self.respawn()
        self._journal = []
        for method, args, kwargs in journal:
            self.call(method, *args, **kwargs)

    # -- async request/response -------------------------------------------

    def call_async(self, method: str, *args, **kwargs):
        if self._pending:
            raise RuntimeError("worker already has a pending call")
        self._parent.send((method, args, kwargs))
        self._pending = True
        self._last_sent = (method, args, kwargs)

    def _raw_call(self, method: str, *args, **kwargs):
        """Pipe round trip without journaling (internal queries)."""
        self._parent.send((method, args, kwargs))
        ok, payload = self._parent.recv()
        if not ok:
            raise RuntimeError(f"env worker failed: {payload}")
        return payload

    def result(self):
        try:
            ok, payload = self._parent.recv()
        except (EOFError, OSError):
            self._pending = False
            raise WorkerDied("env worker process died (EOF on pipe)")
        self._pending = False
        if not ok:
            raise RuntimeError(f"env worker failed: {payload}")
        # journal maintenance on success
        if self._last_sent is not None:
            method, args, kwargs = self._last_sent
            if method == "init_1_given_env":
                task, env_idx = args[0], args[1]
                seeds = self._raw_call("attr:actual_env_seeds")
                self._journal = [(
                    "init_1_given_env", (task, env_idx),
                    {"e_seed": int(seeds[(task, env_idx)])},
                )]
            elif method == "close_1_given_env":
                self._journal = []
            elif method in _JOURNALED:
                self._journal.append((method, args, kwargs))
        return payload

    def call(self, method: str, *args, **kwargs):
        self.call_async(method, *args, **kwargs)
        return self.result()

    def close(self):
        try:
            self._parent.send(None)
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(timeout=10)
        if self._proc.is_alive():
            self._proc.terminate()
        self._parent.close()


class EnvWorkerPool:
    """N workers, broadcast/gather helpers; workers run concurrently when
    driven with call_async on all before collecting results."""

    def __init__(self, env_name: str, n_workers: int, **factory_kwargs):
        self.workers = [
            EnvWorker(env_name, **factory_kwargs) for _ in range(n_workers)
        ]
        self.task_list: List[str] = self.workers[0].call("task_list")

    def __len__(self):
        return len(self.workers)

    def map(
        self,
        calls: Sequence[Tuple[int, str, tuple, dict]],
        max_respawns: int = 1,
    ):
        """Send (worker_idx, method, args, kwargs) concurrently; returns
        results ordered like `calls`. A worker that DIES mid-call is
        auto-respawned, its env state replayed from the journal, and the
        in-flight call retried (`max_respawns` times per call) — exploration
        survives env-process crashes instead of dying with them."""
        for w_idx, method, args, kwargs in calls:
            self.workers[w_idx].call_async(method, *args, **kwargs)
        results = []
        for w_idx, method, args, kwargs in calls:
            worker = self.workers[w_idx]
            attempts = 0
            while True:
                try:
                    results.append(worker.result())
                    break
                except WorkerDied:
                    if attempts >= max_respawns:
                        raise
                    attempts += 1
                    worker.respawn_and_replay()
                    worker.call_async(method, *args, **kwargs)
        return results

    def close(self):
        for w in self.workers:
            w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
