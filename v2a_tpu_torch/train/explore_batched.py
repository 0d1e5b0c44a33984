"""Batched video-guided exploration across parallel env workers.

A copy of `v2a_tpu/train/explore_batched.py`. The reference interleaves
ONE env's sim steps with batch-1 policy DDIM calls
(`lb_online_trainer_v7.py:995-1291`); here N rollouts advance in lock-step
rounds —

    round r: ONE batched predict_action over all live envs (batch N, one
    DDIM chain on the card) -> each worker executes its action chunk
    CONCURRENTLY in its own process and reports frames + grasp observables
    -> per-env grasp triggers inject down/close chunks.

Per-env semantics (schedules, gripper forcing, depth-heuristic grasp
trigger, stop-at-success) are identical to `train/explore.py`; each env
draws from its own seeded Generator so results are reproducible regardless
of worker timing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from v2a_tpu_torch.envs.subproc import EnvWorkerPool
from v2a_tpu_torch.train.explore import (
    ExploreConfig,
    RolloutResult,
    _grasp_window_mean_depth,
    LB_GRASP_ACTDOWN_RANGE,
)

BatchPolicyFn = Callable[[np.ndarray, np.ndarray], np.ndarray]
# batch_policy_fn(img_obs01 (N,H,W,3), img_goal01 (N,H,W,3))
#   -> (N, n_acts_per_pred, Da)


@dataclasses.dataclass
class _EnvState:
    task: str
    env_idx: int
    schedule: List[int]  # goal-frame index per prediction round
    rng: np.random.Generator
    imgs: List[np.ndarray]
    acts: List[np.ndarray]
    pred_video: np.ndarray
    round: int = 0
    do_grasp: bool = False
    is_suc: bool = False
    n_env_steps: int = 0
    finished: bool = False

    @property
    def img_st(self) -> np.ndarray:
        return self.imgs[-1]


class BatchedGuidedRolloutExecutor:
    def __init__(
        self,
        pool: EnvWorkerPool,
        batch_policy_fn: BatchPolicyFn,
        config: ExploreConfig,
        task_to_task_idx: Dict[str, int],
        action_dim: int = 7,
    ):
        self.pool = pool
        self.policy_fn = batch_policy_fn
        self.cfg = config
        self.task_to_task_idx = task_to_task_idx
        self.action_dim = action_dim

    def _sample_act_down_val(self, task: str, rng) -> float:
        cfg = self.cfg
        if cfg.act_down_val is not None:
            if cfg.act_down_val > 0:
                raise ValueError("act_down_val must be <= 0")
            return cfg.act_down_val
        table = cfg.act_down_val_range_per_tk or LB_GRASP_ACTDOWN_RANGE
        lo, hi = table[self.task_to_task_idx[task]]
        return float(rng.uniform(lo, hi))

    def execute_all(
        self,
        assignments: Sequence[Tuple[str, int]],  # (task, env_idx) per worker
        cam: str,
        start_imgs: Sequence[np.ndarray],
        pred_videos: Sequence[np.ndarray],
        seeds: Sequence[int],
    ) -> List[RolloutResult]:
        """Run one guided rollout per worker; envs must already be
        initialized and rendered (start_imgs). Returns per-env results in
        assignment order."""
        cfg = self.cfg
        n = len(assignments)
        if not (len(start_imgs) == len(pred_videos) == len(seeds) == n):
            raise ValueError("assignment length mismatch")
        if n != len(self.pool):
            raise ValueError("need exactly one assignment per worker")

        states: List[_EnvState] = []
        for (task, env_idx), img0, video, seed in zip(
            assignments, start_imgs, pred_videos, seeds
        ):
            rng = np.random.default_rng(seed)
            schedule: List[int] = []
            for g_idx in range(len(video)):
                n_preds = int(rng.integers(
                    cfg.n_preds_betw_vframes[0],
                    cfg.n_preds_betw_vframes[1] + 1,
                ))
                schedule.extend([g_idx] * n_preds)
            states.append(_EnvState(
                task=task, env_idx=env_idx, schedule=schedule, rng=rng,
                imgs=[np.asarray(img0)], acts=[],
                pred_video=np.asarray(video),
            ))

        max_rounds = max(len(s.schedule) for s in states)
        h, w = states[0].img_st.shape[:2]

        for r in range(max_rounds):
            active = [
                i for i, s in enumerate(states)
                if not s.finished and r < len(s.schedule)
            ]
            if not active:
                break
            # -- ONE batched policy call (static shape: always batch n)
            obs = np.zeros((n, h, w, 3), np.float32)
            goal = np.zeros((n, h, w, 3), np.float32)
            for i in active:
                s = states[i]
                obs[i] = s.img_st.astype(np.float32) / 255.0
                goal[i] = (
                    s.pred_video[s.schedule[r]].astype(np.float32) / 255.0
                )
            acts_all = np.asarray(self.policy_fn(obs, goal)).reshape(
                n, cfg.n_acts_per_pred, self.action_dim
            )

            # -- concurrent env stepping
            calls = []
            for i in active:
                s = states[i]
                acts = np.clip(acts_all[i], cfg.act_min, cfg.act_max)
                if cfg.is_grasp_task:
                    acts[:, -1] = (
                        cfg.close_grp_force if s.do_grasp
                        else -cfg.close_grp_force
                    )
                s.acts.append(acts)
                calls.append((
                    i, "step_k",
                    (s.task, s.env_idx, acts, cam),
                    {"grasp_cam": cfg.grasp_cam if (
                        cfg.is_grasp_task and not s.do_grasp
                    ) else None,
                     # serial executor reads done once per chunk
                     # (`train/explore.py:159-163`)
                     "done_mode": "last"},
                ))
            results = self.pool.map(calls)

            # -- per-env bookkeeping + grasp triggers
            grasp_calls = []
            for (i, *_), out in zip(calls, results):
                s = states[i]
                s.imgs.extend(list(out["imgs"]))
                s.n_env_steps += len(out["imgs"])
                s.is_suc = out["done"] or s.is_suc
                if "depth" in out and not s.do_grasp:
                    d_m = _grasp_window_mean_depth(out["depth"])
                    z = float(out["ee_pos"][2])
                    if abs(z - d_m) > cfg.grasp_z_diff_limit and z < cfg.grasp_abs_z_limit:
                        s.do_grasp = True
                        n_down = int(s.rng.integers(
                            cfg.n_acts_down_range[0],
                            cfg.n_acts_down_range[1] + 1,
                        ))
                        down_val = self._sample_act_down_val(s.task, s.rng)
                        act_down = np.zeros(
                            (n_down, self.action_dim), np.float32
                        )
                        act_down[:, 2] = down_val
                        act_grasp = np.zeros(
                            (cfg.n_acts_close_grp, self.action_dim), np.float32
                        )
                        act_grasp[:, 2] = cfg.close_grp_act_down_val
                        act_grasp[:, -1] = cfg.close_grp_force
                        inject = np.concatenate([act_down, act_grasp])
                        s.acts.append(inject)
                        grasp_calls.append((
                            i, "step_k", (s.task, s.env_idx, inject, cam), {},
                        ))
            if grasp_calls:
                for (i, *_), out in zip(
                    grasp_calls, self.pool.map(grasp_calls)
                ):
                    s = states[i]
                    s.imgs.extend(list(out["imgs"]))
                    s.n_env_steps += len(out["imgs"])
                    # the serial executor ignores done during grasp
                    # injection (`train/explore.py:184-202`)

            for i in active:
                s = states[i]
                if s.is_suc and cfg.is_stop_at_suc:
                    # stop after finishing the current goal frame, like the
                    # per-env executor's frame-level break
                    cur_g = s.schedule[r]
                    if r + 1 >= len(s.schedule) or s.schedule[r + 1] != cur_g:
                        s.finished = True

        out: List[RolloutResult] = []
        for s in states:
            acts_cat = np.concatenate(s.acts, axis=0).astype(np.float32)
            imgs_cat = np.stack(s.imgs, axis=0)
            if len(imgs_cat) != len(acts_cat) + 1:
                raise AssertionError("episode image/action length mismatch")
            out.append(RolloutResult(
                imgs=imgs_cat, acts=acts_cat, is_success=s.is_suc,
                n_env_steps=s.n_env_steps, pred_video=s.pred_video,
            ))
        return out
