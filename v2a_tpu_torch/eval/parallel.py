"""Parallel evaluation: N episodes advance in lock-step across env workers.

A copy of `v2a_tpu/eval/parallel.py`. The reference protocol runs 8 tasks
x 25 seeds = 200 episodes strictly serially (`lb_eval_helper.py:84-163`),
each interleaving batch-1 policy DDIM calls with sim steps. Here a worker
pool (one env per process) rolls N episodes concurrently:

- policy predictions batch across all live episodes (ONE DDIM chain per
  round, static batch = pool size),
- video re-predictions batch across the episodes whose replanning clock
  fired that round (padded to the pool size, as the JAX package pads so its
  sampler never recompiles: the card runs the same B=N kernels every
  call),
- sim stepping runs concurrently in the workers.

Episode semantics (replanning cadence, 5 preds/frame, stop-at-success,
artifact payloads) match `eval/harness.py::Evaluator.eval_1_env` exactly;
results aggregate into the same dict shape, so `save_result_json` works
unchanged.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from v2a_tpu_torch.envs.subproc import EnvWorkerPool
from v2a_tpu_torch.eval.harness import EpisodeResult, EvalConfig

BatchPolicyFn = Callable[[np.ndarray, np.ndarray], np.ndarray]
BatchVideoFn = Callable[[np.ndarray, List[str]], np.ndarray]
# batch_video_fn(img01 (N,H,W,3), tasks) -> (N, F, H, W, 3) float01 OR
# uint8 (uint8 preferred: quantizing on the device, 4x less readback)


@dataclasses.dataclass
class _EpState:
    task: str
    env_idx: int
    seed: int
    imgs: List[np.ndarray]
    t0: float
    pred_videos: List[np.ndarray] = dataclasses.field(default_factory=list)
    pred_v: Optional[np.ndarray] = None
    cnt_vid_pred: int = 0
    g_idx: int = 0
    fr_idx: int = 0
    pred_in_frame: int = 0
    is_suc: bool = False
    finished: bool = False

    @property
    def img_st(self):
        return self.imgs[-1]


class ParallelEvaluator:
    def __init__(
        self,
        pool: EnvWorkerPool,
        batch_policy_fn: BatchPolicyFn,
        batch_video_fn: BatchVideoFn,
        video_horizon: int,
        config: Optional[EvalConfig] = None,
        action_dim: int = 7,
    ):
        self.pool = pool
        self.policy_fn = batch_policy_fn
        self.video_fn = batch_video_fn
        self.v_hzn = int(video_horizon)
        self.cfg = config or EvalConfig()
        self.action_dim = action_dim

    # -- one wave: up to len(pool) episodes in lock-step --------------------

    def _run_wave(
        self, episodes: Sequence[Tuple[str, int, int]], cam: str
    ) -> List[EpisodeResult]:
        """episodes: (task, env_idx, env_seed) triples, one per worker."""
        cfg = self.cfg
        n = len(episodes)
        pool_idx = list(range(n))

        self.pool.map([
            (i, "init_1_given_env", (t, e), {"e_seed": seed})
            for i, (t, e, seed) in zip(pool_idx, episodes)
        ])
        start_imgs = self.pool.map([
            (i, "render_an_env", (t, cam, e), {})
            for i, (t, e, _) in zip(pool_idx, episodes)
        ])

        states = [
            _EpState(task=t, env_idx=e, seed=s, imgs=[img], t0=time.perf_counter())
            for (t, e, s), img in zip(episodes, start_imgs)
        ]
        h, w = start_imgs[0].shape[:2]

        def num_vid_ppp(s: _EpState) -> int:
            return (
                1 if s.task in cfg.one_video_pred_tasks
                else cfg.num_vid_pred_per_ep
            )

        def total_frames(s: _EpState) -> int:
            return (num_vid_ppp(s) - 1) * cfg.use_vid_first_n_frames + self.v_hzn

        while True:
            live = [i for i in pool_idx if not states[i].finished]
            if not live:
                break

            # -- frame-start bookkeeping (`lb_eval_helper.py:240-268`):
            # re-predict the video when `use_vid_first_n_frames` of the
            # current one have been consumed, else advance the goal index
            need_vid = []
            for i in live:
                s = states[i]
                if s.pred_in_frame != 0:
                    continue  # mid-frame
                if s.cnt_vid_pred < num_vid_ppp(s) and (
                    s.fr_idx == 0
                    or s.g_idx == cfg.use_vid_first_n_frames - 1
                ):
                    need_vid.append(i)
                elif s.fr_idx > 0:
                    s.g_idx += 1
            if need_vid:
                nb = len(self.pool)  # pad to pool size: one batch shape,
                vb = np.zeros((nb, h, w, 3), np.float32)  # partial waves too
                tasks = [states[live[0]].task] * nb
                for i in need_vid:
                    vb[i] = states[i].img_st.astype(np.float32) / 255.0
                    tasks[i] = states[i].task
                videos = np.asarray(self.video_fn(vb, tasks))
                if videos.dtype != np.uint8:
                    videos = (np.clip(videos, 0.0, 1.0) * 255).astype(np.uint8)
                for i in need_vid:
                    s = states[i]
                    pred_v = videos[i]
                    s.pred_v = pred_v
                    s.pred_videos.append(
                        np.concatenate([s.img_st[None], pred_v], axis=0)
                    )
                    s.cnt_vid_pred += 1
                    s.g_idx = 0

            # -- ONE batched policy call over all live episodes (padded to
            # the pool size, partial final waves too)
            nb = len(self.pool)
            obs = np.zeros((nb, h, w, 3), np.float32)
            goal = np.zeros((nb, h, w, 3), np.float32)
            for i in live:
                s = states[i]
                obs[i] = s.img_st.astype(np.float32) / 255.0
                goal[i] = s.pred_v[s.g_idx].astype(np.float32) / 255.0
            acts_all = np.asarray(self.policy_fn(obs, goal)).reshape(
                nb, cfg.n_acts_per_pred, self.action_dim
            )

            # -- concurrent env stepping
            calls = []
            for i in live:
                s = states[i]
                acts = np.clip(acts_all[i], cfg.act_min, cfg.act_max)
                calls.append((
                    i, "step_k", (s.task, s.env_idx, acts, cam), {},
                ))
            for (i, *_), out in zip(calls, self.pool.map(calls)):
                s = states[i]
                s.imgs.extend(list(out["imgs"]))
                s.is_suc = out["done"] or s.is_suc

            # -- advance per-episode clocks (frame/prediction indices)
            for i in live:
                s = states[i]
                s.pred_in_frame += 1
                if s.pred_in_frame == cfg.eval_n_preds_betw_vframes:
                    s.pred_in_frame = 0
                    s.fr_idx += 1
                    if s.is_suc and cfg.is_stop_at_suc:
                        s.finished = True
                    elif s.fr_idx >= total_frames(s):
                        s.finished = True

        self.pool.map([
            (i, "close_1_given_env", (t, e), {})
            for i, (t, e, _) in zip(pool_idx, episodes)
        ])
        return [
            EpisodeResult(
                is_suc=s.is_suc,
                imgs=np.stack(s.imgs, axis=0),
                run_time=time.perf_counter() - s.t0,
                pred_videos=s.pred_videos,
            )
            for s in states
        ]

    def _write_artifacts(self, task, cam, seed, res, save_path):
        """Reuse the serial evaluator's artifact layout (same tk_idx-prefixed
        directories, `lb_eval_helper.py:119-144`)."""
        from v2a_tpu_torch.eval.harness import Evaluator

        if not hasattr(self, "_task_to_task_idx"):
            self._task_to_task_idx = self.pool.workers[0].call(
                "attr:task_to_task_idx"
            )
        ev = Evaluator.__new__(Evaluator)
        ev.save_path = save_path
        ev.envs = types.SimpleNamespace(
            task_to_task_idx=self._task_to_task_idx
        )
        ev._save_episode_artifacts(task, cam, seed, res)

    # -- full protocol -------------------------------------------------------

    def run_evals(self, save_path: Optional[str] = None, cam: str = "agent") -> Dict:
        cfg = self.cfg
        seed_sets = self.pool.workers[0].call("attr:seed_sets")
        episodes: List[Tuple[str, int, int]] = []
        for task in self.pool.task_list:
            for seed in cfg.valid_seeds:
                episodes.append((task, seed_sets[task][0], seed))

        all_results: Dict[Tuple[str, int], EpisodeResult] = {}
        n_workers = len(self.pool)
        for st in range(0, len(episodes), n_workers):
            wave = episodes[st : st + n_workers]
            for (task, env_idx, seed), res in zip(
                wave, self._run_wave(wave, cam)
            ):
                all_results[(task, seed)] = res
                if cfg.vis and save_path:
                    self._write_artifacts(task, cam, seed, res, save_path)

        is_sucs_all, run_times_all = [], []
        is_sucs_per_tk: Dict[str, list] = {}
        run_times_per_tk: Dict[str, list] = {}
        for task in self.pool.task_list:
            is_sucs_per_tk[task] = []
            run_times_per_tk[task] = []
            for seed in cfg.valid_seeds:
                res = all_results[(task, seed)]
                is_sucs_all.append(res.is_suc)
                is_sucs_per_tk[task].append(res.is_suc)
                run_times_all.append(res.run_time)
                run_times_per_tk[task].append(res.run_time)
        return dict(
            suc_rate=float(np.mean(is_sucs_all)) if is_sucs_all else 0.0,
            num_evals=len(is_sucs_all),
            n_seeds=len(cfg.valid_seeds),
            suc_rate_per_tk={
                tk: float(np.mean(v)) for tk, v in is_sucs_per_tk.items()
            },
            is_sucs_per_tk=is_sucs_per_tk,
            is_sucs_all=is_sucs_all,
            run_times_all=run_times_all,
            run_times_per_tk=run_times_per_tk,
            seeds=cfg.valid_seeds,
        )
