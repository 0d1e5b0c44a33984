"""Evaluation harness: receding-horizon video replanning rollouts.

A copy of `v2a_tpu/eval/harness.py`, the counterpart of `LB_DP_Eval`
(`diffuser/libero/lb_eval_helper.py:14-373`) and the eval entry hyperparams
of `diffuser/libero/plan_lb.py:67-74,140-151`. Semantics preserved:

- per (task, cam, env_seed): create the env with a FIXED seed, roll out
  `eval_1_env`, close the env;
- receding-horizon replanning (`lb_eval_helper.py:233-268`): the guidance
  video is re-predicted from the current frame each time
  `use_vid_first_n_frames` of its frames have been consumed, up to
  `num_vid_pred_per_ep` predictions; total frame slots
  `(num_vid_pred_per_ep - 1) * use_vid_first_n_frames + video_horizon`;
- per frame: `eval_n_preds_betw_vframes` policy predictions x
  `n_acts_per_pred` executed actions, stop at success;
- results: overall + per-task success rates, per-episode run times, seeds;
  JSON file named `result-nm{N}-sr{rate}-...json` (`plan_lb.py:109-130`);
  rollout mp4 (fps 50) + predicted-video mp4s (fps 3) + summary strip png
  per episode when `vis` is on.

The policy and video calls are the caller's `policy_fn` / `video_fn`
(`scripts/eval.py` binds the EMA policy's DDIM prediction and the video
model's `sample_u8` on the card).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from v2a_tpu_torch.data.img_utils import save_episode_mp4, save_episode_png
from v2a_tpu_torch.envs.base import EnvList


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Eval-time overrides of `plan_lb.py:67-74,140-151`."""

    n_seeds: int = 25
    seed_start: int = 100  # env seeds 100..100+n (`plan_lb.py:89`)
    eval_n_preds_betw_vframes: int = 5
    num_vid_pred_per_ep: int = 5
    use_vid_first_n_frames: int = 2
    n_acts_per_pred: int = 8
    is_stop_at_suc: bool = True
    act_min: float = -1.0
    act_max: float = 1.0
    vis: bool = True
    # tasks that only get ONE video prediction per episode
    # (`lb_eval_helper.py:12,233-236`; empty in the release)
    one_video_pred_tasks: tuple = ()

    @property
    def valid_seeds(self) -> List[int]:
        return list(range(self.seed_start, self.seed_start + self.n_seeds))


@dataclasses.dataclass
class EpisodeResult:
    is_suc: bool
    imgs: np.ndarray  # (T+1, H, W, 3) uint8 rollout frames
    run_time: float
    pred_videos: List[np.ndarray]  # each (F+1, H, W, 3) uint8 incl. start


PolicyFn = Callable[[np.ndarray, np.ndarray], np.ndarray]
# policy_fn(img_obs01 (1,H,W,3), img_goal01 (1,H,W,3)) -> (n_acts, Da)
VideoFn = Callable[[np.ndarray, str], np.ndarray]
# video_fn(img_start01 (H,W,3), task) -> (F, H, W, 3) float01 OR uint8
# (uint8 preferred: quantizing on the device cuts readback traffic 4x)


class Evaluator:
    """Runs the full eval protocol over task_list x cam_list x seeds."""

    def __init__(
        self,
        env_list: EnvList,
        policy_fn: PolicyFn,
        video_fn: VideoFn,
        video_horizon: int,
        config: Optional[EvalConfig] = None,
        save_path: Optional[str] = None,
    ):
        self.envs = env_list
        self.policy_fn = policy_fn
        self.video_fn = video_fn
        self.v_hzn = int(video_horizon)
        self.cfg = config or EvalConfig()
        self.save_path = save_path

    # -- single episode ----------------------------------------------------

    def eval_1_env(self, task: str, cam: str, env_idx: int) -> EpisodeResult:
        """One rollout with receding-horizon video replanning
        (`eval_1_env` `lb_eval_helper.py:168-373`)."""
        cfg = self.cfg
        envs = self.envs
        t0 = time.perf_counter()

        img_st = envs.render_an_env(task, cam, env_idx)  # uint8 (H,W,3)
        imgs_out: List[np.ndarray] = [img_st]
        pred_videos: List[np.ndarray] = []
        is_suc = False

        num_vid_ppp = (
            1 if task in cfg.one_video_pred_tasks else cfg.num_vid_pred_per_ep
        )
        num_total_frames = (
            (num_vid_ppp - 1) * cfg.use_vid_first_n_frames + self.v_hzn
        )

        cnt_vid_pred = 0
        g_idx = 0
        pred_v: Optional[np.ndarray] = None
        for fr_idx in range(num_total_frames):
            if cnt_vid_pred < num_vid_ppp and (
                fr_idx == 0 or g_idx == cfg.use_vid_first_n_frames - 1
            ):
                video = np.asarray(
                    self.video_fn(img_st.astype(np.float32) / 255.0, task)
                )
                pred_v = (
                    video if video.dtype == np.uint8
                    else (np.clip(video, 0.0, 1.0) * 255).astype(np.uint8)
                )
                pred_videos.append(
                    np.concatenate([img_st[None], pred_v], axis=0)
                )
                cnt_vid_pred += 1
                g_idx = 0
            else:
                g_idx += 1

            img_goal = pred_v[g_idx]
            for _ in range(cfg.eval_n_preds_betw_vframes):
                acts = np.asarray(
                    self.policy_fn(
                        img_st[None].astype(np.float32) / 255.0,
                        img_goal[None].astype(np.float32) / 255.0,
                    )
                ).reshape(cfg.n_acts_per_pred, envs.action_dim)
                acts = np.clip(acts, cfg.act_min, cfg.act_max)
                for i_a in range(cfg.n_acts_per_pred):
                    _, _, e_done, _ = envs.step_an_env(task, env_idx, acts[i_a])
                    imgs_out.append(envs.render_an_env(task, cam, env_idx))
                    is_suc = bool(e_done) or is_suc
                img_st = imgs_out[-1]

            if is_suc and cfg.is_stop_at_suc:
                break

        return EpisodeResult(
            is_suc=is_suc,
            imgs=np.stack(imgs_out, axis=0),
            run_time=time.perf_counter() - t0,
            pred_videos=pred_videos,
        )

    # -- full protocol -----------------------------------------------------

    def run_evals(self) -> Dict:
        """All tasks x cams x seeds (`run_evals` `lb_eval_helper.py:84-163`).

        Returns the result dict of the reference (suc_rate, per-task rates,
        run times, seeds)."""
        cfg = self.cfg
        is_sucs_all: List[bool] = []
        is_sucs_per_tk: Dict[str, List[bool]] = {}
        run_times_all: List[float] = []
        run_times_per_tk: Dict[str, List[float]] = {}

        for task in self.envs.task_list:
            is_sucs_per_tk[task] = []
            run_times_per_tk[task] = []
            for cam in self.envs.camera_list:
                for env_seed in cfg.valid_seeds:
                    env_idx = self.envs.seed_sets[task][0]
                    self.envs.init_1_given_env(
                        task, env_idx, e_seed=env_seed
                    )
                    res = self.eval_1_env(task, cam, env_idx)
                    self.envs.close_1_given_env(task, env_idx)

                    is_sucs_all.append(res.is_suc)
                    is_sucs_per_tk[task].append(res.is_suc)
                    run_times_all.append(res.run_time)
                    run_times_per_tk[task].append(res.run_time)

                    if cfg.vis and self.save_path:
                        self._save_episode_artifacts(
                            task, cam, env_seed, res
                        )

        suc_rate_per_tk = {
            tk: float(np.mean(v)) if v else 0.0
            for tk, v in is_sucs_per_tk.items()
        }
        return dict(
            suc_rate=float(np.mean(is_sucs_all)) if is_sucs_all else 0.0,
            num_evals=len(is_sucs_all),
            n_seeds=len(cfg.valid_seeds),
            suc_rate_per_tk=suc_rate_per_tk,
            is_sucs_per_tk=is_sucs_per_tk,
            is_sucs_all=is_sucs_all,
            run_times_all=run_times_all,
            run_times_per_tk=run_times_per_tk,
            seeds=cfg.valid_seeds,
        )

    def _save_episode_artifacts(self, task, cam, env_seed, res: EpisodeResult):
        """mp4 + predicted-video mp4s + strip png
        (`lb_eval_helper.py:119-144`)."""
        tk_idx = self.envs.task_to_task_idx.get(task, 0)
        sub = f"{tk_idx}-{task.replace(' ', '_')[:40]}-{cam}"
        parent = os.path.join(self.save_path, sub)
        save_episode_mp4(
            os.path.join(parent, f"{env_seed:03d}-{res.is_suc}.mp4"),
            list(res.imgs), fps=50,
        )
        for i_v, pv in enumerate(res.pred_videos):
            save_episode_mp4(
                os.path.join(
                    parent, f"{env_seed:03d}-{res.is_suc}-predv-{i_v}.mp4"
                ),
                list(pv), fps=3,
            )
        save_episode_png(
            os.path.join(parent, f"{env_seed:03d}-{res.is_suc}.png"), res.imgs
        )


def save_result_json(
    results: Dict,
    save_path: str,
    epoch: int = 0,
    dp_ds: int = 8,
    vid_ds: int = 100,
    num_vid_pred_per_ep: int = 5,
    use_vid_first_n_frames: int = 2,
    eval_seed: Optional[int] = None,
    extra: Optional[Dict] = None,
) -> str:
    """Write the result JSON with the reference's file-name convention
    (`plan_lb.py:109-130`)."""
    results = dict(results)
    results["epoch"] = int(epoch)
    if extra:
        results.update(extra)
    suc_rate = results["suc_rate"]
    num_evals = results["num_evals"]
    epoch_str = f"{round(epoch / 1000)}k"
    fname = (
        f"result-nm{num_evals}-sr{suc_rate * 100:.1f}"
        f"-ds{dp_ds}-vidDs{vid_ds}-ep{epoch_str}"
        f"-vpep{num_vid_pred_per_ep}-vfn{use_vid_first_n_frames}"
        f"-evSd{eval_seed}.json"
    )
    os.makedirs(save_path, exist_ok=True)
    path = os.path.join(save_path, fname)
    with open(path, "w") as f:
        json.dump(results, f, indent=1, default=str)
    return path
