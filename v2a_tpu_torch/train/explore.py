"""Video-guided exploration: chase predicted frames with the EMA policy.

A copy of `v2a_tpu/train/explore.py`. Host-side counterpart of `video_guided_explore` /
`envs_video_guided_execute`
(`diffuser/libero/lb_online_trainer_v7.py:859-1291`). The control flow is
inherently dynamic (random predictions-per-frame, depth-triggered grasp
injection, early stop at success) so it stays in Python; the two device
calls, video sampling and the policy's DDIM action prediction, are made
by the trainer (`train/trainer.py`).

Per task: init a fresh env -> render the start frame -> sample a guidance
video (one call, batched across tasks upstream when possible) -> for each
predicted frame g, repeat n_preds in [4,6] times {predict 8 actions with
DDIM(8), clamp, force the gripper open until the grasp fires, execute them
one sim-step at a time re-rendering after each} -> depth-heuristic grasp
trigger injects 16 down-actions + 8 close-gripper actions once -> the whole
~280-step episode lands in the video replay buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from v2a_tpu_torch.envs.base import EnvList

# `LB_GRASP_actdown_value_range_1` (`diffuser/libero/lb_constants.py:15-24`)
LB_GRASP_ACTDOWN_RANGE = {
    65: (-0.11, -0.10),
    66: (-0.11, -0.10),
    67: (-0.11, -0.10),
    68: (-0.11, -0.10),
    69: (-0.99, -0.98),
    70: (-0.99, -0.98),
    71: (-0.11, -0.10),
    72: (-0.11, -0.10),
}


@dataclasses.dataclass(frozen=True)
class ExploreConfig:
    """Guided-rollout knobs from `trainer_dict`
    (`config/libero/lb_tk8_65to72.py:95-127`)."""

    n_acts_per_pred: int = 8
    n_preds_betw_vframes: Tuple[int, int] = (4, 6)
    n_acts_down_range: Tuple[int, int] = (16, 16)
    n_acts_close_grp: int = 8
    close_grp_force: float = 0.98
    close_grp_act_down_val: float = 0.0
    act_down_val: Optional[float] = None
    act_down_val_range_per_tk: Optional[Dict[int, Tuple[float, float]]] = None
    grasp_z_diff_limit: float = 0.36
    grasp_abs_z_limit: float = 0.56
    grasp_cam: str = "gripper"
    is_stop_at_suc: bool = False
    is_grasp_task: bool = True
    act_min: float = -1.0
    act_max: float = 1.0


@dataclasses.dataclass
class RolloutResult:
    imgs: np.ndarray  # (T+1, H, W, 3) uint8
    acts: np.ndarray  # (T, Da) float32
    is_success: bool
    n_env_steps: int
    pred_video: np.ndarray  # (F, H, W, 3) uint8 guidance video


PolicyFn = Callable[[np.ndarray, np.ndarray], np.ndarray]
# policy_fn(img_obs float01 (1,H,W,3), img_goal float01 (1,H,W,3))
#   -> actions (n_acts_per_pred, Da)


def _grasp_window_mean_depth(depth: np.ndarray) -> float:
    """Mean depth of the fixed under-gripper window
    (`lb_online_trainer_v7.py:1144-1151`)."""
    h, w = depth.shape[:2]
    h_st, h_e = round(h * 0.75), round(h * 0.82)
    w_st, w_e = round(w * 0.35), round(w * 0.65)
    return float(np.mean(depth[h_st:h_e, w_st:w_e]))


class GuidedRolloutExecutor:
    """Executes one guided rollout per live env, collecting the episode."""

    def __init__(
        self,
        env_list: EnvList,
        policy_fn: PolicyFn,
        config: ExploreConfig,
        rng: Optional[np.random.Generator] = None,
    ):
        self.envs = env_list
        self.policy_fn = policy_fn
        self.cfg = config
        self.rng = rng or np.random.default_rng(0)

    def _sample_act_down_val(self, task: str) -> float:
        cfg = self.cfg
        if cfg.act_down_val is not None:
            if cfg.act_down_val > 0:
                raise ValueError("act_down_val must be <= 0")
            return cfg.act_down_val
        table = cfg.act_down_val_range_per_tk or LB_GRASP_ACTDOWN_RANGE
        tk_idx = self.envs.task_to_task_idx[task]
        lo, hi = table[tk_idx]
        return float(self.rng.uniform(lo, hi))

    def execute(
        self,
        task: str,
        cam: str,
        env_idx: int,
        img_start: np.ndarray,
        pred_video: np.ndarray,
    ) -> RolloutResult:
        """Run one episode chasing the frames of `pred_video`.

        `img_start` uint8 (H, W, 3); `pred_video` uint8 (F, H, W, 3).
        """
        cfg = self.cfg
        envs = self.envs
        v_hzn = len(pred_video)
        act_dim = envs.action_dim

        imgs_out: List[np.ndarray] = [img_start]
        acts_out: List[np.ndarray] = []
        is_suc = False
        do_grasp = False
        n_env_steps = 0
        img_st = img_start

        for g_idx in range(v_hzn):
            img_goal = pred_video[g_idx]
            n_preds = int(self.rng.integers(
                cfg.n_preds_betw_vframes[0], cfg.n_preds_betw_vframes[1] + 1
            ))
            for _ in range(n_preds):
                acts = np.asarray(
                    self.policy_fn(
                        img_st[None].astype(np.float32) / 255.0,
                        img_goal[None].astype(np.float32) / 255.0,
                    )
                ).reshape(cfg.n_acts_per_pred, act_dim)
                acts = np.clip(acts, cfg.act_min, cfg.act_max)

                # force gripper open until the grasp fires, then closed
                # (`lb_online_trainer_v7.py:1092-1097`)
                if cfg.is_grasp_task:
                    acts[:, -1] = (
                        cfg.close_grp_force if do_grasp else -cfg.close_grp_force
                    )

                for i_a in range(cfg.n_acts_per_pred):
                    _, _, e_done, _ = envs.step_an_env(task, env_idx, acts[i_a])
                    imgs_out.append(envs.render_an_env(task, cam, env_idx))
                    n_env_steps += 1
                acts_out.append(acts)
                is_suc = bool(e_done) or is_suc
                img_st = imgs_out[-1]

                # -- depth-heuristic grasp trigger
                # (`lb_online_trainer_v7.py:1127-1216`)
                if cfg.is_grasp_task and not do_grasp:
                    _, depth = envs.render_an_env_with_depth(
                        task, cfg.grasp_cam, env_idx
                    )
                    d_m = _grasp_window_mean_depth(np.asarray(depth))
                    ee_pos = envs.get_an_env_obs(task, env_idx)["robot0_eef_pos"]
                    z_diff = abs(float(ee_pos[2]) - d_m)
                    if (
                        z_diff > cfg.grasp_z_diff_limit
                        and float(ee_pos[2]) < cfg.grasp_abs_z_limit
                    ):
                        do_grasp = True
                        n_down = int(self.rng.integers(
                            cfg.n_acts_down_range[0], cfg.n_acts_down_range[1] + 1
                        ))
                        down_val = self._sample_act_down_val(task)
                        act_down = np.zeros((n_down, act_dim), np.float32)
                        act_down[:, 2] = down_val
                        for a in act_down:
                            envs.step_an_env(task, env_idx, a)
                            imgs_out.append(envs.render_an_env(task, cam, env_idx))
                            n_env_steps += 1
                        acts_out.append(act_down)

                        act_grasp = np.zeros(
                            (cfg.n_acts_close_grp, act_dim), np.float32
                        )
                        act_grasp[:, 2] = cfg.close_grp_act_down_val
                        act_grasp[:, -1] = cfg.close_grp_force
                        for a in act_grasp:
                            envs.step_an_env(task, env_idx, a)
                            imgs_out.append(envs.render_an_env(task, cam, env_idx))
                            n_env_steps += 1
                        acts_out.append(act_grasp)
                        img_st = imgs_out[-1]

            if is_suc and cfg.is_stop_at_suc:
                break

        acts_cat = np.concatenate(acts_out, axis=0).astype(np.float32)
        imgs_cat = np.stack(imgs_out, axis=0)
        if len(imgs_cat) != len(acts_cat) + 1:
            raise AssertionError("episode image/action length mismatch")
        return RolloutResult(
            imgs=imgs_cat,
            acts=acts_cat,
            is_success=is_suc,
            n_env_steps=n_env_steps,
            pred_video=pred_video,
        )
