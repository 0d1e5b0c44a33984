"""Scripted oracle for the fake reach-and-grasp world: expert actions and a
ground-truth "video model".

A copy of `v2a_tpu/envs/fake_oracle.py`.

The reference's de-facto acceptance test is the end-to-end eval success rate
(`diffuser/libero/lb_eval_helper.py:84-163`, SURVEY §4.6) — which requires a
*pretrained* frozen video model. This module supplies the hermetic
equivalent for `FakeEnvList`: a scripted goal-frame generator that plays the
frozen video model's role (guidance frames showing the task being solved),
plus an oracle action policy used to synthesize supervised episodes. Both
let the learning gate (tests/test_learning.py) prove the system *learns*
without MuJoCo or a 264M-param checkpoint.

Design constraint: like the real frozen video model, `FakeOracleVideoModel`
is a pure function of (start frame, task, key) — it decodes the world state
from the rendered pixels rather than peeking at the simulator, so it
composes with `pipeline_explore` (which samples videos for a cycle before
its envs are re-opened) exactly the way the frozen U-Net does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from v2a_tpu_torch.envs.fake import FakeEnvList, render_state

# must match `_FakeSim`'s object placement (fake.py): z ~ U[0.45, 0.47]
OBJ_Z = 0.46


def decode_frame(img: np.ndarray) -> Dict[str, np.ndarray]:
    """Recover (ee_pos, obj_pos, gripper_closed) from a fake-world render.

    Inverts `render_state`: the object is the green square (ch1 == 230); the
    EE is the red square — exactly the pixels with an ODD ch0, since the
    rendered height shade is forced odd while every background
    (`20 + 10*(task_idx % 16)`, even) leaves ch0 even. This stays correct
    for bright backgrounds >= 115 (where an absolute ch0 threshold
    classified the whole background as EE) AND when the EE square sits
    entirely inside the object square during the grasp (where a
    ch0-differs-from-ch1 rule loses every EE pixel to the ch1==230
    exclusion). The gripper state is the blue top stripe. Works on uint8
    or float [0,1] frames."""
    if img.dtype != np.uint8:
        img = (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0).round()
        img = img.astype(np.uint8)
    h, w = img.shape[:2]

    def from_px(rows, cols):
        x = float(np.mean(cols)) / (w - 1) - 0.5
        y = float(np.mean(rows)) / (h - 1) - 0.5
        return x, y

    tick = (
        (img[..., 0] == 255) & (img[..., 1] == 255) & (img[..., 2] == 255)
    )
    obj_mask = (img[..., 1] == 230) & ~tick
    ee_mask = (img[..., 0] % 2 == 1) & ~tick
    if not obj_mask.any() or not ee_mask.any():
        raise ValueError("frame does not contain both the EE and the object")
    ox, oy = from_px(*np.nonzero(obj_mask))
    ex, ey = from_px(*np.nonzero(ee_mask))
    shade = float(img[..., 0][ee_mask].max())
    ez = 0.4 + (shade - 120.0) / 160.0
    gripper_closed = bool(np.mean(img[1, :, 2] == 220) > 0.5)
    return {
        "ee_pos": np.asarray([ex, ey, ez], np.float32),
        "obj_pos": np.asarray([ox, oy, OBJ_Z], np.float32),
        "gripper_closed": gripper_closed,
    }


def oracle_action(
    ee_pos: np.ndarray,
    obj_pos: np.ndarray,
    step_scale: float,
    close_dist: float,
    action_dim: int = 7,
) -> np.ndarray:
    """Expert action: full-speed straight-line approach, close the gripper
    inside `close_dist` of the object."""
    act = np.zeros((action_dim,), np.float32)
    delta = np.asarray(obj_pos, np.float32) - np.asarray(ee_pos, np.float32)
    act[:3] = np.clip(delta / max(step_scale, 1e-8), -1.0, 1.0)
    act[6] = 0.98 if float(np.linalg.norm(delta)) < close_dist else -0.98
    return act


def collect_oracle_episodes(
    env_list: FakeEnvList,
    eps_per_task: int,
    ep_len: int,
    rng: np.random.Generator,
    action_noise: float = 0.0,
    close_dist: Optional[float] = None,
) -> List[Dict]:
    """Roll the oracle in the fake sim and return executed episodes
    (uint8 frames + float32 actions), the payload `ReplayBuffer.add_episode`
    takes. Supervision matches the online loop's hindsight relabeling: the
    actions stored are the ones actually executed."""
    close = close_dist if close_dist is not None else env_list.grasp_radius
    cam = env_list.camera_list[0]
    out: List[Dict] = []
    for task in env_list.task_list:
        env_idx = env_list.seed_sets[task][0]
        for _ in range(eps_per_task):
            seed = int(rng.integers(0, 99999999))
            env_list.init_1_given_env(task, env_idx, e_seed=seed)
            sim_obs = env_list.get_an_env_obs(task, env_idx)
            imgs = [env_list.render_an_env(task, cam, env_idx)]
            acts = []
            for _t in range(ep_len):
                act = oracle_action(
                    sim_obs["robot0_eef_pos"], sim_obs["obj_pos"],
                    env_list.step_scale, close,
                )
                if action_noise > 0:
                    act = act + rng.normal(
                        0.0, action_noise, act.shape
                    ).astype(np.float32)
                    act = np.clip(act, -1.0, 1.0).astype(np.float32)
                sim_obs, _r, _done, _info = env_list.step_an_env(
                    task, env_idx, act
                )
                imgs.append(env_list.render_an_env(task, cam, env_idx))
                acts.append(act)
            env_list.close_1_given_env(task, env_idx)
            out.append(
                dict(
                    task=task, cam=cam, env_idx=env_idx,
                    imgs=np.stack(imgs), acts=np.stack(acts),
                )
            )
    return out


class FakeOracleVideoModel:
    """Ground-truth guidance-video generator for the fake world.

    Plays the role of the frozen pretrained video diffusion model
    (`Video_PredModel.sample`, `diffuser/models/video_model.py:55-75`):
    given a start frame and a task it returns `horizon` future frames that
    *show the task being solved* — the EE descending onto the object with
    the gripper closing at the end. Implements the trainer's video-model
    protocol `.sample(rng, imgs01, tasks) -> (B, F, H, W, 3) float01`."""

    def __init__(
        self,
        task_to_task_idx: Dict[str, int],
        horizon: int = 7,
        approach_frames: Optional[int] = None,
    ):
        self.task_to_task_idx = dict(task_to_task_idx)
        self.video_future_horizon = int(horizon)
        # frames over which the approach completes; the rest hold the grasp
        self.approach_frames = (
            int(approach_frames) if approach_frames is not None
            else max(self.video_future_horizon - 2, 1)
        )

    def _frames_for(self, img01: np.ndarray, task: str) -> np.ndarray:
        state = decode_frame(img01)
        ee, obj = state["ee_pos"], state["obj_pos"]
        h, w = img01.shape[:2]
        frames = []
        for f in range(1, self.video_future_horizon + 1):
            alpha = min(f / self.approach_frames, 1.0)
            pos = (1.0 - alpha) * ee + alpha * obj
            gripper = 0.98 if alpha >= 1.0 else -0.98
            frames.append(
                render_state(
                    self.task_to_task_idx[task], pos, obj, gripper,
                    t=f, img_hw=(h, w),
                )
            )
        return np.stack(frames).astype(np.float32) / 255.0

    def sample(self, rng, imgs01: np.ndarray, tasks: Sequence[str]) -> np.ndarray:
        imgs01 = np.asarray(imgs01, np.float32)
        return np.stack(
            [self._frames_for(imgs01[b], t) for b, t in enumerate(tasks)]
        )

    def sample_u8(self, rng, imgs01: np.ndarray, tasks: Sequence[str]) -> np.ndarray:
        """uint8 variant of `sample` (the eval entry's video_fn protocol,
        `scripts/eval.py`)."""
        v = self.sample(rng, imgs01, tasks)
        return (np.clip(v, 0.0, 1.0) * 255.0).astype(np.uint8)

    def video_fn(self, img01: np.ndarray, task: str) -> np.ndarray:
        """Evaluator-protocol adapter (`eval/harness.py` VideoFn)."""
        return self._frames_for(np.asarray(img01, np.float32), task)
