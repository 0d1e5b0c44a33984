"""Deterministic fake environment backend for CI and benchmarks.

A copy of `v2a_tpu/envs/fake.py`: renders, dynamics and seeds are the
same, so one action sequence gives the same frames in both packages.

The reference has no test suite and no sim-free backend (SURVEY §4); this
fake fills that gap: a tiny 2.5-D "reach-and-grasp" world whose dynamics,
rendering, and success criterion are deterministic functions of the seed, so
the full online-training and eval loops run hermetically without
MuJoCo/LIBERO/EGL.

World model per (task, seed):
- an end-effector at `ee_pos` (3,), moved by the first 3 action dims scaled
  by `step_scale`; dim 6 is the gripper (>0 closes),
- a target object at `obj_pos`, placed from the seed,
- success (= `done`) when the closed gripper is within `grasp_radius` of the
  object,
- rendering draws the EE (red), the object (green), and a gripper-state
  stripe (blue) on an (H, W, 3) canvas whose background encodes the task
  index — renders are unique per state, which the replay-buffer continuity
  check relies on,
- the "gripper" camera depth render encodes EE-to-object vertical clearance
  so the grasp heuristic's depth-window logic has real signal to chew on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from v2a_tpu_torch.envs.base import EnvList, make_seed_sets


def render_state(
    task_idx: int,
    ee_pos: np.ndarray,
    obj_pos: np.ndarray,
    gripper: float,
    t: int,
    img_hw: Tuple[int, int],
) -> np.ndarray:
    """Draw one fake-world state. Shared by `_FakeSim.render` and the
    scripted oracle video model (`fake_oracle.py`), so synthesized guidance
    frames are pixel-compatible with live renders."""
    h, w = img_hw

    def to_px(pos):
        col = int((pos[0] + 0.5) / 1.0 * (w - 1))
        row = int((pos[1] + 0.5) / 1.0 * (h - 1))
        return np.clip(row, 0, h - 1), np.clip(col, 0, w - 1)

    img = np.full((h, w, 3), 20 + 10 * (task_idx % 16), np.uint8)
    # object: green square
    r, c = to_px(obj_pos)
    img[max(r - 2, 0) : r + 3, max(c - 2, 0) : c + 3, 1] = 230
    # EE: red square whose intensity encodes height. Forced ODD so ch0
    # always differs from the (even, 20 + 10k) background — the invariant
    # `fake_oracle.decode_frame`'s EE mask rests on; costs <=1/160 of z.
    r, c = to_px(ee_pos)
    shade = np.uint8(np.clip(120 + (ee_pos[2] - 0.4) * 160, 0, 254)) | 1
    img[max(r - 2, 0) : r + 3, max(c - 2, 0) : c + 3, 0] = shade
    # gripper stripe: blue top row block when closed
    if gripper > 0:
        img[0:3, :, 2] = 220
    # timestep tick marks so consecutive frames always differ
    img[h - 1, t % w, :] = 255
    return img


class _FakeSim:
    def __init__(self, task_idx: int, seed: int, img_hw: Tuple[int, int],
                 step_scale: float, grasp_radius: float,
                 obj_window_xy: float = 0.06):
        self.task_idx = task_idx
        self.seed = seed
        self.img_hw = img_hw
        self.step_scale = step_scale
        self.grasp_radius = grasp_radius
        self.obj_window_xy = obj_window_xy
        rs = np.random.RandomState(seed % (2**31 - 1))
        self.ee_pos = np.asarray([0.0, 0.0, 0.8], np.float32) + rs.uniform(
            -0.05, 0.05, 3
        ).astype(np.float32)
        self.obj_pos = rs.uniform(
            [-0.25, -0.25, 0.45], [0.25, 0.25, 0.47], 3
        ).astype(np.float32)
        self.gripper = -1.0  # open
        self.t = 0
        self.done = False

    def step(self, action: np.ndarray):
        action = np.asarray(action, np.float32)
        delta = np.clip(action[:3], -1, 1) * self.step_scale
        self.ee_pos = np.clip(
            self.ee_pos + delta,
            [-0.5, -0.5, 0.4],
            [0.5, 0.5, 1.2],
        ).astype(np.float32)
        self.gripper = float(np.clip(action[6], -1, 1))
        self.t += 1
        dist = float(np.linalg.norm(self.ee_pos - self.obj_pos))
        success = self.gripper > 0.5 and dist < self.grasp_radius
        self.done = self.done or success
        reward = -dist
        return self.obs(), reward, self.done, {"dist": dist}

    def obs(self) -> dict:
        return {
            "robot0_eef_pos": self.ee_pos.copy(),
            "obj_pos": self.obj_pos.copy(),
            "gripper": self.gripper,
            "t": self.t,
        }

    def render(self, cam: str) -> np.ndarray:
        return render_state(
            self.task_idx, self.ee_pos, self.obj_pos, self.gripper,
            self.t, self.img_hw,
        )

    def render_depth(self, cam: str) -> np.ndarray:
        """Metric depth seen from the wrist cam looking down: the window
        under the gripper sees the object's top if the EE is above the
        object, else the table plane at z=0.4."""
        h, w = self.img_hw
        table_z = 0.4
        xy_dist = float(np.linalg.norm(self.ee_pos[:2] - self.obj_pos[:2]))
        depth = np.full((h, w), self.ee_pos[2] - table_z, np.float32)
        if xy_dist < self.obj_window_xy:
            # the object fills the heuristic's center-bottom window
            h_st, h_e = round(h * 0.75), round(h * 0.82)
            w_st, w_e = round(w * 0.35), round(w * 0.65)
            depth[h_st:h_e, w_st:w_e] = max(
                self.ee_pos[2] - self.obj_pos[2], 0.01
            )
        return np.abs(depth)


class FakeEnvList(EnvList):
    """EnvList over `num_tasks` synthetic tasks with the reference's lazy
    one-at-a-time lifecycle."""

    def __init__(
        self,
        num_tasks: int = 8,
        num_envs_per_task: int = 1,
        train_seed_start: int = 10000,
        img_hw: Tuple[int, int] = (128, 128),
        step_scale: float = 0.02,
        grasp_radius: float = 0.08,
        task_names: Optional[List[str]] = None,
        task_idx_offset: int = 65,
        np_seed: int = 2727,
        obj_window_xy: float = 0.06,
    ):
        self.task_list = task_names or [
            f"fake task {i} pick up the block" for i in range(num_tasks)
        ]
        self.camera_list = ["agent"]
        self.task_to_task_idx = {
            t: task_idx_offset + i for i, t in enumerate(self.task_list)
        }
        self.seed_sets = make_seed_sets(
            self.task_list, train_seed_start, num_envs_per_task
        )
        self.img_hw = img_hw
        self.step_scale = step_scale
        self.grasp_radius = grasp_radius
        # xy radius within which the wrist-cam depth window "sees" the
        # object (drives the grasp heuristic's trigger). The learn-gate
        # env widens it to 0.12 so the trigger matches the policy's
        # reachable alignment precision at 32x32 rendering.
        self.obj_window_xy = obj_window_xy
        self.np_random = np.random.default_rng(np_seed)
        self._live: Dict[Tuple[str, int], _FakeSim] = {}
        self.actual_env_seeds: Dict[Tuple[str, int], int] = {}

    # -- lifecycle --------------------------------------------------------

    def init_1_given_env(self, task, env_idx, e_seed=None, is_rand=True):
        self.check_no_envs_exist()
        if e_seed is not None:
            seed = int(e_seed)
        elif is_rand:
            seed = int(self.np_random.integers(0, 99999999))
        else:
            seed = env_idx
        sim = _FakeSim(
            self.task_to_task_idx[task], seed, self.img_hw,
            self.step_scale, self.grasp_radius,
            obj_window_xy=self.obj_window_xy,
        )
        self._live[(task, env_idx)] = sim
        self.actual_env_seeds[(task, env_idx)] = seed
        self.step_zero_act_1_env(task, env_idx)
        return sim

    def close_1_given_env(self, task, env_idx):
        del self._live[(task, env_idx)]

    def _is_alive(self, task, env_idx) -> bool:
        return (task, env_idx) in self._live

    # -- interaction ------------------------------------------------------

    def _sim(self, task, env_idx) -> _FakeSim:
        return self._live[(task, env_idx)]

    def step_an_env(self, task, env_idx, action):
        return self._sim(task, env_idx).step(action)

    def render_an_env(self, task, cam, env_idx):
        return self._sim(task, env_idx).render(cam)

    def render_an_env_with_depth(self, task, cam, env_idx):
        sim = self._sim(task, env_idx)
        return sim.render(cam), sim.render_depth(cam)

    def get_an_env_obs(self, task, env_idx):
        return self._sim(task, env_idx).obs()
