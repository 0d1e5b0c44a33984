"""LIBERO/MuJoCo environment adapter.

A copy of `v2a_tpu/envs/libero.py` on the port's `envs/base.py`: the
`EnvList` contract on top of LIBERO's `OffScreenRenderEnv`, mirroring
`environment/libero/lb_env_v3.py:15-522`:

- task resolution from a benchmark suite (task index -> language + bddl),
- lazy one-env-at-a-time lifecycle with the EGL-safety invariant,
- camera-name translation agent->agentview_image /
  gripper->robot0_eye_in_hand_image (`environment/libero/lb_utils.py:6-28`),
- metric depth conversion near/(1 - d*(1 - near/far))
  (`lb_env_v3.py:380-403`),
- 10 zero-action settle steps after reset (`lb_env_v3.py:306-317`).

Host numpy code only, no torch: LIBERO/robosuite are CPU-host dependencies,
imported when a list is built, which raises `ImportError` when they are
absent (the fake env lists run without them).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from v2a_tpu_torch.envs.base import EnvList, make_seed_sets

_CAM_MAP = {
    "agent": "agentview_image",
    "gripper": "robot0_eye_in_hand_image",
}


def full_cam_name(cam: str, is_depth: bool = False) -> str:
    """`lb_full_cam_name` (`environment/libero/lb_utils.py:6-28`)."""
    name = _CAM_MAP.get(cam, cam)
    if is_depth:
        name = name.replace("_image", "_depth")
    return name


class LiberoEnvList(EnvList):
    def __init__(
        self,
        task_suite_name: str = "libero_90",
        task_idx_list: Optional[List[int]] = None,
        num_envs_per_task: int = 1,
        train_seed_start: int = 10000,
        eval_seed_start: int = 100,
        camera_heights: int = 128,
        camera_widths: int = 128,
        np_seed: int = 2727,
        **_: dict,
    ):
        try:
            from libero.libero import benchmark, get_libero_path
            from libero.libero.envs import OffScreenRenderEnv
        except ImportError as e:
            raise ImportError(
                "LIBERO is not installed; use the 'fake-*' env lists for "
                "simulator-free runs"
            ) from e
        self._OffScreenRenderEnv = OffScreenRenderEnv

        task_idx_list = task_idx_list or list(range(65, 73))
        suite = benchmark.get_benchmark_dict()[task_suite_name]()

        self.task_list = []
        self.task_dirname_list = []
        self.task_to_task_idx = {}
        self._env_args: Dict[str, dict] = {}
        for task_id in task_idx_list:
            task = suite.get_task(task_id)
            lang = task.language
            self.task_list.append(lang)
            self.task_dirname_list.append(task.name)
            self.task_to_task_idx[lang] = task_id
            bddl = os.path.join(
                get_libero_path("bddl_files"), task.problem_folder, task.bddl_file
            )
            self._env_args[lang] = dict(
                bddl_file_name=bddl,
                camera_heights=camera_heights,
                camera_widths=camera_widths,
                camera_depths=True,
            )

        self.camera_list = ["agent"]
        self.seed_sets = make_seed_sets(
            self.task_list, train_seed_start, num_envs_per_task
        )
        self.eval_seed_start = eval_seed_start
        self.np_random = np.random.default_rng(np_seed)
        self._live: Dict[Tuple[str, int], object] = {}
        self.actual_env_seeds: Dict[Tuple[str, int], int] = {}

    # -- lifecycle --------------------------------------------------------

    def init_1_given_env(self, task, env_idx, e_seed=None, is_rand=True):
        self.check_no_envs_exist()
        env = self._OffScreenRenderEnv(**self._env_args[task])
        if e_seed is not None:
            seed = int(e_seed)
        elif is_rand:
            seed = int(self.np_random.integers(0, 99999999))
        else:
            seed = env_idx
        env.seed(seed)
        env.reset()
        self._live[(task, env_idx)] = env
        self.actual_env_seeds[(task, env_idx)] = seed
        self.step_zero_act_1_env(task, env_idx)
        return env

    def close_1_given_env(self, task, env_idx):
        env = self._live.pop((task, env_idx))
        env.close()
        del env

    def _is_alive(self, task, env_idx) -> bool:
        return (task, env_idx) in self._live

    # -- interaction ------------------------------------------------------

    def _env(self, task, env_idx):
        return self._live[(task, env_idx)]

    def step_an_env(self, task, env_idx, action):
        return self._env(task, env_idx).step(np.asarray(action, np.float32))

    def render_an_env(self, task, cam, env_idx):
        obs = self._env(task, env_idx).env._get_observations()
        return obs[full_cam_name(cam)]

    def render_an_env_with_depth(self, task, cam, env_idx):
        env = self._env(task, env_idx)
        obs = env.env._get_observations()
        img = obs[full_cam_name(cam)]
        dep = obs[full_cam_name(cam, is_depth=True)]
        # OpenGL depth buffer -> metric (`lb_env_v3.py:380-403`)
        extent = env.env.sim.model.stat.extent
        near = env.env.sim.model.vis.map.znear * extent
        far = env.env.sim.model.vis.map.zfar * extent
        dep = near / (1.0 - dep * (1.0 - near / far))
        if not (dep >= 0).all():
            raise AssertionError("negative metric depth")
        return img, dep

    def get_an_env_obs(self, task, env_idx):
        return self._env(task, env_idx).env._get_observations()
