"""Abstract environment-list interface.

A copy of `v2a_tpu/envs/base.py` (the port keeps its own).

The contract is distilled from the reference's `LiberoEnvList_V3`
(`environment/libero/lb_env_v3.py:15-522`): a set of tasks, each with a set
of env "slots" keyed by seed, where AT MOST ONE concrete simulator instance
is alive at a time (the reference enforces this lazy one-env-at-a-time
lifecycle to dodge EGL offscreen-render corruption, `lb_env_v3.py:355-357`,
`check_no_envs_exist` `:268-273`). The trainer/evaluator drive environments
exclusively through this interface, so a fake backend can replace MuJoCo in
CI and the simulator never needs to exist on the accelerator's host path.

Conventions:
- actions are float (action_dim,) numpy arrays (Libero: 7-d delta EE pose +
  gripper),
- renders are uint8 (H, W, 3) numpy arrays; depth renders are metric float
  (H, W) or (H, W, 1),
- `step` returns (obs_dict, reward, done, info); `done` doubles as the
  success signal as in the reference rollouts
  (`lb_online_trainer_v7.py:1101-1111`, `lb_eval_helper.py:312-323`).
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class EnvList(abc.ABC):
    """N tasks x M seeds of lazily-instantiated environments."""

    task_list: List[str]
    camera_list: List[str]
    seed_sets: Dict[str, List[int]]
    task_to_task_idx: Dict[str, int]
    action_dim: int = 7

    # -- lifecycle --------------------------------------------------------

    @abc.abstractmethod
    def init_1_given_env(
        self,
        task: str,
        env_idx: int,
        e_seed: Optional[int] = None,
        is_rand: bool = True,
    ):
        """Create and reset the env for (task, env_idx). Must assert no other
        env is alive first. With `e_seed` given, it wins; otherwise a random
        seed when `is_rand` else the deterministic slot seed
        (`lb_env_v3.py:203-244`)."""

    @abc.abstractmethod
    def close_1_given_env(self, task: str, env_idx: int):
        """Destroy the live env in this slot (`lb_env_v3.py:245-252`)."""

    def close_exist_env(self):
        """Close whichever single env is alive, if any
        (`lb_env_v3.py:253-267`)."""
        for task in self.task_list:
            for idx in self.seed_sets[task]:
                if self._is_alive(task, idx):
                    self.close_1_given_env(task, idx)

    def check_no_envs_exist(self):
        for task in self.task_list:
            for idx in self.seed_sets[task]:
                if self._is_alive(task, idx):
                    raise RuntimeError(
                        f"env still alive for task={task!r} idx={idx}; the "
                        "one-env-at-a-time invariant is violated"
                    )

    @abc.abstractmethod
    def _is_alive(self, task: str, env_idx: int) -> bool:
        ...

    # -- interaction ------------------------------------------------------

    @abc.abstractmethod
    def step_an_env(
        self, task: str, env_idx: int, action: np.ndarray
    ) -> Tuple[dict, float, bool, dict]:
        ...

    @abc.abstractmethod
    def render_an_env(self, task: str, cam: str, env_idx: int) -> np.ndarray:
        """uint8 (H, W, 3)."""

    @abc.abstractmethod
    def render_an_env_with_depth(
        self, task: str, cam: str, env_idx: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb uint8 (H,W,3), metric depth float (H,W) or (H,W,1))."""

    @abc.abstractmethod
    def get_an_env_obs(self, task: str, env_idx: int) -> dict:
        """Raw observation dict; must include 'robot0_eef_pos' (3,) for the
        grasp heuristic (`lb_online_trainer_v7.py:1160-1162`)."""

    # -- bookkeeping ------------------------------------------------------

    def step_zero_act_1_env(self, task: str, env_idx: int, n: int = 10):
        """Settle steps after reset (`lb_env_v3.py:306-317`)."""
        ret = None
        zero = np.zeros((self.action_dim,), np.float32)
        for _ in range(n):
            ret = self.step_an_env(task, env_idx, zero)
        return ret


def make_seed_sets(
    task_list: Sequence[str], train_seed_start: int, num_envs_per_task: int
) -> Dict[str, List[int]]:
    """Per-task disjoint seed slots (`lb_env_v3.py:322-343`)."""
    seed_sets = {}
    for i_tk, task in enumerate(task_list):
        start = train_seed_start + i_tk * num_envs_per_task
        seed_sets[task] = sorted(range(start, start + num_envs_per_task))
    return seed_sets
