"""Environment registry.

A copy of `v2a_tpu/envs/registration.py`: configs refer to env lists by
name and the trainer calls `make_env_list(name)`. The fake lists and the
LIBERO suites are registered under the same names; a LIBERO suite builds
the port's `envs/libero.py::LiberoEnvList`, imported when the list is
built, which raises `ImportError` where LIBERO is not installed.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_env_list(name: str, factory: Callable, **default_kwargs):
    def build(**overrides):
        kwargs = {**default_kwargs, **overrides}
        return factory(**kwargs)

    _REGISTRY[name] = build


def make_env_list(name: str, **overrides):
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown env list {name!r}; registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](**overrides)


def _libero(**kwargs):
    # constructed lazily so the LIBERO import only happens if actually requested
    from v2a_tpu_torch.envs.libero import LiberoEnvList

    return LiberoEnvList(**kwargs)


def _register_defaults():
    from v2a_tpu_torch.envs.fake import FakeEnvList

    # CI / hermetic stand-ins
    register_env_list("fake-8tk-v0", FakeEnvList, num_tasks=8)
    register_env_list("fake-2tk-small-v0", FakeEnvList, num_tasks=2, img_hw=(32, 32))
    # the fake_smoke config's dataset (32x32, 2 tasks)
    register_env_list("fake-2tk-v0", FakeEnvList, num_tasks=2, img_hw=(32, 32))
    # the learning-gate world (config/fake/fake_learn.py): faster EE + wider
    # grasp radius so the closed loop converges in CI time
    register_env_list(
        "fake-2tk-learn-v0", FakeEnvList,
        num_tasks=2, img_hw=(32, 32), step_scale=0.05, grasp_radius=0.15,
        obj_window_xy=0.12,
    )

    # the Libero suites of `init_libero.py:25-77`
    register_env_list(
        "libero-8tk-65to72-v3", _libero,
        task_suite_name="libero_90",
        task_idx_list=list(range(65, 73)),
        num_envs_per_task=1,
        train_seed_start=10000,
        eval_seed_start=100,
    )
    register_env_list(
        "libero-1tk-65-v3", _libero,
        task_suite_name="libero_90",
        task_idx_list=[65],
        num_envs_per_task=1,
        train_seed_start=10000,
        eval_seed_start=100,
    )


_register_defaults()
