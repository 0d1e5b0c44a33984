"""The port's LIBERO env list against the JAX package's, on the CPU.

LIBERO is not installed here, so both wrappers run on one stub of the API
they call (`libero.libero.benchmark.get_benchmark_dict`, `get_libero_path`,
`libero.libero.envs.OffScreenRenderEnv` with `seed`, `reset`, `step`,
`close`, `env._get_observations()` and `env.sim.model.stat.extent` /
`vis.map.znear, zfar`), put in `sys.modules`. The stub's worlds are seeded
numpy, so the two wrappers' task tables, seeds, settle steps, steps,
renders and metric depths must be equal, element for element. Without the
stub both raise the same `ImportError`."""

import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from v2a_tpu.envs import libero as jlibero  # noqa: E402
from v2a_tpu.envs import registration as jreg  # noqa: E402
from v2a_tpu_torch.envs import libero as tlibero  # noqa: E402
from v2a_tpu_torch.envs import registration as treg  # noqa: E402

SUITES = ("libero-8tk-65to72-v3", "libero-1tk-65-v3")
HW = (16, 12)


class _StubEnv:
    """`OffScreenRenderEnv`: every instance is logged in `made`; its frames
    and depth buffers are drawn from the seed and the step count."""

    made = None  # the per-test log, set by `libero_stub`
    negative_depth = False

    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.actions, self.closed, self.seed_value, self.t = [], False, None, 0
        self.env = types.SimpleNamespace(
            _get_observations=self._observations,
            sim=types.SimpleNamespace(model=types.SimpleNamespace(
                stat=types.SimpleNamespace(extent=2.5),
                vis=types.SimpleNamespace(map=types.SimpleNamespace(znear=0.01, zfar=50.0)))))
        _StubEnv.made.append(self)

    def seed(self, seed):
        self.seed_value = seed

    def reset(self):
        self.t = 0
        return self._observations()

    def step(self, action):
        self.actions.append(np.array(action))
        self.t += 1
        return self._observations(), 0.5 * self.t, self.t >= 13, {"t": self.t}

    def close(self):
        self.closed = True

    def _observations(self):
        rs = np.random.RandomState((self.seed_value * 7919 + self.t) % 2 ** 31)
        h, w = self.kwargs["camera_heights"], self.kwargs["camera_widths"]
        obs = {}
        for cam in ("agentview", "robot0_eye_in_hand"):
            obs[cam + "_image"] = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
            depth = rs.uniform(0.05, 0.95, (h, w, 1)).astype(np.float32)
            obs[cam + "_depth"] = depth + 2.0 if self.negative_depth else depth
        obs["robot0_eef_pos"] = rs.randn(3).astype(np.float32)
        return obs


def _task(i):
    return types.SimpleNamespace(language=f"pick up object {i} and place it",
                                 name=f"KITCHEN_SCENE{i}_pick_up_object_{i}",
                                 problem_folder="libero_90", bddl_file=f"scene_{i}.bddl")


class _Suite:
    def get_task(self, i):
        return _task(i)


@pytest.fixture
def libero_stub(monkeypatch):
    """LIBERO's API as stub modules; yields the log of built envs."""
    made = []
    monkeypatch.setattr(_StubEnv, "made", made)
    monkeypatch.setattr(_StubEnv, "negative_depth", False)
    root = types.ModuleType("libero")
    pkg = types.ModuleType("libero.libero")
    bench = types.ModuleType("libero.libero.benchmark")
    envs = types.ModuleType("libero.libero.envs")
    bench.get_benchmark_dict = lambda: {"libero_90": _Suite, "libero_10": _Suite}
    pkg.benchmark, pkg.envs = bench, envs
    pkg.get_libero_path = lambda kind: f"/stub/libero/{kind}"
    envs.OffScreenRenderEnv = _StubEnv
    root.libero = pkg
    for name, mod in (("libero", root), ("libero.libero", pkg),
                      ("libero.libero.benchmark", bench), ("libero.libero.envs", envs)):
        monkeypatch.setitem(sys.modules, name, mod)
    yield made


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _drive(envs, made):
    """Three inits (random, given, slot seed) of the first slot, each with
    its settle steps, steps, renders and depths; then the one-env invariant
    and the negative-depth assertion. Returns what a caller could see."""
    task = envs.task_list[0]
    idx = envs.seed_sets[task][0]
    seen = []
    for kw in (dict(), dict(e_seed=123), dict(is_rand=False)):
        start = len(made)
        envs.init_1_given_env(task, idx, **kw)
        env = made[start]
        settle = [a.copy() for a in env.actions]
        steps = [envs.step_an_env(task, idx, np.full(7, 0.1 * k, np.float64)) for k in range(3)]
        seen.append(dict(
            seed=envs.actual_env_seeds[(task, idx)], settle=settle, kwargs=env.kwargs,
            steps=steps, render=envs.render_an_env(task, "agent", idx),
            gripper=envs.render_an_env(task, "gripper", idx),
            depth=envs.render_an_env_with_depth(task, "agent", idx),
            obs=envs.get_an_env_obs(task, idx), step_dtype=str(env.actions[-1].dtype)))
        if len(envs.task_list) > 1:
            other = envs.task_list[1]
            with pytest.raises(RuntimeError, match="one-env-at-a-time"):
                envs.init_1_given_env(other, envs.seed_sets[other][0])
        envs.close_1_given_env(task, idx)
        assert env.closed
        envs.check_no_envs_exist()
    envs.init_1_given_env(task, idx, e_seed=5)
    with pytest.raises(RuntimeError, match="one-env-at-a-time"):
        envs.init_1_given_env(task, idx, e_seed=6)
    _StubEnv.negative_depth = True
    try:
        with pytest.raises(AssertionError, match="negative metric depth"):
            envs.render_an_env_with_depth(task, "gripper", idx)
    finally:
        _StubEnv.negative_depth = False
    envs.close_exist_env()
    envs.check_no_envs_exist()
    return seen


@pytest.mark.parametrize("name", SUITES)
def test_libero_env_list_matches_jax(libero_stub, name):
    """Both registered suites on the stub: the port's registry builds the
    port's `LiberoEnvList`; task list, dirnames, task indices, seed sets,
    env arguments, the seeds of three inits (the `np_seed` stream, a given
    seed, the slot seed), the 10 zero-action settle steps, steps, renders,
    metric depths and observations equal to the JAX wrapper's, and the same
    refusals (a second live env, negative metric depth)."""
    made = libero_stub
    lists = [reg.make_env_list(name, camera_heights=HW[0], camera_widths=HW[1])
             for reg in (jreg, treg)]
    assert type(lists[0]) is jlibero.LiberoEnvList
    assert type(lists[1]) is tlibero.LiberoEnvList
    j, t = lists
    for attr in ("task_list", "task_dirname_list", "task_to_task_idx", "seed_sets",
                 "camera_list", "eval_seed_start", "_env_args", "action_dim"):
        assert getattr(j, attr) == getattr(t, attr), attr
    assert len(t.task_list) == (8 if name.startswith("libero-8tk") else 1)
    assert t.task_to_task_idx[t.task_list[0]] == 65
    assert t._env_args[t.task_list[0]]["bddl_file_name"] == (
        "/stub/libero/bddl_files/libero_90/scene_65.bddl")
    seen = []
    for envs in lists:
        made.clear()
        seen.append(_drive(envs, made))
    _equal(seen[0], seen[1])
    first = seen[1][0]
    assert len(first["settle"]) == 10 and not any(a.any() for a in first["settle"])
    assert first["step_dtype"] == "float32"
    assert [s["seed"] for s in seen[1][1:]] == [123, t.seed_sets[t.task_list[0]][0]]
    depth = first["depth"][1]
    assert depth.shape == (*HW, 1) and (depth > 0).all()
    for cam, key in (("agent", "agentview"), ("gripper", "robot0_eye_in_hand")):
        assert tlibero.full_cam_name(cam) == jlibero.full_cam_name(cam) == key + "_image"
        depth_name = tlibero.full_cam_name(cam, True)
        assert depth_name == jlibero.full_cam_name(cam, True) == key + "_depth"


def test_libero_without_libero_raises_the_jax_import_error(monkeypatch):
    """Without LIBERO both wrappers, built directly or through the registry,
    raise `ImportError` with the same message, chained to the failed
    import."""
    monkeypatch.setitem(sys.modules, "libero", None)
    errors = []
    for build in (jlibero.LiberoEnvList, tlibero.LiberoEnvList,
                  lambda: jreg.make_env_list("libero-1tk-65-v3"),
                  lambda: treg.make_env_list("libero-1tk-65-v3")):
        with pytest.raises(ImportError) as e:
            build()
        assert isinstance(e.value.__cause__, ImportError)
        errors.append(str(e.value))
    assert len(set(errors)) == 1 and "LIBERO is not installed" in errors[0]
