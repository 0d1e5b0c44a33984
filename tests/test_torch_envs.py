"""The port's env layer against the JAX package's, on the CPU: the fake
world's renders, depth, observations, done and success for a seeded action
sequence (the oracle's grasp included), the seed sets and the registry, the
random-action sampler, and the scripted oracle. Host-side numpy on both
sides, so every comparison is exact."""

import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu.envs import base as jbase  # noqa: E402
from v2a_tpu.envs import constants as jconst  # noqa: E402
from v2a_tpu.envs import fake as jfake  # noqa: E402
from v2a_tpu.envs import fake_oracle as joracle  # noqa: E402
from v2a_tpu.envs import randsam as jrandsam  # noqa: E402
from v2a_tpu.envs import registration as jreg  # noqa: E402
from v2a_tpu_torch.envs import base as tbase  # noqa: E402
from v2a_tpu_torch.envs import constants as tconst  # noqa: E402
from v2a_tpu_torch.envs import fake as tfake  # noqa: E402
from v2a_tpu_torch.envs import fake_oracle as toracle  # noqa: E402
from v2a_tpu_torch.envs import randsam as trandsam  # noqa: E402
from v2a_tpu_torch.envs import registration as treg  # noqa: E402


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("env_kw", [dict(num_tasks=2, img_hw=(32, 32)),
                                    dict(num_tasks=2, img_hw=(32, 32), step_scale=0.05,
                                         grasp_radius=0.15, obj_window_xy=0.12)],
                         ids=["smoke", "learn"])
def test_fake_env_steps_like_jax(env_kw):
    """Oracle actions from the JAX side's observations, with noise, drive
    both lists; every render (agent and gripper depth), observation, reward,
    done and info agree, and the closed gripper at the object succeeds."""
    envs = (jfake.FakeEnvList(**env_kw), tfake.FakeEnvList(**env_kw))
    rng = np.random.default_rng(3)
    task = envs[0].task_list[1]
    idx = envs[0].seed_sets[task][0]
    succeeded = False
    for e in envs:
        e.init_1_given_env(task, idx, is_rand=True)  # from each list's own np_random
    assert envs[0].actual_env_seeds == envs[1].actual_env_seeds
    for t in range(60):
        obs = [e.get_an_env_obs(task, idx) for e in envs]
        _equal(*obs)
        act = joracle.oracle_action(obs[0]["robot0_eef_pos"], obs[0]["obj_pos"],
                                    envs[0].step_scale, envs[0].grasp_radius)
        act = np.clip(act + rng.normal(0, 0.05, 7), -1, 1).astype(np.float32)
        outs = [e.step_an_env(task, idx, act) for e in envs]
        for o in outs[1:]:
            _equal(outs[0][0], o[0])
            assert outs[0][1:] == o[1:]
        succeeded |= bool(outs[1][2])
        _equal(envs[0].render_an_env(task, "agent", idx), envs[1].render_an_env(task, "agent", idx))
        for a, b in zip(envs[0].render_an_env_with_depth(task, "gripper", idx),
                        envs[1].render_an_env_with_depth(task, "gripper", idx)):
            _equal(a, b)
    assert succeeded
    for e in envs:
        e.close_1_given_env(task, idx)
        e.check_no_envs_exist()
    envs[1].init_1_given_env(task, idx, e_seed=1)
    other = envs[1].task_list[0]
    with pytest.raises(RuntimeError, match="one-env-at-a-time"):
        envs[1].init_1_given_env(other, envs[1].seed_sets[other][0], e_seed=1)


def test_seed_sets_registry_and_tables(monkeypatch):
    tasks = [f"t{i}" for i in range(5)]
    assert tbase.make_seed_sets(tasks, 100, 3) == jbase.make_seed_sets(tasks, 100, 3)
    assert sorted(treg._REGISTRY) == sorted(jreg._REGISTRY)
    for name in ("fake-8tk-v0", "fake-2tk-small-v0", "fake-2tk-v0", "fake-2tk-learn-v0"):
        j, t = jreg.make_env_list(name), treg.make_env_list(name)
        for attr in ("task_list", "camera_list", "seed_sets", "task_to_task_idx", "img_hw",
                     "step_scale", "grasp_radius", "obj_window_xy", "action_dim"):
            assert getattr(j, attr) == getattr(t, attr), (name, attr)
    # without LIBERO both registries raise the JAX package's ImportError
    monkeypatch.setitem(sys.modules, "libero", None)
    errors = []
    for reg in (jreg, treg):
        with pytest.raises(ImportError) as e:
            reg.make_env_list("libero-8tk-65to72-v3")
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "LIBERO is not installed" in errors[0]
    with pytest.raises(KeyError):
        treg.make_env_list("no-such-list")
    assert tconst.MW_INTERACTION_TYPES == jconst.MW_INTERACTION_TYPES
    assert tconst.THOR_INTERACTION_TYPES == jconst.THOR_INTERACTION_TYPES
    assert tconst.interaction_type("thor", "Mug") == jconst.interaction_type("thor", "Mug")


def test_rand_sample_1_ep_matches_jax():
    """The random-action sampler from one seed: frames, actions and EE
    poses equal (the reflection off the workspace box included)."""
    outs = []
    for mod_env, mod_rs in ((jfake, jrandsam), (tfake, trandsam)):
        envs = mod_env.FakeEnvList(num_tasks=2, img_hw=(32, 32), step_scale=0.05)
        task = envs.task_list[0]
        idx = envs.seed_sets[task][0]
        rng = np.random.default_rng(11)
        eps = []
        for _ in range(2):
            envs.init_1_given_env(task, idx, is_rand=True)
            eps.append(mod_rs.rand_sample_1_ep(envs, task, idx,
                                               mod_rs.RandSamConfig(rand_ep_len=40), rng))
            envs.close_1_given_env(task, idx)
        outs.append(eps)
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            _equal(x, y)
    assert len(outs[1][0][1]) >= 40


def test_oracle_matches_jax():
    """`decode_frame`, `oracle_action`, `collect_oracle_episodes` and the
    oracle video model's frames (float and uint8) equal the JAX package's."""
    jenv = jfake.FakeEnvList(num_tasks=2, img_hw=(32, 32))
    tenv = tfake.FakeEnvList(num_tasks=2, img_hw=(32, 32))
    ja = joracle.collect_oracle_episodes(jenv, 2, 12, np.random.default_rng(5), action_noise=0.1)
    ta = toracle.collect_oracle_episodes(tenv, 2, 12, np.random.default_rng(5), action_noise=0.1)
    assert len(ja) == len(ta) == 4
    for a, b in zip(ja, ta):
        _equal({k: v for k, v in a.items()}, {k: v for k, v in b.items()})
    frames = np.stack([ep["imgs"][i] for ep in ta for i in (0, 6, 12)])
    for f in frames:
        _equal(toracle.decode_frame(f), joracle.decode_frame(f))
        _equal(toracle.decode_frame(f.astype(np.float32) / 255.0),
               joracle.decode_frame(f.astype(np.float32) / 255.0))
        d = toracle.decode_frame(f)
        _equal(toracle.oracle_action(d["ee_pos"], d["obj_pos"], 0.02, 0.08),
               joracle.oracle_action(d["ee_pos"], d["obj_pos"], 0.02, 0.08))
    jvm = joracle.FakeOracleVideoModel(jenv.task_to_task_idx, horizon=5)
    tvm = toracle.FakeOracleVideoModel(tenv.task_to_task_idx, horizon=5)
    imgs01 = frames[:2].astype(np.float32) / 255.0
    tasks = [tenv.task_list[0], tenv.task_list[1]]
    _equal(tvm.sample(None, imgs01, tasks), jvm.sample(None, imgs01, tasks))
    _equal(tvm.sample_u8(None, imgs01, tasks), jvm.sample_u8(None, imgs01, tasks))
    _equal(tvm.video_fn(imgs01[0], tasks[0]), jvm.video_fn(imgs01[0], tasks[0]))
