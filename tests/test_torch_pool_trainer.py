"""The port's concurrent `OnlineTrainer` against the JAX package's, on the
CPU (needs flax for the JAX trainer).

Both trainers are built by their `build_experiment` from `fake_smoke` with
the scripted oracle video model, the port's policy carried across from the
JAX trainer's by `train_state_from_jax`, and the rollouts' policy replaced
on both sides by one numpy stub. Then the same cycles run on each side:
pool-parallel (`n_env_workers=2`, each side its own pool), pool-parallel
and pipelined, serial and pipelined, and pool-parallel and overlapped (each
cycle on a worker thread, committed at the join). After them both trainers hold
equal buffers, counters and `np_rng` states. The JAX side runs no train
step and no DDIM program.
"""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_online import JAX_SMOKE, SMALL_TRUNK, SMOKE, _stub  # noqa: E402
from test_torch_policy import random_params  # noqa: E402
from v2a_tpu.config import load_config_module as jload_config  # noqa: E402
from v2a_tpu.models import policy as jpolicy  # noqa: E402
from v2a_tpu.train import build as jbuild  # noqa: E402
from v2a_tpu_torch.config import load_config_module  # noqa: E402
from v2a_tpu_torch.convert.from_jax import train_state_from_jax  # noqa: E402
from v2a_tpu_torch.train import build as tbuild  # noqa: E402


def _batch_stub(img_obs01, img_goal01):
    """The batched executor's policy on both sides: `_stub` per row."""
    return np.stack([_stub(o[None], g[None]) for o, g in zip(img_obs01, img_goal01)])


# the seeded JAX policy weights per policy config, made once for every case
# (tracing the policy for their shapes takes over a second)
_PARAMS = {}


def _pair(tmp, **overrides):
    """The JAX and the port trainer on fake_smoke with `overrides` on the
    experiment tree (trainer fields under `trainer`)."""
    trainer_kw = overrides.pop("trainer", {})
    sides = []
    for load, path in ((jload_config, JAX_SMOKE), (load_config_module, SMOKE)):
        cfg = load(path)
        cfg = cfg.replace(video_model_kind="oracle", seed=3,
                          policy=dataclasses.replace(cfg.policy, **SMALL_TRUNK),
                          trainer=dataclasses.replace(cfg.trainer, **trainer_kw), **overrides)
        sides.append(cfg)
    jcfg, tcfg = sides

    def init(self, rng):  # seeded numpy weights: flax's eager init takes long here
        key = repr(self.config)
        if key not in _PARAMS:
            h, w = self.config.image_size
            _PARAMS[key] = random_params(
                self.nets, {k: jnp.zeros((1, h, w, 3)) for k in self.config.obs_keys},
                jnp.zeros((1, self.config.horizon, self.config.action_dim)),
                jnp.zeros((1,), jnp.int32), seed=12)
        return _PARAMS[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpolicy.DiffusionPolicy, "init", init)
        jt, *_ = jbuild.build_experiment(jcfg, str(tmp / "jax"), snapshot=False)
    tt, *_ = tbuild.build_experiment(tcfg.replace(device="cpu"), str(tmp / "port"),
                                     snapshot=False)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    tt.start_from(train_state_from_jax(to_np(jt.state.params), to_np(jt.state.ema_params),
                                       jt.state.step))
    for t in (jt, tt):
        t.executor.policy_fn = _stub
        if t._batched_executor is not None:
            t._batched_executor.policy_fn = _batch_stub
    return jt, tt


@pytest.mark.parametrize("workers,pipeline,overlap,cycles",
                         [(2, False, False, 2), (2, True, False, 2), (0, True, False, 3),
                          (2, False, True, 2)],
                         ids=["pool", "pool_pipelined", "serial_pipelined", "pool_overlapped"])
def test_concurrent_cycles_match_jax(tmp_path, workers, pipeline, overlap, cycles):
    """Overlapped cycles spawn on the worker thread and join on the main
    one: the spawn's one `np_rng` draw seeds the worker's own stream."""
    jt, tt = _pair(tmp_path, n_env_workers=workers,
                   trainer=dict(pipeline_explore=pipeline, overlap_explore=overlap))
    try:
        assert (tt.env_pool is None) == (jt.env_pool is None) == (workers == 0)
        for _ in range(cycles):
            for t in (jt, tt):
                if overlap:
                    t._spawn_explore()
                    t._join_explore()
                    assert t._explore_thread is None
                else:
                    t.video_guided_explore()
        assert len(tt.envBuf_vid) == len(jt.envBuf_vid) == 2 * cycles
        assert tt.envBuf_vid.cnt_all_history_episodes == jt.envBuf_vid.cnt_all_history_episodes
        for a, b in zip(jt.envBuf_vid.export_episodes(), tt.envBuf_vid.export_episodes()):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert tt._counters() == jt._counters()
        assert tt.np_rng.bit_generator.state == jt.np_rng.bit_generator.state
        if workers:
            assert tt._pool_task_offset == jt._pool_task_offset
        if pipeline:
            js, ts = jt._video_prefetch, tt._video_prefetch
            assert ts.assignments == js.assignments and ts.seeds == js.seeds
            np.testing.assert_array_equal(ts.videos_u8(), js.videos_u8())
    finally:
        for t in (jt, tt):
            if t.env_pool is not None:
                t.env_pool.close()
    for t in (jt, tt):
        t.envs.check_no_envs_exist()
