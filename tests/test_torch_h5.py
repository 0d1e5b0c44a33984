"""H5 ingestion of the port against the JAX package's, on the CPU.

- `generate_randsam_dataset` on the fake world from one seed: bit-equal
  episodes; `write_randsam_file` and `scripts/gen_randsam.main`: the same
  datasets in the same layout, chmodded read-only;
- `add_episodes_to_buffer` on one small H5 file (32^2, 2 tasks): equal
  buffer contents and env steps, and one hindsight batch from one seed
  equal on both replay backends and the JAX package's native one;
- `validate_and_clip_actions` raises and clips as the JAX package does;
  `OfflineDataset` loads the same dataset and refuses the same inputs;
- the `from_h5` rounds: the JAX and the port `OnlineTrainer` built from
  the release config (the fake world at 32^2 and a small policy in place
  of LIBERO and the release policy, the file's sizes in place of the
  release file's), their train steps replaced by a step counter on both
  sides: the first fill and a circular sweep that crosses
  `h5_total_num_ep_per_task` give equal `h5_randsam_start_idx`,
  `is_all_randsam_visited`, `num_steps_in_env` and buffer lengths at every
  round, and a port trainer loaded from a checkpoint carries on the sweep.
"""

import os
import stat
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu.data import h5_ingest as jh5  # noqa: E402
from v2a_tpu.data import replay_buffer as jrb  # noqa: E402
from v2a_tpu.envs import offline as joffline  # noqa: E402
from v2a_tpu.envs import randsam as jrandsam  # noqa: E402
from v2a_tpu.envs import registration as jreg  # noqa: E402
from v2a_tpu_torch.data import h5_ingest as th5  # noqa: E402
from v2a_tpu_torch.data import replay_buffer as trb  # noqa: E402
from v2a_tpu_torch.envs import offline as toffline  # noqa: E402
from v2a_tpu_torch.envs import randsam as trandsam  # noqa: E402
from v2a_tpu_torch.envs import registration as treg  # noqa: E402
from v2a_tpu_torch.scripts import gen_randsam as tgen  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "fake-2tk-v0"  # 2 tasks at 32^2
N_EP, EP_LEN, SEED = 3, 40, 5
ACT_MIN, ACT_MAX = np.full(7, -1.0, np.float32), np.full(7, 1.0, np.float32)


@pytest.fixture(scope="module")
def episodes():
    """(JAX, port) `generate_randsam_dataset` on the fake world, one seed."""
    out = []
    for reg, rs in ((jreg, jrandsam), (treg, trandsam)):
        envs = reg.make_env_list(ENV)
        out.append(rs.generate_randsam_dataset(envs, N_EP, rs.RandSamConfig(rand_ep_len=EP_LEN),
                                               seed=SEED))
    return out


@pytest.fixture(scope="module")
def h5file(episodes, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h5") / "randsam.hdf5")
    th5.write_randsam_file(path, episodes[1], read_only=False)
    return path


def _read(path):
    """{dataset path: (dtype, array)} of an H5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, (obj.dtype, obj[:]))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_file(a, b):
    fa, fb = _read(a), _read(b)
    assert sorted(fa) == sorted(fb) and fa
    for k in fa:
        assert fa[k][0] == fb[k][0], k
        np.testing.assert_array_equal(fa[k][1], fb[k][1], err_msg=k)


def test_generate_randsam_dataset_matches_jax(episodes):
    jeps, teps = episodes
    assert list(teps) == list(jeps) == treg.make_env_list(ENV).task_list
    for task in jeps:
        assert len(teps[task]) == len(jeps[task]) == N_EP
        for je, te in zip(jeps[task], teps[task]):
            assert len(te[1]) >= EP_LEN
            for a, b in zip(je, te):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_write_randsam_file_and_gen_randsam_match_jax(episodes, tmp_path):
    from scripts import gen_randsam as jgen

    paths = {}
    for side, h5, eps in (("jax", jh5, episodes[0]), ("port", th5, episodes[1])):
        paths[side] = str(tmp_path / f"{side}.hdf5")
        h5.write_randsam_file(paths[side], eps, read_only=True)
        assert stat.S_IMODE(os.stat(paths[side]).st_mode) == 0o444
    _assert_same_file(paths["jax"], paths["port"])
    argv = ["--env", ENV, "--num_ep_per_task", "2", "--rand_ep_len", "16", "--seed", "3"]
    for side, main in (("jax", jgen.main), ("port", tgen.main)):
        paths[side] = str(tmp_path / "gen" / f"{side}.hdf5")
        main(argv + ["--out", paths[side]])
    _assert_same_file(paths["jax"], paths["port"])


def _assert_same_buffers(a, b):
    assert len(a) == len(b) and a.cnt_all_history_episodes == b.cnt_all_history_episodes
    for ea, eb in zip(a.export_episodes(), b.export_episodes()):
        assert ea.keys() == eb.keys()
        for k in ea:
            np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)


@pytest.mark.parametrize("backend", ["native", "python"])
def test_ingestion_matches_jax(h5file, backend):
    """Two ingestions (episodes [0, 2), then [1, 5) past the file's 3 with
    the env steps no longer counted) into the JAX native buffer and the
    port's: equal env steps and episodes; a hindsight batch of one seed
    equal, and the generator's next draw."""
    task_list = treg.make_env_list(ENV).task_list
    kw = dict(cam="agent", env_idx_per_task={task_list[1]: 7})
    jbuf = jrb.ReplayBuffer(8, 64, 30, 8, backend="native")
    tbuf = trb.ReplayBuffer(8, 64, 30, 8, backend=backend)
    for start, end, count in ((0, 2, True), (1, 5, False)):
        got = th5.add_episodes_to_buffer(h5file, tbuf, task_list, start, end, ACT_MIN, ACT_MAX,
                                         count_env_steps=count, **kw)
        want = jh5.add_episodes_to_buffer(h5file, jbuf, task_list, start, end, ACT_MIN, ACT_MAX,
                                          count_env_steps=count, **kw)
        assert got == want and (got > 0) == count
    assert len(tbuf) == 2 * (2 + 2)
    _assert_same_buffers(jbuf, tbuf)
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    jb, tb = jbuf.sample_batch(16, jr, 8), tbuf.sample_batch(16, tr, 8)
    assert jb.keys() == tb.keys()
    for k in jb:
        if isinstance(jb[k], list):
            assert jb[k] == tb[k], k
        else:
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
    assert tr.integers(1 << 30) == jr.integers(1 << 30)


def test_validate_and_clip_actions_matches_jax():
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    inside = np.array([[-1.011, 0.0, 1.011], [0.5, -0.2, 1.0]], np.float32)
    for mod in (jh5, th5):
        np.testing.assert_array_equal(mod.validate_and_clip_actions(inside, lo, hi),
                                      jh5.validate_and_clip_actions(inside, lo, hi))
    assert th5.validate_and_clip_actions(inside, lo, hi).dtype == np.float32
    assert th5.RANGE_SLACK == jh5.RANGE_SLACK
    for bad, word in (([[-1.013, 0, 0]], "below"), ([[0, 0, 1.013]], "above")):
        bad = np.array(bad, np.float32)
        for mod in (jh5, th5):
            with pytest.raises(mod.H5IngestError, match=word):
                mod.validate_and_clip_actions(bad, lo, hi)
    assert issubclass(th5.H5IngestError, ValueError)


def test_offline_dataset_matches_jax(h5file, tmp_path):
    task = treg.make_env_list(ENV).task_list[0]
    for tasks in (None, [task]):
        jd = joffline.OfflineDataset(h5path=h5file).get_dataset(tasks)
        td = toffline.OfflineDataset(h5path=h5file).get_dataset(tasks)
        assert list(td) == list(jd)
        for t in jd:
            for k in ("observations", "actions"):
                assert len(td[t][k]) == len(jd[t][k]) == N_EP
                for a, b in zip(jd[t][k], td[t][k]):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    assert toffline.filepath_from_name("x") == joffline.filepath_from_name("x")
    for mod in (joffline, toffline):
        with pytest.raises(FileNotFoundError):
            mod.OfflineDataset(h5path=str(tmp_path / "missing.hdf5"))
        with pytest.raises(ValueError):
            mod.OfflineDataset()
        with pytest.raises(KeyError):
            mod.OfflineDataset(h5path=h5file).get_dataset(["no such task"])


# the release config with the fake world, a small policy and the small
# file's sizes; its from_h5 rounds every 2 steps from step 1
OVERRIDES = {
    "dataset": ENV, "env_backend": "fake",
    "policy.image_size": "(32, 32)", "policy.down_dims": "(32, 64)",
    "policy.vision_stage_sizes": "(1, 1)", "policy.vision_stage_features": "(32, 64)",
    "trainer.num_init_rand_ep_per_tk": "2", "trainer.h5_total_num_ep_per_task": str(N_EP),
    "trainer.init_rand_steps": "0", "trainer.rand_explo_freq": "2",
    "trainer.max_episodes_rand": "16", "trainer.max_episodes_vid": "4",
    "trainer.save_freq": "1000", "trainer.log_freq": "1000",
    "trainer.checkpoint_buffers": "true",
}


def _state(t):
    return (t.step, t.h5_randsam_start_idx, t.is_all_randsam_visited, t.num_steps_in_env,
            len(t.envBuf_rand), t.envBuf_rand.cnt_all_history_episodes)


def test_from_h5_rounds_match_jax(h5file, tmp_path):
    """The release config's `rand_explo_type="from_h5"`: the first fill of
    `num_init_rand_ep_per_tk` episodes a task, then a round every 2 steps
    (2 episodes a task of the file's 3, a circular sweep): the sweep state
    and the buffer after every round equal the JAX trainer's; a port
    trainer loaded from the checkpoint at step 5 carries on the sweep."""
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from test_torch_policy import random_params
    from v2a_tpu.config import apply_overrides as japply_overrides
    from v2a_tpu.config import load_config_module as jload_config
    from v2a_tpu.models import policy as jpolicy
    from v2a_tpu.train import build as jbuild
    from v2a_tpu_torch.config import apply_overrides, load_config_module
    from v2a_tpu_torch.train import build as tbuild

    name = os.path.join("config", "libero", "lb_tk8_65to72.py")
    kv = dict(OVERRIDES, **{"trainer.randsam_path": h5file})
    jcfg = japply_overrides(jload_config(os.path.join(ROOT, "v2a_tpu", name)), kv)
    tcfg = apply_overrides(load_config_module(os.path.join(ROOT, "v2a_tpu_torch", name)),
                           dict(kv, device="cpu"))
    assert tcfg.trainer.rand_explo_type == "from_h5" and tcfg.trainer.randsam_path == h5file

    def init(self, rng):  # seeded numpy weights: flax's eager init takes long here
        h, w = self.config.image_size
        return random_params(
            self.nets, {k: jnp.zeros((1, h, w, 3)) for k in self.config.obs_keys},
            jnp.zeros((1, self.config.horizon, self.config.action_dim)),
            jnp.zeros((1,), jnp.int32), seed=12)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpolicy.DiffusionPolicy, "init", init)
        jt, *_ = jbuild.build_experiment(jcfg, str(tmp_path / "jax"), with_video_model=False,
                                         snapshot=False)

    def port_trainer():
        t, *_ = tbuild.build_experiment(tcfg, str(tmp_path / "port"), with_video_model=False,
                                        snapshot=False)
        t._train_step = _port_step
        return t

    jt._train_step = lambda state, key, batch: (state.replace(step=state.step + 1),
                                                jnp.zeros(()), jnp.zeros(()))
    tt = port_trainer()
    seen = []
    for n in (1, 3, 5, 7, 9):
        jt.train(n)
        tt.train(n)
        assert _state(tt) == _state(jt), n
        _assert_same_buffers(jt.envBuf_rand, tt.envBuf_rand)
        seen.append(_state(tt))
        if n == 5:
            tt.save()
            tt = port_trainer()
            tt.load()
            assert _state(tt) == _state(jt)
    # the first fill (episodes 0-1 of each task), then rounds at steps 2, 4,
    # 6, 8 of episodes 2, 0-1, 2, 0-1: the file is visited at step 2, whose
    # env steps are the last counted
    assert [s[1:3] for s in seen] == [(2, False), (3, True), (5, True), (6, True), (8, True)]
    assert [s[4] for s in seen] == [4, 6, 10, 12, 16]
    assert seen[1][3] == seen[4][3] > seen[0][3] > 0


def _port_step(state, batch, generator):
    """The port trainer's train step replaced by a step counter."""
    state.step += 1
    return types.SimpleNamespace(loss=torch.zeros(()), grad_norm=torch.zeros(()))
