"""The port's replay buffers against the JAX package's, on the CPU: episode
validation, truncation, continuity and FIFO eviction; `sample_batch` equal
to the JAX package's native backend for the same episodes and generator,
with both port backends (the port's native store is built from its own
source with g++ at first use); checkpoint round trips; `merge_batches`; a
failed build raises; the store's lock under a concurrent sampler; and the
import guard's path rule."""

import sys
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_kernels import jax_imports_and_paths, one_torch_thread  # noqa: E402, F401
from v2a_tpu.data import replay_buffer as jrb  # noqa: E402
from v2a_tpu_torch.data import native_store as tns  # noqa: E402
from v2a_tpu_torch.data import replay_buffer as trb  # noqa: E402

H = W = 16


def _episode(ep_id, n_imgs, seed=None):
    """Frames whose pixel [0,0,0] encodes the frame index and [0,0,1] the
    episode id (random elsewhere with `seed`); actions encode (frame, id)."""
    rs = np.random.RandomState(seed if seed is not None else ep_id)
    imgs = rs.randint(0, 256, (n_imgs, H, W, 3)).astype(np.uint8)
    imgs[:, 0, 0, 0] = np.arange(n_imgs) % 256
    imgs[:, 0, 0, 1] = ep_id % 256
    acts = rs.uniform(-1, 1, (n_imgs - 1, 7)).astype(np.float32)
    acts[:, 0] = np.arange(n_imgs - 1)
    acts[:, 1] = ep_id
    return imgs, acts


def _fill(buf, lengths):
    for e, n in enumerate(lengths):
        imgs, acts = _episode(e, n)
        buf.add_episode(f"task{e % 3}", "agent", 100 + e, imgs, acts, is_success=e % 2 == 0)
    return buf


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):
            assert a[k] == b[k], k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# (max_episodes, max_len, episode lengths): plain, evicting, truncating
CASES = {"plain": (8, 64, [30, 41, 55, 33, 20]),
         "evicting": (3, 64, [30, 41, 55, 33, 20, 47]),
         "truncating": (4, 24, [30, 12, 60, 24, 40])}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("backend", ["native", "python"])
def test_sample_batch_matches_jax(case, backend):
    """The same episodes and generator state give the JAX native backend's
    batch, rows, metadata and the generator's next draw included; over
    several batches of different sizes and horizons."""
    max_eps, max_len, lengths = CASES[case]
    jbuf = _fill(jrb.ReplayBuffer(max_eps, max_len, 10, 8, backend="native"), lengths)
    tbuf = _fill(trb.ReplayBuffer(max_eps, max_len, 10, 8, backend=backend), lengths)
    assert tbuf.backend == backend
    assert len(tbuf) == len(jbuf) == min(max_eps, len(lengths))
    assert tbuf.cnt_all_history_episodes == jbuf.cnt_all_history_episodes == len(lengths)
    np.testing.assert_array_equal(tbuf.episode_lengths(), jbuf.episode_lengths())
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    for bs, hz in ((32, None), (5, 3), (64, 9)):
        _assert_batches_equal(tbuf.sample_batch(bs, tr, hz), jbuf.sample_batch(bs, jr, hz))
    assert tr.integers(1 << 30) == jr.integers(1 << 30)


def test_auto_is_native_and_backends_agree():
    """'auto' is the native store; both backends sample the same batch and
    export the same episodes."""
    lengths = [30, 41, 55, 33, 20, 47]
    nat = _fill(trb.ReplayBuffer(4, 64, 10, 8), lengths)
    py = _fill(trb.ReplayBuffer(4, 64, 10, 8, backend="python"), lengths)
    assert nat.backend == "native"
    _assert_batches_equal(nat.sample_batch(40, np.random.default_rng(3)),
                          py.sample_batch(40, np.random.default_rng(3)))
    for a, b in zip(nat.export_episodes(), py.export_episodes()):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("src,dst", [("native", "python"), ("python", "native")])
def test_checkpoint_roundtrip_across_backends(tmp_path, src, dst):
    buf = _fill(trb.ReplayBuffer(3, 64, 10, 8, backend=src), [30, 41, 55, 33])
    path = str(tmp_path / "buf.npz")
    buf.save(path)
    back = trb.ReplayBuffer(3, 64, 10, 8, backend=dst)
    back.load(path)
    assert len(back) == 3 and back.cnt_all_history_episodes == 4
    for a, b in zip(buf.export_episodes(), back.export_episodes()):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    _assert_batches_equal(buf.sample_batch(16, np.random.default_rng(1)),
                          back.sample_batch(16, np.random.default_rng(1)))


def test_episode_validation_truncation_continuity():
    """The JAX `EpisodeBuffer` / `add_episode` rules: uint8 (T+1, H, W, 3)
    frames, T actions, min length, truncation to the newest `max_len`
    frames, continuity on appends; FIFO eviction in `episodes`."""
    imgs, acts = _episode(0, 30)
    for mod in (jrb, trb):
        with pytest.raises(TypeError):
            mod.EpisodeBuffer("t", "agent", 0, imgs.astype(np.float32), acts)
        with pytest.raises(ValueError):
            mod.EpisodeBuffer("t", "agent", 0, imgs[..., :2], acts)
        with pytest.raises(ValueError):
            mod.EpisodeBuffer("t", "agent", 0, imgs, acts[:-1])
        for backend in ("python", "native"):
            with pytest.raises(ValueError, match="too short"):
                mod.ReplayBuffer(4, 64, 40, backend=backend).add_episode(
                    "t", "agent", 0, imgs, acts)
            with pytest.raises(RuntimeError, match="empty"):
                mod.ReplayBuffer(4, 64, 10, backend=backend).sample_batch(
                    2, np.random.default_rng(0))
    ep = {}
    for mod in (jrb, trb):
        e = mod.EpisodeBuffer("t", "agent", 0, imgs[:20], acts[:19], max_len=25)
        e.append_seq(imgs[19:], acts[19:])
        with pytest.raises(ValueError, match="continuity"):
            e.append_seq(imgs[:5], acts[:4])
        ep[mod] = e
    assert len(ep[trb]) == 25
    np.testing.assert_array_equal(ep[trb].imgs, ep[jrb].imgs)
    np.testing.assert_array_equal(ep[trb].acts, ep[jrb].acts)
    np.testing.assert_array_equal(ep[trb].imgs, imgs[-25:])
    buf = _fill(trb.ReplayBuffer(2, 64, 10, 8, backend="python"), [30, 31, 32])
    assert [e.env_idx for e in buf.episodes] == [101, 102]
    for backend in ("python", "native"):
        short = trb.ReplayBuffer(2, 64, 5, 8, backend=backend)
        short.add_episode("t", "agent", 0, *_episode(0, 6))
        with pytest.raises(ValueError, match="horizon"):
            short.sample_batch(4, np.random.default_rng(0), horizon=10)


def test_merge_batches_matches_jax():
    bufs = [_fill(trb.ReplayBuffer(4, 64, 10, 8), [30, 41]),
            _fill(trb.ReplayBuffer(4, 64, 10, 8, backend="python"), [50, 33, 28])]
    rng = np.random.default_rng(4)
    parts = [bufs[0].sample_batch(3, rng), bufs[1].sample_batch(5, rng)]
    _assert_batches_equal(trb.merge_batches(parts), jrb.merge_batches(parts))


def test_hindsight_draws_match_the_store():
    """The numpy draws of `hindsight_draws` are the native store's: its
    slots and windows, at batch sizes past one thread's share and a seed
    with the top bit set."""
    store = tns.NativeEpisodeStore(6, 80, (H, W), 7)
    lengths = [30, 41, 80, 33, 20, 47]
    for e, n in enumerate(lengths):
        store.add_episode(*_episode(e, n))
    for seed in (0, 12345, 2**63 + 17):
        obs, goal, acts, slots = store.sample_batch(37, 9, seed)
        live, start = tns.hindsight_draws(seed, 37, 6, lengths, 9)
        np.testing.assert_array_equal(slots, live)
        np.testing.assert_array_equal(obs[:, 0, 0, 0], start)
        np.testing.assert_array_equal(goal[:, 0, 0, 0], start + 9)
        np.testing.assert_array_equal(acts[:, :, 0], start[:, None] + np.arange(9))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ rejects raises with the compiler's message; 'auto'
    never falls back to the Python backend."""
    from v2a_tpu_torch.ops import _build

    src = tmp_path / "native"
    src.mkdir()
    (src / "replay_store.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(tns, "_lib", None)
    buf = trb.ReplayBuffer(4, 64, 10, 8)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        buf.add_episode("t", "agent", 0, *_episode(0, 30))
    assert buf.backend == "native" and not list((tmp_path / "build").glob("*.so"))


def test_store_lock_under_concurrent_sampling():
    """A sampler thread against appends from this one, with a short switch
    interval: every row stays one episode's window (obs, goal and actions
    agree), which a torn append or sample would break."""
    store = tns.NativeEpisodeStore(4, 64, (H, W), 7, n_threads=2)
    store.add_episode(*_episode(0, 40))
    stop, errors = threading.Event(), []

    def sample():
        i = 0
        while not stop.is_set():
            obs, goal, acts, _ = store.sample_batch(16, 8, i)
            i += 1
            ok = ((goal[:, 0, 0, 0] == obs[:, 0, 0, 0] + 8).all()
                  and (goal[:, 0, 0, 1] == obs[:, 0, 0, 1]).all()
                  and (acts[:, 0, 0] == obs[:, 0, 0, 0]).all()
                  and (acts[:, 0, 1] == obs[:, 0, 0, 1]).all())
            if not ok:
                errors.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=sample) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for e in range(1, 200):
            store.add_episode(*_episode(e, 30 + e % 30, seed=0))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert store.total_added == 200


def test_guard_flags_paths_into_the_jax_package():
    """The import guard's path rule (`test_torch_kernels.py`): string
    literals naming a path into `v2a_tpu/` or the root `native/` fail;
    citations, docstrings, the port's own `native/` and the backend name
    do not."""
    flagged = [
        'LIB = "v2a_tpu/_native/libv2a_replay.so"',
        'p = os.path.join(ROOT, "v2a_tpu", "_native")',
        'src = "native/replay/replay_store.cpp"',
        'src = os.path.join(ROOT, "../native/replay")',
        'cfg = f"{root}/v2a_tpu/config/fake/{name}.py"',
    ]
    passed = [
        '"""Reads `v2a_tpu/_native/libv2a_replay.so` in the JAX package."""',
        'replaces = "v2a_tpu/ops/resblock_kernels.py:662"',
        'backend = "native"',
        'src = "v2a_tpu_torch/native/replay_store.cpp"',
        'import numpy as np',
    ]
    for src in flagged:
        assert jax_imports_and_paths(src), src
    for src in passed:
        assert not jax_imports_and_paths(src), src
    assert jax_imports_and_paths("from v2a_tpu.data import native_store")
