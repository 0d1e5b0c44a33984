"""The port's sample-quality metrics (`ops/fid.py`) and evaluator CLI
(`scripts/evaluate_samples.py`) against the JAX package, on the CPU.

The numpy metrics are copies: on the same seeded features they agree to
1e-10. The random conv trunk runs on the JAX package's own weights (its
`jax.random` draws re-derived here and handed in as `params`) at an even
and an odd side, within 1e-5 relative: "SAME" padding at stride 2 is (0, 1)
on an even side, which `padding=1` would get wrong. The CLI without
`--inception`: the JAX CLI's keys, and FID ~0 on identical batches
(`tests/test_torch_inception.py` holds it with `--inception` against the
JAX CLI).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu.ops import fid as jfid  # noqa: E402
from v2a_tpu_torch.ops import fid as tfid  # noqa: E402
from v2a_tpu_torch.scripts import evaluate_samples as tcli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread for numpy while a module of these tests runs
    (`tests/test_torch_inception.py` imports it too): the metrics' `eigh`
    and products on ~2,000-wide covariances spun OpenBLAS's thread pool
    against the other test workers' (the `--inception` CLI test took 192 s
    of junit time in a six-worker run, 12 s alone)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _features(seed, n=40, d=6):
    rs = np.random.RandomState(seed)
    return rs.randn(n, d) @ rs.randn(d, d)


METRICS = {
    "feature_stats": lambda m: m.feature_stats(_features(0)),
    "frechet_distance": lambda m: m.frechet_distance(*m.feature_stats(_features(0)),
                                                     *m.feature_stats(_features(1) + 0.3)),
    "inception_score": lambda m: m.inception_score(_features(2, 50, 10), splits=5),
    "pairwise_sq_distances": lambda m: m.pairwise_sq_distances(_features(3), _features(4)),
    "manifold_radii": lambda m: m.manifold_radii(_features(5), 3),
    "precision_recall": lambda m: m.precision_recall(_features(6), _features(7) * 1.5, 3),
    "fid": lambda m: m.fid(_features(8, 30, 4).reshape(30, 2, 2, 1),
                           _features(9, 30, 4).reshape(30, 2, 2, 1),
                           lambda x: np.asarray(x).reshape(len(x), -1), batch=7),
}


@pytest.mark.parametrize("name", list(METRICS))
def test_numpy_metrics_match_jax(name):
    """Each metric on seeded features: equal to the JAX package's to 1e-10."""
    got, want = METRICS[name](tfid), METRICS[name](jfid)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   **METRIC_TOL)


def _jax_trunk_params(seed, widths, feature_dim):
    """The JAX extractor's weights, drawn as `v2a_tpu/ops/fid.py:139-152`
    draws them."""
    key = jax.random.PRNGKey(seed)
    kernels, cin = [], 3
    for w in widths:
        key, k1 = jax.random.split(key)
        kernels.append(np.asarray(jax.random.normal(k1, (3, 3, cin, w), jnp.float32)
                                  * np.sqrt(2.0 / (9 * cin))))
        cin = w
    key, k2 = jax.random.split(key)
    head = np.asarray(jax.random.normal(k2, (cin, feature_dim), jnp.float32)
                      * np.sqrt(1.0 / cin))
    return kernels, head


@pytest.mark.parametrize("side", [16, 15], ids=["even", "odd"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_random_trunk_matches_jax_on_its_weights(side, dtype):
    """The port's trunk with the JAX package's weights handed in: features
    within 1e-5 relative (of the largest feature) of the JAX extractor's,
    on uint8 and float images."""
    widths, dim = (8, 16, 16, 24), 20
    rs = np.random.RandomState(side)
    imgs = rs.randint(0, 256, (3, side, side, 3)).astype(np.uint8)
    if dtype == "float32":
        imgs = imgs.astype(np.float32) / 255.0
    want = np.asarray(jfid.random_conv_features(3, widths, dim)(imgs))
    got = tfid.random_conv_features(params=_jax_trunk_params(3, widths, dim),
                                    device="cpu")(imgs)
    assert got.shape == (3, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_same_padding_is_xla_rule():
    """`_same_pad` is XLA's "SAME" at stride 2: (0, 1) on even sides, (1, 1)
    on odd ones; the output side is ceil(n / 2)."""
    for n in range(2, 12):
        lo, hi = tfid._same_pad(n)
        assert (lo, hi) == ((0, 1) if n % 2 == 0 else (1, 1))
        assert (n + lo + hi - 3) // 2 + 1 == -(-n // 2)


def test_port_trunk_weights_are_he_init():
    """`random_conv_params`: the JAX draw's shapes and scales (He init for
    the kernels, 1/sqrt(C) for the head), float32, reproducible by seed."""
    kernels, head = tfid.random_conv_params(0, (32, 64), 48)
    assert [k.shape for k in kernels] == [(3, 3, 3, 32), (3, 3, 32, 64)]
    assert head.shape == (64, 48) and head.dtype == np.float32
    for k, cin in zip(kernels, (3, 32)):
        assert abs(k.std() / np.sqrt(2.0 / (9 * cin)) - 1) < 0.1
    assert abs(head.std() * 8 - 1) < 0.1
    again, _ = tfid.random_conv_params(0, (32, 64), 48)
    np.testing.assert_array_equal(kernels[1], again[1])


# -- the evaluator CLI ---------------------------------------------------------------


def load_jax_cli():
    """The JAX package's CLI module (a root script)."""
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_samples", os.path.join(ROOT, "scripts", "evaluate_samples.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


@pytest.fixture(scope="module")
def jax_cli():
    return load_jax_cli()


def batches(tmp_path, n=8, side=32, n_sample=None):
    """Reference and sample npz batches (uint8 under `arr_0`), their paths."""
    rs = np.random.RandomState(5)
    ref = rs.randint(0, 256, (max(n, n_sample or n), side, side, 3)).astype(np.int32)
    # half the samples near a reference image, half shifted and dimmed
    sample = ref + rs.randint(-8, 9, ref.shape)
    sample[len(sample) // 2:] = sample[len(sample) // 2:] // 2 + 60
    sample = np.clip(sample, 0, 255).astype(np.uint8)[:n_sample or n]
    ref = ref[:n].astype(np.uint8)
    paths = []
    for name, arr in (("ref", ref), ("sample", sample)):
        paths.append(str(tmp_path / f"{name}.npz"))
        np.savez(paths[-1], arr_0=arr)
    return paths


def run_cli(main, argv, capsys):
    """The JSON line a CLI's `main(argv)` prints."""
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_without_inception(jax_cli, tmp_path, capsys):
    """Without `--inception`: the JAX CLI's keys, IS and sFID null, not
    calibrated; FID ~0 (< 1e-4) on identical batches and larger on
    different ones. The numbers are the port's trunk's, not the JAX
    package's (another weight draw)."""
    ref, sample = batches(tmp_path, n=6, side=16)
    want = run_cli(jax_cli.main, [ref, sample], capsys)
    got = run_cli(tcli.main, [ref, sample, "--device", "cpu"], capsys)
    assert list(got) == list(want)
    assert got["inception_calibrated"] is False and got["sfid"] is None
    assert got["inception_score"] is None and got["inception_score_std"] is None
    same = run_cli(tcli.main, [ref, ref, "--device", "cpu"], capsys)
    assert abs(same["fid"]) < 1e-4 and got["fid"] > 100 * max(abs(same["fid"]), 1e-6)
    assert same["precision"] == same["recall"] == 1.0


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """`cuda` is the default device: without a card the CLI raises."""
    ref, sample = batches(tmp_path, n=4, side=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([ref, sample])
