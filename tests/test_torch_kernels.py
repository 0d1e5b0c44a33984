"""The port's kernel modules against the JAX package, on the CPU.

On the CPU the K1 / K2 wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels in interpret mode (atol 2e-4 /
rtol 1e-4, float32) on the same numpy inputs. Also: the GroupNorm statistics
fold, the float32 temporal reference, and the rule that the port imports
nothing of JAX and names no path into the JAX package or `native/`.
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from v2a_tpu.ops import resblock_kernels as jrk  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch while a module of these tests runs.
    The suite runs in several worker processes at once (pytest-xdist): with
    a thread pool per core in every process, torch's threads oversubscribe
    the cores and waiting for them took most of these tests' time. The
    other `tests/test_torch_*.py` CPU files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("hw", [8, 32, (5, 7)], ids=["whole-frame", "banded", "ragged"])
@pytest.mark.parametrize("mode", ["plain", "affine_silu", "affine"])
def test_affine_conv3x3_matches_pallas(hw, mode):
    """K1's plain version against the Pallas kernel; "ragged": H and W that
    no 8x8, 8x4 or 4x4 pixel tile of the card's plan divides, C = 32 (one
    channel chunk) and D = 64 (the 64-wide output slice)."""
    if isinstance(hw, tuple):
        (h, w), (c, d), rs = hw, (32, 64), np.random.RandomState(57)
    else:
        (h, w), (c, d), rs = (hw, hw), (128, 128), np.random.RandomState(hw)
    n = 2
    x = rs.randn(n, h, w, c).astype(np.float32)
    k = (rs.randn(3, 3, c, d) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.1 * rs.randn(d)).astype(np.float32)
    a = b = None
    if mode != "plain":
        a = (1 + 0.1 * rs.randn(n, c)).astype(np.float32)
        b = (0.5 * rs.randn(n, c)).astype(np.float32)
    silu = mode == "affine_silu"
    want = jrk.fused_affine_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                    a=None if a is None else jnp.asarray(a),
                                    b=None if b is None else jnp.asarray(b),
                                    silu=silu, interpret=True)
    before = trk.launches["fused_affine_conv3x3"]
    got = trk.fused_affine_conv3x3(_t(x), _t(k), _t(bias), _t(a), _t(b), silu=silu)
    assert trk.launches["fused_affine_conv3x3"] == before  # CPU: plain version, no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("extras", ["none", "emb_residual_stats"])
def test_temporal_conv_matches_pallas(extras):
    rs = np.random.RandomState(1)
    b, f, h, w, c = 2, 3, 4, 8, 128
    x = rs.randn(b, f, h, w, c).astype(np.float32)
    k = (rs.randn(3, c, c) * 0.05).astype(np.float32)
    bias = (0.1 * rs.randn(c)).astype(np.float32)
    full = extras != "none"
    emb = (0.3 * rs.randn(b, c)).astype(np.float32) if full else None
    res = rs.randn(b, f, h, w, c).astype(np.float32) if full else None
    want = jrk.temporal_conv_fused(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
        emb=None if emb is None else jnp.asarray(emb),
        residual=None if res is None else jnp.asarray(res),
        want_stats=full, interpret=True,
    )
    got = trk.temporal_conv_fused(_t(x), _t(k), _t(bias), _t(emb), _t(res), want_stats=full)
    if full:
        (got, gst), (want, wst) = got, want
        assert gst.shape == (b, f, 2, c)
        np.testing.assert_allclose(gst.numpy(), np.asarray(wst), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_temporal_conv_is_not_causal():
    """Frames are zero-padded on both sides: frame 0 sees frame 1."""
    x = np.zeros((1, 3, 2, 128), np.float32)
    x[0, 1] = 1.0
    k = np.zeros((3, 128, 128), np.float32)
    k[2] = np.eye(128)  # tap t=2 reads frame f+1
    y = trk.temporal_conv_fused(_t(x), _t(k), torch.zeros(128)).numpy()
    assert y[0, 0].min() == 1.0 and y[0, 1].max() == 0.0


def test_temporal_conv_reference_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 4, 6, 64).astype(np.float32)
    k = (rs.randn(3, 64, 64) * 0.1).astype(np.float32)
    bias, emb = rs.randn(64).astype(np.float32), rs.randn(2, 64).astype(np.float32)
    res = rs.randn(2, 4, 6, 64).astype(np.float32)
    want = jrk.temporal_conv_reference(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                       jnp.asarray(emb), jnp.asarray(res))
    got = trk.temporal_conv_reference(_t(x), _t(k), _t(bias), _t(emb), _t(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_stats_to_group_affine_matches_jax():
    rs = np.random.RandomState(3)
    b, c, n = 2, 256, 3 * 16
    x = rs.randn(b, n, c).astype(np.float32) * 2 + 0.5
    stats = np.stack([x.sum(1), (x * x).sum(1)], 1)
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    wa, wb = jrk.stats_to_group_affine(jnp.asarray(stats), jnp.asarray(scale),
                                       jnp.asarray(bias), n, 32)
    ga, gb = trk.stats_to_group_affine(_t(stats), _t(scale), _t(bias), n, 32)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TOL)


def test_plain_versions_round_like_the_kernels():
    """bf16 in, bf16 out; the activation is rounded to bf16 before the conv."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(1, 4, 4, 32).astype(np.float32)).bfloat16()
    k = torch.from_numpy((rs.randn(3, 3, 32, 64) * 0.1).astype(np.float32))
    a, b = torch.ones(1, 32), torch.full((1, 32), 0.3)
    y = trk.fused_affine_conv3x3(x, k, torch.zeros(64), a, b, silu=True)
    xf = x.float() + 0.3
    xa = (xf * torch.sigmoid(xf)).bfloat16().float()
    w = k.bfloat16().float().permute(3, 2, 0, 1)
    ref = torch.nn.functional.conv2d(xa.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), ref.bfloat16().float(), atol=0, rtol=0)


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "v2a_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


# a path into the JAX package or the root `native/` directory: "v2a_tpu" or
# "_native" as a whole string or a path segment, or "native" as a segment
# ("native/replay", "../native"; the bare word is the replay backend's name,
# and `v2a_tpu_torch/native/` is the port's own); a `file.py:line` citation
# is not one
_PATH_INTO_JAX = re.compile(
    r"(?<![\w.-])(?<!v2a_tpu_torch/)(?:\.{1,2}/)*"
    r"(?:(?:v2a_tpu|_native)(?:/|$)|native/|native$(?<=/native))")
_CITATION = re.compile(r"(?:v2a_tpu|native)/[\w./-]+\.\w+:\d+")


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    getattr(body[0], "value", None), ast.Constant):
                out.add(id(body[0].value))
    return out


def jax_imports_and_paths(source, path="<source>"):
    """The imports of JAX, flax, optax or the JAX package in `source`, and
    its string literals (docstrings aside) that name a path into
    `v2a_tpu/` or the root `native/`: the port reads only its own copies."""
    banned = {"jax", "jaxlib", "flax", "optax", "v2a_tpu"}
    tree = ast.parse(source, path)
    docs = _docstrings(tree)
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs):
            text = _CITATION.sub("", node.value)
            if _PATH_INTO_JAX.search(text):
                bad.append(f"{path}:{node.lineno}: string {node.value!r}")
        bad += [f"{path}: {n}" for n in names if n.split(".")[0] in banned]
    return bad


def test_port_imports_nothing_of_jax():
    bad = []
    for path in _port_files():
        with open(path) as fh:
            bad += jax_imports_and_paths(fh.read(), path)
    assert len(_port_files()) > 10
    assert not bad, bad
