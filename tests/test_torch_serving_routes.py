"""The video U-Net's three further serving routings against the JAX package,
on the CPU: K8 (`downconv`, the stride-2 padded downsample conv), K9
(`attn_kernel`, fused spatial attention) and K7 (`use_pallas_gn`,
GroupNorm+SiLU).

On the CPU the wrappers run their plain PyTorch versions, held here against
the JAX Pallas kernels in interpret mode (as `tests/test_pallas_kernels.py`
runs them): in float32 at the JAX tests' own tolerances, and in bf16 within
one bf16 ulp (plus 1e-3 of the output's std near zero). The port's padded
inputs carry NaN in every pad position, the JAX side finite garbage. Then
the blocks and small U-Nets against the JAX modules with the flags on, with
the same launches per kernel; the release forward's counts against the JAX
package's trace; one state dict for every routing; the repaired `loss`
(the non-fused U-Net, as the JAX package's `_model_fn(for_training=True)`)
and a trainer's refusal of K7, which has no backward.
"""

import functools
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_padded import (  # noqa: E402
    PACKAGE_KERNELS, _counting, _jax_defaults, _jax_module, _streams)
from test_torch_video import UNET_TOL, _load, _unet_inputs, japply, random_params  # noqa: E402
from v2a_tpu.models import video_model as jvm  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu.ops import pallas_kernels as jpk  # noqa: E402
from v2a_tpu.ops import resblock_kernels as jrk  # noqa: E402
from v2a_tpu_torch.convert.from_jax import video_model_from_jax  # noqa: E402
from v2a_tpu_torch.models import video_model as tvm  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.ops import group_norm as tgn  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402
from v2a_tpu_torch.train import video_trainer as tvt  # noqa: E402

ALL = PACKAGE_KERNELS


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32),
                      np.float32)


def _one_ulp(got, want):
    """bf16: within one unit in the last place of the JAX value, plus 1e-3
    of its std (float32 sums in another order round to neighbouring bf16
    values)."""
    g, w = _np(got), _np(want)
    bad = np.abs(g - w) > np.abs(w) * 2.0 ** -7 + 1e-3 * w.std()
    assert not bad.any(), f"{bad.sum()} of {bad.size} beyond one ulp"


def _interior(a, hw):
    h, w = hw
    return a[..., 1:h + 1, 1:w + 1, :]


def _zero_pads(got, hw, cols_only=True):
    """Pad cols of the interior rows exactly zero (and the pad rows too,
    unless `cols_only`)."""
    h, w = hw
    g = _np(got)
    rows = g[..., 1:h + 1, :, :]
    assert not rows[..., 0, :].any() and not rows[..., w + 1:, :].any()
    if not cols_only:
        assert not g[..., 0, :, :].any() and not g[..., h + 1:, :, :].any()


# -- K7: GroupNorm + SiLU -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 64), (3, 48, 128), (2, 64, 640),
                                   (1, 4, 4, 4, 1280)], ids=["5d", "3d", "3d-gw20", "5d-gw40"])
def test_group_norm_silu_plain_matches_pallas(dtype, silu, shape):
    """f32: atol 1e-5 (`tests/test_pallas_kernels.py:61`); bf16: one ulp.
    C 640 and 1280 are the release's widest groups (20 and 40 channels)."""
    rs = np.random.RandomState(20)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    scale = (1 + 0.2 * rs.randn(c)).astype(np.float32)
    bias = (0.2 * rs.randn(c)).astype(np.float32)
    want = jpk.fused_group_norm_silu(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                                     jnp.asarray(bias), 32, with_silu=silu, interpret=True)
    before = dict(trk.launches)
    got = tgn.fused_group_norm_silu(_t(x).to(getattr(torch, dtype)), _t(scale), _t(bias), 32,
                                    with_silu=silu)
    assert trk.launches == before  # CPU: the plain version, no launch
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    else:
        _one_ulp(got, want)
    ref = jpk.group_norm_silu_reference(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                        with_silu=silu)
    np.testing.assert_allclose(tgn.group_norm_silu_reference(_t(x), _t(scale), _t(bias),
                                                             with_silu=silu).numpy(),
                               np.asarray(ref), atol=1e-5)


def test_group_norm_silu_variance_is_not_clamped():
    """K7 takes var = E[x^2] - mean^2 as it comes (`pallas_kernels.py:83`);
    the XLA GroupNorm and the port's `GroupNorm32` clamp it at zero. Groups
    of two elements (every sum order gives the same float32 values) where
    a = 10.077312, b = 10.077604 round to var = -7.6e-6: rsqrt(var + eps)
    is about twice rsqrt(eps), so the two normalisations differ by that factor.
    (In interpret mode on the CPU, XLA contracts sumsq / n - mean * mean into
    one fused multiply-add, so the Pallas kernel's variance of that group is
    exact there; its other groups are compared.)"""
    x = np.random.RandomState(21).randn(1, 2, 32).astype(np.float32)
    x[0, :, 0] = [10.077312, 10.077604]
    one, zero = np.ones(32, np.float32), np.zeros(32, np.float32)
    want = np.asarray(jpk.fused_group_norm_silu(jnp.asarray(x), jnp.asarray(one),
                                                jnp.asarray(zero), 32, with_silu=False,
                                                interpret=True))
    got = tgn.fused_group_norm_silu(_t(x), _t(one), _t(zero), 32, with_silu=False).numpy()
    clamped = tvu.GroupNorm32(32)(_t(x)).detach().numpy()
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], atol=1e-5)
    np.testing.assert_allclose(got[..., 1:], clamped[..., 1:], atol=1e-5)
    f = np.float32
    g = x[0, :, 0]
    mean = f(f(g[0] + g[1]) / f(2))
    var = f(f(f(f(g[0] * g[0]) + f(g[1] * g[1])) / f(2)) - f(mean * mean))
    assert var < 0
    np.testing.assert_allclose(got[0, :, 0], (g - mean) / np.sqrt(var + f(1e-5)), rtol=1e-5)
    assert np.all(got[0, :, 0] / clamped[0, :, 0] > 1.9)


# -- K8: stride-2 padded downsample conv -----------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [False, True], ids=["bare", "affine_silu"])
@pytest.mark.parametrize("hw", [(8, 8), (6, 12)], ids=["8x8", "6x12"])
def test_downconv3x3_padded_plain_matches_pallas(dtype, affine, hw):
    """f32: atol 1e-4 (`tests/test_pallas_kernels.py:791`); bf16: one ulp;
    the port's output has exactly zero pad cols."""
    rs = np.random.RandomState(22)
    n, c, d = 3, 8, 16
    jx, tx = _streams(rs, (n,), hw, c)
    k = (rs.randn(3, 3, c, d) * 0.2).astype(np.float32)
    bias = (0.1 * rs.randn(d)).astype(np.float32)
    a = b = None
    if affine:
        a = (1 + 0.1 * rs.randn(n, c)).astype(np.float32)
        b = (0.1 * rs.randn(n, c)).astype(np.float32)
    want = jrk.fused_downconv3x3_padded(
        jx.astype(dtype), jnp.asarray(k), jnp.asarray(bias), hw,
        a=None if a is None else jnp.asarray(a), b=None if b is None else jnp.asarray(b),
        silu=affine, interpret=True)
    before = dict(trk.launches)
    got = trk.fused_downconv3x3_padded(tx.to(getattr(torch, dtype)), _t(k), _t(bias), hw, _t(a),
                                       _t(b), silu=affine)
    assert trk.launches == before
    hw2 = (hw[0] // 2, hw[1] // 2)
    assert got.shape == tuple(want.shape) and got.dtype == getattr(torch, dtype)
    _zero_pads(got, hw2)
    if dtype == "float32":
        np.testing.assert_allclose(_interior(got.numpy(), hw2), _interior(np.asarray(want), hw2),
                                   atol=1e-4)
    else:
        _one_ulp(_interior(got, hw2), _interior(want, hw2))


def test_downconv3x3_padded_keeps_the_jax_guards():
    x = torch.zeros(1, 9, 16, 8)
    with pytest.raises(ValueError, match="even"):
        trk.fused_downconv3x3_padded(x, torch.zeros(3, 3, 8, 8), torch.zeros(8), (7, 8))
    with pytest.raises(ValueError, match="padded"):
        trk.fused_downconv3x3_padded(x, torch.zeros(3, 3, 8, 8), torch.zeros(8), (8, 8))


# -- K9: fused spatial attention ---------------------------------------------------


def _attn_inputs(rs, n, hw, c, x_scale=1.0, a_scale=1.0):
    jx, tx = _streams(rs, (n,), hw, c)
    jx, tx = jx * x_scale, tx * x_scale
    a = (a_scale * (1 + 0.1 * rs.randn(n, c))).astype(np.float32)
    b = (0.1 * rs.randn(n, c)).astype(np.float32)
    w = [(rs.randn(c, 3 * c) / math.sqrt(c)).astype(np.float32),
         (0.1 * rs.randn(3 * c)).astype(np.float32),
         (rs.randn(c, c) / math.sqrt(c)).astype(np.float32),
         (0.1 * rs.randn(c)).astype(np.float32)]
    return jx, tx, (a, b, *w)


def _run_k9(jx, tx, hw, params, dtype, want_stats, ch=32):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jrk.fused_spatial_attention_padded(jx.astype(jdt), hw, *map(jnp.asarray, params), ch,
                                              want_stats=want_stats, interpret=True)
    got = trk.fused_spatial_attention_padded(tx.to(tdt), hw, *map(_t, params), ch,
                                             want_stats=want_stats)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("want_stats", [True, False])
@pytest.mark.parametrize("hw,c,ch", [((8, 8), 64, 32), ((6, 10), 64, 32), ((4, 4), 160, 8),
                                     ((4, 4), 160, 40)],
                         ids=["8x8", "6x10", "4x4-c160-ch8", "4x4-c160-ch40"])
def test_spatial_attention_padded_plain_matches_pallas(dtype, want_stats, hw, c, ch):
    """f32: atol / rtol 2e-4, statistics atol 5e-3 / rtol 5e-4
    (`tests/test_pallas_kernels.py:1067, 1076`); bf16: one ulp, statistics
    rtol 1e-4 of their scale. Every pad position of the output is zero.
    Head widths 8 and 40 (C 160, 16 tokens): widths the card kernel runs in
    masked 16- and 64-lane slices."""
    rs = np.random.RandomState(23)
    jx, tx, params = _attn_inputs(rs, 3, hw, c)
    before = dict(trk.launches)
    got, want = _run_k9(jx, tx, hw, params, dtype, want_stats, ch)
    assert trk.launches == before
    if want_stats:
        (got, gst), (want, wst) = got, want
        wst = np.asarray(wst)
        if dtype == "float32":
            np.testing.assert_allclose(gst.numpy(), wst, atol=5e-3, rtol=5e-4)
        else:
            np.testing.assert_allclose(gst.numpy(), wst, atol=1e-4 * np.abs(wst).max())
    assert got.dtype == getattr(torch, dtype)
    _zero_pads(got, hw, cols_only=False)
    if dtype == "float32":
        np.testing.assert_allclose(_interior(got.numpy(), hw), _interior(np.asarray(want), hw),
                                   atol=2e-4, rtol=2e-4)
    else:
        _one_ulp(_interior(got, hw), _interior(want, hw))


def _k9_variant(tx, hw, params, scale_in_dtype=False, residual_in_dtype=False):
    """K9's plain version with one rounding moved to where the port's
    `SpatialAttentionBlock` puts it: q and k scaled by ch^-1/4 in the
    compute dtype before the dot, or the residual added as two rounded
    tensors."""
    a, b, wqkv, bqkv, wproj, bproj = map(_t, params)
    n, hp, wp, c = tx.shape
    dt, ch, m = tx.dtype, 32, hp * wp
    inside = trk._interior_mask(hw, tx.device)[None, :, None]
    xs = torch.where(inside, tx.reshape(n, m, c), torch.zeros((), dtype=dt))
    xn = (xs.float() * a[:, None] + b[:, None]).to(dt)
    qkv = (xn.float() @ wqkv.to(dt).float() + bqkv).to(dt)
    qkv = qkv.reshape(n, m, c // ch, 3 * ch).permute(0, 2, 1, 3)
    q, k, v = qkv[..., :ch], qkv[..., ch:2 * ch], qkv[..., 2 * ch:]
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    if scale_in_dtype:
        logits = (q * scale).float() @ (k * scale).float().transpose(-1, -2)
    else:
        logits = (q.float() @ k.float().transpose(-1, -2)) * (scale * scale)
    logits = logits + torch.where(inside[0, :, 0], 0.0, -1e30)
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = (ex / ex.sum(-1, keepdim=True)).to(dt)
    att = (probs.float() @ v.float()).to(dt).permute(0, 2, 1, 3).reshape(n, m, c)
    proj = att.float() @ wproj.to(dt).float() + bproj
    y = xs + proj.to(dt) if residual_in_dtype else (xs.float() + proj).to(dt)
    return torch.where(inside, y, torch.zeros((), dtype=dt)).reshape(n, hp, wp, c)


def test_spatial_attention_padded_pins_the_tpu_rounding():
    """bf16, the three places where K9 rounds otherwise than the block:
    (1) logits = dot(q, k) * scale^2 in float32 (the block scales q and k in
    bf16 first); (2) the residual x + proj in float32, rounded once (the
    block adds two bf16 tensors); (3) statistics of the unrounded float32
    output (the block's are of the rounded one). The plain version agrees
    with the Pallas kernel far more closely than each variant does."""
    rs = np.random.RandomState(24)
    hw = (8, 8)
    # a peaked softmax (large normalised activations) and a small residual,
    # so that the logits' and the residual's rounding show in the output
    jx, tx, params = _attn_inputs(rs, 2, hw, 64, x_scale=0.05, a_scale=60.0)
    (got, gst), (want, wst) = _run_k9(jx, tx, hw, params, "bfloat16", True)
    w = _interior(_np(want), hw)

    def mismatches(y):
        return int((_interior(_np(y), hw) != w).sum())

    txb = tx.bfloat16()
    assert torch.equal(_k9_variant(txb, hw, params)[:, 1:-1], got[:, 1:-1])  # same rounding
    plain = mismatches(got)
    scaled = mismatches(_k9_variant(txb, hw, params, scale_in_dtype=True))
    summed = mismatches(_k9_variant(txb, hw, params, residual_in_dtype=True))
    assert scaled > 4 * plain + 20 and summed > 4 * plain + 20, (plain, scaled, summed)
    wst = np.asarray(wst)
    y = _interior(got, hw).float().reshape(2, -1, 64)
    rounded = torch.stack([y.sum(1), (y * y).sum(1)], 1).numpy()
    err = np.abs(gst.numpy() - wst).max() / np.abs(wst).max()
    err_rounded = np.abs(rounded - wst).max() / np.abs(wst).max()
    assert err < 1e-5 and err_rounded > 20 * err, (err, err_rounded)


def test_spatial_attention_padded_keeps_the_jax_guards():
    x = torch.zeros(2, 10, 16, 64)
    a = torch.ones(2, 64)
    w = (a, a, torch.zeros(64, 192), torch.zeros(192), torch.zeros(64, 64), torch.zeros(64))
    with pytest.raises(ValueError, match="padded"):
        trk.fused_spatial_attention_padded(x, (8, 6), *w, 32)
    with pytest.raises(ValueError, match="divisible"):
        trk.fused_spatial_attention_padded(x, (8, 8), *w, 48)


# -- the blocks --------------------------------------------------------------------


def test_downsample_block_matches_jax(monkeypatch):
    """`Downsample3D(downconv=True)` with `padded_out` from a NaN-padded
    stream: K8 then K4b, with statistics, against the JAX module with
    `PERF_DOWNCONV`; one K8 and one K4b launch on both sides."""
    _jax_defaults(monkeypatch)
    monkeypatch.setattr(jvu, "PERF_DOWNCONV", True)
    rs = np.random.RandomState(25)
    hw, c = (8, 8), 64
    jx, tx = _streams(rs, (1, 2), hw, c)
    jm = jvu.Downsample3D(c, fused=True)
    params = random_params(jm, jnp.zeros((1, 2) + hw + (c,)), seed=25)
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    want, wst = jm.apply(params, jvu.PaddedStream(jx, hw), want_stats=True, padded_out=True)
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    tm = _load(tvu.Downsample3D(c, fused=True, routing=tvu.ConvRouting(downconv=True)), params)
    got, gst = tm(tvu.PaddedStream(tx, hw), want_stats=True, padded_out=True)
    assert jcalls == tcalls == {"fused_downconv3x3_padded": 1, "temporal_conv_padded": 1}
    assert isinstance(got, tvu.PaddedStream) and got.hw == (4, 4)
    _zero_pads(got.x, (4, 4))
    np.testing.assert_allclose(_interior(got.x.numpy(), (4, 4)),
                               _interior(np.asarray(want.x), (4, 4)), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "entered"])
def test_attention_block_kernel_matches_jax(monkeypatch, padded):
    """`SpatialAttentionBlock(attn_kernel=True)` with forwarded statistics:
    on a NaN-padded stream the output stays padded (every pad zero); on a
    plain tensor the block enters the padded layout for the call and leaves
    it (the release case). Against the JAX module with `PERF_PALLAS_ATTN`,
    atol / rtol 2e-4, statistics atol 5e-3 / rtol 5e-4."""
    _jax_defaults(monkeypatch)
    monkeypatch.setattr(jvu, "PERF_PALLAS_ATTN", True)
    rs = np.random.RandomState(26)
    hw, c = (8, 8), 64
    jx, tx = _streams(rs, (1, 2), hw, c)
    inner = _interior(tx, hw)
    xf = inner.reshape(1, 2, -1, c)
    st = torch.stack([xf.sum(2), (xf * xf).sum(2)], 2)
    jm = jvu.SpatialAttentionBlock(num_head_channels=32)
    params = random_params(jm, jnp.asarray(inner.numpy()), seed=26)
    jin = jvu.PaddedStream(jx, hw) if padded else jnp.asarray(inner.numpy())
    tin = tvu.PaddedStream(tx, hw) if padded else inner
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    want, wst = jm.apply(params, jin, jnp.asarray(st.numpy()), want_stats=True)
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    got, gst = _load(tvu.SpatialAttentionBlock(c, 32, routing=tvu.ConvRouting(attn_kernel=True)),
                     params)(tin, st, True)
    assert jcalls == tcalls == {"fused_spatial_attention_padded": 1}
    if padded:
        assert isinstance(got, tvu.PaddedStream) and got.hw == hw
        _zero_pads(got.x, hw, cols_only=False)
        got, want = _interior(got.x, hw), _interior(np.asarray(want.x), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), atol=5e-3, rtol=5e-4)


# -- the U-Nets ----------------------------------------------------------------------


def test_attn_kernel_unet_matches_jax(monkeypatch):
    """mc 128, mult (1, 2), attention at ds 2, 24x24 (576 interior pixels,
    the smallest square level the padded stream takes), F=2: K9 enters the
    padded layout at 12x12 in its four attention blocks, beside the padded
    routing of the 24x24 level, as the JAX package with `PERF_PALLAS_ATTN`."""
    _jax_defaults(monkeypatch)
    monkeypatch.setattr(jvu, "PERF_PALLAS_ATTN", True)
    kw = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(24, seed=27)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=27)
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    want = japply(jvu.VideoUNet(fused=True, **kw), params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    got = _load(tvu.VideoUNet(fused=True, routing=tvu.ConvRouting(attn_kernel=True), **kw), params)(
        _t(x), torch.from_numpy(t), _t(tok))
    assert jcalls == tcalls == {"fused_affine_conv3x3": 12, "temporal_conv_fused": 12,
                                "fused_conv_tconv_padded": 6, "temporal_conv_padded": 1,
                                "fused_upconv3x3_padded": 1, "fused_spatial_attention_padded": 4}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


def test_pallas_gn_unet_matches_jax(monkeypatch):
    """The non-fused U-Net with `use_pallas_gn` (mc 32, mult (1, 2),
    attention at ds 2, 16x16, F=2; `tests/test_pallas_kernels.py:76-96`)
    against JAX `VideoUNet(use_pallas_gn=True)`: K7 in every ResBlock norm,
    the attention norms and the output norm (8 x 2 + 4 + 1 = 21) on both
    sides, no other kernel."""
    _jax_defaults(monkeypatch)
    kw = dict(in_channels=6, model_channels=32, out_channels=3, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(16, seed=28)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=28)
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    want = japply(jvu.VideoUNet(use_pallas_gn=True, **kw), params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    got = _load(tvu.VideoUNet(routing=tvu.ConvRouting(use_pallas_gn=True), **kw), params)(
        _t(x), torch.from_numpy(t), _t(tok))
    assert jcalls == tcalls == {"fused_group_norm_silu": 21}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


def test_downconv_unet_launches_and_output(monkeypatch):
    """mc 128, mult (1, 2), 64x64, F=2: the level after the downsample (32x32)
    is still padded, so the downsample runs K8 and its temporal conv K4b.
    Counts from the JAX package by `jax.eval_shape` (its forward at this
    width is slow on the CPU); the port's output against its own plain path."""
    _jax_defaults(monkeypatch)
    monkeypatch.setattr(jvu, "PERF_DOWNCONV", True)
    kw = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=1,
              attention_resolutions=(), channel_mult=(1, 2), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(64, seed=29)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=29)
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    jax.eval_shape(jvu.VideoUNet(fused=True, **kw).apply, params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    got = _load(tvu.VideoUNet(fused=True, routing=tvu.ConvRouting(downconv=True), **kw), params)(
        _t(x), torch.from_numpy(t), _t(tok))
    want = _load(tvu.VideoUNet(**kw), params)(_t(x), torch.from_numpy(t), _t(tok))
    assert jcalls == tcalls == {"temporal_conv_fused": 1, "fused_conv_tconv_padded": 16,
                                "fused_downconv3x3_padded": 1, "temporal_conv_padded": 2,
                                "fused_upconv3x3_padded": 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), **UNET_TOL)


ROUTES = {"padded_k8_k9": (dict(PERF_DOWNCONV=True, PERF_PALLAS_ATTN=True), dict(fused=True),
                           dict(fused=True,
                                routing=tvu.ConvRouting(downconv=True, attn_kernel=True))),
          "plain_k7": (dict(), dict(use_pallas_gn=True),
                       dict(routing=tvu.ConvRouting(use_pallas_gn=True))),
          "spatial_k10_k11": (dict(PERF_PALLAS_SPATIAL2_MIN_CH=0, PERF_PALLAS_SPATIAL=True,
                                   PERF_TCONV_HW=True), dict(fused=True),
                              dict(fused=True, routing=tvu.ConvRouting(
                                  spatial2_min_ch=0, pallas_spatial=True, tconv_hw=True))),
          "padded_k12": (dict(PERF_STREAM_KERNEL=True), dict(fused=True),
                         dict(fused=True, routing=tvu.ConvRouting(stream_kernel=True))),
          # the shipped routing with the mega-kernel off: K4a -> K4b where K3 was
          "padded_mega_off": (dict(PERF_MEGA_KERNEL=False), dict(fused=True),
                              dict(fused=True, routing=tvu.ConvRouting(mega_kernel=False))),
          # the K1 gate up to H*W 512: no padded level
          "spatial2_deep": (dict(PERF_PALLAS_SPATIAL2_MAX_S=512), dict(fused=True),
                            dict(fused=True, routing=tvu.ConvRouting(spatial2_max_s=512))),
          # the upsample convs into a padded level without K5
          "padded_upconv_off": (dict(PERF_UPCONV=False), dict(fused=True),
                                dict(fused=True, routing=tvu.ConvRouting(upconv=False))),
          # the 6-channel entry conv on the padded stream
          "padded_entry_pad": (dict(PERF_ENTRY_PAD=True), dict(fused=True),
                               dict(fused=True, routing=tvu.ConvRouting(entry_pad=True)))}
# padded_k8_k9 on the release U-Net with attention at ds 4 / 8 / 16 and
# 64-channel heads: K9 at the padded 32^2 level (1,024 tokens) too
WIDE = dict(attention_resolutions=(4, 8, 16), num_head_channels=64)
ROUTES["padded_k8_k9_wide"] = (ROUTES["padded_k8_k9"][0], dict(fused=True, **WIDE),
                               dict(fused=True, routing=tvu.ConvRouting(downconv=True,
                                                                         attn_kernel=True),
                                    **WIDE))
ARCH = ("attention_resolutions", "num_head_channels")


# each of the U-Net's last serving switches on a small U-Net (mc 128, mult
# (1, 2), attention at ds 2, 24x24: the smallest square level the padded
# stream takes, F=2): (JAX flags, JAX VideoUNet kwargs, port kwargs)
SWITCHES = {
    # K1 only at 12x12: the 24x24 level neither K1 nor padded
    "spatial2_max_s": (dict(PERF_PALLAS_SPATIAL2_MAX_S=512), dict(fused=True),
                       dict(fused=True, routing=tvu.ConvRouting(spatial2_max_s=512))),
    # the upsample conv into the padded 24x24 level: nearest-2x, pad, K3
    "upconv": (dict(PERF_UPCONV=False), dict(fused=True),
               dict(fused=True, routing=tvu.ConvRouting(upconv=False))),
    # the 6-channel entry conv on the padded stream: K3 at C=6
    "entry_pad": (dict(PERF_ENTRY_PAD=True), dict(fused=True),
                  dict(fused=True, routing=tvu.ConvRouting(entry_pad=True))),
    # the attention's plain path (the non-fused forward): the port's one
    # path against the JAX module's head-major form and its default form
    "attn_hmajor": (dict(PERF_ATTN_HMAJOR=True), dict(), dict()),
    "attn_hmajor_off": (dict(PERF_ATTN_HMAJOR=False), dict(), dict()),
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_unet_matches_jax(monkeypatch, switch):
    """Each switch of `ConvRouting` / `VideoUNet` added for the JAX flags
    `V2A_SPATIAL2_MAX_S`, `PERF_UPCONV` and `PERF_ENTRY_PAD`, and the port's
    one attention path for both values of `PERF_ATTN_HMAJOR`: the port's
    small U-Net against the JAX module with the flag monkeypatched, the same
    launches per kernel."""
    _jax_defaults(monkeypatch)
    flags, jkw, tkw = SWITCHES[switch]
    for flag, value in flags.items():
        monkeypatch.setattr(jvu, flag, value)
    kw = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(24, seed=43)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=43)
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    want = japply(jvu.VideoUNet(**jkw, **kw), params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    got = _load(tvu.VideoUNet(**tkw, **kw), params)(_t(x), torch.from_numpy(t), _t(tok))
    assert jcalls == tcalls and (jcalls or switch.startswith("attn_hmajor"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


@functools.lru_cache(maxsize=None)
def _release_args(arch=()):
    """The release U-Net's parameter shapes and (x, t, tokens), abstract;
    `arch`: (name, value) pairs of U-Net arguments that change its
    parameters."""
    x = jnp.zeros((1, 7, 128, 128, 6), jnp.bfloat16)
    t, tok = jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 512))
    params = jax.eval_shape(lambda: jvu.VideoUNet(dtype=jnp.bfloat16, **dict(arch)).init(
        jax.random.PRNGKey(0), x, t, tok))
    return params, x, t, tok


@pytest.mark.parametrize("route", list(ROUTES))
def test_release_counts_match_the_jax_trace(monkeypatch, route):
    """The release U-Net (128^2, F=7, bf16) of each new routing: the JAX
    package's launches by `jax.eval_shape` with its flags set, the port's on
    the meta device (`tests/test_torch_padded.py::
    test_release_forward_launch_counts` holds the port to the numbers)."""
    _jax_defaults(monkeypatch)
    flags, jkw, tkw = ROUTES[route]
    for flag, value in flags.items():
        monkeypatch.setattr(jvu, flag, value)
    params, x, t, tok = _release_args(tuple((k, v) for k, v in jkw.items() if k in ARCH))
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    jax.eval_shape(jvu.VideoUNet(dtype=jnp.bfloat16, **jkw).apply, params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL, via_plain=True)
    with torch.device("meta"), torch.no_grad():
        tvu.VideoUNet(dtype=torch.bfloat16, **tkw)(torch.randn(1, 7, 128, 128, 6),
                                                   torch.zeros(1, dtype=torch.long),
                                                   torch.randn(1, 77, 512))
    assert jcalls == tcalls and jcalls


def test_one_state_dict_loads_into_every_routing():
    """The parameter tree does not change with the routing: one converted
    state dict loads strictly into all five."""
    kw = dict(model_channels=128, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(2,), task_token_dim=64)
    R = tvu.ConvRouting
    routes = [dict(), dict(fused=True), dict(fused=True, routing=R(padded_stream=False)),
              dict(fused=True, routing=R(downconv=True, attn_kernel=True)),
              dict(routing=R(use_pallas_gn=True))]
    nets = [tvu.VideoUNet(**kw, **r) for r in routes]
    state = nets[0].state_dict()
    for net in nets[1:]:
        net.load_state_dict(state, strict=True)
        assert list(net.state_dict()) == list(state)


# -- the model: the repaired loss, and a trainer that cannot train through K7 ---------

SMALL = dict(image_size=(16, 16), sample_per_seq=3, timesteps=4, sampling_timesteps=4,
             model_channels=128, channel_mult=(1,), num_res_blocks=1, attention_resolutions=(),
             num_head_channels=32, text_dim=64)


def test_loss_runs_the_non_fused_unet(monkeypatch):
    """With `fused=True` the model's U-Net runs K1 / K2 at this width, but
    `loss` evaluates the non-fused U-Net on the same Parameter objects, as
    the JAX `_model_fn(for_training=True)` clones the U-Net with fused=False:
    neither side calls a kernel, and the values agree (rtol 1e-4 / atol
    1e-6, `tests/test_torch_train.py::test_p_losses_matches_jax`)."""
    from test_torch_train import _jax_noise

    jm = jvm.VideoPredModel(jvm.VideoModelConfig(fused=True, **SMALL))
    f, (h, w) = jm.config.video_future_horizon, jm.config.image_size
    unet = random_params(jm.unet, np.zeros((1, f, h, w, 6), np.float32), np.zeros((1,), np.int32),
                         np.zeros((1, 4, 64), np.float32), seed=30)
    text = random_params(jm.text_encoder, np.zeros((1, 4), np.int32), np.ones((1, 4), np.int32),
                         seed=31)
    jm.params = {"unet": unet, "text": text}
    tm = tvm.VideoPredModel(tvm.VideoModelConfig(fused=True, **SMALL), device="cpu")
    tm.load_state_dict(video_model_from_jax(unet, text))
    assert tm.unet.fused and not tm.loss_unet.fused and tm.loss_unet is tm.loss_unet
    for (name, p), q in zip(tm.unet.named_parameters(), tm.loss_unet.parameters()):
        assert p is q, name  # shared, not copied
    rs = np.random.RandomState(32)
    video = rs.rand(2, f, h, w, 3).astype(np.float32)
    x_cond = rs.rand(2, h, w, 3).astype(np.float32)
    te = rs.randn(2, 5, 64).astype(np.float32)
    rng = jax.random.PRNGKey(33)
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    want = jax.jit(lambda p: jm.loss(p, rng, jnp.asarray(video), jnp.asarray(x_cond),
                                     jnp.asarray(te)))(jm.params)
    # the JAX loss draws its timesteps and noise from `rng`; the port is
    # handed the same draws
    t = torch.from_numpy(np.array(jax.random.randint(jax.random.split(rng)[0], (2,), 0, 4)))
    noise = _t(_jax_noise(rng, video.shape))
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    with torch.no_grad():
        # the fault: the model's own (fused) U-Net runs kernels
        tm.diffusion.p_losses(tm.unet, _t(video), _t((x_cond * 2 - 1)[:, None]), _t(te), t=t,
                              noise=noise)
        assert tcalls["fused_affine_conv3x3"] and tcalls["temporal_conv_fused"]
        tcalls.clear()
        got = tm.loss(_t(video), _t(x_cond), _t(te), t=t, noise=noise)
    assert jcalls == {} and tcalls == {}
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-6)


def test_trainer_refuses_to_train_through_k7(tmp_path):
    """K7 has no backward (none in the JAX package either): a trainer whose
    config sets `use_pallas_gn` raises at its first step instead of
    dropping the gradients below every GroupNorm."""
    cfg = tvm.VideoModelConfig(use_pallas_gn=True, **dict(SMALL, model_channels=32))
    tm = tvm.VideoPredModel(cfg, device="cpu").init(0)
    tr = tvt.VideoModelTrainer(tm, None, tvt.VideoTrainerConfig(batch_size=2),
                               workdir=str(tmp_path))
    rs = np.random.RandomState(34)
    video = _t(rs.rand(2, 2, 16, 16, 3))
    with pytest.raises(RuntimeError, match="fused_group_norm_silu has no backward"):
        tr.train_step(video, _t(rs.rand(2, 1, 16, 16, 3) * 2 - 1), _t(rs.randn(2, 5, 64)),
                      torch.tensor([1, 3]), torch.ones(2))
    tr.close()
