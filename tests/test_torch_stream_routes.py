"""The video U-Net's routings that reach K10 (`spatial_conv3x3`), K11
(`temporal_conv_fused_hw`) and K12 (`fused_conv_tconv_stream`) against the
JAX package, on the CPU.

On the CPU the wrappers run their plain PyTorch versions, held here against
the JAX Pallas kernels in interpret mode (as `tests/test_pallas_kernels.py`
runs them): in float32 at the JAX tests' own tolerances (atol 1e-4, the
statistics atol 1e-3 / rtol 1e-5), in bf16 within one bf16 ulp (plus 1e-3
of the output's std near zero). The port's padded inputs carry NaN in
every pad position, the JAX side finite garbage. Then a conv through K10's
split path, pinning the bf16 sum of its parts; small U-Nets of both
routings against the JAX modules with the same flags and the same launches
per kernel; and the copied K12 gate at the release shapes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_padded import (  # noqa: E402
    KTOL, PACKAGE_KERNELS, STATS_TOL, _counting, _jax_defaults, _jax_module, _streams)
from test_torch_serving_routes import _interior, _np, _one_ulp, _t, _zero_pads  # noqa: E402
from test_torch_video import UNET_TOL, _load, _unet_inputs, japply, random_params  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu.ops import resblock_kernels as jrk  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402

ALL = PACKAGE_KERNELS
# the JAX module flags of each routing, and the port's VideoUNet arguments
ROUTES = {
    "spatial_k10_k11": (dict(PERF_PALLAS_SPATIAL2_MIN_CH=0, PERF_PALLAS_SPATIAL=True,
                             PERF_TCONV_HW=True),
                        dict(fused=True, spatial2_min_ch=0, pallas_spatial=True, tconv_hw=True)),
    "padded_k12": (dict(PERF_STREAM_KERNEL=True), dict(fused=True, stream_kernel=True)),
}


def _route(monkeypatch, route):
    """The JAX package's shipped flags with this routing's set; returns the
    port's VideoUNet arguments."""
    _jax_defaults(monkeypatch)
    for flag in ("PERF_PALLAS_SPATIAL", "PERF_TCONV_HW"):
        monkeypatch.setattr(jvu, flag, False)
    for flag, value in ROUTES[route][0].items():
        monkeypatch.setattr(jvu, flag, value)
    return ROUTES[route][1]


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **KTOL)
    else:
        _one_ulp(got, want)


# -- K10: the plain 3x3 conv ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,d", [(2, 8, 16, 128, 128), (3, 5, 7, 32, 64)])
def test_spatial_conv3x3_plain_matches_pallas(dtype, n, h, w, c, d):
    """One K10 call against the Pallas kernel; the second shape has a width
    that is no multiple of 8 and rows that do not fill a band."""
    rs = np.random.RandomState(40)
    x = rs.randn(n, h, w, c).astype(np.float32)
    k = (rs.randn(3, 3, c, d) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.1 * rs.randn(d)).astype(np.float32)
    want = jrk.spatial_conv3x3(jnp.asarray(x).astype(dtype), jnp.asarray(k), jnp.asarray(bias),
                               interpret=True)
    before = dict(trk.launches)
    got = trk.spatial_conv3x3(_t(x).to(getattr(torch, dtype)), _t(k), _t(bias))
    assert trk.launches == before  # CPU: the plain version, no launch
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, h, w, d)
    _close(got, want, dtype)


def _split_parts(rs, cins, d):
    x = [rs.randn(2, 8, 8, c).astype(np.float32) for c in cins]
    k = (rs.randn(3, 3, sum(cins), d) / np.sqrt(9 * sum(cins))).astype(np.float32)
    return x, k, (0.1 * rs.randn(d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_conv3x3_two_parts_match_pallas(dtype):
    """The split path's two K10 calls: the bias with the first part only,
    zeros with the second, the results summed in the compute dtype; the
    JAX kernels summed the same way."""
    rs = np.random.RandomState(41)
    x, k, bias = _split_parts(rs, (128, 256), 128)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = (jrk.spatial_conv3x3(jnp.asarray(x[0]).astype(jdt), jnp.asarray(k[:, :, :128]),
                                jnp.asarray(bias), interpret=True)
            + jrk.spatial_conv3x3(jnp.asarray(x[1]).astype(jdt), jnp.asarray(k[:, :, 128:]),
                                  jnp.zeros_like(jnp.asarray(bias)), interpret=True))
    got = (trk.spatial_conv3x3(_t(x[0]).to(tdt), _t(k[:, :, :128]), _t(bias))
           + trk.spatial_conv3x3(_t(x[1]).to(tdt), _t(k[:, :, 128:]), torch.zeros(128)))
    assert got.dtype == tdt
    _close(got, want, dtype)


def test_split_conv_sums_its_k10_parts_in_bf16(monkeypatch):
    """bf16, the fused PseudoConv3d on an (h, skip) pair without the K1 gate:
    one K10 launch per part, and the parts summed as two rounded bf16
    tensors (`v2a_tpu/models/video_unet.py:599`), not in float32 and rounded
    once. The port agrees with the JAX module far more closely than that
    variant does. Gate: one ulp of the output plus what the temporal taps
    carry of a one-ulp difference in their bf16 input (the summed parts),
    sum_t |W_t| ulp(y(f + t - 1)), as `chip_smoke.py` holds K3."""
    _jax_defaults(monkeypatch)
    monkeypatch.setattr(jvu, "PERF_PALLAS_SPATIAL2_MIN_CH", 0)
    monkeypatch.setattr(jvu, "PERF_PALLAS_SPATIAL", True)
    rs = np.random.RandomState(42)
    parts = [rs.randn(1, 2, 8, 8, c).astype(np.float32) for c in (128, 128)]
    jm = jvu.PseudoConv3d(128, dtype=jnp.bfloat16, fused=True)
    params = random_params(jm, tuple(jnp.asarray(p) for p in parts), seed=42)
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    want = jm.apply(params, tuple(jnp.asarray(p) for p in parts))
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    tm = _load(tvu.PseudoConv3d(256, 128, dtype=torch.bfloat16, fused=True,
                                routing=tvu.ConvRouting(spatial2_min_ch=0, pallas_spatial=True)),
               params)
    got = tm(tuple(_t(p) for p in parts))
    assert jcalls == tcalls == {"spatial_conv3x3": 2, "temporal_conv_fused": 1}
    w = _np(want)
    # the variant: the two parts' convs in one float32 sum, rounded once
    sc = tm.spatial_conv
    x = torch.cat([_t(p) for p in parts], -1).reshape(2, 8, 8, 256).bfloat16()
    y = trk.spatial_conv3x3_plain(x, sc.kernel, sc.bias).reshape(1, 2, 8, 8, 128)
    tk, tb = tm.temporal_conv.kernel, tm.temporal_conv.bias
    once = trk.temporal_conv_fused_plain(y, tk, tb)

    def mismatches(v):
        return int((_np(v) != w).sum())

    assert mismatches(got) * 4 + 20 < mismatches(once), (mismatches(got), mismatches(once))
    y = sum(trk.spatial_conv3x3_plain(_t(p).reshape(2, 8, 8, 128).bfloat16(),
                                      sc.kernel[:, :, 128 * i:128 * (i + 1)],
                                      sc.bias if i == 0 else torch.zeros(128))
            for i, p in enumerate(parts))
    ulp_y = torch.nn.functional.pad(y.float().abs().reshape(1, 2, 64, 128) * 2.0 ** -7,
                                    (0, 0, 0, 0, 1, 1))
    wt = tk.bfloat16().float().abs()
    carried = sum(ulp_y[:, i:i + 2] @ wt[i] for i in range(3)).reshape(w.shape).numpy()
    bad = np.abs(_np(got) - w) > np.abs(w) * 2.0 ** -7 + 1e-3 * w.std() + carried
    assert not bad.any(), f"{bad.sum()} of {bad.size} beyond the gate"


# -- K11: the temporal conv on the (H*W, B, F, C) view ---------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extras", [True, False], ids=["emb_residual_stats", "bare"])
def test_temporal_conv_hw_plain_matches_pallas(dtype, extras):
    """With emb, a broadcast residual and the statistics, and without any."""
    rs = np.random.RandomState(43)
    b, f, h, w, c = 2, 3, 4, 8, 128
    x = rs.randn(b, f, h, w, c).astype(np.float32)
    k = (rs.randn(3, c, c) / np.sqrt(3 * c)).astype(np.float32)
    bias = (0.1 * rs.randn(c)).astype(np.float32)
    emb = res = None
    if extras:
        emb = (0.5 * rs.randn(b, c)).astype(np.float32)
        res = rs.randn(b, f, 1, w, c).astype(np.float32)  # broadcast over H
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jrk.temporal_conv_fused_hw(
        jnp.asarray(x).astype(jdt), jnp.asarray(k), jnp.asarray(bias),
        emb=None if emb is None else jnp.asarray(emb),
        residual=None if res is None else jnp.asarray(res), want_stats=extras, interpret=True)
    before = dict(trk.launches)
    got = trk.temporal_conv_fused_hw(_t(x).to(tdt), _t(k), _t(bias), _t(emb), _t(res),
                                     want_stats=extras)
    assert trk.launches == before
    if extras:
        (got, gst), (want, wst) = got, want
        wst = np.asarray(wst)
        if dtype == "float32":
            np.testing.assert_allclose(gst.numpy(), wst, **STATS_TOL)
        else:
            np.testing.assert_allclose(gst.numpy(), wst, atol=1e-4 * np.abs(wst).max())
    assert got.shape == x.shape and got.dtype == tdt
    _close(got, want, dtype)


# -- K12: the frame-streaming conv + temporal conv ------------------------------------


def _k12_inputs(rs, b, f, hw, cins, d, emb, res):
    jparts, tparts = [], []
    for c in cins:
        jx, tx = _streams(rs, (b, f), hw, c)
        k = (rs.randn(3, 3, c, d) * 0.1).astype(np.float32)
        a = (1 + 0.1 * rs.randn(b * f, c)).astype(np.float32)
        bb = (0.1 * rs.randn(b * f, c)).astype(np.float32)
        jparts.append((jx, jnp.asarray(k), jnp.asarray(a), jnp.asarray(bb)))
        tparts.append((tx, _t(k), _t(a), _t(bb)))
    kbias, tb = (0.1 * rs.randn(d)).astype(np.float32), (0.1 * rs.randn(d)).astype(np.float32)
    tk = (rs.randn(3, d, d) * 0.2).astype(np.float32)
    e = (0.5 * rs.randn(b, d)).astype(np.float32) if emb else None
    jr = tr = None
    if res:
        jr, tr = _streams(rs, (b, f), hw, d)
    jargs = (jparts, jnp.asarray(kbias), jnp.asarray(tk), jnp.asarray(tb), hw)
    targs = (tparts, _t(kbias), _t(tk), _t(tb), hw)
    return jargs, targs, (None if e is None else jnp.asarray(e), jr), (_t(e), tr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu,emb,res,cins", [(True, True, True, (8, 16)),
                                               (False, False, False, (16,)),
                                               (True, False, True, (16,))],
                         ids=["silu_emb_res_2parts", "affine_bare", "silu_res"])
def test_conv_tconv_stream_plain_matches_pallas(dtype, silu, emb, res, cins):
    """K12 against the Pallas kernel (F = 4, frames streamed through the
    ring, bands of 4 rows): NaN in every port pad position, finite garbage
    in the JAX ones; the interiors agree, the port's pad cols are exactly
    zero, the statistics agree."""
    rs = np.random.RandomState(44)
    b, f, hw, d = 2, 4, (8, 8), 16
    jargs, targs, (je, jr), (te, tr) = _k12_inputs(rs, b, f, hw, cins, d, emb, res)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jparts = [(q[0].astype(jdt), q[1], q[2], q[3]) for q in jargs[0]]
    tparts = [(q[0].to(tdt), q[1], q[2], q[3]) for q in targs[0]]
    want, wst = jrk.fused_conv_tconv_stream(
        jparts, *jargs[1:], emb=je, residual=None if jr is None else jr.astype(jdt), silu=silu,
        want_stats=True, tile_h=4, interpret=True)
    before = dict(trk.launches)
    got, gst = trk.fused_conv_tconv_stream(tparts, *targs[1:], te,
                                           None if tr is None else tr.to(tdt), silu=silu,
                                           want_stats=True)
    assert trk.launches == before
    assert got.dtype == tdt and got.shape == (b, f) + trk.padded_hw(*hw) + (d,)
    _zero_pads(got, hw)
    wst = np.asarray(wst)
    if dtype == "float32":
        np.testing.assert_allclose(gst.numpy(), wst, **STATS_TOL)
    else:
        np.testing.assert_allclose(gst.numpy(), wst, atol=1e-3 * np.abs(wst).max())
    _close(_interior(got, hw), _interior(np.asarray(want.astype(jnp.float32)), hw), dtype)


@pytest.mark.parametrize("hw,cins,d", [((128, 128), (128,), 128), ((64, 64), (128,), 256),
                                       ((64, 64), (256,), 256), ((64, 64), (256, 256), 256),
                                       ((32, 32), (256,), 384), ((32, 32), (384, 384), 384),
                                       ((32, 32), (384, 256), 384), ((24, 24), (128,), 128)])
def test_stream_band_rows_is_the_jax_gate(hw, cins, d):
    """The copied gate gives the JAX package's band at the release U-Net's
    padded shapes, and at the small U-Net's below; K12 is viable at each."""
    wp = trk.padded_hw(*hw)[1]
    got = trk.stream_band_rows(hw[0], hw[1], wp, list(cins), d)
    assert got == jrk.stream_band_rows(hw[0], hw[1], wp, list(cins), d) > 0


# -- the U-Nets ----------------------------------------------------------------------


def test_spatial_k10_k11_unet_matches_jax(monkeypatch):
    """mc 128, mult (1, 2), attention at ds 2, 16x16, F=2, the K1 gate off
    (`V2A_SPATIAL2_MIN_CH=0`), `PERF_PALLAS_SPATIAL` and `PERF_TCONV_HW`: no
    padded stream, the ResBlock norms as tensor ops, K10 at every 3x3
    stride-1 conv with 128-multiple channels (one launch per part of the up
    path's pairs), K11 at every temporal conv, as the JAX package."""
    tkw = _route(monkeypatch, "spatial_k10_k11")
    kw = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(16, seed=45)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=45)
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    want = japply(jvu.VideoUNet(fused=True, **kw), params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    got = _load(tvu.VideoUNet(**kw, **tkw), params)(_t(x), torch.from_numpy(t), _t(tok))
    assert jcalls == tcalls == {"spatial_conv3x3": 21, "temporal_conv_fused_hw": 19}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


def test_padded_k12_unet_matches_jax(monkeypatch):
    """mc 128, mult (1,), 24x24 (576 interior pixels: the smallest square
    level the padded stream takes), F=2, `V2A_STREAM_KERNEL=1`: K12 in both
    convs of the down and middle blocks and in the up blocks' first convs
    (two parts, the (h, skip) pair), K3 where a skip fold rides the conv,
    as the JAX package."""
    tkw = _route(monkeypatch, "padded_k12")
    kw = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=1,
              attention_resolutions=(), channel_mult=(1,), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(24, seed=46)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=46)
    jcalls = _counting(monkeypatch, _jax_module, ALL)
    want = japply(jvu.VideoUNet(fused=True, **kw), params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, ALL)
    got = _load(tvu.VideoUNet(**kw, **tkw), params)(_t(x), torch.from_numpy(t), _t(tok))
    assert jcalls == tcalls == {"temporal_conv_fused": 1, "fused_conv_tconv_stream": 8,
                                "fused_conv_tconv_padded": 2}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)
