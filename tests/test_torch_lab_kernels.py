"""The sixth slice's kernels against the JAX package, on the CPU: K13
(`fused_conv_tconv_dma`), K14 (`winograd_conv3x3`, `winograd_weights`), the
perf lab's temporal conv K15 (`temporal_conv_taps`), and K9 at the head
widths and token counts its kernel now takes; then the port's perf lab run
tiny.

On the CPU the wrappers run their plain PyTorch versions, held here against
the Pallas kernels in interpret mode (as `tests/test_pallas_kernels.py` runs
them), on the same numpy inputs. Tolerances: float32 as the JAX tests'
own (stated per test); bf16 within one bf16 ulp plus 1e-3 of the output's
std (float32 sums in another order round to neighbouring bf16 values).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_padded import _streams  # noqa: E402
from test_torch_serving_routes import _attn_inputs, _interior, _one_ulp, _zero_pads  # noqa: E402
from v2a_tpu.ops import resblock_kernels as jrk  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402
from v2a_tpu_torch.scripts import perf_lab  # noqa: E402


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


# -- K13: K3 with double-buffered copies ------------------------------------------


def _k13_inputs(rs, dtype, nan_pads):
    """`tests/test_pallas_kernels.py:712-761`'s inputs: B 2, F 3, 8x8, parts
    of 8 and 16 channels, D 16, a 16-channel skip part, emb. With
    `nan_pads` the port's streams carry NaN in every pad position and the
    JAX side finite garbage; without, both sides get that test's pad rows
    (3.3 and -2.2)."""
    b, f, h, w, d = 2, 3, 8, 8, 16
    hp, wp = jrk.padded_hw(h, w)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def stream(c, pad_rows):
        if nan_pads:
            jx, tx = _streams(rs, (b, f), (h, w), c)
            return jx.astype(jdt), tx.to(tdt)
        x = np.zeros((b, f, hp, wp, c), np.float32)
        if pad_rows:
            x[:, :, 0], x[:, :, -1] = 3.3, -2.2
        x[:, :, 1:h + 1, 1:w + 1] = rs.randn(b, f, h, w, c)
        return jnp.asarray(x).astype(jdt), _t(x).to(tdt)

    jparts, tparts = [], []
    for ci in (8, 16):
        jx, tx = stream(ci, True)
        k = (rs.randn(3, 3, ci, d) * 0.1).astype(np.float32)
        a = (1 + 0.1 * rs.randn(b * f, ci)).astype(np.float32)
        bb = (0.1 * rs.randn(b * f, ci)).astype(np.float32)
        jparts.append((jx, jnp.asarray(k), jnp.asarray(a), jnp.asarray(bb)))
        tparts.append((tx, _t(k), _t(a), _t(bb)))
    rest = [(rs.randn(d) * 0.1).astype(np.float32), (rs.randn(3, d, d) * 0.2).astype(np.float32),
            (rs.randn(d) * 0.1).astype(np.float32), (rs.randn(b, d) * 0.5).astype(np.float32)]
    jxs, txs = stream(16, False)
    ks = (rs.randn(16, d) * 0.1).astype(np.float32)
    sb = (rs.randn(d) * 0.1).astype(np.float32)
    jargs = (jparts, *map(jnp.asarray, rest[:3]), (h, w))
    jkw = dict(emb=jnp.asarray(rest[3]), skip_parts=[(jxs, jnp.asarray(ks))],
               skip_bias=jnp.asarray(sb))
    targs = (tparts, *map(_t, rest[:3]), (h, w))
    tkw = dict(emb=_t(rest[3]), skip_parts=[(txs, _t(ks))], skip_bias=_t(sb))
    return (jargs, jkw), (targs, tkw)


@pytest.mark.parametrize("dtype,nan_pads", [("float32", False), ("bfloat16", True)],
                         ids=["f32", "bf16-nan-pads"])
def test_conv_tconv_dma_plain_matches_pallas(dtype, nan_pads):
    """K13's plain version against `fused_conv_tconv_dma(interpret=True)`
    at the JAX test's shape, tile_h 4: float32 within atol 1e-5 on the
    interior, statistics rtol 1e-5 / atol 1e-4 (that test's tolerances);
    bf16 within one ulp, statistics within 1e-4 of their largest magnitude
    plus what one-ulp output differences move them by (sum over the
    frame's pixels of |y| 2^-7, and of |y|^2 2^-6). Pad cols exactly zero."""
    rs = np.random.RandomState(4)
    (jargs, jkw), (targs, tkw) = _k13_inputs(rs, dtype, nan_pads)
    want, wst = jrk.fused_conv_tconv_dma(*jargs, silu=True, want_stats=True, interpret=True,
                                         tile_h=4, **jkw)
    before = dict(trk.launches)
    got, gst = trk.fused_conv_tconv_dma(*targs, silu=True, want_stats=True, tile_h=4, **tkw)
    assert trk.launches == before  # CPU: the plain version, no launch
    hw = (8, 8)
    _zero_pads(got, hw)
    wst = np.asarray(wst)
    if dtype == "float32":
        np.testing.assert_allclose(_interior(got.numpy(), hw), _interior(np.asarray(want), hw),
                                   atol=1e-5)
        np.testing.assert_allclose(gst.numpy(), wst, rtol=1e-5, atol=1e-4)
        return
    _one_ulp(_interior(got, hw), _interior(want, hw))
    y = np.abs(_interior(np.asarray(want.astype(jnp.float32)), hw)).reshape(2, 3, -1, 16)
    slack = np.stack([y.sum(2) * 2.0 ** -7, (y * y).sum(2) * 2.0 ** -6], 2)
    assert (np.abs(gst.numpy() - wst) <= 1e-4 * np.abs(wst).max() + slack).all()


def test_conv_tconv_dma_keeps_the_jax_guards():
    """Where the JAX wrapper raises (:2403-2406), the port's does: a band
    height that does not divide H, and a shape where `conv_tconv_band_rows`
    admits no band (an interior too small for the mega-kernel's rows)."""
    rs = np.random.RandomState(5)
    _, (targs, tkw) = _k13_inputs(rs, "float32", False)
    with pytest.raises(ValueError, match="must divide"):
        trk.fused_conv_tconv_dma(*targs, tile_h=3, **tkw)
    with pytest.raises(ValueError, match="not viable"):
        trk.fused_conv_tconv_dma(*targs, **tkw)


@pytest.mark.parametrize("b,f,hw,cins,d,skip_cins", [
    (8, 7, (128, 128), (128,), 128, ()), (8, 7, (128, 128), (128, 128), 128, (128, 128)),
    (1, 7, (64, 64), (256, 128), 256, ()), (8, 7, (64, 64), (256,), 256, (256, 128)),
    (1, 7, (32, 32), (384, 384), 384, ())])
def test_conv_tconv_dma_launches_k3s_plan(monkeypatch, b, f, hw, cins, d, skip_cins):
    """K13's wrapper, driven to its launch with tensors on the meta device
    (the device checks, the library and the stream stubbed), hands its C
    entry point exactly the integers K3's wrapper hands K3's: the tile plan
    of `conv_tconv_plan` (pixels per tile; its TMA variant, with K13's
    larger shared memory, plans the same launch) and the shapes; its
    statistics buffers have K3's tiles."""
    import contextlib

    seen = {}

    def fake_lib(name, fn, nptr, nint):
        def launch(*args):
            seen[name] = (args[nptr:nptr + nint], args[nptr - 2].shape if args[nptr - 2] is not None
                          else None)
            return 0
        return launch

    monkeypatch.setattr(trk, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(trk, "_stream", lambda x: 0)
    monkeypatch.setattr(trk, "_ptr", lambda t: t)
    monkeypatch.setattr(trk, "_lib", fake_lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    hp, wp = trk.padded_hw(*hw)
    with torch.device("meta"):
        parts = [(torch.empty(b, f, hp, wp, c, dtype=torch.bfloat16), torch.empty(3, 3, c, d),
                  torch.empty(b * f, c), torch.empty(b * f, c)) for c in cins]
        skips = [(torch.empty(b, f, hp, wp, c, dtype=torch.bfloat16), torch.empty(c, d))
                 for c in skip_cins] or None
        args = (parts, torch.empty(d), torch.empty(3, d, d), torch.empty(d), hw,
                torch.empty(b, d), None, skips, torch.empty(d) if skips else None, True, True)
        trk.fused_conv_tconv_padded(*args)
        trk.fused_conv_tconv_dma(*args, tile_h=hw[0])
    k3, k13 = seen["conv_tconv_padded"], seen["conv_tconv_dma"]
    plan = trk.conv_tconv_plan(b, f, hw[0], hw[1], d)
    assert trk.conv_tconv_plan(b, f, hw[0], hw[1], d, tma=True)[:5] == plan[:5]
    assert k13 == k3 and k3[0][-3] == plan.pixels
    assert k3[1] == (b * f * plan.tiles * 2 * d,)


# -- K14: Winograd F(2x2, 3x3) ------------------------------------------------------


def test_winograd_weights_match_jax_exactly():
    rs = np.random.RandomState(6)
    k = rs.randn(3, 3, 16, 24).astype(np.float32)
    want = np.asarray(jrk.winograd_weights(jnp.asarray(k)))
    got = trk.winograd_weights(_t(k)).numpy()
    assert got.shape == (16, 16, 24) and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_winograd_conv3x3_plain_matches_pallas(dtype):
    """(1, 8, 8, 16) -> 16 against `winograd_conv3x3(interpret=True)`:
    float32 within atol 1e-5, bf16 within one ulp."""
    rs = np.random.RandomState(7)
    x = rs.randn(1, 8, 8, 16).astype(np.float32)
    k = (rs.randn(3, 3, 16, 16) * 0.1).astype(np.float32)
    bias = (0.1 * rs.randn(16)).astype(np.float32)
    want = jrk.winograd_conv3x3(jnp.asarray(x).astype(dtype), jnp.asarray(k), jnp.asarray(bias),
                                interpret=True)
    before = dict(trk.launches)
    got = trk.winograd_conv3x3(_t(x).to(getattr(torch, dtype)), _t(k), _t(bias))
    assert trk.launches == before
    assert got.dtype == getattr(torch, dtype) and got.shape == (1, 8, 8, 16)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    else:
        _one_ulp(got, want)


@pytest.mark.parametrize("hw", [(7, 8), (8, 5)])
def test_winograd_conv3x3_needs_even_sides(hw):
    x = torch.zeros(1, *hw, 16)
    with pytest.raises(ValueError, match="even H and W"):
        trk.winograd_conv3x3(x, torch.zeros(3, 3, 16, 16), torch.zeros(16))
    with pytest.raises(ValueError, match="even H and W"):
        jrk.winograd_conv3x3(jnp.zeros((1, *hw, 16)), jnp.zeros((3, 3, 16, 16)), jnp.zeros(16),
                             interpret=True)


# -- K15: the perf lab's temporal conv ------------------------------------------------


def _make_call(impl, tile, b, f, s, c):
    """`scripts/perf_lab.py:627-682` (`tconv_variants_bench.make_call`), a
    closure of that bench and so not importable, copied verbatim but for
    `interpret=True` in the pallas_call."""
    def kernel(x_ref, w_ref, o_ref):
        x = x_ref[0]  # (F, tile, C)
        w = w_ref[:]
        zeros = jnp.zeros((1,) + x.shape[1:], x.dtype)
        if impl == "all_frames":
            xm1 = jnp.concatenate([zeros, x[:-1]], axis=0)
            xp1 = jnp.concatenate([x[1:], zeros], axis=0)
            cat = jnp.concatenate([xm1, x, xp1], axis=-1).reshape(
                f * tile, 3 * c
            )
            y = jax.lax.dot_general(
                cat, w, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            o_ref[0] = y.reshape(f, tile, c).astype(o_ref.dtype)
        elif impl == "taps":
            w0, w1, w2 = w[:c], w[c:2 * c], w[2 * c:]
            for fi in range(f):
                acc = jax.lax.dot_general(
                    x[fi], w1, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
                if fi > 0:
                    acc += jax.lax.dot_general(
                        x[fi - 1], w0, (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32,
                    )
                if fi < f - 1:
                    acc += jax.lax.dot_general(
                        x[fi + 1], w2, (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32,
                    )
                o_ref[0, fi] = acc.astype(o_ref.dtype)
        else:  # frame_concat (production)
            z2 = jnp.zeros(x.shape[1:], x.dtype)
            for fi in range(f):
                xm1 = x[fi - 1] if fi > 0 else z2
                xp1 = x[fi + 1] if fi < f - 1 else z2
                cat = jnp.concatenate([xm1, x[fi], xp1], axis=-1)
                y = jax.lax.dot_general(
                    cat, w, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
                o_ref[0, fi] = y.astype(o_ref.dtype)

    n_tiles = s // tile
    return pl.pallas_call(
        kernel,
        grid=(b, n_tiles),
        in_specs=[
            pl.BlockSpec((1, f, tile, c), lambda i, j: (i, 0, j, 0)),
            pl.BlockSpec((3 * c, c), lambda i, j: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, f, tile, c), lambda i, j: (i, 0, j, 0)),
        out_shape=jax.ShapeDtypeStruct((b, f, s, c), jnp.bfloat16),
        interpret=True,
    )


@pytest.mark.parametrize("impl", ["frame_concat", "all_frames", "taps"])
def test_temporal_conv_taps_plain_matches_pallas(impl):
    """K15's plain version against each of the three TPU schedules at
    (1, 3, 16, 16), bf16: within one ulp."""
    rs = np.random.RandomState(8)
    b, f, s, c = 1, 3, 16, 16
    x = rs.randn(b, f, s, c).astype(np.float32)
    w = (rs.randn(3 * c, c) * 0.05).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
    want = _make_call(impl, 8, b, f, s, c)(jx, jw)
    before = dict(trk.launches)
    got = perf_lab.temporal_conv_taps(_t(x).bfloat16(), _t(w).bfloat16())
    assert trk.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == (b, f, s, c)
    _one_ulp(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,f,s,c", [(8, 7, 16384, 128), (8, 7, 64, 640), (1, 3, 1000, 192)])
def test_temporal_conv_taps_is_k2s_launch(monkeypatch, dtype, b, f, s, c):
    """K15's wrapper, driven to its launch on meta tensors (the device
    checks, the library and the stream stubbed), calls K2's entry
    (`v2a_temporal_conv3` of `temporal_conv.cu`) with the integers K2's
    wrapper hands it for the same x, on x itself, with w as the (3C, C)
    kernel, a cached float32 zero bias of C elements and no emb, residual or
    statistics, and counts the launch as K15's, not K2's."""
    import contextlib

    seen = []

    def fake_lib(name, fn, nptr, nint, nfloat=0):
        def launch(*args):
            seen.append((name, fn, args[:nptr], args[nptr:nptr + nint]))
            return 0
        return launch

    monkeypatch.setattr(trk, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(trk, "_stream", lambda x: 0)
    monkeypatch.setattr(trk, "_ptr", lambda t: t)
    monkeypatch.setattr(trk, "_lib", fake_lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(trk, "launches", {k: 0 for k in trk.launches})
    monkeypatch.setattr(perf_lab, "_zero_bias", {})
    with torch.device("meta"):
        x, w = torch.empty(b, f, s, c, dtype=dtype), torch.empty(3 * c, c)
        y = perf_lab.temporal_conv_taps(x, w)
        perf_lab.temporal_conv_taps(x, w)
        zero = perf_lab._zero_bias[(x.device, c)]
        trk.temporal_conv_fused(x, w.reshape(3, c, c), zero)
    (name, fn, ptrs, ints), (_, _, ptrs2, _), (_, k2_fn, k2_ptrs, k2_ints) = seen
    assert (name, fn) == ("temporal_conv", "v2a_temporal_conv3") and k2_fn == fn
    assert ints == k2_ints == (b, f, s, c, trk._DTYPE_CODE[dtype])
    assert ptrs[0] is x and ptrs[5] is y and y.shape == x.shape and y.dtype == dtype
    assert tuple(ptrs[1].shape) == (3 * c, c) and ptrs[1].dtype == dtype
    assert ptrs[2] is zero is ptrs2[2] and zero.dtype == torch.float32 and zero.shape == (c,)
    assert ptrs[3] is ptrs[4] is ptrs[6] is ptrs[7] is None
    assert trk.launches["temporal_conv_taps"] == 2 and trk.launches["temporal_conv_fused"] == 1


# -- K9: any head width, any token count ---------------------------------------------


@pytest.mark.parametrize("n,hw,c,ch", [(1, (32, 32), 128, 64), (2, (6, 10), 96, 32)],
                         ids=["head64-1024-tokens", "head32-c96"])
def test_spatial_attention_beyond_the_old_kernel_limits(n, hw, c, ch):
    """K9's plain version against the Pallas kernel (interpret mode, f32)
    where the port's kernel refused before: 64-channel heads over 1,024
    interior tokens, and C = 96 (no multiple of 64). atol / rtol 2e-4,
    statistics atol 5e-3 / rtol 5e-4 (`tests/test_pallas_kernels.py:1067,
    1076`); every pad position zero."""
    rs = np.random.RandomState(9)
    jx, tx, params = _attn_inputs(rs, n, hw, c)
    want, wst = jrk.fused_spatial_attention_padded(jx, hw, *map(jnp.asarray, params), ch,
                                                   want_stats=True, interpret=True)
    got, gst = trk.fused_spatial_attention_padded(tx, hw, *map(_t, params), ch, want_stats=True)
    _zero_pads(got, hw, cols_only=False)
    np.testing.assert_allclose(_interior(got.numpy(), hw), _interior(np.asarray(want), hw),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), atol=5e-3, rtol=5e-4)


# -- the port's perf lab ----------------------------------------------------------------


def test_perf_lab_runs_tiny_on_the_cpu():
    """Both benches at tiny shapes on the plain versions: a row per (shape,
    implementation), K14's error against the library conv within bf16
    rounding, and no kernel launched (the CPU)."""
    lines = []
    before = dict(trk.launches)
    rows = perf_lab.winobench2([("t", 2, 8, 8, 32)], device="cpu", chain=2, iters=1,
                               out=lines.append)
    rows += perf_lab.tconvbench2([("t", 1, 3, 16, 64)], device="cpu", chain=2, iters=1,
                                 out=lines.append)
    assert trk.launches == before
    assert [(r["bench"], r["impl"]) for r in rows] == [
        ("winobench2", "library"), ("winobench2", "direct"), ("winobench2", "wino"),
        ("tconvbench2", "kernel"), ("tconvbench2", "stacked-matmul")]
    assert len(lines) == 5 and all("cpu (host clock)" in line for line in lines)
    assert all(r["ms"] > 0 for r in rows) and 0 < rows[2]["relerr"] < 2e-2


@pytest.mark.parametrize("argv,match", [(["winobench2", "megabench:L9"], "level"),
                                        (["winobench2", "fused_join_wide"], "tap-join"),
                                        ([], None)],
                         ids=["other-bench", "one-unported", "default-ablations"])
def test_perf_lab_refuses_what_it_does_not_port(argv, match, monkeypatch):
    """Every name is checked before a bench runs: a bad argument of another
    bench and a name with no counterpart on the card (K3's TPU-only tap
    join) raise `ValueError` saying why, and nothing runs. With no name the
    lab runs the JAX lab's default, the five ablations, and no bench."""
    ran = []
    monkeypatch.setattr(perf_lab, "BENCHES", {name: lambda **kw: ran.append(kw)
                                              for name in perf_lab.BENCHES})
    monkeypatch.setattr(perf_lab, "time_forward", lambda name, *a, **k: ran.append(name)
                        or dict(bench="forward", name=name, ms=1.0))
    if match is None:
        perf_lab.main(argv, device="cpu", out=lambda _: None)
        assert ran == list(perf_lab.ABLATIONS)
        return
    with pytest.raises(ValueError, match=match):
        perf_lab.main(argv, device="cpu")
    assert not ran


def test_perf_lab_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_lab.winobench2([("t", 1, 8, 8, 32)], chain=1, iters=1, out=lambda _: None)


def test_lab_kernels_are_registered():
    """K13-K15 have registry entries (K15 in the lab's module) and counts."""
    for name in ("fused_conv_tconv_dma", "winograd_conv3x3", "temporal_conv_taps"):
        assert name in trk.KERNELS and trk.launches[name] >= 0
        assert callable(getattr(trk.wrapper_module(name), name))
    assert trk.wrapper_module("temporal_conv_taps") is perf_lab
    assert all(e["source"].endswith(".cu") for e in trk.KERNELS.values())
