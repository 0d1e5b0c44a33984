"""The port's padded-stream routing against the JAX package, on the CPU.

On the CPU the K3 / K4a / K4b / K5 wrappers run their plain PyTorch
versions. These are held against the JAX Pallas kernels in interpret mode,
in float32 at tiny shapes, atol 1e-4: the JAX side gets finite garbage in
every input pad position, the port side NaN, and the interiors must agree
(the contract: pad values are removed by selection, never by arithmetic).
Then the padded U-Net against JAX `fused=True` with its default flags,
with the same launches per kernel; a routing that reaches K4a against the
port's own plain path; one state dict for both routings; and the release
forward's launch counts, traced on the meta device.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_video import UNET_TOL, _load, _unet_inputs, japply, random_params  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu.ops import resblock_kernels as jrk  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402

KTOL = dict(atol=1e-4, rtol=1e-5)
STATS_TOL = dict(atol=1e-3, rtol=1e-5)
HW = (8, 8)
PADDED = ("fused_conv_tconv_padded", "fused_affine_conv3x3_padded", "temporal_conv_padded",
          "fused_upconv3x3_padded")


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32))


def _streams(rs, lead, hw, c):
    """One random interior as two padded streams: (JAX, garbage pads; port,
    NaN pads)."""
    h, w = hw
    hp, wp = trk.padded_hw(h, w)
    jx = rs.uniform(-9, 9, lead + (hp, wp, c)).astype(np.float32)
    tx = np.full(lead + (hp, wp, c), np.nan, np.float32)
    inner = rs.randn(*lead, h, w, c).astype(np.float32)
    jx[..., 1:h + 1, 1:w + 1, :] = inner
    tx[..., 1:h + 1, 1:w + 1, :] = inner
    return jnp.asarray(jx), torch.from_numpy(tx)


def _same_stream(got, want, hw):
    """Port interior == JAX interior; port pad cols exactly zero."""
    h, w = hw
    got = got.numpy()
    np.testing.assert_allclose(got[..., 1:h + 1, 1:w + 1, :],
                               np.asarray(want)[..., 1:h + 1, 1:w + 1, :], **KTOL)
    assert not np.any(got[..., 1:h + 1, 0, :]) and not np.any(got[..., 1:h + 1, w + 1:, :])


def _conv_parts(rs, lead, rows, cins, d):
    jparts, tparts = [], []
    for c in cins:
        jx, tx = _streams(rs, lead, HW, c)
        k = (rs.randn(3, 3, c, d) * 0.1).astype(np.float32)
        a = (1 + 0.1 * rs.randn(rows, c)).astype(np.float32)
        b = (0.1 * rs.randn(rows, c)).astype(np.float32)
        jparts.append((jx, jnp.asarray(k), jnp.asarray(a), jnp.asarray(b)))
        tparts.append((tx, _t(k), _t(a), _t(b)))
    return jparts, tparts


def _tconv_extras(rs, b, f, d, emb, res, skip_cins):
    """(JAX kwargs, port kwargs) for the temporal half."""
    e = (0.5 * rs.randn(b, d)).astype(np.float32) if emb else None
    jr = tr = None
    if res:
        jr, tr = _streams(rs, (b, f), HW, d)
    jsk, tsk = [], []
    for c in skip_cins:
        jx, tx = _streams(rs, (b, f), HW, c)
        k = (rs.randn(c, d) * 0.2).astype(np.float32)
        jsk.append((jx, jnp.asarray(k)))
        tsk.append((tx, _t(k)))
    sb = (0.1 * rs.randn(d)).astype(np.float32) if skip_cins else None
    jkw = dict(emb=None if e is None else jnp.asarray(e), residual=jr, skip_parts=jsk or None,
               skip_bias=None if sb is None else jnp.asarray(sb), want_stats=True)
    tkw = dict(emb=_t(e), residual=tr, skip_parts=tsk or None, skip_bias=_t(sb), want_stats=True)
    return jkw, tkw


def _no_launch():
    return {k: trk.launches[k] for k in PADDED}


@pytest.mark.parametrize("silu", [True, False])
def test_affine_conv3x3_padded_matches_pallas(silu):
    rs = np.random.RandomState(1)
    jparts, tparts = _conv_parts(rs, (2,), 2, (8, 16), 16)
    bias = (0.1 * rs.randn(16)).astype(np.float32)
    want = jrk.fused_affine_conv3x3_padded(jparts, jnp.asarray(bias), HW, silu=silu, tile_h=4,
                                           interpret=True)
    before = _no_launch()
    got = trk.fused_affine_conv3x3_padded(tparts, _t(bias), HW, silu=silu)
    assert _no_launch() == before  # CPU: the plain version, no launch
    _same_stream(got, want, HW)


@pytest.mark.parametrize("emb,res,skip_cins", [(True, True, ()), (True, False, (8, 16))],
                         ids=["emb_residual", "skip_fold"])
def test_temporal_conv_padded_matches_pallas(emb, res, skip_cins):
    rs = np.random.RandomState(2)
    b, f, c = 2, 3, 8
    jx, tx = _streams(rs, (b, f), HW, c)
    k = (rs.randn(3, c, c) * 0.2).astype(np.float32)
    bias = (0.1 * rs.randn(c)).astype(np.float32)
    jkw, tkw = _tconv_extras(rs, b, f, c, emb, res, skip_cins)
    want, wst = jrk.temporal_conv_padded(jx, jnp.asarray(k), jnp.asarray(bias), HW,
                                         interpret=True, tile_r=4, **jkw)
    got, gst = trk.temporal_conv_padded(tx, _t(k), _t(bias), HW, **tkw)
    _same_stream(got, want, HW)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), **STATS_TOL)


@pytest.mark.parametrize("res,skip_cins", [(False, (8, 16)), (True, ())],
                         ids=["skip_fold", "residual"])
def test_conv_tconv_padded_matches_pallas(res, skip_cins):
    rs = np.random.RandomState(3)
    b, f, d = 2, 3, 16
    jparts, tparts = _conv_parts(rs, (b, f), b * f, (8, 16), d)
    kbias = (0.1 * rs.randn(d)).astype(np.float32)
    tk = (rs.randn(3, d, d) * 0.2).astype(np.float32)
    tb = (0.1 * rs.randn(d)).astype(np.float32)
    jkw, tkw = _tconv_extras(rs, b, f, d, True, res, skip_cins)
    want, wst = jrk.fused_conv_tconv_padded(jparts, jnp.asarray(kbias), jnp.asarray(tk),
                                            jnp.asarray(tb), HW, silu=True, tile_h=4,
                                            interpret=True, **jkw)
    args = (tparts, _t(kbias), _t(tk), _t(tb), HW)
    got, gst = trk.fused_conv_tconv_padded(*args, silu=True, **tkw)
    _same_stream(got, want, HW)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), **STATS_TOL)
    # K3's definition: K4a, rounded, then K4b
    hp, wp = trk.padded_hw(*HW)
    flat = [(x.reshape(b * f, hp, wp, -1), k, a, bb) for x, k, a, bb in tparts]
    y = trk.fused_affine_conv3x3_padded_plain(flat, _t(kbias), HW, True)
    two, tst = trk.temporal_conv_padded_plain(y.reshape(b, f, hp, wp, d), _t(tk), _t(tb), HW,
                                              **tkw)
    assert torch.equal(got[:, :, 1:-1], two[:, :, 1:-1]) and torch.equal(gst, tst)


@pytest.mark.parametrize("kernel", ["k4a", "k3"])
def test_widened_entry_conv_matches_pallas(kernel):
    """The 6-channel entry conv of `entry_pad` (identity affine, no SiLU):
    the operands the wrappers hand the card, zero-extended to 32 channels
    by `widen_channels` (zero channels, zero kernel rows, zero affine), give
    through the plain version what the JAX Pallas kernel gives on the 6
    real channels in interpret mode, as does the plain version on those 6."""
    rs = np.random.RandomState(44)
    b, f, d = 2, 3, 64
    jparts, tparts = _conv_parts(rs, (b, f), b * f, (6,), d)
    tparts = [(x, k, torch.ones_like(a), torch.zeros_like(bb)) for x, k, a, bb in tparts]
    jparts = [(x, k, jnp.ones_like(a), jnp.zeros_like(bb)) for x, k, a, bb in jparts]
    wide = [trk.widen_channels(*p) for p in tparts]
    x32, k32, a32, b32 = wide[0]
    assert x32.shape[-1] == k32.shape[2] == a32.shape[-1] == 32 == trk.widened(6)
    assert not x32[..., 6:].any() and not k32[:, :, 6:].any() and not a32[:, 6:].any()
    assert not b32[:, 6:].any() and torch.equal(k32[:, :, :6], tparts[0][1])
    assert trk.widen_channels(*wide[0])[0] is x32  # a multiple of 32 passes as it is
    kbias = (0.1 * rs.randn(d)).astype(np.float32)
    hp, wp = trk.padded_hw(*HW)
    if kernel == "k4a":
        flat = lambda parts: [(x.reshape(b * f, hp, wp, -1), k, a[:b * f], bb[:b * f])
                              for x, k, a, bb in parts]
        want = jrk.fused_affine_conv3x3_padded(flat(jparts), jnp.asarray(kbias), HW, silu=False,
                                               tile_h=4, interpret=True)
        for parts in (tparts, wide):
            _same_stream(trk.fused_affine_conv3x3_padded_plain(flat(parts), _t(kbias), HW,
                                                               silu=False), want, HW)
        return
    tk = (rs.randn(3, d, d) * 0.2).astype(np.float32)
    tb = (0.1 * rs.randn(d)).astype(np.float32)
    want, wst = jrk.fused_conv_tconv_padded(jparts, jnp.asarray(kbias), jnp.asarray(tk),
                                            jnp.asarray(tb), HW, silu=False, tile_h=4,
                                            want_stats=True, interpret=True)
    for parts in (tparts, wide):
        got, gst = trk.fused_conv_tconv_padded_plain(parts, _t(kbias), _t(tk), _t(tb), HW,
                                                     silu=False, want_stats=True)
        _same_stream(got, want, HW)
        np.testing.assert_allclose(gst.numpy(), np.asarray(wst), **STATS_TOL)


@pytest.mark.parametrize("affine", [False, True])
def test_upconv3x3_padded_matches_pallas(affine):
    rs = np.random.RandomState(4)
    n, c, d = 3, 8, 16
    jx, tx = _streams(rs, (n,), HW, c)
    k = (rs.randn(3, 3, c, d) * 0.1).astype(np.float32)
    bias = (0.1 * rs.randn(d)).astype(np.float32)
    a = b = None
    if affine:
        a = (1 + 0.1 * rs.randn(n, c)).astype(np.float32)
        b = (0.1 * rs.randn(n, c)).astype(np.float32)
    want = jrk.fused_upconv3x3_padded(jx, jnp.asarray(k), jnp.asarray(bias), HW,
                                      a=None if a is None else jnp.asarray(a),
                                      b=None if b is None else jnp.asarray(b), silu=affine,
                                      tile_h=4, interpret=True)
    got = trk.fused_upconv3x3_padded(tx, _t(k), _t(bias), HW, _t(a), _t(b), silu=affine)
    _same_stream(got, want, (16, 16))


def test_upconv3x3_padded_rounds_the_collapsed_weights_like_jax():
    """bf16: the 2x2 parity weights are summed in float32 and then rounded,
    as the JAX package does; the outputs agree within one bf16 ulp."""
    rs = np.random.RandomState(5)
    n, c, d = 2, 32, 32
    jx, tx = _streams(rs, (n,), HW, c)
    k = (rs.randn(3, 3, c, d) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.1 * rs.randn(d)).astype(np.float32)
    want = jrk.fused_upconv3x3_padded(jx.astype(jnp.bfloat16), jnp.asarray(k), jnp.asarray(bias),
                                      HW, tile_h=4, interpret=True)
    got = trk.fused_upconv3x3_padded(tx.bfloat16(), _t(k), _t(bias), HW)
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()[:, 1:17, 1:17]
    w = np.asarray(want.astype(jnp.float32))[:, 1:17, 1:17]
    assert np.all(np.abs(g - w) <= np.abs(w) * 2.0 ** -7 + 1e-3 * w.std())


# -- the U-Net ---------------------------------------------------------------------


def test_attention_and_downsample_take_the_interior_of_a_stream():
    """Neither block is reached on a padded stream at the release widths,
    but both must take one: the interior in (NaN pad rows never read); the
    attention block hands back a padded stream, the downsample a tensor."""
    rs = np.random.RandomState(6)
    x = _t(rs.randn(1, 2, 8, 8, 64))
    st = torch.stack([x.sum((2, 3)), (x * x).sum((2, 3))], 2)
    nan_pads = tvu.PaddedStream(trk._place(x, *trk.padded_hw(8, 8)), (8, 8))
    with torch.no_grad():
        attn = tvu.SpatialAttentionBlock(64, 32)
        got, gst = attn(nan_pads, st, True)
        want, wst = attn(x, st, True)
        assert isinstance(got, tvu.PaddedStream) and got.hw == (8, 8)
        assert torch.equal(tvu.unpad_stream(got), want) and torch.equal(gst, wst)
        down = tvu.Downsample3D(64)
        torch.nn.init.normal_(down.conv.spatial_conv.kernel)
        assert torch.equal(down(nan_pads), down(x))


def _jax_module(name):
    """The JAX package's module that holds the Pallas wrapper `name`, as the
    port's registry entry names it in `replaces`."""
    return importlib.import_module(trk.KERNELS[name]["replaces"].split(".py:")[0]
                                   .replace("/", "."))


# the kernels of the JAX package itself (the perf lab's K15 is a closure of
# its script, with no module attribute to count)
PACKAGE_KERNELS = tuple(n for n, e in trk.KERNELS.items() if e["replaces"].startswith("v2a_tpu/"))


def _counting(monkeypatch, module, names, via_plain=False):
    """Counts calls of module.<name> for each name; `module` may instead be a
    function of the name (`trk.wrapper_module`, `_jax_module`). `via_plain`
    calls the port's plain version instead (for tensors on the meta
    device)."""
    calls = {}
    module_of = module if callable(module) else (lambda name: module)

    def wrap(name):
        fn = getattr(module_of(name), name + "_plain" if via_plain else name)

        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return counted

    for name in names:
        monkeypatch.setattr(module_of(name), name, wrap(name))
    return calls


def _jax_defaults(monkeypatch):
    """The JAX package's shipped flags, pinned."""
    for flag, value in (("PERF_PADDED_STREAM", True), ("PERF_MEGA_KERNEL", True),
                        ("PERF_UPCONV", True), ("PERF_STREAM_KERNEL", False),
                        ("PERF_DOWNCONV", False), ("PERF_ENTRY_PAD", False),
                        ("PERF_PALLAS_ATTN", False), ("PERF_PALLAS_SPATIAL2_MIN_CH", 128),
                        ("PERF_PALLAS_SPATIAL2_MAX_S", 16384), ("PERF_ATTN_HMAJOR", False)):
        monkeypatch.setattr(jvu, flag, value)
    monkeypatch.setattr(jrk, "TAPJOIN", "")
    monkeypatch.setattr(jrk, "MEGA_MIN_M", 256)


def test_padded_unet_matches_jax_default_routing(monkeypatch):
    """mc 128, mult (1, 2), attention at ds 2, 24x24 (576 interior pixels,
    the smallest square level the padded stream takes), F=2: the 24x24 level
    runs the padded stream (K3 in every ResBlock conv, K5 + K4b for the
    upsample), the 12x12 level K1 / K2, exactly as the JAX package."""
    _jax_defaults(monkeypatch)
    kw = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(24, seed=13)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=13)
    jcalls = _counting(monkeypatch, _jax_module, PACKAGE_KERNELS)
    want = japply(jvu.VideoUNet(fused=True, **kw), params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS)
    padded = _load(tvu.VideoUNet(fused=True, **kw), params)
    got = padded(_t(x), torch.from_numpy(t), _t(tok))
    assert jcalls == tcalls == {"fused_affine_conv3x3": 12, "temporal_conv_fused": 12,
                                "fused_conv_tconv_padded": 6, "temporal_conv_padded": 1,
                                "fused_upconv3x3_padded": 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)
    # one converted state dict drives both routings
    unpadded = _load(tvu.VideoUNet(fused=True, padded_stream=False, **kw), params)
    assert padded.state_dict().keys() == unpadded.state_dict().keys()
    np.testing.assert_allclose(unpadded(_t(x), torch.from_numpy(t), _t(tok)).numpy(),
                               got.numpy(), **UNET_TOL)


def test_padded_unet_reaches_k4a(monkeypatch):
    """mc 128, mult (3, 4), 24x24, F=4: the JAX rule sends some of the
    level-0 convs to K4a + K4b. Counts from the JAX package by
    `jax.eval_shape` (its forward at this width is slow on the CPU); the
    port's output against its own plain path."""
    _jax_defaults(monkeypatch)
    kw = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=1,
              attention_resolutions=(), channel_mult=(3, 4), num_head_channels=32,
              task_token_dim=64)
    rs = np.random.RandomState(17)
    x = rs.randn(1, 4, 24, 24, 6).astype(np.float32)
    t, tok = np.array([7]), rs.randn(1, 4, 64).astype(np.float32)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=17)
    jcalls = _counting(monkeypatch, _jax_module, PACKAGE_KERNELS)
    jax.eval_shape(jvu.VideoUNet(fused=True, **kw).apply, params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS)
    got = _load(tvu.VideoUNet(fused=True, **kw), params)(_t(x), torch.from_numpy(t), _t(tok))
    want = _load(tvu.VideoUNet(**kw), params)(_t(x), torch.from_numpy(t), _t(tok))
    assert jcalls == tcalls == {"fused_affine_conv3x3": 12, "temporal_conv_fused": 12,
                                "fused_conv_tconv_padded": 2, "fused_affine_conv3x3_padded": 4,
                                "temporal_conv_padded": 5, "fused_upconv3x3_padded": 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), **UNET_TOL)


@pytest.mark.parametrize("routing,counts", [
    (dict(fused=True), {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30,
                        "fused_conv_tconv_padded": 16, "fused_affine_conv3x3_padded": 14,
                        "temporal_conv_padded": 17, "fused_upconv3x3_padded": 3}),
    (dict(fused=True, padded_stream=False), {"fused_affine_conv3x3": 73,
                                             "temporal_conv_fused": 63}),
    # K8 at the two downsamples into a padded level, whose temporal convs
    # move from K2 to K4b; K9 at the 5 attention blocks at 16^2, 6 at 8^2
    (dict(fused=True, downconv=True, attn_kernel=True),
     {"fused_affine_conv3x3": 31, "temporal_conv_fused": 28, "fused_conv_tconv_padded": 16,
      "fused_affine_conv3x3_padded": 14, "temporal_conv_padded": 19,
      "fused_upconv3x3_padded": 3, "fused_downconv3x3_padded": 2,
      "fused_spatial_attention_padded": 11}),
    # K7: 27 ResBlocks x 2, 11 attention norms, the output norm
    (dict(use_pallas_gn=True), {"fused_group_norm_silu": 66}),
    # the K1 gate off: K10 at every 3x3 stride-1 conv (a launch per part of
    # the up path's pairs), K11 at every temporal conv
    (dict(fused=True, spatial2_min_ch=0, pallas_spatial=True, tconv_hw=True),
     {"spatial_conv3x3": 73, "temporal_conv_fused_hw": 63}),
    # K12 in the 19 padded convs without a skip fold, in place of 11 K3 and
    # 8 K4a -> K4b
    (dict(fused=True, stream_kernel=True),
     {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30, "fused_conv_tconv_stream": 19,
      "fused_conv_tconv_padded": 5, "fused_affine_conv3x3_padded": 6, "temporal_conv_padded": 9,
      "fused_upconv3x3_padded": 3}),
    # padded_k8_k9 with attention at ds 4 / 8 / 16 and 64-channel heads: K9
    # also at the padded 32^2 level (1,024 tokens, 6 heads), 16 calls
    (dict(fused=True, downconv=True, attn_kernel=True, attention_resolutions=(4, 8, 16),
          num_head_channels=64),
     {"fused_affine_conv3x3": 31, "temporal_conv_fused": 28, "fused_conv_tconv_padded": 16,
      "fused_affine_conv3x3_padded": 14, "temporal_conv_padded": 19,
      "fused_upconv3x3_padded": 3, "fused_downconv3x3_padded": 2,
      "fused_spatial_attention_padded": 16}),
    # the padded routing with the mega-kernel switch off (`V2A_MEGA_KERNEL=0`):
    # K4a -> K4b take K3's 16 calls
    (dict(fused=True, mega_kernel=False),
     {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30, "fused_affine_conv3x3_padded": 30,
      "temporal_conv_padded": 33, "fused_upconv3x3_padded": 3}),
    # the K1 gate up to H*W 512 (`V2A_SPATIAL2_MAX_S=512`): K1 at 16^2 and 8^2
    # only, no padded level, K2 at every temporal conv
    (dict(fused=True, spatial2_max_s=512),
     {"fused_affine_conv3x3": 31, "temporal_conv_fused": 63}),
    # the padded routing without K5 (`V2A_UPCONV=0`): its 3 upsample convs
    # nearest-2x, padded, then K3 (1) or K4a -> K4b (2)
    (dict(fused=True, upconv=False),
     {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30, "fused_conv_tconv_padded": 17,
      "fused_affine_conv3x3_padded": 16, "temporal_conv_padded": 16}),
    # the entry conv on the padded stream (`V2A_ENTRY_PAD=1`): K3 at C=6 in
    # place of a library conv and K2
    (dict(fused=True, entry_pad=True),
     {"fused_affine_conv3x3": 31, "temporal_conv_fused": 29, "fused_conv_tconv_padded": 17,
      "fused_affine_conv3x3_padded": 14, "temporal_conv_padded": 17,
      "fused_upconv3x3_padded": 3}),
], ids=["padded", "unpadded", "padded_k8_k9", "plain_k7", "spatial_k10_k11", "padded_k12",
        "padded_k8_k9_wide", "padded_mega_off", "spatial2_deep", "padded_upconv_off",
        "padded_entry_pad"])
def test_release_forward_launch_counts(monkeypatch, routing, counts):
    """The release U-Net (128^2, F=7, mc 128, mult (1,2,3,4,5), 2 res blocks,
    attention at ds 8 / 16, bf16) traced on the meta device: the kernels
    each routing calls per forward, the counts `chip_smoke.py` holds the
    card to."""
    calls = _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    with torch.device("meta"), torch.no_grad():
        net = tvu.VideoUNet(dtype=torch.bfloat16, **routing)
        out = net(torch.randn(1, 7, 128, 128, 6), torch.zeros(1, dtype=torch.long),
                  torch.randn(1, 77, 512))
    assert tuple(out.shape) == (1, 7, 128, 128, 3)
    assert calls == counts


def _release_calls(monkeypatch, name, **routing):
    """The (B, F, H, W, D) of every call of wrapper `name` in a B=1 release
    forward traced on the meta device."""
    _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    calls = []
    plain = getattr(trk, name + "_plain")

    def record(parts, kbias, tkernel, tbias, hw, *a, **k):
        b, f = parts[0][0].shape[:2]
        calls.append((b, f, hw[0], hw[1], parts[0][1].shape[-1]))
        return plain(parts, kbias, tkernel, tbias, hw, *a, **k)

    monkeypatch.setattr(trk, name, record)
    with torch.device("meta"), torch.no_grad():
        tvu.VideoUNet(dtype=torch.bfloat16, fused=True, **routing)(
            torch.randn(1, 7, 128, 128, 6), torch.zeros(1, dtype=torch.long),
            torch.randn(1, 77, 512))
    return sorted(set(calls))


def test_conv_tconv_plan_fits_every_release_call(monkeypatch):
    """The tile plan of K3 and K12 (`trk.conv_tconv_plan`) at every signature
    of the release forward (B=8) and of a served request (B=1), from the
    meta-device trace: shared memory within a CTA's 227 KB, the cluster
    along D dividing the grid, full 64-pixel tiles at B=8, a CTA per SM
    (132) for K12 at B=1; and D=64 (the card tests' width) admitted."""
    k3 = _release_calls(monkeypatch, "fused_conv_tconv_padded")
    k12 = _release_calls(monkeypatch, "fused_conv_tconv_stream", stream_kernel=True)
    # the JAX gates: K3 at 128^2 and 64^2 (K4a -> K4b at 32^2), K12 at all three
    assert {(h, d) for *_, h, _, d in k3} == {(128, 128), (64, 256)}
    assert {(h, d) for *_, h, _, d in k12} == {(128, 128), (64, 256), (32, 384)}
    for ring, calls in ((False, k3), (True, k12)):
        for _, f, h, w, d in calls:
            for b in (1, 8):
                plan = trk.conv_tconv_plan(b, f, h, w, d, ring=ring)
                assert plan.smem <= 227 * 1024 and plan.grid % plan.cluster == 0
                assert plan.cluster == d // 128 and plan.stages == 3
                if b == 8:
                    assert plan.pixels == 64
                if ring and b == 1:
                    assert plan.grid >= trk.HOPPER_SMS, (h, w, d, plan)
    for ring in (False, True):
        plan = trk.conv_tconv_plan(2, 3, 8, 8, 64, ring=ring)
        assert plan.cluster == 1 and plan.smem <= 227 * 1024
    with pytest.raises(ValueError):
        trk.conv_tconv_plan(1, 7, 32, 32, 96)


def test_conv_out_receives_the_conv_half_on_the_cpu():
    """`conv_out` of K3 and K12 on CPU tensors: K4a's plain conv half in its
    interior, pads untouched; the output is the plain chain's either way."""
    rs = np.random.RandomState(41)
    hw, d = (6, 10), 64
    hp, wp = trk.padded_hw(*hw)
    x = torch.from_numpy(rs.randn(1, 2, hp, wp, 32).astype(np.float32))
    parts = [(x, torch.from_numpy(0.1 * rs.randn(3, 3, 32, d).astype(np.float32)),
              torch.ones(2, 32), torch.zeros(2, 32))]
    kb, tb = torch.zeros(d), torch.zeros(d)
    tk = torch.from_numpy(0.1 * rs.randn(3, d, d).astype(np.float32))
    want = trk.fused_affine_conv3x3_padded_plain(
        [(x.reshape(2, hp, wp, 32),) + parts[0][1:]], kb, hw).reshape(1, 2, hp, wp, d)
    for fn in (trk.fused_conv_tconv_padded, trk.fused_conv_tconv_stream):
        conv = torch.full((1, 2, hp, wp, d), 7.0)
        y = fn(parts, kb, tk, tb, hw, conv_out=conv)
        assert torch.equal(trk._interior(conv, hw), trk._interior(want, hw))
        assert bool((conv[:, :, 0] == 7.0).all()) and bool((conv[..., 0, :] == 7.0).all())
        _same_stream(y, fn(parts, kb, tk, tb, hw), hw)
