"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, the wrappers' refusal of what the kernels do not take, small
U-Nets of each fused routing against the plain path, and the training path
(the autograd Functions of `ops/conv_vjp.py`, a small `train_fused`
U-Net's gradients).

Marked `gpu`; each test decides inside a fixture whether there is a card
and skips without one. This file imports no JAX, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from v2a_tpu_torch.ops import group_norm as gn
from v2a_tpu_torch.ops import resblock_kernels as rk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within_ulp(got, want, dtype, extra=0.0):
    """bf16: both sides sum the same rounded products in float32 in another
    order, so the final rounding may differ by one unit in the last place.
    float32: the sums differ only in order. `extra`: a further per-element
    allowance (a carried difference of an intermediate)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.bfloat16:
        tol = want.abs() * 2.0 ** -7 + 1e-3 * want.std()
    else:
        tol = want.abs() * 1e-5 + 1e-5 * want.std()
    return bool((err <= tol + extra).all()), float(err.max() / want.std())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["plain", "affine", "silu"])
@pytest.mark.parametrize("n,h,w,c,d", [(3, 8, 8, 128, 128), (2, 32, 32, 256, 128),
                                       (2, 5, 7, 32, 64)])
def test_affine_conv3x3_kernel_matches_plain(cuda, dtype, mode, n, h, w, c, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, h, w, c, generator=g, device=cuda).to(dtype)
    k = torch.randn(3, 3, c, d, generator=g, device=cuda) / (9 * c) ** 0.5
    bias = torch.randn(d, generator=g, device=cuda) * 0.1
    a = b = None
    if mode != "plain":
        a = 1 + 0.1 * torch.randn(n, c, generator=g, device=cuda)
        b = 0.1 * torch.randn(n, c, generator=g, device=cuda)
    before = rk.launches["fused_affine_conv3x3"]
    got = rk.fused_affine_conv3x3(x, k, bias, a, b, silu=mode == "silu")
    torch.cuda.synchronize()
    assert rk.launches["fused_affine_conv3x3"] == before + 1
    want = rk.fused_affine_conv3x3_plain(x, k, bias, a, b, silu=mode == "silu")
    ok, rel = _within_ulp(got, want, dtype)
    assert ok, f"max err / std {rel}"


@pytest.mark.parametrize("n,h,w,c,d,mode", [
    (7, 8, 8, 640, 640, "silu"),    # a served request's 8^2 calls: 16-pixel tiles, 140 CTAs
    (3, 8, 8, 128, 192, "silu"),    # 64-wide output slices
    (2, 5, 7, 32, 64, "affine"),    # ragged tiles, one channel chunk
    (4, 16, 16, 512, 384, "dgrad"),  # the train step's dgrad: mode 0 on the flipped kernel
    (28, 32, 32, 384, 384, "silu"),  # 128-pixel tiles, sixteen warps
    (2, 64, 64, 64, 192, "affine"),  # 128-pixel tiles, 64-wide output slices
    (56, 8, 8, 640, 640, "silu")])   # 64-pixel tiles
def test_affine_conv3x3_kernel_at_plan_edges(cuda, n, h, w, c, d, mode):
    """K1's bf16 body at the edges of `rk.affine_conv_plan` within one ulp of
    its plain version; two launches bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(n, h, w, c, generator=g, device=cuda).bfloat16()
    k = torch.randn(3, 3, c, d, generator=g, device=cuda) / (9 * c) ** 0.5
    bias = torch.randn(d, generator=g, device=cuda) * 0.1
    a = b = None
    if mode in ("silu", "affine"):
        a = 1 + 0.1 * torch.randn(n, c, generator=g, device=cuda)
        b = 0.1 * torch.randn(n, c, generator=g, device=cuda)
    before = rk.launches["fused_affine_conv3x3"]
    if mode == "dgrad":  # x is the cotangent, k the forward's (3, 3, D, C) kernel
        from v2a_tpu_torch.ops import conv_vjp

        fk = k.permute(0, 1, 3, 2).contiguous()
        got, again = conv_vjp._dgrad_kernel(x, fk), conv_vjp._dgrad_kernel(x, fk)
        want = rk.fused_affine_conv3x3_plain(x, fk.flip(0, 1).permute(0, 1, 3, 2),
                                             torch.zeros(d, device=cuda))
    else:
        got = rk.fused_affine_conv3x3(x, k, bias, a, b, silu=mode == "silu")
        again = rk.fused_affine_conv3x3(x, k, bias, a, b, silu=mode == "silu")
        want = rk.fused_affine_conv3x3_plain(x, k, bias, a, b, silu=mode == "silu")
    torch.cuda.synchronize()
    assert rk.launches["fused_affine_conv3x3"] == before + 2
    assert got.shape == (n, h, w, d) and torch.equal(got, again)
    ok, rel = _within_ulp(got, want, torch.bfloat16)
    assert ok, f"max err / std {rel}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extras", [(False, False, False), (True, True, True),
                                    (False, True, True), (True, False, False)])
@pytest.mark.parametrize("b,f,s,c", [(2, 7, 64, 128), (1, 3, 1000, 256), (2, 2, 16, 64)])
def test_temporal_conv_kernel_matches_plain(cuda, dtype, extras, b, f, s, c):
    has_emb, has_res, stats = extras
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(b, f, s, c, generator=g, device=cuda).to(dtype)
    k = torch.randn(3, c, c, generator=g, device=cuda) / (3 * c) ** 0.5
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    emb = torch.randn(b, c, generator=g, device=cuda).to(dtype) if has_emb else None
    res = torch.randn(b, f, s, c, generator=g, device=cuda).to(dtype) if has_res else None
    got = rk.temporal_conv_fused(x, k, bias, emb, res, want_stats=stats)
    want = rk.temporal_conv_fused_plain(x, k, bias, emb, res, want_stats=stats)
    torch.cuda.synchronize()
    if stats:
        (got, gst), (want, wst) = got, want
        for i in range(2):  # sum, sum of squares: relative to their scale
            scale = wst[:, :, i].abs().max()
            assert float((gst[:, :, i] - wst[:, :, i]).abs().max() / scale) < 1e-3
    ok, rel = _within_ulp(got, want, dtype)
    assert ok, f"max err / std {rel}"


def test_stats_are_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 4, 4096, 128, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(3, 128, 128, generator=g, device=cuda) / 20
    bias = torch.zeros(128, device=cuda)
    _, s1 = rk.temporal_conv_fused(x, k, bias, want_stats=True)
    _, s2 = rk.temporal_conv_fused(x, k, bias, want_stats=True)
    assert torch.equal(s1, s2)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 4, 4, 48, device=cuda)
    with pytest.raises(ValueError):  # C % 32
        rk.fused_affine_conv3x3(x, torch.zeros(3, 3, 48, 64, device=cuda),
                                torch.zeros(64, device=cuda))
    x = torch.zeros(1, 4, 4, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):  # not contiguous
        rk.fused_affine_conv3x3(x, torch.zeros(3, 3, 64, 64, device=cuda),
                                torch.zeros(64, device=cuda))
    with pytest.raises(TypeError):
        rk.temporal_conv_fused(torch.zeros(1, 2, 4, 64, device=cuda, dtype=torch.float16),
                               torch.zeros(3, 64, 64, device=cuda), torch.zeros(64, device=cuda))


def test_plain_versions_agree_with_numpy(cuda):
    """Anchors the plain versions themselves on the card (TF32 off)."""
    rs = np.random.RandomState(3)
    x = rs.randn(1, 2, 3, 64).astype(np.float32)
    k = rs.randn(3, 64, 64).astype(np.float32) * 0.1
    want = sum(np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))[:, t:t + 2] @ k[t]
               for t in range(3))
    got = rk.temporal_conv_fused_plain(torch.from_numpy(x).to(cuda),
                                       torch.from_numpy(k).to(cuda),
                                       torch.zeros(64, device=cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=1e-4)


def _fused_vs_plain(cuda, padded_stream):
    """A small U-Net (mc 128, mult (1, 2), 32x32, F=2) with the fused float32
    kernels against the plain path with the same weights, at the JAX
    package's own fused-vs-plain tolerance; the default device resolves to
    the card. Returns the launches of the fused forward."""
    from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
    from v2a_tpu_torch.models.video_unet import VideoUNet

    cfg = VideoModelConfig(image_size=(32, 32), sample_per_seq=3, model_channels=128,
                           channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(2,),
                           text_dim=64, padded_stream=padded_stream)
    model = VideoPredModel(cfg).init(0)
    assert model.device.type == "cuda" and model.unet.fused
    assert model.unet.routing.padded_stream == padded_stream
    plain = VideoUNet(model_channels=128, channel_mult=(1, 2), num_res_blocks=1,
                      attention_resolutions=(2,), task_token_dim=64).to(cuda).eval()
    plain.load_state_dict(model.unet.state_dict())
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 2, 32, 32, 6, generator=g, device=cuda)
    t = torch.tensor([5, 60], device=cuda)
    te = model.encode_batch_text(["open the drawer", "pick up the bowl"])
    before = dict(rk.launches)
    with torch.no_grad():
        got, want = model.unet(x, t, te), plain(x, t, te)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)
    return {k: v - before[k] for k, v in rk.launches.items() if v != before[k]}


def test_fused_unet_matches_plain_on_the_card(cuda):
    """The unpadded fused routing: K1 / K2 only."""
    made = _fused_vs_plain(cuda, padded_stream=False)
    assert made == {"fused_affine_conv3x3": 21, "temporal_conv_fused": 19}


def test_padded_unet_matches_plain_on_the_card(cuda):
    """The padded-stream routing (the default): the 32x32 level runs K3 and
    K5, the 16x16 level K1 / K2, as the JAX package launches them."""
    made = _fused_vs_plain(cuda, padded_stream=True)
    assert made == {"fused_affine_conv3x3": 12, "temporal_conv_fused": 12,
                    "fused_conv_tconv_padded": 6, "temporal_conv_padded": 1,
                    "fused_upconv3x3_padded": 1}


# -- the padded-stream kernels: NaN in the input pad rows, zero output pad cols --


def _stream(gen, dev, dtype, lead, hw, c):
    """A padded stream with a random interior, zero pad cols, NaN pad rows."""
    inner = torch.randn(*lead, *hw, c, generator=gen, device=dev)
    return rk._place(inner, *rk.padded_hw(*hw)).to(dtype)


def _check_padded(got, want, hw, dtype, extra=0.0, what=""):
    """Interior within one ulp of the plain version (plus `extra`, shaped as
    the interior); pad cols exactly zero."""
    h, w = hw
    gi, wi = got[..., 1:h + 1, :, :], want[..., 1:h + 1, :, :]
    assert torch.equal(gi[..., 0, :], torch.zeros_like(gi[..., 0, :]))
    assert torch.equal(gi[..., w + 1:, :], torch.zeros_like(gi[..., w + 1:, :]))
    ok, rel = _within_ulp(gi[..., 1:w + 1, :], wi[..., 1:w + 1, :], dtype, extra)
    assert ok, f"{what} max err / std {rel}"


def _stats_close(got, want, y_got=None, y_want=None):
    """Sum and sum of squares within 1e-3 of their scale; given the two
    outputs they were taken of (padded streams), also what the outputs'
    differences move each sum by (as `chip_smoke.stats_ok`)."""
    slack = torch.zeros_like(want)
    if y_got is not None:  # interior rows; the pad cols are zero in both
        yg, yw = y_got[:, :, 1:-1].float(), y_want[:, :, 1:-1].float()
        slack = torch.stack([(yg - yw).abs().sum((2, 3)), (yg * yg - yw * yw).abs().sum((2, 3))],
                            dim=2)
    for i in range(2):
        scale = want[:, :, i].abs().max()
        assert bool(((got[:, :, i] - want[:, :, i]).abs() <= 1e-3 * scale + slack[:, :, i]).all())


def _conv_parts(gen, dev, dtype, lead, hw, cins, d):
    rows = 1
    for v in lead:
        rows *= v
    parts = []
    for c in cins:
        parts.append((_stream(gen, dev, dtype, lead, hw, c),
                      torch.randn(3, 3, c, d, generator=gen, device=dev) / (9 * sum(cins)) ** 0.5,
                      1 + 0.1 * torch.randn(rows, c, generator=gen, device=dev),
                      0.1 * torch.randn(rows, c, generator=gen, device=dev)))
    return parts


def _tconv_extras(gen, dev, dtype, b, f, hw, d, emb, res, skip_cins):
    bias = torch.randn(d, generator=gen, device=dev) * 0.1
    e = torch.randn(b, d, generator=gen, device=dev).to(dtype) if emb else None
    r = _stream(gen, dev, dtype, (b, f), hw, d) if res else None
    skips = [(_stream(gen, dev, dtype, (b, f), hw, c),
              torch.randn(c, d, generator=gen, device=dev) / c ** 0.5) for c in skip_cins]
    sb = torch.randn(d, generator=gen, device=dev) * 0.1 if skip_cins else None
    return bias, e, r, skips or None, sb


PADDED_SHAPES = [(2, 3, (8, 8), (64,), 64), (1, 7, (12, 20), (128, 64), 128),
                 (1, 2, (32, 32), (256, 128), 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("b,f,hw,cins,d", PADDED_SHAPES)
def test_affine_conv3x3_padded_kernel_matches_plain(cuda, dtype, silu, b, f, hw, cins, d):
    gen = torch.Generator(device=cuda).manual_seed(5)
    parts = _conv_parts(gen, cuda, dtype, (b * f,), hw, cins, d)
    bias = torch.randn(d, generator=gen, device=cuda) * 0.1
    before = rk.launches["fused_affine_conv3x3_padded"]
    got = rk.fused_affine_conv3x3_padded(parts, bias, hw, silu)
    torch.cuda.synchronize()
    assert rk.launches["fused_affine_conv3x3_padded"] == before + 1
    _check_padded(got, rk.fused_affine_conv3x3_padded_plain(parts, bias, hw, silu), hw, dtype)


# K4a at the edges of its plan (`rk.affine_conv_plan` over C0 + C1): each
# tile size, W that no tile divides, C0 != C1, a served request's N = 7
K4A_EDGES = [
    (2, (64, 64), (64, 32), 192, True),     # 128-pixel tiles, 64-wide output slices, C0 != C1
    (56, (8, 8), (512, 128), 640, True),    # 64-pixel tiles, two parts
    (7, (16, 16), (512,), 512, True),       # 32-pixel tiles at N = 7
    (7, (8, 8), (640,), 640, False),        # 16-pixel tiles at N = 7: 140 CTAs
    (2, (12, 20), (128, 64), 128, True),    # W = 20: no tile divides it
    (3, (5, 7), (32,), 64, False),          # W = 7 below the tile's 8 cols, one chunk
    (28, (32, 32), (384,), 384, True)]      # 128-pixel tiles, sixteen warps


@pytest.mark.parametrize("n,hw,cins,d,silu", K4A_EDGES)
def test_affine_conv3x3_padded_kernel_at_plan_edges(cuda, n, hw, cins, d, silu):
    """K4a's bf16 body (K1's) at its plan's edges, from streams with NaN pad
    rows: the interior within one ulp of its plain version, zero pad cols,
    two launches bit-equal; with one part, bit-equal to K1 on the interior
    (the same chunks in the same order: an addressing slip shows here
    before it shows above one ulp)."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    parts = _conv_parts(gen, cuda, torch.bfloat16, (n,), hw, cins, d)
    bias = torch.randn(d, generator=gen, device=cuda) * 0.1
    got = rk.fused_affine_conv3x3_padded(parts, bias, hw, silu)
    again = rk.fused_affine_conv3x3_padded(parts, bias, hw, silu)
    torch.cuda.synchronize()
    h = hw[0]
    assert torch.equal(got[:, 1:h + 1], again[:, 1:h + 1])  # pad rows are not written
    _check_padded(got, rk.fused_affine_conv3x3_padded_plain(parts, bias, hw, silu), hw,
                  torch.bfloat16)
    if len(cins) == 1:
        x, k, a, b = parts[0]
        k1 = rk.fused_affine_conv3x3(rk._interior(x, hw).contiguous(), k, bias, a, b, silu)
        assert torch.equal(rk._interior(got, hw), k1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("emb,res,skip_cins,stats", [(True, True, (), True), (False, False, (), False),
                                                     (True, False, (128,), True),
                                                     (False, False, (64, 128), True)])
@pytest.mark.parametrize("b,f,hw,d", [(2, 3, (8, 8), 64), (1, 7, (12, 20), 128)])
def test_temporal_conv_padded_kernel_matches_plain(cuda, dtype, emb, res, skip_cins, stats, b, f,
                                                   hw, d):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _stream(gen, cuda, dtype, (b, f), hw, d)
    k = torch.randn(3, d, d, generator=gen, device=cuda) / (3 * d) ** 0.5
    bias, e, r, skips, sb = _tconv_extras(gen, cuda, dtype, b, f, hw, d, emb, res, skip_cins)
    got = rk.temporal_conv_padded(x, k, bias, hw, e, r, skips, sb, stats)
    want = rk.temporal_conv_padded_plain(x, k, bias, hw, e, r, skips, sb, stats)
    torch.cuda.synchronize()
    if stats:
        (got, gst), (want, wst) = got, want
        _stats_close(gst, wst)
    _check_padded(got, want, hw, dtype)


def _carried(dy, tk, dtype):
    """sum_t |W_t| |dY(f + t - 1)| (B, F, H, W, D): how far the temporal taps
    carry a difference dY of the conv half (interior, B, F, H, W, D)."""
    b, f, h, w, d = dy.shape
    yp = torch.nn.functional.pad(dy.float().abs().reshape(b, f, h * w, d), (0, 0, 0, 0, 1, 1))
    stacked = torch.cat([yp[:, :f], yp[:, 1:f + 1], yp[:, 2:]], -1)
    return (stacked @ tk.to(dtype).float().abs().reshape(3 * d, d)).reshape(b, f, h, w, d)


def _conv_tconv_case(gen, dev, dtype, b, f, hw, cins, d, emb, res, skip_cins):
    parts = _conv_parts(gen, dev, dtype, (b, f), hw, cins, d)
    kbias = torch.randn(d, generator=gen, device=dev) * 0.1
    tk = torch.randn(3, d, d, generator=gen, device=dev) / (3 * d) ** 0.5
    tb, e, r, skips, sb = _tconv_extras(gen, dev, dtype, b, f, hw, d, emb, res, skip_cins)
    return parts, kbias, tk, tb, e, r, skips, sb


def _check_conv_tconv(got, gst, conv, parts, kbias, tk, tb, hw, e, r, skips, sb, silu, dtype):
    """K3 / K12 one rounding at a time, against the kernel's own conv half
    `conv` (its `conv_out`): that conv half within one ulp of the plain conv;
    the output within one ulp of the plain temporal conv of it and of K4b of
    it; against K4a -> K4b within one ulp plus the carried difference of the
    two conv halves, sum_t |W_t| |y_kernel - y_K4a| (their float32 conv sums
    run in other orders, so a conv output may round to the neighbouring
    bf16 value); statistics within 1e-3 of each."""
    b, f = parts[0][0].shape[:2]
    d = tk.shape[-1]
    hp, wp = rk.padded_hw(*hw)
    flat = [(x.reshape(b * f, hp, wp, -1), kk, a, bb) for x, kk, a, bb in parts]
    yp = rk.fused_affine_conv3x3_padded_plain(flat, kbias, hw, silu).reshape(conv.shape)
    _check_padded(conv, yp, hw, dtype, what="conv half vs plain conv:")
    half, hst = rk.temporal_conv_padded_plain(conv, tk, tb, hw, e, r, skips, sb, True)
    _check_padded(got, half, hw, dtype, what="vs plain temporal conv of its conv half:")
    _stats_close(gst, hst, got, half)
    own, ost = rk.temporal_conv_padded(conv, tk, tb, hw, e, r, skips, sb, True)
    _check_padded(got, own, hw, dtype, what="vs K4b of its conv half:")
    _stats_close(gst, ost, got, own)
    yk = rk.fused_affine_conv3x3_padded(flat, kbias, hw, silu).reshape(conv.shape)
    two, tst = rk.temporal_conv_padded(yk, tk, tb, hw, e, r, skips, sb, True)
    extra = _carried(rk._interior(conv, hw).float() - rk._interior(yk, hw).float(), tk, dtype)
    _check_padded(got, two, hw, dtype, extra, what="vs K4a -> K4b:")
    _stats_close(gst, tst, got, two)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("emb,res,skip_cins", [(True, True, ()), (True, False, (128, 64)),
                                               (False, False, ())])
@pytest.mark.parametrize("b,f,hw,cins,d", PADDED_SHAPES)
def test_conv_tconv_padded_kernel_matches_plain(cuda, dtype, emb, res, skip_cins, b, f, hw, cins,
                                                d):
    """K3 from NaN-padded streams, one rounding at a time against its own
    conv half (`_check_conv_tconv`); the launch with `conv_out` bit-equal to
    the model's launch without it; pad cols exactly zero."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    parts, kbias, tk, tb, e, r, skips, sb = _conv_tconv_case(gen, cuda, dtype, b, f, hw, cins, d,
                                                             emb, res, skip_cins)
    args = (parts, kbias, tk, tb, hw, e, r, skips, sb, True, True)
    conv = torch.zeros(parts[0][0].shape[:4] + (d,), dtype=dtype, device=cuda)
    before = rk.launches["fused_conv_tconv_padded"]
    got, gst = rk.fused_conv_tconv_padded(*args, conv_out=conv)
    again, ast = rk.fused_conv_tconv_padded(*args)
    torch.cuda.synchronize()
    assert rk.launches["fused_conv_tconv_padded"] == before + 2
    rows = slice(1, hw[0] + 1)
    assert torch.equal(got[:, :, rows], again[:, :, rows]) and torch.equal(gst, ast)
    _check_conv_tconv(got, gst, conv, parts, kbias, tk, tb, hw, e, r, skips, sb, True, dtype)


# the 6-channel entry conv of `entry_pad`, its channels zero-extended to 32
# by the wrappers (`rk.widen_channels`): the release shape (F = 7, 128^2, D
# 128) at B = 1 and a small one, with the U-Net's identity affine and random
# ones, without SiLU as the U-Net calls it and with it
ENTRY_SHAPES = [(1, 7, (128, 128), 128), (2, 3, (8, 12), 64)]


@pytest.mark.parametrize("kernel", ["k3", "k4a"])
@pytest.mark.parametrize("identity,silu", [(True, False), (False, True)],
                         ids=["identity", "affine_silu"])
@pytest.mark.parametrize("b,f,hw,d", ENTRY_SHAPES, ids=["release", "small"])
def test_entry_conv_kernels_match_plain(cuda, kernel, identity, silu, b, f, hw, d):
    """K3 and K4a at C = 6 in bf16 against their plain versions on the 6
    real channels: one ulp (K3 one rounding at a time, `_check_conv_tconv`),
    pad cols zero, statistics; and bit-equal to the same launch on operands
    widened by hand (the extension adds exact zeros)."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    dtype = torch.bfloat16
    parts, kbias, tk, tb, e, r, skips, sb = _conv_tconv_case(gen, cuda, dtype, b, f, hw, (6,), d,
                                                             False, False, ())
    if identity:
        parts = [(x, k, torch.ones_like(a), torch.zeros_like(bb)) for x, k, a, bb in parts]
    wide = [rk.widen_channels(*p) for p in parts]
    assert wide[0][0].shape[-1] == 32
    hp, wp = rk.padded_hw(*hw)
    if kernel == "k4a":
        flat = [(x.reshape(b * f, hp, wp, -1), k, a, bb) for x, k, a, bb in parts]
        before = rk.launches["fused_affine_conv3x3_padded"]
        got = rk.fused_affine_conv3x3_padded(flat, kbias, hw, silu)
        wflat = [(x.reshape(b * f, hp, wp, -1), k, a, bb) for x, k, a, bb in wide]
        same = rk.fused_affine_conv3x3_padded(wflat, kbias, hw, silu)
        torch.cuda.synchronize()
        assert rk.launches["fused_affine_conv3x3_padded"] == before + 2
        assert torch.equal(got[:, 1:hw[0] + 1], same[:, 1:hw[0] + 1])
        _check_padded(got, rk.fused_affine_conv3x3_padded_plain(flat, kbias, hw, silu), hw, dtype)
        return
    conv = torch.zeros(b, f, hp, wp, d, dtype=dtype, device=cuda)
    before = rk.launches["fused_conv_tconv_padded"]
    got, gst = rk.fused_conv_tconv_padded(parts, kbias, tk, tb, hw, silu=silu, want_stats=True,
                                          conv_out=conv)
    same, sst = rk.fused_conv_tconv_padded(wide, kbias, tk, tb, hw, silu=silu, want_stats=True)
    torch.cuda.synchronize()
    assert rk.launches["fused_conv_tconv_padded"] == before + 2
    rows = slice(1, hw[0] + 1)
    assert torch.equal(got[:, :, rows], same[:, :, rows]) and torch.equal(gst, sst)
    _check_conv_tconv(got, gst, conv, parts, kbias, tk, tb, hw, e, r, skips, sb, silu, dtype)


# the release U-Net's padded levels (K3 and K12 signatures): 128^2 with one
# and two parts, 64^2, 32^2 with C 384 + 384; F = 7
RELEASE_LEVELS = [((128, 128), (128,), 128), ((128, 128), (128, 128), 128),
                  ((64, 64), (256,), 256), ((32, 32), (384, 384), 384)]


@pytest.mark.parametrize("kernel", ["k3", "k12"])
@pytest.mark.parametrize("extras", [False, True], ids=["bare", "emb_res_skip"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("hw,cins,d", RELEASE_LEVELS, ids=["128", "128x2", "64", "32"])
def test_conv_tconv_at_release_levels(cuda, kernel, extras, b, hw, cins, d):
    """K3 and K12 in bf16 at every padded level of the release U-Net, at B=1
    (a served request; the tile plan shrinks the pixel tile there) and B=8,
    with and without emb, residual and (K3) the skip fold of the up path:
    `_check_conv_tconv`, and the launch without `conv_out` bit-equal."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(31)
    skip_cins = cins if extras and kernel == "k3" else ()
    parts, kbias, tk, tb, e, r, skips, sb = _conv_tconv_case(gen, cuda, dtype, b, 7, hw, cins, d,
                                                             extras, extras, skip_cins)
    conv = torch.zeros(parts[0][0].shape[:4] + (d,), dtype=dtype, device=cuda)
    if kernel == "k3":
        args = (parts, kbias, tk, tb, hw, e, r, skips, sb, True, True)
        fn = rk.fused_conv_tconv_padded
    else:
        args = (parts, kbias, tk, tb, hw, e, r, True, True)
        fn = rk.fused_conv_tconv_stream
    got, gst = fn(*args, conv_out=conv)
    again, ast = fn(*args)
    torch.cuda.synchronize()
    rows = slice(1, hw[0] + 1)
    assert torch.equal(got[:, :, rows], again[:, :, rows]) and torch.equal(gst, ast)
    _check_conv_tconv(got, gst, conv, parts, kbias, tk, tb, hw, e, r, skips, sb, True, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["plain", "affine", "silu"])
@pytest.mark.parametrize("n,hw,c,d", [(3, (8, 8), 64, 64), (2, (12, 20), 128, 128),
                                      (4, (16, 16), 512, 512)])
def test_upconv3x3_padded_kernel_matches_plain(cuda, dtype, mode, n, hw, c, d):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _stream(gen, cuda, dtype, (n,), hw, c)
    k = torch.randn(3, 3, c, d, generator=gen, device=cuda) / (9 * c) ** 0.5
    bias = torch.randn(d, generator=gen, device=cuda) * 0.1
    a = b = None
    if mode != "plain":
        a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=cuda)
        b = 0.1 * torch.randn(n, c, generator=gen, device=cuda)
    got = rk.fused_upconv3x3_padded(x, k, bias, hw, a, b, mode == "silu")
    torch.cuda.synchronize()
    want = rk.fused_upconv3x3_padded_plain(x, k, bias, hw, a, b, mode == "silu")
    _check_padded(got, want, (2 * hw[0], 2 * hw[1]), dtype)


def _parity_kernel(k, p, pp, dtype):
    """K_pp': the collapsed weights `upconv_weights(k)` in x's dtype at output
    parity (p, p') placed at the 3x3 taps (p + a, p' + b), zeros at the
    other five: K1 with it on the low-res interior is K5's parity plane."""
    w16 = rk.upconv_weights(k).to(dtype)
    kk = torch.zeros(3, 3, *k.shape[2:], dtype=dtype, device=k.device)
    for a in range(2):
        for b in range(2):
            kk[p + a, pp + b] = w16[p, pp, a, b]
    return kk


# K5 at the matching test's shapes and the edges of its plan
# (`rk.affine_conv_plan(..., up=True)` over the low-res grid x 4 parities):
# (N, (H, W) low-res, C, D) and its tile
K5_EDGES = [
    ((3, (8, 8), 64, 64), 16),
    ((2, (12, 20), 128, 128), 16),   # no tile divides the grid
    ((4, (16, 16), 512, 512), 64),
    ((7, (16, 16), 512, 512), 128),  # a served request's 16^2 call: sixteen warps, 224 CTAs
    ((2, (12, 20), 128, 192), 64),   # 64-wide output slices
    ((3, (16, 16), 256, 256), 32),
    ((3, (5, 7), 64, 64), 16),       # W below the tile's cols
    ((1, (1, 1), 32, 64), 16)]       # one low-res pixel


@pytest.mark.parametrize("mode", ["plain", "affine", "silu"])
@pytest.mark.parametrize("shape,pixels", K5_EDGES)
def test_upconv3x3_padded_parities_are_k1(cuda, mode, shape, pixels):
    """K5's bf16 body (K1's with the parity tap sets) from a stream with
    NaN pad rows, at its plan's edges: each parity plane (p, p') of its
    interior bit-equal to K1 on the low-res interior with the 3x3 kernel
    K_pp' (`_parity_kernel`: the same products in the same order, K1's five
    zero taps adding exact zeros); pad cols exactly zero, two launches
    bit-equal, within one ulp of the plain version."""
    n, hw, c, d = shape
    assert rk.affine_conv_plan(n, *hw, c, d, up=True).pixels == pixels
    gen = torch.Generator(device=cuda).manual_seed(31)
    x = _stream(gen, cuda, torch.bfloat16, (n,), hw, c)
    k = torch.randn(3, 3, c, d, generator=gen, device=cuda) / (9 * c) ** 0.5
    bias = torch.randn(d, generator=gen, device=cuda) * 0.1
    a = b = None
    if mode != "plain":
        a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=cuda)
        b = 0.1 * torch.randn(n, c, generator=gen, device=cuda)
    silu = mode == "silu"
    before = rk.launches["fused_upconv3x3_padded"]
    got = rk.fused_upconv3x3_padded(x, k, bias, hw, a, b, silu)
    again = rk.fused_upconv3x3_padded(x, k, bias, hw, a, b, silu)
    torch.cuda.synchronize()
    assert rk.launches["fused_upconv3x3_padded"] == before + 2
    hw2 = (2 * hw[0], 2 * hw[1])
    assert torch.equal(got[:, 1:hw2[0] + 1], again[:, 1:hw2[0] + 1])  # pad rows are not written
    _check_padded(got, rk.fused_upconv3x3_padded_plain(x, k, bias, hw, a, b, silu), hw2,
                  torch.bfloat16)
    xi, yi = rk._interior(x, hw).contiguous(), rk._interior(got, hw2)
    for p in range(2):
        for pp in range(2):
            k1 = rk.fused_affine_conv3x3(xi, _parity_kernel(k, p, pp, x.dtype), bias, a, b, silu)
            assert torch.equal(yi[:, p::2, pp::2], k1), (p, pp)


def test_padded_stats_are_deterministic(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    hw, d = (32, 32), 128
    parts = _conv_parts(gen, cuda, torch.bfloat16, (2, 7), hw, (128,), d)
    kb = torch.zeros(d, device=cuda)
    tk = torch.randn(3, d, d, generator=gen, device=cuda) / 20
    x = _stream(gen, cuda, torch.bfloat16, (2, 7), hw, d)
    k3 = [rk.fused_conv_tconv_padded(parts, kb, tk, kb, hw, want_stats=True)[1] for _ in range(2)]
    k4b = [rk.temporal_conv_padded(x, tk, kb, hw, want_stats=True)[1] for _ in range(2)]
    assert torch.equal(*k3) and torch.equal(*k4b)


# K2 and K4b at the edges of their plan (`rk.temporal_conv_plan`): (B, F, (H, W), C)
# and the (pixels, frames) a CTA the plan takes there
TCONV_EDGES = [
    ((8, 7, (16, 16), 512), (128, 2)),  # the padded forward's 16^2 level: sixteen warps
    ((8, 7, (8, 8), 640), (64, 2)),     # its 8^2 level
    ((8, 7, (8, 8), 512), (32, 2)),     # its 8^2 x 512 call
    ((1, 7, (16, 16), 512), (16, 2)),   # a served request's 16^2 level
    ((1, 7, (8, 8), 640), (16, 1)),     # its 8^2 level: 140 CTAs
    ((8, 2, (3, 43), 640), (128, 1)),   # frames alone: a pair's grid is short of the SMs
    ((8, 2, (9, 9), 640), (64, 1)),     # S = 81 that no tile divides
    ((8, 2, (5, 7), 640), (32, 1)),
    ((2, 7, (32, 32), 192), (128, 2)),  # 64-wide output slices, sixteen warps
    ((2, 3, (12, 20), 192), (16, 2)),   # 64-wide slices, eight warps over them: one n8 tile each
    ((1, 1, (5, 7), 64), (16, 1))]      # one frame: no temporal neighbour, one 64-wide slice


def _tconv_edge(gen, dev, b, f, hw, c, extras):
    x = torch.randn(b, f, *hw, c, generator=gen, device=dev).bfloat16()
    k = torch.randn(3, c, c, generator=gen, device=dev) / (3 * c) ** 0.5
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    emb = torch.randn(b, c, generator=gen, device=dev).bfloat16() if extras else None
    res = torch.randn(b, f, *hw, c, generator=gen, device=dev).bfloat16() if extras else None
    return x, k, bias, emb, res


@pytest.mark.parametrize("extras", [False, True], ids=["bare", "emb_res_stats"])
@pytest.mark.parametrize("shape,pixels", TCONV_EDGES)
def test_temporal_conv_padded_is_k2_at_every_tile(cuda, extras, shape, pixels):
    """K4b with no skip part on a padded copy of K2's input (NaN pad rows)
    runs K2's body with K2's plan: the same products in the same order, so
    its interior and statistics are bit-equal to K2's; an addressing slip
    shows here before it shows above one ulp. Each tile size of the plan."""
    b, f, hw, c = shape
    assert rk.temporal_conv_plan(b, f, hw[0] * hw[1], c)[:2] == pixels
    gen = torch.Generator(device=cuda).manual_seed(41)
    x, k, bias, emb, res = _tconv_edge(gen, cuda, b, f, hw, c, extras)
    hp, wp = rk.padded_hw(*hw)
    xp = rk._place(x, hp, wp)
    rp = None if res is None else rk._place(res, hp, wp)
    k2 = rk.temporal_conv_fused(x, k, bias, emb, res, want_stats=extras)
    k4b = rk.temporal_conv_padded(xp, k, bias, hw, emb, rp, want_stats=extras)
    torch.cuda.synchronize()
    if extras:
        (k2, s2), (k4b, s4) = k2, k4b
        assert torch.equal(s2, s4)
    assert torch.equal(rk._interior(k4b, hw), k2)


@pytest.mark.parametrize("shape,pixels", TCONV_EDGES)
def test_temporal_conv_kernels_at_plan_edges(cuda, shape, pixels):
    """K2 (emb, residual, statistics) and K4b (emb, residual, two skip
    parts, statistics, NaN pad rows) at each tile of their plan, within one
    ulp of their plain versions, statistics within 1e-3 of their scale plus
    what the outputs' differences move them by, zero pad cols; two launches
    bit-equal."""
    b, f, hw, c = shape
    gen = torch.Generator(device=cuda).manual_seed(42)
    x, k, bias, emb, res = _tconv_edge(gen, cuda, b, f, hw, c, True)
    before = rk.launches["temporal_conv_fused"]
    got, gst = rk.temporal_conv_fused(x, k, bias, emb, res, want_stats=True)
    again, ast = rk.temporal_conv_fused(x, k, bias, emb, res, want_stats=True)
    want, wst = rk.temporal_conv_fused_plain(x, k, bias, emb, res, want_stats=True)
    torch.cuda.synchronize()
    assert rk.launches["temporal_conv_fused"] == before + 2
    assert torch.equal(got, again) and torch.equal(gst, ast)
    ok, rel = _within_ulp(got, want, torch.bfloat16)
    assert ok, f"K2 max err / std {rel}"
    pad = lambda t: rk._place(t, *rk.padded_hw(*hw))  # noqa: E731
    _stats_close(gst, wst, pad(got), pad(want))

    xs = _stream(gen, cuda, torch.bfloat16, (b, f), hw, c)
    _, e, r, skips, sb = _tconv_extras(gen, cuda, torch.bfloat16, b, f, hw, c, True, True,
                                       (64, 96))
    args = (xs, k, bias, hw, e, r, skips, sb, True)
    before = rk.launches["temporal_conv_padded"]
    (got, gst), (again, ast) = rk.temporal_conv_padded(*args), rk.temporal_conv_padded(*args)
    want, wst = rk.temporal_conv_padded_plain(*args)
    torch.cuda.synchronize()
    assert rk.launches["temporal_conv_padded"] == before + 2
    rows = slice(1, hw[0] + 1)  # pad rows are not written
    assert torch.equal(got[:, :, rows], again[:, :, rows]) and torch.equal(gst, ast)
    _check_padded(got, want, hw, torch.bfloat16, what="K4b")
    _stats_close(gst, wst, got, want)


def test_temporal_conv_plan_is_the_kernels(cuda):
    """K2 and K4b's C side (`plan_of`, read through `v2a_temporal_conv_plan`)
    launches the plan `rk.temporal_conv_plan` logs and sizes the statistics'
    partial sums by, at the edges' shapes and the release levels'."""
    shapes = [(b, f, hw[0] * hw[1], c) for (b, f, hw, c), _ in TCONV_EDGES]
    shapes += [(8, 7, 16384, 128), (8, 7, 4096, 256), (8, 7, 1024, 384), (1, 7, 16384, 128),
               (1, 7, 1024, 384), (2, 3, 1000, 320), (1, 7, 64, 512)]
    for shape in shapes:
        assert rk.temporal_conv_plan_of_kernel(*shape) == rk.temporal_conv_plan(*shape), shape


# -- the training path: K6, the autograd Functions, a train_fused U-Net ----------


def _wgrad_ok(got, x, g, a, b, silu):
    """K6's gate: |err| <= 1e-4 * (|s|^T |g|), the float32 sum of absolute
    products, which bounds what any summation order can change."""
    want = rk.wgrad_conv3x3_plain(x, g, a, b, silu)
    bound = rk.wgrad_conv3x3_plain(rk._act(x, a, b, silu).abs(), g.abs())
    return bool(((got - want).abs() <= 1e-4 * bound).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["plain", "silu"])
@pytest.mark.parametrize("n,h,w,c,d", [(2, 8, 8, 128, 128), (3, 5, 7, 64, 192),
                                       (2, 4, 5, 64, 64), (28, 8, 8, 1280, 640)],
                         ids=["8x8", "ragged", "narrow", "release_8"])
def test_wgrad_kernel_matches_plain(cuda, dtype, mode, n, h, w, c, d):
    """At small shapes a lost pixel or a wrong border tap shows above the
    gate: H and W not multiples of the 8x8 tile, W below it (the tile is
    then 5 pixels wide) and the release U-Net's 8^2 level (28 x 8 x 8 x
    1280 -> 640, one chunk, 400 CTAs); two launches are bit-equal (no
    atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(n, h, w, c, generator=gen, device=cuda).to(dtype)
    g = torch.randn(n, h, w, d, generator=gen, device=cuda).to(dtype)
    a = b = None
    if mode == "silu":
        a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=cuda)
        b = 0.1 * torch.randn(n, c, generator=gen, device=cuda)
    before = rk.launches["wgrad_conv3x3"]
    got = rk.wgrad_conv3x3(x, g, a, b, mode == "silu")
    again = rk.wgrad_conv3x3(x, g, a, b, mode == "silu")
    torch.cuda.synchronize()
    assert rk.launches["wgrad_conv3x3"] == before + 2
    assert torch.equal(got, again)
    assert _wgrad_ok(got, x, g, a, b, mode == "silu")


@pytest.mark.parametrize("n,h,w,c,d", [(5, 48, 40, 128, 128), (4, 40, 48, 128, 192)])
def test_wgrad_kernel_at_a_chunked_shape(cuda, n, h, w, c, d):
    """Shapes that split the pixels into several chunks (the second,
    fixed-order pass), with chunk boundaries in the middle of a sample and a
    ragged last chunk, with 128-wide output blocks and with 64-wide ones
    (D = 192)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    plan = rk.wgrad_plan(n, h, w, c, d)
    per_image = plan.tiles // n
    assert plan.chunks > 1 and plan.per_chunk % per_image and plan.tiles % plan.per_chunk
    x = torch.randn(n, h, w, c, generator=gen, device=cuda).bfloat16()
    g = torch.randn(n, h, w, d, generator=gen, device=cuda).bfloat16()
    a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=cuda)
    b = 0.1 * torch.randn(n, c, generator=gen, device=cuda)
    got = rk.wgrad_conv3x3(x, g, a, b, True)
    assert torch.equal(got, rk.wgrad_conv3x3(x, g, a, b, True))
    assert _wgrad_ok(got, x, g, a, b, True)


@pytest.mark.parametrize("form", ["affine_silu", "plain"])
def test_conv_functions_on_the_card(cuda, form):
    """The autograd Functions with K1 forward, K1 dgrad and K6 on the card
    against the same Functions on CPU copies (the plain versions), float32:
    value and every gradient of sum(sin(y)) within rtol 2e-4 / atol 2e-4
    (tests/test_conv_vjp.py:48-55)."""
    from v2a_tpu_torch.ops import conv_vjp

    rs = np.random.RandomState(12)
    n, h, w, c, d = 3, 16, 16, 128, 128
    vals = [rs.randn(n, h, w, c), 0.05 * rs.randn(3, 3, c, d), 0.1 * rs.randn(d),
            1 + 0.3 * rs.randn(n, c), 0.2 * rs.randn(n, c)]
    if form == "plain":
        vals, fn = vals[:3], conv_vjp.plain_conv3x3
    else:
        fn = conv_vjp.affine_silu_conv3x3
    out = {}
    for dev in ("cpu", cuda):
        args = [torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=True)
                for v in vals]
        before = rk.launches["wgrad_conv3x3"]
        value = torch.sin(fn(*args, wgrad_kernel=True)).sum()
        value.backward()
        out[str(dev)] = (value.item(), [t.grad.cpu() for t in args])
        assert rk.launches["wgrad_conv3x3"] == before + (0 if dev == "cpu" else 1)
    (v0, g0), (v1, g1) = out.values()
    np.testing.assert_allclose(v1, v0, rtol=2e-5, atol=2e-5)
    for want, got in zip(g0, g1):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_train_fused_unet_matches_plain_on_the_card(cuda):
    """A small U-Net (mc 128, mult (1, 2), 16x16, F=2), float32, K6 on: loss
    and every parameter gradient of the train_fused routing against the
    plain path with the same weights, at the JAX package's train_fused-vs-
    plain tolerance (rtol 5e-4 / atol 5e-5); 17 convs, each one K1 forward,
    one K1 dgrad and one K6 launch."""
    from v2a_tpu_torch.models.init import init_params
    from v2a_tpu_torch.models.video_unet import VideoUNet

    kw = dict(model_channels=128, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(), task_token_dim=64)
    plain = VideoUNet(**kw).to(cuda)
    init_params(plain, torch.Generator(device=cuda).manual_seed(13))
    tf = VideoUNet(train_fused=True, wgrad_kernel=True, **kw).to(cuda)
    tf.load_state_dict(plain.state_dict())
    gen = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(2, 2, 16, 16, 6, generator=gen, device=cuda)
    t = torch.tensor([3, 70], device=cuda)
    te = torch.randn(2, 4, 64, generator=gen, device=cuda)
    losses = []
    for net in (plain, tf):
        before = dict(rk.launches)
        loss = (net(x, t, te) ** 2).mean()
        loss.backward()
        torch.cuda.synchronize()
        losses.append(loss.item())
        made = {k: v - before[k] for k, v in rk.launches.items() if v != before[k]}
        assert made == ({} if net is plain else
                        {"fused_affine_conv3x3": 34, "wgrad_conv3x3": 17})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5, atol=1e-6)
    for (k, p0), p1 in zip(plain.named_parameters(), tf.parameters()):
        np.testing.assert_allclose(p1.grad.cpu().numpy(), p0.grad.cpu().numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=k)


# -- the further serving routings: K7, K8, K9 and their small U-Nets -------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 64), (3, 1000, 128), (2, 7, 16, 16, 640),
                                   (1, 5, 8, 1280)])
def test_group_norm_silu_kernel_matches_plain(cuda, dtype, silu, shape):
    """K7 within one ulp of its plain version (float32: 1e-5 relative); two
    launches bit-equal (fixed-order statistics)."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    c = shape[-1]
    x = (torch.randn(*shape, generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    scale = 1 + 0.2 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.2 * torch.randn(c, generator=gen, device=cuda)
    before = rk.launches["fused_group_norm_silu"]
    got = gn.fused_group_norm_silu(x, scale, bias, 32, with_silu=silu)
    again = gn.fused_group_norm_silu(x, scale, bias, 32, with_silu=silu)
    torch.cuda.synchronize()
    assert rk.launches["fused_group_norm_silu"] == before + 2
    assert got.dtype == dtype and got.shape == x.shape and torch.equal(got, again)
    ok, rel = _within_ulp(got, gn.fused_group_norm_silu_plain(x, scale, bias, 32, with_silu=silu),
                          dtype)
    assert ok, f"max err / std {rel}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (1, 7, 8, 8, 1152),     # one lane, 3 rows a CTA, S % rows == 1, 150 CTAs
    (1, 7, 13, 13, 1280),   # one lane, 296 CTAs, S % rows == 3
    (56, 64, 640),          # an attention norm's B: 6 CTAs a sample, S % rows == 4
    (56, 37, 512),          # S < 64, a last CTA of one row
    (2, 3, 1000, 128),      # 16 lanes, S % rows == 30
    (8, 7, 12, 12, 384),    # 5 lanes, groups of 12 channels across vectors
    (1, 100000, 64),        # 32 lanes, 527 CTAs: the fold's longest runs
    (2, 3, 7, 8192)])       # 1,024 threads, 64 KiB of opted-in shared memory
def test_group_norm_silu_kernel_at_plan_edges(cuda, dtype, shape):
    """K7 at the edges of `gn.group_norm_plan` (ragged last CTAs, one and
    many lanes, B = 1 and 56, C up to 8192) within one ulp of its plain
    version (float32: 1e-5 relative); two launches bit-equal, the second on
    the scratch whose arrival counters the first reset."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    c = shape[-1]
    x = (torch.randn(*shape, generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    scale = 1 + 0.2 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.2 * torch.randn(c, generator=gen, device=cuda)
    before = rk.launches["fused_group_norm_silu"]
    got = gn.fused_group_norm_silu(x, scale, bias, 32)
    again = gn.fused_group_norm_silu(x, scale, bias, 32)
    torch.cuda.synchronize()
    assert rk.launches["fused_group_norm_silu"] == before + 2
    assert torch.equal(got, again)
    ok, rel = _within_ulp(got, gn.fused_group_norm_silu_plain(x, scale, bias, 32), dtype)
    assert ok, f"max err / std {rel}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["plain", "affine", "silu"])
@pytest.mark.parametrize("n,hw,c,d", [(3, (8, 8), 64, 64), (2, (12, 20), 128, 128),
                                      (2, (32, 32), 256, 256)])
def test_downconv3x3_padded_kernel_matches_plain(cuda, dtype, mode, n, hw, c, d):
    """K8 from a stream with NaN pad rows: the half-size interior within one
    ulp, pad cols exactly zero."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    x = _stream(gen, cuda, dtype, (n,), hw, c)
    k = torch.randn(3, 3, c, d, generator=gen, device=cuda) / (9 * c) ** 0.5
    bias = torch.randn(d, generator=gen, device=cuda) * 0.1
    a = b = None
    if mode != "plain":
        a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=cuda)
        b = 0.1 * torch.randn(n, c, generator=gen, device=cuda)
    before = rk.launches["fused_downconv3x3_padded"]
    got = rk.fused_downconv3x3_padded(x, k, bias, hw, a, b, mode == "silu")
    torch.cuda.synchronize()
    assert rk.launches["fused_downconv3x3_padded"] == before + 1
    want = rk.fused_downconv3x3_padded_plain(x, k, bias, hw, a, b, mode == "silu")
    _check_padded(got, want, (hw[0] // 2, hw[1] // 2), dtype)
    if dtype == torch.bfloat16:
        assert torch.equal(rk._interior(got, (hw[0] // 2, hw[1] // 2)),
                           _k1_at_even_pixels(x, k, bias, hw, a, b, mode == "silu"))


def _k1_at_even_pixels(x, k, bias, hw, a, b, silu):
    """K1 on the interior of a padded stream, sampled at even pixels: what
    K8 computes (the same products in the same order)."""
    return rk.fused_affine_conv3x3(rk._interior(x, hw).contiguous(), k, bias, a, b,
                                   silu)[:, ::2, ::2]


# K8 at the edges of its plan (`rk.affine_conv_plan(..., stride=2)` over the
# half-size output grid): each tile size, output grids no tile divides
K8_EDGES = [
    (28, (64, 64), 128, 128),   # 128-pixel tiles, sixteen warps
    (7, (64, 64), 256, 256),    # a served request's 64^2 -> 32^2: 64-pixel tiles, 224 CTAs
    (7, (32, 32), 512, 512),    # 32-pixel tiles
    (7, (16, 16), 640, 640),    # 16-pixel tiles, 140 CTAs
    (2, (12, 20), 128, 192),    # a 6 x 10 output: no tile divides it; 64-wide slices
    (3, (10, 14), 64, 64)]      # a 5 x 7 output, below the tile's 8 cols


@pytest.mark.parametrize("mode", ["plain", "affine", "silu"])
@pytest.mark.parametrize("n,hw,c,d", K8_EDGES)
def test_downconv3x3_padded_is_k1_at_even_pixels(cuda, mode, n, hw, c, d):
    """K8's bf16 body (K1's at stride 2) at its plan's edges, from a stream
    with NaN pad rows: its interior bit-equal to K1 on the input's interior
    at even pixels, pad cols exactly zero, two launches bit-equal, within
    one ulp of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    x = _stream(gen, cuda, torch.bfloat16, (n,), hw, c)
    k = torch.randn(3, 3, c, d, generator=gen, device=cuda) / (9 * c) ** 0.5
    bias = torch.randn(d, generator=gen, device=cuda) * 0.1
    a = b = None
    if mode != "plain":
        a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=cuda)
        b = 0.1 * torch.randn(n, c, generator=gen, device=cuda)
    got = rk.fused_downconv3x3_padded(x, k, bias, hw, a, b, mode == "silu")
    again = rk.fused_downconv3x3_padded(x, k, bias, hw, a, b, mode == "silu")
    torch.cuda.synchronize()
    hw2 = (hw[0] // 2, hw[1] // 2)
    assert torch.equal(got[:, 1:hw2[0] + 1], again[:, 1:hw2[0] + 1])  # pad rows are not written
    _check_padded(got, rk.fused_downconv3x3_padded_plain(x, k, bias, hw, a, b, mode == "silu"),
                  hw2, torch.bfloat16)
    assert torch.equal(rk._interior(got, hw2),
                       _k1_at_even_pixels(x, k, bias, hw, a, b, mode == "silu"))


def _attn_args(gen, dev, dtype, n, hw, c):
    x = _stream(gen, dev, dtype, (n,), hw, c)
    a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=dev)
    b = 0.1 * torch.randn(n, c, generator=gen, device=dev)
    w = [torch.randn(c, 3 * c, generator=gen, device=dev) / c ** 0.5,
         0.1 * torch.randn(3 * c, generator=gen, device=dev),
         torch.randn(c, c, generator=gen, device=dev) / c ** 0.5,
         0.1 * torch.randn(c, generator=gen, device=dev)]
    return x, a, b, w


def _check_attention(got, want, x, hw, a, b, w, ch, dtype):
    """K9's interior against its plain version. bf16: one ulp plus what a
    one-ulp difference of each head output (the projection's input, which
    kernel and plain version round from float32 sums taken in other orders)
    moves the output by through Wproj: (|att| 2^-7) @ |Wproj|. float32: as
    `_check_padded`. Every pad position exactly zero."""
    h, wd = hw
    pads = got.clone()
    pads[:, 1:h + 1, 1:wd + 1] = 0
    assert not bool(pads.any())
    gi, wi = rk._interior(got, hw).float(), rk._interior(want, hw).float()
    if dtype != torch.bfloat16:
        ok, rel = _within_ulp(gi, wi, dtype)
        assert ok, f"max err / std {rel}"
        return
    _, att = rk.spatial_attention_heads_plain(x, hw, a, b, w[0], w[1], ch)
    carried = (att.float().abs() * 2.0 ** -7) @ w[2].to(dtype).float().abs()
    tol = wi.abs() * 2.0 ** -7 + 1e-3 * wi.std() + rk._interior(carried.reshape(got.shape), hw)
    bad = int(((gi - wi).abs() > tol).sum())
    assert not bad, f"{bad} elements beyond the gate"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,hw,c,ch", [(3, (8, 8), 64, 32), (2, (6, 10), 128, 32),
                                       (4, (16, 16), 512, 32), (2, (8, 8), 640, 32),
                                       (1, (24, 30), 64, 32), (1, (32, 32), 128, 64),
                                       (2, (6, 10), 96, 32), (2, (8, 8), 48, 16),
                                       (1, (12, 12), 256, 128),
                                       (2, (16, 16), 640, 8), (2, (16, 16), 640, 40),
                                       (2, (16, 16), 640, 80), (2, (16, 16), 640, 160),
                                       (2, (8, 8), 640, 8), (2, (8, 8), 640, 40),
                                       (2, (8, 8), 640, 80), (2, (8, 8), 640, 160),
                                       (2, (32, 32), 384, 64), (7, (8, 8), 640, 32),
                                       (2, (6, 10), 96, 12)])
def test_spatial_attention_padded_kernel_matches_plain(cuda, dtype, n, hw, c, ch):
    """K9 from a stream with NaN pad rows at head widths from 8 to 160 (any
    width that divides C: 8, 40, 80 and 160 need zero lanes or 128-wide
    slices; 12, no multiple of 8, is copied element by element), C no
    multiple of 64 (96, 48), 1,024 tokens (a wide forward's 32^2 level,
    head 64) and a served request's N = 7 (16-token projection tiles,
    `rk.attention_plan`): every pad
    position of the output exactly zero, the interior within one ulp of the
    plain version plus the carried difference of its head outputs
    (`_check_attention`), the statistics within 1e-3 of their scale; two
    launches bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    x, a, b, w = _attn_args(gen, cuda, dtype, n, hw, c)
    before = rk.launches["fused_spatial_attention_padded"]
    got, gst = rk.fused_spatial_attention_padded(x, hw, a, b, *w, ch, want_stats=True)
    again = rk.fused_spatial_attention_padded(x, hw, a, b, *w, ch)
    torch.cuda.synchronize()
    assert rk.launches["fused_spatial_attention_padded"] == before + 2
    assert torch.equal(got, again)
    want, wst = rk.fused_spatial_attention_padded_plain(x, hw, a, b, *w, ch, want_stats=True)
    _stats_close(gst, wst)
    _check_attention(got, want, x, hw, a, b, w, ch, dtype)


def _routing_vs_plain(cuda, hw, routing, counts, **kw):
    """A small U-Net of one routing, float32, against the plain path with the
    same weights at the JAX package's fused-vs-plain tolerance; the launches
    of its forward across both kernel registries."""
    from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
    from v2a_tpu_torch.models.video_unet import VideoUNet

    cfg = VideoModelConfig(image_size=(hw, hw), sample_per_seq=3, model_channels=128,
                           text_dim=64, num_res_blocks=1, **kw, **routing)
    model = VideoPredModel(cfg).init(0)
    plain = VideoUNet(model_channels=128, num_res_blocks=1, task_token_dim=64,
                      **kw).to(cuda).eval()
    plain.load_state_dict(model.unet.state_dict())
    g = torch.Generator(device=cuda).manual_seed(18)
    x = torch.randn(2, 2, hw, hw, 6, generator=g, device=cuda)
    t = torch.tensor([5, 60], device=cuda)
    te = model.encode_batch_text(["open the drawer", "pick up the bowl"])
    before = dict(rk.launches)
    with torch.no_grad():
        got, want = model.unet(x, t, te), plain(x, t, te)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)
    after = dict(rk.launches)
    assert {k: v - before[k] for k, v in after.items() if v != before[k]} == counts


def test_padded_k8_k9_unet_matches_plain_on_the_card(cuda):
    """64x64, mult (1, 2, 2), attention at ds 4: K8 into the padded 32x32
    level, K9 entered at 16x16."""
    _routing_vs_plain(cuda, 64, dict(downconv=True, attn_kernel=True),
                      {"fused_affine_conv3x3": 12, "temporal_conv_fused": 12,
                       "fused_conv_tconv_padded": 12, "temporal_conv_padded": 3,
                       "fused_upconv3x3_padded": 2, "fused_downconv3x3_padded": 1,
                       "fused_spatial_attention_padded": 4},
                      channel_mult=(1, 2, 2), attention_resolutions=(4,))


def test_padded_upconv_off_unet_matches_plain_on_the_card(cuda):
    """64x64, mult (1, 2, 2), attention at ds 4, `upconv=False`: the two
    upsample convs into the padded 32x32 and 64x64 levels nearest-2x, padded,
    then K3 where K5 ran (the JAX package's count, traced on the CPU)."""
    _routing_vs_plain(cuda, 64, dict(upconv=False),
                      {"fused_affine_conv3x3": 12, "temporal_conv_fused": 13,
                       "fused_conv_tconv_padded": 14},
                      channel_mult=(1, 2, 2), attention_resolutions=(4,))


def test_plain_k7_unet_matches_plain_on_the_card(cuda):
    """32x32, mult (1, 2), attention at ds 2, the non-fused forward: K7 in
    every GroupNorm without forwarded statistics (8 x 2 + 4 + 1)."""
    _routing_vs_plain(cuda, 32, dict(fused=False, use_pallas_gn=True),
                      {"fused_group_norm_silu": 21},
                      channel_mult=(1, 2), attention_resolutions=(2,))


# -- K10, K11, K12: the routings without the K1 gate, and the streaming kernel ----


def _refuses_grad(fn, *args):
    """A kernel wrapper given an input that requires grad, under grad mode."""
    with pytest.raises(RuntimeError, match="has no backward"):
        fn(*args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,w,c,d", [(3, 8, 8, 128, 128), (2, 5, 7, 32, 64),
                                       (2, 12, 100, 64, 128), (2, 64, 64, 256, 256)])
def test_spatial_conv3x3_kernel_matches_plain(cuda, dtype, n, h, w, c, d):
    """K10 within one ulp of its plain version, two launches bit-equal, and
    bit-equal to K1 without an affine (K1's entry in mode 0); W = 7 below
    the tile's 8 cols, W = 100 that no tile divides."""
    g = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn(n, h, w, c, generator=g, device=cuda).to(dtype)
    k = torch.randn(3, 3, c, d, generator=g, device=cuda) / (9 * c) ** 0.5
    bias = torch.randn(d, generator=g, device=cuda) * 0.1
    before = rk.launches["spatial_conv3x3"]
    got, again = rk.spatial_conv3x3(x, k, bias), rk.spatial_conv3x3(x, k, bias)
    torch.cuda.synchronize()
    assert rk.launches["spatial_conv3x3"] == before + 2
    assert torch.equal(got, again) and torch.equal(got, rk.fused_affine_conv3x3(x, k, bias))
    ok, rel = _within_ulp(got, rk.spatial_conv3x3_plain(x, k, bias), dtype)
    assert ok, f"max err / std {rel}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extras", [(False, False, False), (True, True, True),
                                    (True, False, True)])
@pytest.mark.parametrize("b,f,s,c", [(2, 7, 64, 128), (1, 3, 1000, 256), (2, 2, 16, 64),
                                     (8, 7, 4096, 256)])
def test_temporal_conv_hw_kernel_matches_plain(cuda, dtype, extras, b, f, s, c):
    """K11 (the (S, B, F, C) view read by address in x's own memory) within
    one ulp of its plain version, statistics within 1e-3, two launches
    bit-equal."""
    has_emb, has_res, stats = extras
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn(b, f, s, c, generator=g, device=cuda).to(dtype)
    k = torch.randn(3, c, c, generator=g, device=cuda) / (3 * c) ** 0.5
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    emb = torch.randn(b, c, generator=g, device=cuda).to(dtype) if has_emb else None
    res = torch.randn(b, f, s, c, generator=g, device=cuda).to(dtype) if has_res else None
    before = rk.launches["temporal_conv_fused_hw"]
    got = rk.temporal_conv_fused_hw(x, k, bias, emb, res, want_stats=stats)
    again = rk.temporal_conv_fused_hw(x, k, bias, emb, res, want_stats=stats)
    torch.cuda.synchronize()
    assert rk.launches["temporal_conv_fused_hw"] == before + 2
    want = rk.temporal_conv_fused_hw_plain(x, k, bias, emb, res, want_stats=stats)
    if stats:
        (got, gst), (again, ast), (want, wst) = got, again, want
        assert torch.equal(gst, ast)
        _stats_close(gst, wst)
    assert got.shape == x.shape and torch.equal(got, again)
    ok, rel = _within_ulp(got, want, dtype)
    assert ok, f"max err / std {rel}"


# K11 against K2: the matching test's shapes, a served request's 8^2 x 640
# and S = 81 that no tile divides with C = 192, as (B, F, S, C)
K11_VS_K2 = [(2, 7, 64, 128), (1, 3, 1000, 256), (2, 2, 16, 64), (8, 7, 4096, 256),
             (1, 7, 64, 640), (3, 5, 81, 192)]


@pytest.mark.parametrize("extras", [(False, False, False), (True, True, True),
                                    (True, False, True)], ids=["bare", "emb_res_stats", "emb_stats"])
@pytest.mark.parametrize("shape", K11_VS_K2)
def test_temporal_conv_hw_is_k2(cuda, extras, shape):
    """K11's y and statistics bit-equal to K2's (`temporal_conv_fused`) on
    the same tensor, since it is K2's launch on x's own memory; the
    statistics within 1e-3 of the plain version's, two launches bit-equal,
    and each wrapper counted on its own counter."""
    b, f, s, c = shape
    has_emb, has_res, stats = extras
    g = torch.Generator(device=cuda).manual_seed(43)
    x = torch.randn(b, f, s, c, generator=g, device=cuda).bfloat16()
    k = torch.randn(3, c, c, generator=g, device=cuda) / (3 * c) ** 0.5
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    emb = torch.randn(b, c, generator=g, device=cuda).bfloat16() if has_emb else None
    res = torch.randn(b, f, s, c, generator=g, device=cuda).bfloat16() if has_res else None
    args = (x, k, bias, emb, res, stats)
    before = dict(rk.launches)
    got, again = rk.temporal_conv_fused_hw(*args), rk.temporal_conv_fused_hw(*args)
    k2 = rk.temporal_conv_fused(*args)
    torch.cuda.synchronize()
    assert rk.launches["temporal_conv_fused_hw"] == before["temporal_conv_fused_hw"] + 2
    assert rk.launches["temporal_conv_fused"] == before["temporal_conv_fused"] + 1
    if stats:
        (got, gst), (again, ast), (k2, kst) = got, again, k2
        _, wst = rk.temporal_conv_fused_hw_plain(*args)
        assert torch.equal(gst, ast) and torch.equal(gst, kst)
        _stats_close(gst, wst)
    assert torch.equal(got, k2) and torch.equal(got, again)


K12_SHAPES = PADDED_SHAPES + [(2, 7, (64, 64), (256,), 256), (2, 7, (32, 32), (384, 384), 384)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu,emb,res", [(True, True, True), (False, False, False),
                                          (True, True, False)])
@pytest.mark.parametrize("b,f,hw,cins,d", K12_SHAPES)
def test_conv_tconv_stream_kernel_matches_plain(cuda, dtype, silu, emb, res, b, f, hw, cins, d):
    """K12 from NaN-padded streams, held as K3 is: one rounding at a time
    against its own conv half (`_check_conv_tconv`); pad cols exactly zero;
    two launches (with and without `conv_out`) bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    parts, kbias, tk, tb, e, r, _, _ = _conv_tconv_case(gen, cuda, dtype, b, f, hw, cins, d, emb,
                                                        res, ())
    args = (parts, kbias, tk, tb, hw, e, r, silu, True)
    conv = torch.zeros(parts[0][0].shape[:4] + (d,), dtype=dtype, device=cuda)
    before = rk.launches["fused_conv_tconv_stream"]
    (got, gst), (again, ast) = (rk.fused_conv_tconv_stream(*args, conv_out=conv),
                                rk.fused_conv_tconv_stream(*args))
    torch.cuda.synchronize()
    assert rk.launches["fused_conv_tconv_stream"] == before + 2
    h = hw[0]
    assert torch.equal(got[:, :, 1:h + 1], again[:, :, 1:h + 1]) and torch.equal(gst, ast)
    _check_conv_tconv(got, gst, conv, parts, kbias, tk, tb, hw, e, r, None, None, silu, dtype)


def test_new_wrappers_refuse_a_differentiated_call(cuda):
    """K10-K12 have no backward, like K1-K9: an input that requires grad
    under grad mode raises instead of losing the gradient."""
    x = torch.zeros(1, 4, 4, 64, device=cuda, requires_grad=True)
    _refuses_grad(rk.spatial_conv3x3, x, torch.zeros(3, 3, 64, 64, device=cuda),
                  torch.zeros(64, device=cuda))
    _refuses_grad(rk.temporal_conv_fused_hw, torch.zeros(1, 2, 16, 64, device=cuda),
                  torch.zeros(3, 64, 64, device=cuda, requires_grad=True),
                  torch.zeros(64, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(23)
    parts = _conv_parts(gen, cuda, torch.float32, (1, 2), (8, 8), (64,), 64)
    kb = torch.zeros(64, device=cuda, requires_grad=True)
    _refuses_grad(rk.fused_conv_tconv_stream, parts, kb, torch.zeros(3, 64, 64, device=cuda),
                  torch.zeros(64, device=cuda), (8, 8))
    with torch.no_grad():
        rk.spatial_conv3x3(x, torch.zeros(3, 3, 64, 64, device=cuda), torch.zeros(64, device=cuda))


def test_spatial_k10_k11_unet_matches_plain_on_the_card(cuda):
    """32x32, mult (1, 2), attention at ds 2, the K1 gate off: K10 at every
    3x3 stride-1 conv with 128-multiple channels (one launch per channel
    part), K11 at every temporal conv."""
    _routing_vs_plain(cuda, 32, dict(spatial2_min_ch=0, pallas_spatial=True, tconv_hw=True),
                      {"spatial_conv3x3": 21, "temporal_conv_fused_hw": 19},
                      channel_mult=(1, 2), attention_resolutions=(2,))


def test_padded_k12_unet_matches_plain_on_the_card(cuda):
    """32x32, mult (1, 2), attention at ds 2, the padded routing with the
    streaming kernel: K12 in the padded convs without a skip fold."""
    _routing_vs_plain(cuda, 32, dict(stream_kernel=True),
                      {"fused_affine_conv3x3": 12, "temporal_conv_fused": 12,
                       "fused_conv_tconv_stream": 4, "fused_conv_tconv_padded": 2,
                       "temporal_conv_padded": 1, "fused_upconv3x3_padded": 1},
                      channel_mult=(1, 2), attention_resolutions=(2,))


# -- the lab kernels: K13, K14, K15 ---------------------------------------------------


@pytest.mark.parametrize("emb,res,skip_cins", [(True, True, ()), (True, False, (128, 64)),
                                               (False, False, ())])
@pytest.mark.parametrize("b,f,hw,cins,d", PADDED_SHAPES + [(2, 7, (128, 128), (128,), 128),
                                                           (1, 7, (64, 64), (256, 256), 256)])
def test_conv_tconv_dma_kernel_is_k3(cuda, emb, res, skip_cins, b, f, hw, cins, d):
    """K13 against K3 (bf16) at the small padded shapes and one shape of each
    padded level of the release U-Net (128^2 and 64^2), as the JAX tests
    relate the two (`tests/test_pallas_kernels.py:712-760`): K13 is K3's
    mainloop with its copies issued by TMA, the same products in the same
    order, so y and the statistics are bit-equal to K3's; two K13 launches
    bit-equal."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(30)
    parts = _conv_parts(gen, cuda, dtype, (b, f), hw, cins, d)
    kbias = torch.randn(d, generator=gen, device=cuda) * 0.1
    tk = torch.randn(3, d, d, generator=gen, device=cuda) / (3 * d) ** 0.5
    tb, e, r, skips, sb = _tconv_extras(gen, cuda, dtype, b, f, hw, d, emb, res, skip_cins)
    args = (parts, kbias, tk, tb, hw, e, r, skips, sb, True, True)
    before = rk.launches["fused_conv_tconv_dma"]
    got, gst = rk.fused_conv_tconv_dma(*args, tile_h=hw[0])
    again, ast = rk.fused_conv_tconv_dma(*args, tile_h=hw[0])
    want, wst = rk.fused_conv_tconv_padded(*args)
    torch.cuda.synchronize()
    assert rk.launches["fused_conv_tconv_dma"] == before + 2
    rows = slice(1, hw[0] + 1)
    assert torch.equal(got[:, :, rows], again[:, :, rows]) and torch.equal(gst, ast)
    assert torch.equal(got[:, :, rows], want[:, :, rows]) and torch.equal(gst, wst)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,w,c,d", [(2, 8, 16, 128, 128), (1, 32, 32, 256, 128),
                                       (3, 6, 10, 32, 64), (2, 128, 128, 128, 128),
                                       (1, 32, 32, 384, 384), (56, 32, 32, 384, 384),
                                       (2, 8, 8, 1280, 128), (8, 64, 64, 64, 192)])
def test_winograd_kernel_matches_plain(cuda, dtype, n, h, w, c, d):
    """K14 within one ulp of its plain version (float32: 1e-5 relative, the
    Winograd transform's cancellation stays far inside it); two launches
    bit-equal. The bf16 shapes reach every tile of `rk.winograd_plan`: 64
    patches (sixteen warps, and eight at 64-wide slices), 32, 16, and a
    streamed window (C = 1280 at 8^2)."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn(n, h, w, c, generator=gen, device=cuda).to(dtype)
    k = torch.randn(3, 3, c, d, generator=gen, device=cuda) / (9 * c) ** 0.5
    bias = torch.randn(d, generator=gen, device=cuda) * 0.1
    before = rk.launches["winograd_conv3x3"]
    got, again = rk.winograd_conv3x3(x, k, bias), rk.winograd_conv3x3(x, k, bias)
    torch.cuda.synchronize()
    assert rk.launches["winograd_conv3x3"] == before + 2
    assert got.shape == (n, h, w, d) and torch.equal(got, again)
    ok, rel = _within_ulp(got, rk.winograd_conv3x3_plain(x, k, bias), dtype)
    assert ok, f"max err / std {rel}"


def test_winograd_plan_is_the_kernels(cuda):
    """K14's C side (`plan_of`, read through `v2a_winograd_plan`) launches
    the plan `rk.winograd_plan` logs, at the lab's, K10's and ragged shapes
    (resident 32- and 16-patch tiles, a streamed window)."""
    shapes = [(56, 128, 128, 128, 128), (56, 64, 64, 256, 256), (56, 32, 32, 384, 384),
              (56, 8, 8, 512, 640), (56, 8, 8, 640, 640), (56, 16, 16, 640, 512),
              (56, 32, 32, 512, 512), (56, 64, 64, 384, 384), (56, 128, 128, 256, 256),
              (3, 6, 10, 32, 64), (1, 32, 32, 384, 384), (2, 8, 8, 1280, 128), (1, 2, 2, 32, 64)]
    for shape in shapes:
        assert rk.winograd_plan_of_kernel(*shape) == rk.winograd_plan(*shape), shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,f,s,c", [(2, 7, 64, 128), (1, 3, 1000, 256), (2, 2, 16, 64),
                                     (8, 7, 64, 640)])
def test_temporal_conv_taps_kernel_matches_plain(cuda, dtype, b, f, s, c):
    """K15 within one ulp of its plain version; two launches bit-equal."""
    from v2a_tpu_torch.scripts import perf_lab

    gen = torch.Generator(device=cuda).manual_seed(32)
    x = torch.randn(b, f, s, c, generator=gen, device=cuda).to(dtype)
    w = torch.randn(3 * c, c, generator=gen, device=cuda) / (3 * c) ** 0.5
    before = rk.launches["temporal_conv_taps"]
    got, again = perf_lab.temporal_conv_taps(x, w), perf_lab.temporal_conv_taps(x, w)
    torch.cuda.synchronize()
    assert rk.launches["temporal_conv_taps"] == before + 2
    assert torch.equal(got, again)
    ok, rel = _within_ulp(got, perf_lab.temporal_conv_taps_plain(x, w), dtype)
    assert ok, f"max err / std {rel}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,f,s,c", [(2, 7, 64, 128), (1, 3, 1000, 256), (8, 7, 64, 640)])
def test_temporal_conv_taps_is_k2(cuda, dtype, b, f, s, c):
    """K15 is K2's launch with a zero bias: y bit-equal to
    `temporal_conv_fused` with w as its (3, C, C) kernel and a zero bias on
    the same x, counted as K15's launch."""
    from v2a_tpu_torch.scripts import perf_lab

    gen = torch.Generator(device=cuda).manual_seed(34)
    x = torch.randn(b, f, s, c, generator=gen, device=cuda).to(dtype)
    w = torch.randn(3 * c, c, generator=gen, device=cuda) / (3 * c) ** 0.5
    k15, k2 = rk.launches["temporal_conv_taps"], rk.launches["temporal_conv_fused"]
    got = perf_lab.temporal_conv_taps(x, w)
    assert rk.launches["temporal_conv_taps"] == k15 + 1
    assert rk.launches["temporal_conv_fused"] == k2
    want = rk.temporal_conv_fused(x, w.reshape(3, c, c), torch.zeros(c, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_lab_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from v2a_tpu_torch.scripts import perf_lab

    with pytest.raises(ValueError):  # a head width that does not divide C, as in JAX
        x, a, b, w = _attn_args(torch.Generator(device=cuda).manual_seed(33), cuda,
                                torch.bfloat16, 1, (8, 8), 96)
        rk.fused_spatial_attention_padded(x, (8, 8), a, b, *w, 40)
    with pytest.raises(ValueError):  # D % 64
        rk.winograd_conv3x3(torch.zeros(1, 8, 8, 32, device=cuda),
                            torch.zeros(3, 3, 32, 48, device=cuda), torch.zeros(48, device=cuda))
    with pytest.raises(ValueError):  # C % 64
        perf_lab.temporal_conv_taps(torch.zeros(1, 3, 8, 96, device=cuda),
                                    torch.zeros(288, 96, device=cuda))
    with pytest.raises(ValueError):  # w not (3C, C)
        perf_lab.temporal_conv_taps(torch.zeros(1, 3, 8, 64, device=cuda),
                                    torch.zeros(3, 64, 64, device=cuda))


# -- the online loop (train/trainer.py) ----------------------------------------


def test_online_loop_on_the_card(cuda, tmp_path):
    """The fake_smoke loop on the card: live random episodes, one guided
    cycle whose goal videos go through the padded routing's kernels (video
    width 128, the small U-Net of the tests above: K2 needs C % 64 == 0),
    finite losses, a checkpoint that loads bit for bit into a fresh
    trainer."""
    import json
    import os

    from v2a_tpu_torch.config import apply_overrides, load_config_module
    from v2a_tpu_torch.train.build import build_experiment

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config_module(os.path.join(root, "v2a_tpu_torch", "config", "fake",
                                          "fake_smoke.py"))
    cfg = apply_overrides(cfg, {"video.model_channels": "128", "trainer.n_train_steps": "8",
                                "logbase": str(tmp_path)})
    trainer, policy, env_list, video_model = build_experiment(cfg)
    assert policy.device.type == "cuda" and video_model.unet.fused
    before = dict(rk.launches)
    trainer.train()
    made = {k: v - before[k] for k, v in rk.launches.items() if v != before[k]}
    torch.cuda.synchronize()
    assert trainer.step == 8 and trainer.cnt_vid_rollouts == len(env_list.task_list)
    assert made.get("fused_affine_conv3x3", 0) > 0 and made.get("temporal_conv_fused", 0) > 0
    for ep in trainer.envBuf_vid.export_episodes():
        assert ep["imgs"].shape[1:] == (32, 32, 3) and len(ep["imgs"]) == len(ep["acts"]) + 1
    with open(os.path.join(trainer.workdir, "metrics.jsonl")) as fh:
        losses = [r["train/loss"] for r in map(json.loads, fh) if "train/loss" in r]
    assert losses and np.all(np.isfinite(losses))
    trainer.save()  # fake_smoke saves at steps 1 and 10: this run stops at 8
    fresh, *_ = build_experiment(cfg, trainer.workdir, with_video_model=False, snapshot=False)
    fresh.load()
    a, b = trainer.state_dict(), fresh.state_dict()
    assert a["step"] == b["step"] == 8
    for part in ("params", "ema_params"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])
    for part in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a["opt_state"][part], b["opt_state"][part]))


def test_pool_cycle_on_the_card(cuda, tmp_path):
    """A guided cycle of fake_smoke on a pool of 2 spawned env workers: one
    B=2 goal-video chain through the fused routing's kernels, one B=2 DDIM
    prediction per lock-step round, valid episodes; then the same chain as
    a `VideoSampleStream` pumped chunk by chunk equals `sample_u8` bit for
    bit on the card."""
    import os

    from v2a_tpu_torch.config import apply_overrides, load_config_module
    from v2a_tpu_torch.train.build import build_experiment

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config_module(os.path.join(root, "v2a_tpu_torch", "config", "fake",
                                          "fake_smoke.py"))
    cfg = apply_overrides(cfg, {"video.model_channels": "128", "n_env_workers": "2",
                                "logbase": str(tmp_path)})
    trainer, policy, env_list, video_model = build_experiment(cfg)
    try:
        assert len(trainer.env_pool) == 2 and video_model.unet.fused
        batches = []
        fn = trainer._batched_executor.policy_fn
        trainer._batched_executor.policy_fn = lambda o, g: (batches.append(len(o)), fn(o, g))[1]
        before = dict(rk.launches)
        trainer.video_guided_explore()
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in rk.launches.items() if v != before[k]}
    finally:
        trainer.env_pool.close()
    assert made.get("fused_affine_conv3x3", 0) > 0 and made.get("temporal_conv_fused", 0) > 0
    assert batches and set(batches) == {2}
    assert trainer.cnt_vid_rollouts == len(trainer.envBuf_vid) == 2
    for ep in trainer.envBuf_vid.export_episodes():
        assert ep["imgs"].shape[1:] == (32, 32, 3) and len(ep["imgs"]) == len(ep["acts"]) + 1
        assert -1.0 <= ep["acts"].min() and ep["acts"].max() <= 1.0
    imgs01 = np.random.default_rng(0).random((2, 32, 32, 3), np.float32)
    tasks = list(env_list.task_list)
    ref = video_model.sample_u8(imgs01, tasks, generator=torch.Generator(cuda).manual_seed(3))
    stream = video_model.sample_u8_stream(imgs01, tasks, torch.Generator(cuda).manual_seed(3),
                                          n_chunks=3)
    while stream.pump(1):
        pass
    assert torch.equal(stream.result_u8(), ref)


def test_native_store_matches_python_backend(cuda):
    """The replay store built on this machine samples the Python backend's
    batches, and a batch reaches the card through the trainer's pinned
    copier as uint8 scaled there (held against the same scaling on the
    card: a division by a scalar there is a product by its reciprocal)."""
    from v2a_tpu_torch.data.replay_buffer import ReplayBuffer
    from v2a_tpu_torch.parallel.prefetch import PinnedCopier

    rs = np.random.RandomState(0)
    bufs = [ReplayBuffer(4, 64, 10, 8, backend=b) for b in ("native", "python")]
    for e in range(6):
        n = 20 + 7 * e
        imgs = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
        acts = rs.uniform(-1, 1, (n - 1, 7)).astype(np.float32)
        for buf in bufs:
            buf.add_episode(f"t{e}", "agent", e, imgs, acts)
    got = [buf.sample_batch(64, np.random.default_rng(5)) for buf in bufs]
    for k in ("img_obs", "img_goal", "action", "env_idx"):
        np.testing.assert_array_equal(got[0][k], got[1][k])
    assert got[0]["task"] == got[1]["task"]
    copier = PinnedCopier(cuda, n_slots=2, transform=lambda t: {k: v.float() / 255.0
                                                                for k, v in t.items()})
    for _ in range(3):  # the ring comes round
        out = copier.take(copier.put({"img_obs": got[0]["img_obs"]}))
    torch.cuda.synchronize()
    want = torch.from_numpy(got[0]["img_obs"]).to(cuda).float() / 255.0
    assert out["img_obs"].device.type == "cuda" and torch.equal(out["img_obs"], want)
