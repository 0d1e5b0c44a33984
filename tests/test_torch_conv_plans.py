"""The launch plans of K1, K4a, K10, K8 and K5 (`affine_conv_plan`), K2,
K4b and K11 (`temporal_conv_plan`), K9 (`attention_plan`), K14
(`winograd_plan`) and K7 (`group_norm_plan`), on the CPU: at every shape the release paths give the
kernels (traced on the `meta` device, no memory) and at ragged shapes off
them, each plan's tiles cover every pixel (K5: every output pixel of every
parity; K14: every 2x2 patch; K9: every token, column and (sample, head,
query)) exactly once, its shared memory fits a CTA, and its grid has a CTA
per SM wherever its smallest tile allows. The card checks the kernels
themselves (`tests/test_torch_gpu.py`, `chip_smoke.py`), and that K2/K4b's
and K14's C sides plan the same.
"""

import numpy as np
import pytest
import torch

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_padded import PACKAGE_KERNELS, _counting
from v2a_tpu_torch.models import video_unet as tvu
from v2a_tpu_torch.ops import conv_vjp as tcv
from v2a_tpu_torch.ops import group_norm as tgn
from v2a_tpu_torch.ops import resblock_kernels as trk

SMEM_227_KIB = 227 * 1024


def _k1_calls(monkeypatch, path):
    """{(N, H, W, C, D): calls} of K1 on one release path traced on the meta
    device: "serve_b8" / "serve_b1" (the shipped padded routing's forward at
    B=8, and at B=1 as a served request runs it), "forward" / "dgrad" (the
    B=4 train step's K1 forwards, and its dgrads: K1 in plain-conv mode on
    the flipped, transposed kernel)."""
    _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    calls, role = {}, ["forward"]

    def record(x, kernel, bias, a=None, b=None, silu=False):
        if path in ("serve_b8", "serve_b1") or role[0] == path:
            key = tuple(x.shape) + (kernel.shape[-1],)
            calls[key] = calls.get(key, 0) + 1
        return trk.fused_affine_conv3x3_plain(x, kernel, bias, a, b, silu)

    dgrad = tcv._dgrad_kernel

    def dgrad_recorded(g, kernel):
        role[0] = "dgrad"
        try:
            return dgrad(g, kernel)
        finally:
            role[0] = "forward"

    monkeypatch.setattr(trk, "fused_affine_conv3x3", record)
    monkeypatch.setattr(tcv, "_dgrad_kernel", dgrad_recorded)
    text = torch.randn
    with torch.device("meta"):
        if path.startswith("serve"):
            b = 8 if path == "serve_b8" else 1
            with torch.no_grad():
                tvu.VideoUNet(dtype=torch.bfloat16, fused=True)(
                    text(b, 7, 128, 128, 6), torch.zeros(b, dtype=torch.long), text(b, 77, 512))
        else:
            net = tvu.VideoUNet(dtype=torch.bfloat16, train_fused=True, wgrad_kernel=True)
            y = net(text(4, 7, 128, 128, 6), torch.zeros(4, dtype=torch.long), text(4, 77, 512))
            y.float().square().mean().backward()
    return calls


def _covered_once(h, w, th, tw, tiles):
    """Tiles of th x tw over an (h, w) grid in row-major order, as
    `hop::tile_of` deals them out, each covering its cells; all once?"""
    tiles_w = -(-w // tw)
    covered = np.zeros((h, w), np.int32)
    for t in range(tiles):
        h0, w0 = (t // tiles_w) * th, (t % tiles_w) * tw
        covered[h0:h0 + th, w0:w0 + tw] += 1
    return bool((covered == 1).all())


def _check_k1_plan(n, h, w, c, d, stride=1):
    """K1's plan (K8's at stride 2, over the (h/2, w/2) output grid): its
    tiles cover the output grid once, its shared memory (three weight
    stages and three windows of `_window_rows` 64-byte rows) fits, and
    the largest tile with a CTA per SM."""
    plan = trk.affine_conv_plan(n, h, w, c, d, stride)
    assert plan == trk.affine_conv_plan(n, h, w, c, d, stride)
    h, w = h // stride, w // stride
    nc = 128 if d % 128 == 0 else 64
    th, tw, per_image = trk._hop_tile(h, w, plan.pixels)
    assert plan.nc == nc and th * tw <= plan.pixels and plan.tiles == n * per_image
    assert _covered_once(h, w, th, tw, per_image)
    assert plan.grid == plan.tiles * (d // nc) and plan.smem <= SMEM_227_KIB
    window = (stride * th + 3 - stride) * (stride * tw + 3 - stride) * 64
    assert plan.smem >= 3 * 3 * 32 * nc * 2 + 3 * window
    # the tiles the plan may take: 16, and each larger one that needs fewer
    # tiles than the next smaller
    tiles = {p: trk._hop_tile(h, w, p)[2] for p in (128, 64, 32, 16)}
    grids = {p: n * t * (d // nc) for p, t in tiles.items() if p == 16 or t < tiles[p // 2]}
    if grids[16] >= trk.HOPPER_SMS:  # a CTA per SM, at the largest tile that gives one
        assert plan.grid >= trk.HOPPER_SMS
        assert plan.pixels == max(p for p, g in grids.items() if g >= trk.HOPPER_SMS)
    else:
        assert plan.pixels == 16
    return plan


# the K1 signatures of each release path: (N, H, W, C, D) and calls
RELEASE_K1_CALLS = {"serve_b8": 31, "serve_b1": 31, "forward": 58, "dgrad": 58}


@pytest.mark.parametrize("path", list(RELEASE_K1_CALLS))
def test_affine_conv_plan_fits_every_release_call(monkeypatch, path):
    """`trk.affine_conv_plan` at every K1 call of the served forward (B=8,
    and a B=1 request, whose 8^2 x 640 -> 640 calls take 16-pixel tiles: 28
    x 5 = 140 CTAs) and of the B=4 train step's forwards and dgrads."""
    calls = _k1_calls(monkeypatch, path)
    assert sum(calls.values()) == RELEASE_K1_CALLS[path]
    plans = {key: _check_k1_plan(*key) for key in calls}
    assert all(p.grid >= trk.HOPPER_SMS for p in plans.values())
    if path == "serve_b1":
        plan = plans[(7, 8, 8, 640, 640)]
        assert (plan.pixels, plan.nc, plan.grid) == (16, 128, 140)
    if path == "dgrad":  # the dgrad's C is the forward's D
        assert (28, 128, 128, 128, 384) in calls and (28, 8, 8, 640, 1280) in calls


@pytest.mark.parametrize("n,h,w,c,d", [(2, 5, 7, 32, 64), (3, 8, 8, 128, 192), (1, 1, 1, 32, 64),
                                       (2, 130, 9, 64, 64), (7, 8, 8, 640, 192),
                                       (28, 16, 16, 512, 384)])
def test_affine_conv_plan_at_ragged_shapes(n, h, w, c, d):
    """Off the release path: W narrower than a tile, H and W no tile
    divides, one pixel, D = 192 (64-wide slices), the card tests' shapes."""
    _check_k1_plan(n, h, w, c, d)


def _padded_calls(monkeypatch, name, b, **routing):
    """{signature: calls} of wrapper `name` (K4a: (N, H, W, C0 + C1, D); K9:
    (N, H, W, C, head width); K8: (N, H, W, C, D) at its full-size input;
    K5: (N, H, W, C, D) at its low-res input) in one B-sample release
    forward of a routing, traced on the meta device with every kernel's
    plain version."""
    _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    calls, plain = {}, getattr(trk, name + "_plain")

    def k8(x, kernel, bias, hw, a=None, b=None, silu=False):  # and K5
        key = (x.shape[0],) + tuple(hw) + (x.shape[-1], kernel.shape[-1])
        calls[key] = calls.get(key, 0) + 1
        return plain(x, kernel, bias, hw, a, b, silu)

    def k4a(parts, bias, hw, silu=True):
        key = (parts[0][0].shape[0],) + tuple(hw) + (sum(p[0].shape[-1] for p in parts),
                                                    parts[0][1].shape[-1])
        calls[key] = calls.get(key, 0) + 1
        return plain(parts, bias, hw, silu)

    def k9(x, hw, a, b, wqkv, bqkv, wproj, bproj, num_head_channels, want_stats=False):
        key = (x.shape[0],) + tuple(hw) + (x.shape[-1], num_head_channels)
        calls[key] = calls.get(key, 0) + 1
        return plain(x, hw, a, b, wqkv, bqkv, wproj, bproj, num_head_channels, want_stats)

    monkeypatch.setattr(trk, name, {"fused_affine_conv3x3_padded": k4a,
                                    "fused_downconv3x3_padded": k8,
                                    "fused_upconv3x3_padded": k8}.get(name, k9))
    with torch.device("meta"), torch.no_grad():
        tvu.VideoUNet(dtype=torch.bfloat16, fused=True, **routing)(
            torch.randn(b, 7, 128, 128, 6), torch.zeros(b, dtype=torch.long),
            torch.randn(b, 77, 512))
    return calls


# K4a's calls per release forward: the shipped padded routing at B=8 and at
# a B=1 request, and padded_mega_off (K4a -> K4b where K3 would run)
K4A_PATHS = {"padded_b8": (8, {}, 14), "padded_b1": (1, {}, 14),
             "mega_off_b8": (8, dict(mega_kernel=False), 30),
             "mega_off_b1": (1, dict(mega_kernel=False), 30)}


@pytest.mark.parametrize("path", list(K4A_PATHS))
def test_k4a_plan_fits_every_release_call(monkeypatch, path):
    """K4a takes K1's plan over its parts' summed channels at every call:
    its tiles cover every interior pixel once, its shared memory (which
    does not depend on C) fits, and its grid has a CTA per SM, a served
    request's (N = 7) included; padded_mega_off's two-part 128^2 calls
    (128 + 128 -> 128, 256 + 128 -> 128) take the 128-pixel tile."""
    b, routing, total = K4A_PATHS[path]
    calls = _padded_calls(monkeypatch, "fused_affine_conv3x3_padded", b, **routing)
    assert sum(calls.values()) == total
    plans = {key: _check_k1_plan(*key) for key in calls}
    assert all(p.grid >= trk.HOPPER_SMS for p in plans.values())
    if path == "mega_off_b8":
        assert plans[(56, 128, 128, 256, 128)].pixels == 128
        assert plans[(56, 128, 128, 384, 128)].pixels == 128


# K8's calls per release forward of padded_k8_k9 and padded_k8_k9_wide, at
# B=8 and at a B=1 request
K8_PATHS = {"k8_k9_b8": (8, {}), "k8_k9_b1": (1, {}),
            "wide_b8": (8, dict(attention_resolutions=(4, 8, 16), num_head_channels=64)),
            "wide_b1": (1, dict(attention_resolutions=(4, 8, 16), num_head_channels=64))}


@pytest.mark.parametrize("path", list(K8_PATHS))
def test_k8_plan_fits_every_release_call(monkeypatch, path):
    """K8 takes K1's plan at stride 2 at both of its calls (128^2 x 128 ->
    64^2 and 64^2 x 256 -> 32^2): its tiles cover the half-size output grid
    once, the stride-2 windows' shared memory fits, and its grid has a CTA
    per SM, a served request's (N = 7) included, where the 32^2 output takes
    64-pixel tiles (7 x 16 x 2 = 224 CTAs)."""
    b, arch = K8_PATHS[path]
    calls = _padded_calls(monkeypatch, "fused_downconv3x3_padded", b, downconv=True,
                          attn_kernel=True, **arch)
    n = 7 * b
    assert calls == {(n, 128, 128, 128, 128): 1, (n, 64, 64, 256, 256): 1}
    plans = {key: _check_k1_plan(*key, stride=2) for key in calls}
    assert all(p.grid >= trk.HOPPER_SMS for p in plans.values())
    if b == 8:
        assert {p.pixels for p in plans.values()} == {128}
    else:
        assert (plans[(7, 64, 64, 256, 256)].pixels, plans[(7, 64, 64, 256, 256)].grid) == (64, 224)


@pytest.mark.parametrize("n,h,w,c,d", [(2, 24, 40, 128, 128), (3, 10, 14, 64, 64),
                                       (1, 2, 2, 32, 64), (2, 12, 20, 128, 192),
                                       (1, 70, 18, 256, 256), (7, 16, 16, 640, 640)])
def test_k8_plan_at_ragged_shapes(n, h, w, c, d):
    """Off the release paths: H/2 and W/2 that no tile divides (12 x 20, 5 x
    7, 35 x 9), W/2 below the tile's cols, one output pixel, 64-wide output
    slices."""
    _check_k1_plan(n, h, w, c, d, stride=2)


def _check_k5_plan(n, h, w, c, d):
    """K5's plan (`affine_conv_plan(..., up=True)`): K1's tiles over the
    low-res (h, w) grid and its shared memory, a CTA per tile and output
    parity; the grid, decoded as the kernel decodes it (D slices fastest,
    then the parity, then the tile), writes every pixel of the (2h, 2w)
    output once; the largest tile whose grid has a CTA per SM."""
    plan = trk.affine_conv_plan(n, h, w, c, d, up=True)
    assert plan == trk.affine_conv_plan(n, h, w, c, d, up=True)
    th, tw, per_image = trk._hop_tile(h, w, plan.pixels)
    assert plan.nc == (128 if d % 128 == 0 else 64) and plan.smem <= SMEM_227_KIB
    assert plan.smem >= 3 * 3 * 32 * plan.nc * 2 + 3 * (th + 2) * (tw + 2) * 64
    slices = d // plan.nc
    assert plan.tiles == n * per_image and plan.grid == plan.tiles * 4 * slices
    covered = np.zeros((n, 2 * h, 2 * w), np.int32)
    tiles_w = -(-w // tw)
    for cta in range(0, plan.grid, slices):
        par, cid = cta // slices % 4, cta // slices // 4
        img, tile = cid // per_image, cid % per_image
        i0, j0 = (tile // tiles_w) * th, (tile % tiles_w) * tw
        rows = np.arange(i0, min(i0 + th, h)) * 2 + (par >> 1)
        cols = np.arange(j0, min(j0 + tw, w)) * 2 + (par & 1)
        covered[img][np.ix_(rows, cols)] += 1
    assert (covered == 1).all()
    tiles = {p: trk._hop_tile(h, w, p)[2] for p in (128, 64, 32, 16)}
    grids = {p: n * t * 4 * slices for p, t in tiles.items() if p == 16 or t < tiles[p // 2]}
    if grids[16] >= trk.HOPPER_SMS:
        assert plan.pixels == max(p for p, g in grids.items() if g >= trk.HOPPER_SMS)
    return plan


@pytest.mark.parametrize("b", [8, 1])
def test_k5_plan_fits_every_release_call(monkeypatch, b):
    """K5 takes K1's plan over its low-res grid x 4 parities at its three
    calls of the padded forward (16^2 x 512, 32^2 x 384, 64^2 x 256 in, D =
    C): every output pixel of every parity once, the shared memory fits,
    and a B=1 request's grid keeps a CTA per SM (16^2: 128-pixel tiles, 7 x
    2 x 4 parities x 4 slices = 224 CTAs)."""
    calls = _padded_calls(monkeypatch, "fused_upconv3x3_padded", b)
    n = 7 * b
    assert calls == {(n, 16, 16, 512, 512): 1, (n, 32, 32, 384, 384): 1,
                     (n, 64, 64, 256, 256): 1}
    plans = {key: _check_k5_plan(*key) for key in calls}
    assert all(p.grid >= trk.HOPPER_SMS for p in plans.values())
    assert {p.pixels for p in plans.values()} == {128}
    if b == 1:
        assert plans[(7, 16, 16, 512, 512)].grid == 224


@pytest.mark.parametrize("n,h,w,c,d", [(2, 12, 20, 128, 192), (3, 5, 7, 64, 64),
                                       (1, 1, 1, 32, 64), (1, 4, 4, 640, 640)])
def test_k5_plan_at_ragged_shapes(n, h, w, c, d):
    """Off the path: low-res grids no tile divides, W below the tile's cols,
    one pixel, 64-wide output slices, a grid short of the SMs at every
    tile (16-pixel tiles)."""
    _check_k5_plan(n, h, w, c, d)


def _driven_to_the_launch(monkeypatch):
    """Stubs the device checks, the library and the stream so that a wrapper
    called on meta tensors runs to its launch; returns {entry: [(source,
    pointer arguments, int arguments)]} of each C entry launched."""
    import contextlib

    seen = {}

    def fake_lib(name, fn, nptr, nint, nfloat=0):
        def launch(*args):
            seen.setdefault(fn, []).append((name, args[:nptr], args[nptr:nptr + nint]))
            return 0
        return launch

    monkeypatch.setattr(trk, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(trk, "_stream", lambda x: 0)
    monkeypatch.setattr(trk, "_ptr", lambda t: t)
    monkeypatch.setattr(trk, "_lib", fake_lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return seen


# K8's two B=8 signatures (`test_k8_plan_fits_every_release_call`), a served
# request's 64^2 one (64-pixel tiles at stride 2, 128 at stride 1) and a ragged one
K8_CALLS = [(56, 128, 128, 128, 128), (56, 64, 64, 256, 256), (7, 64, 64, 256, 256),
            (2, 12, 20, 128, 192)]


# K5's three B=8 signatures (low-res in), a B=1 request's 16^2 one and a ragged one
K5_CALLS = [(56, 16, 16, 512, 512), (56, 32, 32, 384, 384), (56, 64, 64, 256, 256),
            (7, 16, 16, 512, 512), (2, 12, 20, 128, 192)]


def test_k10_and_k8_wrappers_pass_the_plan(monkeypatch):
    """K10's wrapper, at each of its 17 signatures, and K8's, at both of its
    B=8 ones and a ragged one, driven to the launch on meta tensors: each
    calls its entry of `affine_conv3x3.cu` with the P of `affine_conv_plan`
    (K8: at stride 2, with the half-size stream's Wp2)."""
    seen = _driven_to_the_launch(monkeypatch)
    with torch.device("meta"):
        for n, h, w, c, d in K10_K14:
            trk.spatial_conv3x3(torch.empty(n, h, w, c, dtype=torch.bfloat16),
                                torch.empty(3, 3, c, d), torch.empty(d))
        for n, h, w, c, d in K8_CALLS:
            hp, wp = trk.padded_hw(h, w)
            trk.fused_downconv3x3_padded(torch.empty(n, hp, wp, c, dtype=torch.bfloat16),
                                         torch.empty(3, 3, c, d), torch.empty(d), (h, w))
    ints = {fn: [(name,) + tuple(args) for name, _, args in calls] for fn, calls in seen.items()}
    assert ints["v2a_spatial_conv3x3"] == [
        ("affine_conv3x3", n, h, w, c, d, trk.affine_conv_plan(n, h, w, c, d).pixels, 1)
        for n, h, w, c, d in K10_K14]
    assert ints["v2a_downconv3x3_padded"] == [
        ("affine_conv3x3", n, h, w, trk.padded_hw(h, w)[1], trk.padded_hw(h // 2, w // 2)[1], c,
         d, 0, trk.affine_conv_plan(n, h, w, c, d, stride=2).pixels, 1)
        for n, h, w, c, d in K8_CALLS]


@pytest.mark.parametrize("silu", [None, False, True], ids=["plain", "affine", "silu"])
def test_k5_wrapper_passes_the_plan(monkeypatch, silu):
    """K5's wrapper, at its three B=8 signatures, a B=1 one and a ragged
    one, driven to the launch on meta tensors in each mode: it calls
    `v2a_upconv3x3_padded` of `affine_conv3x3.cu` with the double-size
    stream's Wph, its mode and the P of `affine_conv_plan(..., up=True)`,
    and the (16 C, D) collapsed weights."""
    seen = _driven_to_the_launch(monkeypatch)
    mode = 0 if silu is None else 2 if silu else 1
    with torch.device("meta"):
        for n, h, w, c, d in K5_CALLS:
            hp, wp = trk.padded_hw(h, w)
            a = b = None if silu is None else torch.empty(n, c)
            trk.fused_upconv3x3_padded(torch.empty(n, hp, wp, c, dtype=torch.bfloat16),
                                       torch.empty(3, 3, c, d), torch.empty(d), (h, w), a, b,
                                       bool(silu))
    calls = seen["v2a_upconv3x3_padded"]
    assert [(name,) + tuple(args) for name, _, args in calls] == [
        ("affine_conv3x3", n, h, w, trk.padded_hw(h, w)[1], trk.padded_hw(2 * h, 2 * w)[1], c,
         d, mode, trk.affine_conv_plan(n, h, w, c, d, up=True).pixels, 1)
        for n, h, w, c, d in K5_CALLS]
    assert [tuple(ptrs[3].shape) for _, ptrs, _ in calls] == [(16 * c, d)
                                                              for _, _, _, c, d in K5_CALLS]


def _check_tconv_plan(b, f, s, c):
    """K2 / K4b's plan: flat P-pixel tiles of each frame's S pixels, each
    pixel once; ceil(F / T) groups of T frames a sample; C / NC output
    slices; the shared memory fits; the first (P, T) of `_TCONV_TILES` (a
    larger P only where it needs fewer tiles than half of it) whose grid has
    a CTA per SM, else 16-pixel tiles of one frame."""
    plan = trk.temporal_conv_plan(b, f, s, c)
    assert plan == trk.temporal_conv_plan(b, f, s, c)
    nc = 128 if c % 128 == 0 else 64
    assert plan.nc == nc and plan.tiles == -(-s // plan.pixels) and plan.frames in (1, 2)
    covered = np.zeros((f, plan.tiles * plan.pixels), np.int32)
    for g in range(-(-f // plan.frames)):
        for t in range(plan.tiles):
            rows, cols = slice(g * plan.frames, (g + 1) * plan.frames), slice(
                t * plan.pixels, (t + 1) * plan.pixels)
            covered[rows, cols] += 1
    assert (covered[:, :s] == 1).all() and plan.tiles * plan.pixels - s < plan.pixels
    assert plan.grid == b * -(-f // plan.frames) * plan.tiles * (c // nc)
    assert plan.smem <= SMEM_227_KIB
    grids = {(p, t): b * -(-f // t) * -(-s // p) * (c // nc) for p, t in trk._TCONV_TILES
             if p == 16 or -(-s // p) < -(-s // (p // 2))}
    fits = [pt for pt, g in grids.items() if g >= trk.HOPPER_SMS]
    assert (plan.pixels, plan.frames) == (fits[0] if fits else (16, 1))
    return plan


def _tconv_calls(monkeypatch, b, **routing):
    """{(B, F, S, C): calls} of K2 and of K4b (S: the interior's pixels) in
    one B-sample release forward of a routing, traced on the meta device
    with every kernel's plain version."""
    _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    k2, k4b = {}, {}

    def record(calls, x, c, s):
        key = (x.shape[0], x.shape[1], s, c)
        calls[key] = calls.get(key, 0) + 1

    def fused(x, kernel, bias, emb=None, residual=None, want_stats=False):
        record(k2, x, x.shape[-1], int(np.prod(x.shape[2:-1])))
        return trk.temporal_conv_fused_plain(x, kernel, bias, emb, residual, want_stats)

    def padded(x, kernel, bias, hw, emb=None, residual=None, skip_parts=None, skip_bias=None,
               want_stats=False):
        record(k4b, x, x.shape[-1], hw[0] * hw[1])
        return trk.temporal_conv_padded_plain(x, kernel, bias, hw, emb, residual, skip_parts,
                                              skip_bias, want_stats)

    monkeypatch.setattr(trk, "temporal_conv_fused", fused)
    monkeypatch.setattr(trk, "temporal_conv_padded", padded)
    with torch.device("meta"), torch.no_grad():
        tvu.VideoUNet(dtype=torch.bfloat16, fused=True, **routing)(
            torch.randn(b, 7, 128, 128, 6), torch.zeros(b, dtype=torch.long),
            torch.randn(b, 77, 512))
    return k2, k4b


# K2's and K4b's calls per release forward: the shipped padded routing at B=8
# and at a B=1 request, padded_mega_off (K4a -> K4b where K3 would run) and
# the unpadded routing (K2 only)
TCONV_PATHS = {"padded_b8": (8, {}, 30, 17), "padded_b1": (1, {}, 30, 17),
               "mega_off_b8": (8, dict(mega_kernel=False), 30, 33),
               "unpadded_b8": (8, dict(padded_stream=False), 63, 0)}


@pytest.mark.parametrize("path", list(TCONV_PATHS))
def test_temporal_conv_plan_fits_every_release_call(monkeypatch, path):
    """`trk.temporal_conv_plan` at every K2 and K4b call: its tiles cover
    every interior pixel once, its shared memory fits, and its grid has a
    CTA per SM, a served request's (B*F = 7: 8^2 x 640 on 16-pixel tiles,
    140 CTAs) included, but for the one call where 16-pixel tiles give
    fewer (8^2 x 512 at B*F = 7: 112)."""
    b, routing, n_k2, n_k4b = TCONV_PATHS[path]
    k2, k4b = _tconv_calls(monkeypatch, b, **routing)
    assert sum(k2.values()) == n_k2 and sum(k4b.values()) == n_k4b
    plans = {key: _check_tconv_plan(*key) for key in set(k2) | set(k4b)}
    short = {key for key, p in plans.items() if p.grid < trk.HOPPER_SMS}
    if path == "padded_b1":  # 8^2 x 512 (the first up block's tconv): 16-pixel tiles, 112 CTAs
        assert short == {(1, 7, 64, 512)} and plans[(1, 7, 64, 512)][:2] == (16, 1)
        assert plans[(1, 7, 64, 640)][:4] == (16, 1, 128, 4) and plans[(1, 7, 64, 640)].grid == 140
    else:
        assert not short
    if path == "padded_b8":  # frame pairs at the forward's 16^2 x 512 and 8^2 x 640
        assert plans[(8, 7, 256, 512)][:2] == (128, 2) and plans[(8, 7, 64, 640)][:2] == (64, 2)


@pytest.mark.parametrize("b,f,s,c", [(2, 3, 240, 192), (1, 1, 35, 64), (2, 1, 1000, 320),
                                     (3, 1, 1, 128), (8, 7, 16384, 128), (1, 7, 100, 192),
                                     (4, 2, 1000, 256)])
def test_temporal_conv_plan_at_ragged_shapes(b, f, s, c):
    """Off the release paths: S that no tile divides, one pixel, one frame,
    an even F, C = 192 and 320 (64-wide output slices), C = 64 (one
    slice)."""
    _check_tconv_plan(b, f, s, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,f,hw,c", [(8, 7, (16, 16), 512), (1, 7, (8, 8), 640),
                                      (2, 3, (12, 20), 192)])
def test_temporal_conv_wrappers_size_statistics_by_the_plan(monkeypatch, dtype, b, f, hw, c):
    """K2's and K4b's wrappers, driven to their launch with tensors on the
    meta device (the device checks, the library and the stream stubbed),
    call the one source's two entries and size the statistics' per-tile
    partial sums by the plan's tiles (the float32 body's: 64 pixels)."""
    launched = _driven_to_the_launch(monkeypatch)
    hp, wp = trk.padded_hw(*hw)
    s = hw[0] * hw[1]
    with torch.device("meta"):
        k, bias = torch.empty(3, c, c), torch.empty(c)
        trk.temporal_conv_fused(torch.empty(b, f, *hw, c, dtype=dtype), k, bias, want_stats=True)
        trk.temporal_conv_padded(torch.empty(b, f, hp, wp, c, dtype=dtype), k, bias, hw,
                                 want_stats=True)
    tiles = trk.temporal_conv_plan(b, f, s, c).tiles if dtype == torch.bfloat16 else -(-s // 64)
    seen = {fn: (name, tuple(ptrs[6 if fn == "v2a_temporal_conv3" else 11].shape))
            for fn, [(name, ptrs, _)] in launched.items()}
    assert seen == {fn: ("temporal_conv", (b * f * tiles * 2 * c,))
                    for fn in ("v2a_temporal_conv3", "v2a_temporal_conv_padded")}


def _k11_calls(monkeypatch, b):
    """{(B, F, S, C): calls} of K11 in one B-sample spatial_k10_k11 forward,
    traced on the meta device with every kernel's plain version."""
    calls = {}

    def record(x, kernel, bias, emb=None, residual=None, want_stats=False):
        key = trk._fold(x)
        calls[key] = calls.get(key, 0) + 1
        return trk.temporal_conv_fused_hw_plain(x, kernel, bias, emb, residual, want_stats)

    _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    monkeypatch.setattr(trk, "temporal_conv_fused_hw", record)
    with torch.device("meta"), torch.no_grad():
        tvu.VideoUNet(dtype=torch.bfloat16, fused=True, spatial2_min_ch=0, pallas_spatial=True,
                      tconv_hw=True)(torch.randn(b, 7, 128, 128, 6),
                                     torch.zeros(b, dtype=torch.long), torch.randn(b, 77, 512))
    return calls


@pytest.mark.parametrize("b", [8, 1])
def test_k11_plan_fits_every_release_call(monkeypatch, b):
    """K11 launches K2's kernel with K2's plan: at every K11 call of a
    spatial_k10_k11 forward (63, at B=8 and at a B=1 request), that plan's
    tiles cover every pixel of every (sample, frame) once, its shared memory
    fits, and its grid has a CTA per SM (at B=1 not 8^2 x 512, whose
    16-pixel tiles give 112 CTAs, the most any tile gives)."""
    calls = _k11_calls(monkeypatch, b)
    assert sum(calls.values()) == 63 and len(calls) == 13
    plans = {key: _check_tconv_plan(*key) for key in calls}
    short = {key for key, p in plans.items() if p.grid < trk.HOPPER_SMS}
    assert short == (set() if b == 8 else {(1, 7, 64, 512)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,f,hw,c", [(8, 7, (8, 8), 640), (8, 14, (8, 8), 640),
                                      (1, 7, (16, 16), 512)])
def test_k11_wrapper_passes_x_and_its_plan(monkeypatch, dtype, b, f, hw, c):
    """K11's wrapper, driven to its launch on meta tensors, hands K2's entry
    (`v2a_temporal_conv3` of `temporal_conv.cu`) x's own tensor, a view of
    the residual (no copy of either) and the y it returns, sizes the
    statistics' per-tile partial sums by `temporal_conv_plan`'s tiles (the
    float32 body's: 64 pixels), and counts the launch as K11's, not K2's."""
    launched = _driven_to_the_launch(monkeypatch)
    monkeypatch.setattr(trk, "launches", {k: 0 for k in trk.launches})
    s = hw[0] * hw[1]
    with torch.device("meta"):
        x, res = (torch.empty(b, f, *hw, c, dtype=dtype) for _ in range(2))
        y, _ = trk.temporal_conv_fused_hw(x, torch.empty(3, c, c), torch.empty(c),
                                          torch.empty(b, c), res, want_stats=True)
    [(name, ptrs, ints)] = launched["v2a_temporal_conv3"]
    assert name == "temporal_conv" and tuple(ints) == (b, f, s, c, trk._DTYPE_CODE[dtype])
    assert ptrs[0] is x and ptrs[4]._base is res and ptrs[5] is y and y.shape == x.shape
    tiles = (trk.temporal_conv_plan(b, f, s, c).tiles if dtype == torch.bfloat16
             else -(-s // 64))
    assert tuple(ptrs[6].shape) == (b * f * tiles * 2 * c,)
    assert trk.launches["temporal_conv_fused_hw"] == 1 and trk.launches["temporal_conv_fused"] == 0


def _check_k7_plan(b, s, c, itemsize=2, groups=32):
    """K7's plan, decoded as csrc/group_norm_silu.cu decodes its grid: CTA i
    of a sample takes chunks i, i + ctas, ... of `rows` rows, thread (v,
    lane) the rows lane, lane + lanes, ... of each, at most 64 bytes a
    thread; every row of the sample once, every CTA at least one chunk;
    threads C / 8 x lanes, at most 1,024; the shared memory (the ring of
    three chunks, or the statistics' [2][lanes][C] floats) within the
    opted-in 227 KiB; the scratch the counters, (mean, rstd) and every
    CTA's partials; the same plan on every call."""
    plan = tgn.group_norm_plan(b, s, c, groups, itemsize)
    assert plan == tgn.group_norm_plan.__wrapped__(b, s, c, groups, itemsize)
    per_lane = 64 // (8 * itemsize)
    assert plan.threads == c // 8 * plan.lanes <= 1024 and 1 <= plan.rows <= plan.lanes * per_lane
    covered = np.zeros(s, np.int32)
    for cta in range(plan.ctas):
        chunks = range(cta, -(-s // plan.rows), plan.ctas)
        assert len(chunks) >= 1
        for ch in chunks:
            n = min(plan.rows, s - ch * plan.rows)
            for lane in range(plan.lanes):
                for u in range(per_lane):
                    if lane + u * plan.lanes < n:
                        covered[ch * plan.rows + lane + u * plan.lanes] += 1
    assert (covered == 1).all()
    ring = 3 * plan.rows * c * itemsize
    assert plan.smem == 128 + max(ring, 2 * plan.lanes * c * 4) <= SMEM_227_KIB
    up4 = lambda n: -(-n // 4) * 4  # noqa: E731
    assert plan.scratch == up4(b) + up4(2 * groups * b) + 2 * groups * b * up4(plan.ctas)
    return plan


def _k7_calls(monkeypatch, b):
    """{(x's shape, SiLU): calls} of K7 in one B-sample plain_k7 forward,
    traced on the meta device with every kernel's plain version."""
    calls = {}

    def record(x, scale, bias, groups=32, eps=1e-5, with_silu=True):
        key = (tuple(x.shape), with_silu)
        calls[key] = calls.get(key, 0) + 1
        return tgn.fused_group_norm_silu_plain(x, scale, bias, groups, eps, with_silu)

    _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    monkeypatch.setattr(tgn, "fused_group_norm_silu", record)
    with torch.device("meta"), torch.no_grad():
        tvu.VideoUNet(dtype=torch.bfloat16, fused=False, use_pallas_gn=True)(
            torch.randn(b, 7, 128, 128, 6), torch.zeros(b, dtype=torch.long),
            torch.randn(b, 77, 512))
    return calls


@pytest.mark.parametrize("b", [8, 1])
def test_group_norm_plan_fits_every_release_call(monkeypatch, b):
    """`tgn.group_norm_plan` at all 24 K7 signatures of a plain_k7 forward
    (66 calls), at B=8 and at a B=1 request: every row once, the shared
    memory and threads as the kernel needs, and a CTA per SM everywhere (a
    request's 8^2 calls on chunks of three rows, 150 CTAs)."""
    calls = _k7_calls(monkeypatch, b)
    assert sum(calls.values()) == 66 and len(calls) == 24
    for (shape, _), n in calls.items():
        plan = _check_k7_plan(shape[0], int(np.prod(shape[1:-1])), shape[-1])
        assert shape[0] * plan.ctas >= trk.HOPPER_SMS, shape
        if shape[0] * int(np.prod(shape[1:-1])) >= 8 * 7 * 128 * 128:  # 128^2: four CTAs an SM
            assert shape[0] * plan.ctas == 4 * trk.HOPPER_SMS


@pytest.mark.parametrize("b,s,c,itemsize,groups", [
    (1, 448, 640, 2, 32), (56, 37, 512, 2, 32), (2, 3000, 128, 4, 32), (1, 100000, 64, 2, 32),
    (2, 21, 8192, 4, 32), (3, 1, 32, 2, 32), (1, 33, 8, 4, 8)])
def test_group_norm_plan_at_ragged_shapes(b, s, c, itemsize, groups):
    """Off the path: a last chunk of one row, S < 64, float32 (two rows a
    lane), 32 lanes, 1,024 threads, one row, one 8-channel vector."""
    _check_k7_plan(b, s, c, itemsize, groups)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,silu", [((8, 7, 128, 128, 128), True), ((56, 256, 512), False),
                                        ((1, 7, 8, 8, 1280), True)])
def test_k7_wrapper_passes_the_plan(monkeypatch, dtype, shape, silu):
    """K7's wrapper, driven to its launch on meta tensors, hands its C entry
    x, y and one float32 scratch of the plan's size (zeroed once, the same
    tensor on the next call) and `group_norm_plan`'s integers, and counts
    one K7 launch a call."""
    launched = _driven_to_the_launch(monkeypatch)
    monkeypatch.setattr(trk, "launches", {k: 0 for k in trk.launches})
    monkeypatch.setattr(tgn, "_scratch", {})
    b, c = shape[0], shape[-1]
    s = int(np.prod(shape[1:-1]))
    with torch.device("meta"):
        x = torch.empty(*shape, dtype=dtype)
        y = tgn.fused_group_norm_silu(x, torch.empty(c), torch.empty(c), 32, with_silu=silu)
        tgn.fused_group_norm_silu(x, torch.empty(c), torch.empty(c), 32, with_silu=silu)
    plan = tgn.group_norm_plan(b, s, c, 32, x.element_size())
    [(name, ptrs, ints), (_, ptrs2, ints2)] = launched["v2a_group_norm_silu"]
    assert name == "group_norm_silu" and ints == ints2 == (
        b, s, c, 32, plan.threads, plan.rows, plan.ctas, int(silu), trk._DTYPE_CODE[dtype])
    assert ptrs[0] is x and ptrs[4] is y and y.shape == x.shape and y.dtype == dtype
    assert ptrs[3] is ptrs2[3] and ptrs[3].dtype == torch.float32
    assert tuple(ptrs[3].shape) == (plan.scratch,)
    assert trk.launches["fused_group_norm_silu"] == 2


def _check_attention_plan(n, h, w, c, ch):
    """K9's plan: the GEMMs' token tiles cover each sample's tokens once and
    their column slices the 3C / C columns once; the attention's CTAs cover
    every (sample, head, query) once; every phase's shared memory fits."""
    plan = trk.attention_plan(n, h, w, c, ch)
    assert plan == trk.attention_plan(n, h, w, c, ch)
    s = h * w
    for g, ldw in ((plan.qkv, 3 * c), (plan.proj, c)):
        assert g.nc == (128 if ldw % 128 == 0 else 64) and g.warps == 8 and g.tokens <= 64
        assert g.tiles == -(-s // g.tokens) and g.smem <= SMEM_227_KIB
        covered = np.zeros(s, np.int32)
        for t in range(g.tiles):
            covered[t * g.tokens:(t + 1) * g.tokens] += 1
        cols = np.zeros(ldw, np.int32)
        for sl in range(-(-ldw // g.nc)):
            cols[sl * g.nc:(sl + 1) * g.nc] += 1
        assert (covered == 1).all() and (cols == 1).all()
        assert g.grid == n * g.tiles * -(-ldw // g.nc)
        # a CTA per SM at the largest token tile that gives one
        grids = {p: n * -(-s // p) * -(-ldw // g.nc) for p in (64, 32, 16)}
        if grids[16] >= trk.HOPPER_SMS:
            assert g.grid >= trk.HOPPER_SMS
    assert plan.slice == (32 if ch <= 32 else 64 if ch <= 64 else 128)
    assert plan.slices * plan.slice >= ch > (plan.slices - 1) * plan.slice
    assert plan.smem <= SMEM_227_KIB and plan.warps * 16 == plan.queries
    assert plan.smem == (plan.slices * plan.queries + 4 * plan.keys) * plan.slice * 2
    # the query tiles the plan may take: 16, and each larger one that needs
    # fewer tiles than the next smaller; the most with a CTA per SM
    tiles = {q: -(-s // q) for q in (128, 64, 32, 16)}
    grids = {q: t * (c // ch) * n for q, t in tiles.items() if q == 16 or t < tiles[q // 2]}
    if grids[16] >= trk.HOPPER_SMS:
        assert plan.grid >= trk.HOPPER_SMS
        assert plan.queries == max(q for q, g in grids.items() if g >= trk.HOPPER_SMS)
    seen = np.zeros((n, c // ch, s), np.int32)
    q_tiles = -(-s // plan.queries)
    assert plan.grid == q_tiles * (c // ch) * n
    for q in range(q_tiles):
        seen[:, :, q * plan.queries:(q + 1) * plan.queries] += 1
    assert (seen == 1).all()
    return plan


# K9's calls per release forward of padded_k8_k9 (head 32) and
# padded_k8_k9_wide (head 64, attention also at 32^2)
K9_PATHS = {"k8_k9_b8": (8, {}, 11), "k8_k9_b1": (1, {}, 11),
            "wide_b8": (8, dict(attention_resolutions=(4, 8, 16), num_head_channels=64), 16),
            "wide_b1": (1, dict(attention_resolutions=(4, 8, 16), num_head_channels=64), 16)}


@pytest.mark.parametrize("path", list(K9_PATHS))
def test_attention_plan_fits_every_release_call(monkeypatch, path):
    """`trk.attention_plan` at every K9 call of the two routings at B=8 and
    at a B=1 request: each phase's grid has a CTA per SM (the QKV and
    projection GEMMs take smaller token tiles at N = 7)."""
    b, arch, total = K9_PATHS[path]
    calls = _padded_calls(monkeypatch, "fused_spatial_attention_padded", b, downconv=True,
                          attn_kernel=True, **arch)
    assert sum(calls.values()) == total
    for key in calls:
        plan = _check_attention_plan(*key)
        assert min(plan.qkv.grid, plan.grid, plan.proj.grid) >= trk.HOPPER_SMS, (key, plan)
    if path == "k8_k9_b1":  # 8^2 x 640, 20 heads of 32: 140 attention CTAs
        plan = trk.attention_plan(7, 8, 8, 640, 32)
        assert (plan.queries, plan.grid, plan.proj.tokens) == (64, 140, 16)
    if path == "wide_b8":  # 1,024 tokens: 128-query tiles
        assert trk.attention_plan(56, 32, 32, 384, 64).queries == 128
    if path == "wide_b1":  # 10 heads of 64 at 8^2: 32-query tiles, 140 CTAs
        plan = trk.attention_plan(7, 8, 8, 640, 64)
        assert (plan.queries, plan.grid) == (32, 140)


@pytest.mark.parametrize("n,h,w,c,ch", [
    (2, 16, 16, 640, 8), (2, 16, 16, 640, 40), (2, 16, 16, 640, 80), (2, 8, 8, 640, 160),
    (2, 6, 10, 128, 32), (1, 32, 32, 128, 64), (2, 8, 8, 48, 16), (2, 6, 10, 96, 32),
    (1, 12, 12, 256, 128), (1, 1, 1, 64, 64), (3, 5, 7, 640, 320), (1, 4, 4, 1280, 1280)])
def test_attention_plan_at_ragged_shapes(n, h, w, c, ch):
    """Off the release paths: head widths 8, 40, 80, 160, 320 and 1,280
    (zero lanes; 128-wide slices past 128), 60 and 1,024 tokens, C = 48 and
    96 (3C and C no multiple of 64: 64-wide column slices past the end),
    one token."""
    _check_attention_plan(n, h, w, c, ch)


def _k10_signatures(monkeypatch):
    """K10's 17 (N, H, W, C, D) of a B=8 spatial_k10_k11 forward, traced on
    the meta device with every kernel's plain version."""
    sigs = set()

    def record(x, kernel, bias):
        sigs.add(tuple(x.shape) + (kernel.shape[-1],))
        return trk.spatial_conv3x3_plain(x, kernel, bias)

    _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    monkeypatch.setattr(trk, "spatial_conv3x3", record)
    with torch.device("meta"), torch.no_grad():
        tvu.VideoUNet(dtype=torch.bfloat16, fused=True, spatial2_min_ch=0, pallas_spatial=True,
                      tconv_hw=True)(torch.randn(8, 7, 128, 128, 6),
                                     torch.zeros(8, dtype=torch.long), torch.randn(8, 77, 512))
    return sorted(sigs)


# the perf lab's level shapes (`scripts/perf_lab.py` WINO_SHAPES), K10's 17
# signatures of a B=8 spatial_k10_k11 forward (`test_k10_signatures`), and
# shapes off both: the card tests', one that streams its window, one patch
LAB_K14 = [(56, 128, 128, 128, 128), (56, 64, 64, 256, 256), (56, 32, 32, 384, 384)]
K10_K14 = [
    (56, 8, 8, 512, 640), (56, 8, 8, 640, 640), (56, 16, 16, 384, 512), (56, 16, 16, 512, 512),
    (56, 16, 16, 640, 512), (56, 16, 16, 640, 640), (56, 32, 32, 256, 384),
    (56, 32, 32, 384, 384), (56, 32, 32, 512, 384), (56, 32, 32, 512, 512),
    (56, 64, 64, 128, 256), (56, 64, 64, 256, 256), (56, 64, 64, 384, 256),
    (56, 64, 64, 384, 384), (56, 128, 128, 128, 128), (56, 128, 128, 256, 128),
    (56, 128, 128, 256, 256)]
RAGGED_K14 = [(3, 6, 10, 32, 64), (1, 32, 32, 384, 384), (2, 8, 8, 1280, 128), (1, 2, 2, 32, 64),
              (2, 8, 16, 128, 128)]


def test_k10_signatures(monkeypatch):
    """The K10 signatures `K10_K14` lists are the release forward's."""
    assert _k10_signatures(monkeypatch) == sorted(K10_K14)


@pytest.mark.parametrize("n,h,w,c,d", LAB_K14 + K10_K14 + RAGGED_K14)
def test_winograd_plan_fits(n, h, w, c, d):
    """`trk.winograd_plan`: its patch tiles cover the (H/2, W/2) patch grid
    once, its shared memory fits a CTA, the window of all of C is resident
    exactly where that fits (else streamed, 3 slices), and the grid has a
    CTA per SM wherever a fitting tile gives one."""
    plan = trk.winograd_plan(n, h, w, c, d)
    assert plan == trk.winograd_plan(n, h, w, c, d)
    nc = 128 if d % 128 == 0 else 64
    ph, pw = h // 2, w // 2
    th, tw, per_image = trk._hop_tile(ph, pw, plan.patches)
    assert (plan.tile_h, plan.tile_w) == (th, tw) and th * tw <= plan.patches
    assert plan.tiles == n * per_image and _covered_once(ph, pw, th, tw, per_image)
    assert plan.nc == nc and plan.grid == plan.tiles * (d // nc)
    assert plan.smem <= SMEM_227_KIB
    slices = -(-c // 64)
    window = (slices if plan.resident else 3) * (2 * th + 2) * (2 * tw + 2) * 128
    assert plan.smem >= window
    if not plan.resident:  # all of C fits at no tile the plan takes
        for p in (64, 32, 16):
            a, b, tiles = trk._hop_tile(ph, pw, p)
            if p == 16 or tiles < trk._hop_tile(ph, pw, p // 2)[2]:
                rest = SMEM_227_KIB - 3 * 2 * 32 * nc * 2 - 4 * p * 64
                assert slices * (2 * a + 2) * (2 * b + 2) * 128 > rest
    grids = [n * trk._hop_tile(ph, pw, p)[2] * (d // nc) for p in (64, 32, 16)]
    if max(grids) >= trk.HOPPER_SMS and plan.resident:
        assert plan.grid >= trk.HOPPER_SMS
    if (n, h, w, c, d) in LAB_K14 + K10_K14:
        assert plan.grid >= trk.HOPPER_SMS and plan.resident
    if (n, h, w, c, d) == (2, 8, 8, 1280, 128):
        assert not plan.resident


def test_probe_cuts_match_the_sources():
    """Every cut of `scripts/conv_tconv_probe.py --ablate` finds its text in
    `csrc/` (the probe refuses a cut that no longer matches, on the card)."""
    import glob
    import os

    from v2a_tpu_torch.ops import _build
    from v2a_tpu_torch.scripts import conv_tconv_probe as probe

    text = "".join(open(p).read() for p in glob.glob(os.path.join(_build.CSRC, "*.cu*")))
    for name, (_, cuts) in probe.CUTS.items():
        for old, _ in cuts:
            assert old in text, (name, old)
