"""Peaks, per-launch costs of the port's hand kernels, and the model's own
FLOP count.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
card's full 700 W power limit.

The per-launch costs are copies of the cost arithmetic that `chip_smoke.py`
keeps beside its kernel gates (`_conv_cost`, `_tconv_cost`, `_k3_cost` and
the formulas inside `check_k1`, `check_k2` and `check_k5`), keyed by the
same launch signatures (`KERNEL_CHECKS`), for the kernels that the cells
launch: K1 to K5 (a cell that launches another brings its cost). Operations
count only the taps that land inside the frame; bytes count each input read
once and each output written once, whatever a kernel reads again.

`unet_forward_flops` counts the convolutions and attention of one video
U-Net forward from the configuration's widths alone, with the same
conventions, so that a kernel swap or a routing change reads the same work.
The time-embedding MLPs, the emb projections and the Perceiver are left
out: together they are under 0.1% of a forward at the benchmark's sizes.
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_BF16_FLOPS = 989e12  # tensor cores, bf16 / fp16 dense
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # HBM3 bytes/s


def padded_hw(h: int, w: int) -> Tuple[int, int]:
    """(Hp, Wp) of the padded-stream layout: one halo row each side, the
    width rounded up to a multiple of 8."""
    return h + 2, ((w + 2 + 7) // 8) * 8


# -- launch signatures: wrapper name -> (tag, key from the bound arguments) ----

def _k3_signature(a):
    return (tuple(a["parts"][0][0].shape[:2]), tuple(a["hw"]),
            tuple(p[0].shape[-1] for p in a["parts"]), a["parts"][0][1].shape[-1],
            a["emb"] is not None, a["residual"] is not None,
            tuple(s[0].shape[-1] for s in a["skip_parts"] or ()), bool(a["silu"]),
            bool(a["want_stats"]))


SIGNATURES = {
    "fused_affine_conv3x3": ("k1", lambda a: (
        tuple(a["x"].shape), a["kernel"].shape[-1], a["a"] is not None, bool(a["silu"]))),
    "temporal_conv_fused": ("k2", lambda a: (
        tuple(a["x"].shape), a["emb"] is not None, a["residual"] is not None,
        bool(a["want_stats"]))),
    "fused_affine_conv3x3_padded": ("k4a", lambda a: (
        a["parts"][0][0].shape[0], tuple(a["hw"]), tuple(p[0].shape[-1] for p in a["parts"]),
        a["parts"][0][1].shape[-1], bool(a["silu"]))),
    "temporal_conv_padded": ("k4b", lambda a: (
        tuple(a["x"].shape[:2]), tuple(a["hw"]), a["x"].shape[-1], a["emb"] is not None,
        a["residual"] is not None, tuple(s[0].shape[-1] for s in a["skip_parts"] or ()),
        bool(a["want_stats"]))),
    "fused_conv_tconv_padded": ("k3", _k3_signature),
    "fused_upconv3x3_padded": ("k5", lambda a: (
        a["x"].shape[0], tuple(a["hw_lo"]), a["x"].shape[-1], a["kernel"].shape[-1],
        a["a"] is not None, bool(a["silu"]))),
}


# -- per-launch costs: (tensor-core FLOP, float32 FLOP, bytes) -----------------

def _conv_cost(n, h, w, wp, cins, d):
    """K4a: in-frame taps only; interior in, interior and pad cols out."""
    flops = sum(2.0 * n * (3 * h - 2) * (3 * w - 2) * c * d for c in cins)
    nbytes = sum(2 * n * h * w * c + 18 * c * d + 8 * n * c for c in cins) + 2 * n * h * wp * d
    return flops, nbytes + 4 * d


def _tconv_cost(b, f, h, w, wp, c, emb, res, skip_cins, stats):
    """K4b, as `_conv_cost`."""
    s = h * w
    flops = 2.0 * b * s * c * c * (3 * f - 2) + sum(2.0 * b * f * s * cs * c for cs in skip_cins)
    nbytes = (2 * b * f * s * c * (1 + res) + 2 * b * f * h * wp * c + 6 * c * c + 4 * c
              + sum(2 * b * f * s * cs + 2 * cs * c for cs in skip_cins)
              + (4 * c if skip_cins else 0) + (4 * b * c if emb else 0)
              + (8 * b * f * c if stats else 0))
    return flops, nbytes


def _k1(key):
    (n, h, w, c), d, affine, _ = key
    flops = 2.0 * n * (3 * h - 2) * (3 * w - 2) * c * d
    nbytes = 2 * (n * h * w * (c + d) + 9 * c * d) + 4 * d + (8 * n * c if affine else 0)
    return flops, 0.0, nbytes


def _k2(key):
    shape, has_emb, has_res, stats = key
    b, f, c = shape[0], shape[1], shape[-1]
    s = 1
    for dim in shape[2:-1]:
        s *= dim
    flops = 2.0 * b * s * c * c * (3 * f - 2)
    nbytes = (2 * b * f * s * c * (2 + has_res) + 2 * 3 * c * c + 4 * c
              + (4 * b * c if has_emb else 0) + (8 * b * f * c if stats else 0))
    return flops, 0.0, nbytes


def _k4a(key):
    n, (h, w), cins, d, _ = key
    flops, nbytes = _conv_cost(n, h, w, padded_hw(h, w)[1], cins, d)
    return flops, 0.0, nbytes


def _k4b(key):
    (b, f), (h, w), c, emb, res, skip_cins, stats = key
    flops, nbytes = _tconv_cost(b, f, h, w, padded_hw(h, w)[1], c, emb, res, skip_cins, stats)
    return flops, 0.0, nbytes


def _k3(key):
    (b, f), (h, w), cins, d, emb, res, skip_cins, _, stats = key
    wp = padded_hw(h, w)[1]
    f1, b1 = _conv_cost(b * f, h, w, wp, cins, d)
    f2, b2 = _tconv_cost(b, f, h, w, wp, d, emb, res, skip_cins, stats)
    # the conv output stays on chip: neither its write nor its read counts
    return f1 + f2, 0.0, b1 + b2 - 2 * b * f * h * wp * d - 2 * b * f * h * w * d


def _k5(key):
    n, (h, w), c, d, affine, _ = key
    # the collapsed taps of the four parities that land inside the low-res frame
    flops = 2.0 * n * (4 * h - 2) * (4 * w - 2) * c * d
    nbytes = (2 * n * h * w * c + 32 * c * d + 4 * d + (8 * n * c if affine else 0)
              + 2 * n * 2 * h * padded_hw(2 * h, 2 * w)[1] * d)
    return flops, 0.0, nbytes


COSTS = {"k1": _k1, "k2": _k2, "k3": _k3, "k4a": _k4a, "k4b": _k4b, "k5": _k5}


def launch_cost(tag: str, key: tuple) -> Tuple[float, float, float]:
    """(tensor-core FLOP, float32 FLOP, bytes) of one launch."""
    return COSTS[tag](key)


def launch_bound_s(tag: str, key: tuple) -> float:
    """The least time the card could take for one launch: the larger of
    its operations over the peak rates and its bytes over HBM's."""
    tensor, f32, nbytes = launch_cost(tag, key)
    return max(tensor / PEAK_BF16_FLOPS + f32 / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


# -- the model's own count ------------------------------------------------------

def unet_forward_flops(model: dict, batch: int) -> List[Tuple[str, float]]:
    """(component, FLOP) of one U-Net forward on `batch` videos, from the
    configuration's `model` section: every spatial conv, temporal conv, 1x1
    skip projection and attention block of the plain structure, in the
    conventions of the per-launch costs (in-frame taps only; an upsample
    conv counts the collapsed taps that nearest-2x input needs)."""
    h, w = model["image_size"]
    f = model["sample_per_seq"] - 1
    mc, mult, nrb = model["model_channels"], model["channel_mult"], model["num_res_blocks"]
    attn_res = model["attention_resolutions"]  # the head width moves no FLOP
    cond = model.get("cond_channels") or model["channels"]
    n = batch * f
    out: List[Tuple[str, float]] = []

    def conv3(tag, hh, ww, c, d):
        out.append((tag + ".spatial", 2.0 * n * (3 * hh - 2) * (3 * ww - 2) * c * d))

    def tconv(tag, hh, ww, c):
        out.append((tag + ".temporal", 2.0 * batch * hh * ww * c * c * (3 * f - 2)))

    def res(tag, hh, ww, cin, cout):
        conv3(tag + ".in", hh, ww, cin, cout)
        tconv(tag + ".in", hh, ww, cout)
        conv3(tag + ".out", hh, ww, cout, cout)
        tconv(tag + ".out", hh, ww, cout)
        if cin != cout:
            out.append((tag + ".skip", 2.0 * n * hh * ww * cin * cout))

    def attn(tag, hh, ww, c):
        s = hh * ww
        out.append((tag, 2.0 * n * s * c * 4 * c + 4.0 * n * s * s * c))

    conv3("entry", h, w, model["channels"] + cond, mc)
    tconv("entry", h, w, mc)
    skips, cur, ds, hh, ww = [mc], mc, 1, h, w
    for level, m in enumerate(mult):
        c = m * mc
        for i in range(nrb):
            res(f"down{level}.res{i}", hh, ww, cur, c)
            cur = c
            if ds in attn_res:
                attn(f"down{level}.attn{i}", hh, ww, c)
            skips.append(c)
        if level != len(mult) - 1:
            h2, w2 = hh // 2, ww // 2
            out.append((f"down{level}.downsample.spatial",
                        2.0 * n * (3 * h2 - 1) * (3 * w2 - 1) * c * c))
            tconv(f"down{level}.downsample", h2, w2, c)
            hh, ww = h2, w2
            skips.append(c)
            ds *= 2
    res("mid.res0", hh, ww, cur, cur)
    attn("mid.attn", hh, ww, cur)
    res("mid.res1", hh, ww, cur, cur)
    for level, m in reversed(list(enumerate(mult))):
        c = m * mc
        for i in range(nrb + 1):
            res(f"up{level}.res{i}", hh, ww, cur + skips.pop(), c)
            cur = c
            if ds in attn_res:
                attn(f"up{level}.attn{i}", hh, ww, c)
            if level and i == nrb:
                out.append((f"up{level}.upsample.spatial",
                            2.0 * n * (4 * hh - 2) * (4 * ww - 2) * c * c))
                hh, ww = 2 * hh, 2 * ww
                tconv(f"up{level}.upsample", hh, ww, c)
                ds //= 2
    conv3("out", hh, ww, cur, model["channels"])
    tconv("out", hh, ww, model["channels"])
    return out


def unet_forward_total(model: dict, batch: int) -> float:
    return sum(v for _, v in unet_forward_flops(model, batch))
