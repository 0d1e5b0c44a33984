"""Where the hand-written Hopper kernels spend their time, on the card.

    python -m v2a_tpu_torch.scripts.conv_tconv_probe [--ablate] \
        [--kernels k3,k12,k13,k6,k1,k14,k4a,k9,k2,k4b,k10,k8,k5,k11,k7,k15]

Times K3 (`fused_conv_tconv_padded`) and K12 (`fused_conv_tconv_stream`) in
bf16 at release-level shapes (F=7, emb and residual) against the same work
as K4a -> K4b, K13 (`fused_conv_tconv_dma`, K3's mainloop with TMA copies)
beside K3 at K3's shapes, and K6 (`wgrad_conv3x3`) at release train-step
shapes against the library's `conv2d_weight` on the materialised
activation, K1 (`fused_affine_conv3x3`) at the release serving (B=8 and
B=1) and train-step (forward and dgrad) shapes against `F.conv2d` on the
materialised activation, K14 (`winograd_conv3x3`) at the perf lab's
three level shapes against K10 and `F.conv2d`, K4a
(`fused_affine_conv3x3_padded`) at the padded forward's two largest
shapes against `F.conv2d` on the activated interiors, and K9
(`fused_spatial_attention_padded`) at 16^2 x 512 head 32 and 32^2 x 384
head 64 against the QKV and projection matmuls around
`scaled_dot_product_attention`, K2 (`temporal_conv_fused`) and K4b
(`temporal_conv_padded`) at the padded forward's most called and costliest
signatures (K4b also at padded_mega_off's costliest) against one matmul of
the frame-stacked (B*F*S, 3C) operand (K4b: and one of its skip parts),
with the host's ms per call beside the card's, K10 (`spatial_conv3x3`) at
its costliest and most called signatures of a spatial_k10_k11 forward and
K8 (`fused_downconv3x3_padded`) at its two of padded_k8_k9, against
`F.conv2d` (K8: at stride 2 on the interior), K5 (`fused_upconv3x3_padded`)
at its three calls of the padded forward against `F.conv2d` on the
upsampled interior, and K11 (`temporal_conv_fused_hw`, K2's launch) at
three signatures of a spatial_k10_k11 forward beside K2 at the same
signature, the host's ms per call of each wrapper, and one matmul of the
frame-stacked operand, K7 (`fused_group_norm_silu`) at the plain_k7
forward's costliest signature, its most called small one and an attention
norm beside `y.copy_(x)` (the same bytes read and written) and the host's
ms per call, and K15 (the perf lab's `temporal_conv_taps`) at the lab's
three shapes beside K2 with a zero bias and one matmul of the
frame-stacked operand; ms by CUDA events over chained calls,
with each launch's plan. `--ablate` also times copies of
the kernels with one part cut out: for K3 / K12 (`csrc/conv_tconv_hopper.cuh`) the activation,
the conv products, the temporal epilogue or the whole temporal phase; for
K6 (`csrc/wgrad_conv3x3.cu`) the activation, the products or the refill of
the copy ring; for K1, K4a, K10, K8 and K5 (`csrc/affine_conv3x3.cu`, one
body) the activation, the products, the refill of the weight ring, of the
window ring or of both rings, or (not a cut) mode 0's window by cp.async
in place of its TMA box;
for K14 (`csrc/winograd_conv3x3.cu`) the component transform, the
products, the refill of the weight ring or all parity adds but one a
component; for K9 (`csrc/spatial_attention_padded.cu`) the attention (the
GEMMs alone) or the two GEMMs; for K2, K4b and K11
(`csrc/temporal_conv.cu`, one body) the products, the refill of the A
tiles or of the weight slabs, and (K2, K4b) the ring at 2 or 4 stages in
place of 3; for K7 (`csrc/group_norm_silu.cu`) the statistics pass alone
and the apply pass alone (also without the SiLU). The cut copies compute
wrong outputs by design; only their times mean anything. Cutting the
epilogue leaves the temporal products unused, so the compiler drops them
too: that cut times the epilogue and the products together. They are
built from copies of `csrc/` under `_build/variants/`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import Dict, List, Tuple

import torch

from v2a_tpu_torch.ops import _build
from v2a_tpu_torch.ops import resblock_kernels as rk
from v2a_tpu_torch.scripts import perf_lab

# (kernel, B, (H, W), input channel parts, D)
CASES = [("k3", 8, (128, 128), (128,), 128), ("k3", 8, (32, 32), (384, 384), 384),
         ("k12", 8, (64, 64), (256,), 256), ("k12", 1, (32, 32), (384,), 384),
         ("k13", 8, (128, 128), (128,), 128), ("k13", 8, (64, 64), (256,), 256)]
# K6 at the B=4 release train step (N = B x F = 28): (N, H, W, C, D, calls per step)
K6_CASES = [(28, 128, 128, 128, 128, 7), (28, 64, 64, 256, 256, 6), (28, 32, 32, 384, 384, 6),
            (28, 16, 16, 512, 512, 6), (28, 8, 8, 640, 640, 10)]
# K1: (N, H, W, C, D, silu affine or plain conv, role, calls): the B=8 and B=1
# serving shapes' largest, the B=4 train step's forwards and dgrads
K1_CASES = [(56, 16, 16, 512, 512, True, "serve", 10), (56, 8, 8, 640, 640, True, "serve", 15),
            (7, 16, 16, 512, 512, True, "request", 10), (7, 8, 8, 640, 640, True, "request", 15),
            (28, 128, 128, 128, 128, True, "forward", 7), (28, 64, 64, 256, 256, True, "forward", 6),
            (28, 32, 32, 384, 384, True, "forward", 6), (28, 8, 8, 640, 640, True, "forward", 10),
            (28, 128, 128, 128, 128, False, "dgrad", 7), (28, 64, 64, 256, 256, False, "dgrad", 6),
            (28, 8, 8, 640, 640, False, "dgrad", 10)]
# K14 at the perf lab's level shapes and K10's most called 16^2 and 8^2 ones (N, H, W, C, D)
K14_CASES = [(56, 128, 128, 128, 128), (56, 64, 64, 256, 256), (56, 32, 32, 384, 384),
             (56, 16, 16, 512, 512), (56, 8, 8, 640, 640)]
# K10 at a B=8 spatial_k10_k11 forward's costliest signature and its two
# most called: (N, H, W, C, D, calls per forward)
K10_CASES = [(56, 128, 128, 256, 256, 1), (56, 128, 128, 128, 128, 12), (56, 8, 8, 640, 640, 15)]
# K8 at its two calls of a B=8 padded_k8_k9 forward, bare as the Downsample
# calls it: (N, (H, W) of its full-size input, C, D, calls per forward)
K8_CASES = [(56, (128, 128), 128, 128, 1), (56, (64, 64), 256, 256, 1)]
# K5 at its three calls of a B=8 padded forward, bare as the Upsample calls
# it: (N, (H, W) of its low-res input, C, D, calls per forward)
K5_CASES = [(56, (16, 16), 512, 512, 1), (56, (32, 32), 384, 384, 1),
            (56, (64, 64), 256, 256, 1)]
# K11 at a B=8 spatial_k10_k11 forward's costliest 128^2 and 64^2 signatures
# and its most called 8^2 one, each beside K2: (B, S, C, emb, residual,
# calls per forward); all with statistics, F = 7
K11_CASES = [(8, 16384, 128, False, True, 5), (8, 4096, 256, False, True, 5),
             (8, 64, 640, True, False, 7)]
# K7 at a B=8 plain_k7 forward's costliest signature, its most called small
# one and an attention norm: (x's shape, SiLU, calls per forward)
K7_CASES = [((8, 7, 128, 128, 128), True, 8), ((8, 7, 8, 8, 640), True, 10),
            ((56, 256, 512), False, 5)]
# K15 at the perf lab's three shapes (B, F, S, C)
K15_CASES = [(8, 7, 128 * 128, 128), (8, 7, 64 * 64, 256), (8, 7, 64, 640)]
# K4a at the B=8 padded forward's largest call (two parts) and its most
# called shape: (N, (H, W), parts' C, D, calls per forward)
K4A_CASES = [(56, (64, 64), (384, 256), 256, 1), (56, (32, 32), (384,), 384, 6)]
# K9 at padded_k8_k9's 16^2 level and padded_k8_k9_wide's 32^2 one:
# (N, (H, W), C, head width, calls per forward)
K9_CASES = [(56, (16, 16), 512, 32, 5), (56, (32, 32), 384, 64, 5)]
# K2 and K4b at the B=8 padded forward's most called signature and its
# costliest (calls x ms, `chip_smoke_shapes.json`), and K4b at
# padded_mega_off's costliest: (kernel, B, (H, W), C, emb, residual, skip
# parts' C, calls per forward); all with statistics
TCONV_CASES = [("k2", 8, (8, 8), 640, True, False, (), 7),
               ("k2", 8, (8, 8), 640, False, True, (), 7),
               ("k4b", 8, (32, 32), 384, True, False, (), 5),
               ("k4b", 8, (128, 128), 256, False, False, (), 1),
               ("k4b", 8, (128, 128), 128, True, False, (), 5)]

# K1's and K14's weight slabs come by TMA, each stage completing on an
# mbarrier: a cut of their refill also waits on the first stages alone (a
# wait on a stage never refilled would trap)
_K1_FIRST_WAITS = (
    "    hop::mbar_wait(bar_s + 8 * (j % K1_STAGES), (bph >> (j % K1_STAGES)) & 1);",
    "    if (j < K1_STAGES - 1)\n"
    "      hop::mbar_wait(bar_s + 8 * (j % K1_STAGES), (bph >> (j % K1_STAGES)) & 1);")
_K1_WEIGHT_REFILL = ("    if (j + K1_STAGES - 1 < nsteps) issue_b(j + K1_STAGES - 1);\n", "")
# the window ring's refill: the first two chunks' windows stay, the rest are
# never copied (mode 0's TMA windows: waited on for those two alone)
_K1_WINDOW_REFILL = [
    ("    if (di == 0 && g + 2 < nch) issue_window(g + 2, (g + 2) % K1_WSTAGES);\n", ""),
    ("    if (tma_win && di == 0) {", "    if (tma_win && di == 0 && g < 2) {")]

# K2 / K4b's weight slabs come by TMA too: the same for their refill
_TC_FIRST_WAITS = (
    "    hop::mbar_wait(bar_s + 8 * st, (bph >> st) & 1);",
    "    if (j < TC_STAGES - 1) hop::mbar_wait(bar_s + 8 * st, (bph >> st) & 1);")

# variant -> (the kernels it cuts, [(text in a csrc/ file, its replacement)])
CUTS: Dict[str, Tuple[Tuple[str, ...], List[Tuple[str, str]]]] = {
    "no_activation": (("k3", "k12"), [("      if (g + 1 < nchunk) activate(",
                                       "      if (false) activate(")]),
    "no_conv_products": (("k3", "k12"), [("      mma_taps(g % WSTAGES, j % STAGES, di);", "")]),
    "no_epilogue": (("k3", "k12"), [("        store_out(g0 + j / mid);", "")]),
    "no_temporal_phase": (("k3", "k12"), [("    m.tconv_frames(f - 1, 1, 3);", ""),
                                          ("  m.tconv_frames(0, a.F, 0);", "")]),
    "k6_no_activation": (("k6",), [("      if (kk == act_kk && j + 1 < ntile)\n"
                                    "        activate((j + 1) % WSTAGES, ac);\n", "")]),
    "k6_no_products": (("k6",), [(
        "          hop::mma16816(acc[dj][2 * np], af[dj], q[0], q[1]);\n"
        "          hop::mma16816(acc[dj][2 * np + 1], af[dj], q[2], q[3]);\n", "")]),
    "k6_no_refill": (("k6",), [("      issue((j + WSTAGES - 1) % WSTAGES, ic);\n", "")]),
    "k1_no_activation": (("k1", "k4a"), [("    if (mode && g + 1 < nch) activate(",
                                          "    if (false) activate(")]),
    "k1_no_products": (("k1", "k4a", "k10", "k8", "k5"), [(
        "        hop::mma_slab<MT, NT>(acc, bb + dj * SLAB, kk, af, wn * (NC / WN), lane);\n", "")]),
    "k1_no_weight_refill": (("k1", "k4a", "k10", "k8", "k5"),
                            [_K1_FIRST_WAITS, _K1_WEIGHT_REFILL]),
    "k1_no_window_refill": (("k1", "k10", "k8", "k5"), _K1_WINDOW_REFILL),
    "k1_no_refill": (("k1", "k10", "k8", "k5"),
                     [_K1_FIRST_WAITS, _K1_WEIGHT_REFILL] + _K1_WINDOW_REFILL),
    # mode 0's window by cp.async, as the other modes copy theirs, in place of its TMA box
    "k1_window_cp_async": (("k1", "k10", "k5"), [("  const bool tma_win = S == 1 && mode == 0;",
                                                  "  const bool tma_win = false;")]),
    "k14_no_transform": (("k14",), [("      if (foff[i] >= 0) {", "      if (false) {")]),
    "k14_no_products": (("k14",), [(
        "        hop::mma_slab<1, NT>(mab, bb + u * SLAB, kk, af, wn * (NC / WN), lane);\n", "")]),
    "k14_no_weight_refill": (("k14",), [
        ("    hop::mbar_wait(bar_s + 8 * (s % BSTAGES), (bph >> (s % BSTAGES)) & 1);",
         "    if (s < BSTAGES - 1)\n"
         "      hop::mbar_wait(bar_s + 8 * (s % BSTAGES), (bph >> (s % BSTAGES)) & 1);"),
        ("    if (s + BSTAGES - 1 < nsteps) issue_b(s + BSTAGES - 1);\n", "")]),
    "k14_one_parity": (("k14",), [(
        "        add_parity<at_sign(0, ca) * at_sign(0, cb)>(yp[0], mab[0]);\n"
        "        add_parity<at_sign(0, ca) * at_sign(1, cb)>(yp[1], mab[0]);\n"
        "        add_parity<at_sign(1, ca) * at_sign(0, cb)>(yp[2], mab[0]);\n"
        "        add_parity<at_sign(1, ca) * at_sign(1, cb)>(yp[3], mab[0]);\n",
        "        add_parity<1>(yp[0], mab[0]);\n")]),
    "k9_no_attention": (("k9",), [("  e = attention(qkv, att, N, S, C, ch, s2, Qa, s);\n", "")]),
    "k9_no_gemms": (("k9",), [("  e = gemm<false>(Pq, qkv_in, s);\n", ""),
                              ("  e = gemm<true>(Pp, proj_in, s);\n", "")]),
    "tconv_no_products": (("k2", "k4b", "k11"), [
        ("hop::mma_slab<MT, NT>(acc[e], bb + t * SLAB, kk, af, wn * (NC / WN), lane);", ""),
        ("hop::mma_slab<MT, NT>(acc[e], bb + u * SLAB, kk, af, wn * (NC / WN), lane);", "")]),
    "tconv_no_a_refill": (("k2", "k4b", "k11"), [("      issue_a(j + TC_STAGES - 1);\n", "")]),
    "tconv_no_weight_refill": (("k2", "k4b", "k11"),
                               [_TC_FIRST_WAITS, ("      issue_b(j + TC_STAGES - 1);\n", "")]),
    # K7's two passes apart: the apply launch cut, or the statistics launch
    # (the apply pass then reads the statistics an earlier call left)
    "k7_stats_only": (("k7",), [("  apply<<<grid, threads, smem, stream>>>(",
                                 "  if (false) apply<<<grid, threads, smem, stream>>>(")]),
    "k7_apply_only": (("k7",), [("  gn_stats_kernel<T><<<grid, threads, smem, stream>>>(",
                                 "  if (false) gn_stats_kernel<T><<<grid, threads, smem, "
                                 "stream>>>(")]),
    # the ring's depth: 2 or 4 stages in place of 3 (the plan's shared memory follows)
    "tconv_stages_2": (("k2", "k4b"), [("constexpr int TC_STAGES = 3;",
                                         "constexpr int TC_STAGES = 2;")]),
    "tconv_stages_4": (("k2", "k4b"), [("constexpr int TC_STAGES = 3;",
                                         "constexpr int TC_STAGES = 4;")]),
}


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean ms per call by CUDA events (the perf lab's `time_calls`)."""
    return perf_lab.time_calls(fn, torch.device("cuda"), reps, warm)


def host_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean ms per call on the host's clock, without waiting for the card:
    where it comes near `time_ms`, the host's launches bound the call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _case_args(b, hw, cins, d, dev, f=7):
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def stream(c):
        return rk._place(randn(b, f, *hw, c), *rk.padded_hw(*hw)).bfloat16()

    parts = [(stream(c), randn(3, 3, c, d, scale=(9 * sum(cins)) ** -0.5),
              1 + randn(b * f, c, scale=0.1), randn(b * f, c, scale=0.1)) for c in cins]
    return (parts, randn(d, scale=0.1), randn(3, d, d, scale=(3 * d) ** -0.5),
            randn(d, scale=0.1), hw, randn(b, d).bfloat16(), stream(d))


def _runs(kernel, args):
    """(the kernel's call, the same work as K4a -> K4b; K13: as K3)"""
    parts, kbias, tk, tbias, hw, emb, res = args
    b, f, hp, wp = parts[0][0].shape[:4]
    d = tk.shape[-1]
    flat = [(x.reshape(b * f, hp, wp, -1), k, a, bb) for x, k, a, bb in parts]
    fn = {"k3": rk.fused_conv_tconv_padded, "k12": rk.fused_conv_tconv_stream,
          "k13": rk.fused_conv_tconv_dma}[kernel]
    fused = lambda: fn(parts, kbias, tk, tbias, hw, emb, res, want_stats=True)
    if kernel == "k13":
        return fused, lambda: rk.fused_conv_tconv_padded(parts, kbias, tk, tbias, hw, emb, res,
                                                         want_stats=True)
    split = lambda: rk.temporal_conv_padded(
        rk.fused_affine_conv3x3_padded(flat, kbias, hw).reshape(b, f, hp, wp, d), tk, tbias,
        hw, emb, res, want_stats=True)
    return fused, split


def _k6_args(n, h, w, c, d, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n, h, w, c, generator=gen, device=dev).bfloat16()
    g = torch.randn(n, h, w, d, generator=gen, device=dev).bfloat16()
    a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=dev)
    b = 0.1 * torch.randn(n, c, generator=gen, device=dev)
    return x, g, a, b


def _k6_runs(args):
    """(K6's call, the library's conv2d_weight on the materialised activation)"""
    x, g, a, b = args
    n, h, w, c = x.shape
    d = g.shape[-1]
    sl = rk._act(x, a, b, True).permute(0, 3, 1, 2)
    gl = g.permute(0, 3, 1, 2)
    return (lambda: rk.wgrad_conv3x3(x, g, a, b, True),
            lambda: torch.nn.grad.conv2d_weight(sl, (d, c, 3, 3), gl, padding=1))


def _k1_args(n, h, w, c, d, silu, dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(n, h, w, c, generator=gen, device=dev).bfloat16()
    k = torch.randn(3, 3, c, d, generator=gen, device=dev) * (9 * c) ** -0.5
    bias = 0.1 * torch.randn(d, generator=gen, device=dev)
    a = b = None
    if silu:
        a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=dev)
        b = 0.1 * torch.randn(n, c, generator=gen, device=dev)
    return x, k, bias, a, b, silu


def _k1_runs(args):
    """(K1's call, `F.conv2d` on the materialised activation, channels_last bf16)"""
    x, k, bias, a, b, silu = args
    xa = rk._act(x, a, b, silu).permute(0, 3, 1, 2)
    wl = k.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bl = bias.bfloat16()
    return (lambda: rk.fused_affine_conv3x3(*args),
            lambda: torch.nn.functional.conv2d(xa, wl, bl, padding=1))


def _k14_args(n, h, w, c, d, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(n, h, w, c, generator=gen, device=dev).bfloat16()
    k = torch.randn(3, 3, c, d, generator=gen, device=dev) * (9 * c) ** -0.5
    return x, k, 0.1 * torch.randn(d, generator=gen, device=dev)


def _k14_runs(args):
    """(K14's call, its weight transform included, K10's, `F.conv2d`, the
    weight transform alone)"""
    x, k, bias = args
    wl = k.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xl, bl = x.permute(0, 3, 1, 2), bias.bfloat16()
    return (lambda: rk.winograd_conv3x3(*args), lambda: rk.spatial_conv3x3(*args),
            lambda: torch.nn.functional.conv2d(xl, wl, bl, padding=1),
            lambda: rk.winograd_weights(k).to(x.dtype))


def _k10_args(n, h, w, c, d, dev):
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(n, h, w, c, generator=gen, device=dev).bfloat16()
    k = torch.randn(3, 3, c, d, generator=gen, device=dev) * (9 * c) ** -0.5
    return x, k, 0.1 * torch.randn(d, generator=gen, device=dev)


def _k10_runs(args):
    """(K10's call, `F.conv2d` on the same input, channels_last bf16)"""
    x, k, bias = args
    wl = k.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xl, bl = x.permute(0, 3, 1, 2), bias.bfloat16()
    return (lambda: rk.spatial_conv3x3(*args),
            lambda: torch.nn.functional.conv2d(xl, wl, bl, padding=1))


def _k8_args(n, hw, c, d, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    x = rk._place(torch.randn(n, *hw, c, generator=gen, device=dev), *rk.padded_hw(*hw))
    k = torch.randn(3, 3, c, d, generator=gen, device=dev) * (9 * c) ** -0.5
    return x.bfloat16(), k, 0.1 * torch.randn(d, generator=gen, device=dev), hw


def _k8_runs(args):
    """(K8's call, `F.conv2d` at stride 2 on the interior, channels_last bf16)"""
    x, k, bias, hw = args
    xl = rk._interior(x, hw).contiguous().permute(0, 3, 1, 2)
    wl = k.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bl = bias.bfloat16()
    return (lambda: rk.fused_downconv3x3_padded(*args),
            lambda: torch.nn.functional.conv2d(xl, wl, bl, stride=2, padding=1))


def _k4a_args(n, hw, cins, d, dev):
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    parts = [(rk._place(randn(n, *hw, c), *rk.padded_hw(*hw)).bfloat16(),
              randn(3, 3, c, d, scale=(9 * sum(cins)) ** -0.5), 1 + randn(n, c, scale=0.1),
              randn(n, c, scale=0.1)) for c in cins]
    return parts, randn(d, scale=0.1), hw


def _k4a_runs(args):
    """(K4a's call, `F.conv2d` on the activated interiors, channels_last bf16)"""
    parts, bias, hw = args
    xa = torch.cat([rk._act(rk._interior(x, hw), a, b, True) for x, _, a, b in parts], -1)
    xa = xa.permute(0, 3, 1, 2)
    wl = torch.cat([k for _, k, _, _ in parts], 2).bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bl = bias.bfloat16()
    return (lambda: rk.fused_affine_conv3x3_padded(parts, bias, hw),
            lambda: torch.nn.functional.conv2d(xa, wl, bl, padding=1))


def _k9_args(n, hw, c, ch, dev):
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x = rk._place(randn(n, *hw, c), *rk.padded_hw(*hw)).bfloat16()
    return (x, hw, 1 + randn(n, c, scale=0.1), randn(n, c, scale=0.1),
            randn(c, 3 * c, scale=c ** -0.5), randn(3 * c, scale=0.1),
            randn(c, c, scale=c ** -0.5), randn(c, scale=0.1), ch)


def _k9_runs(args):
    """(K9's call with statistics, as the path calls it; the QKV and
    projection matmuls around `scaled_dot_product_attention` on the normed
    interior tokens)"""
    x, hw, a, b, wqkv, bqkv, wproj, bproj, ch = args
    n, c, s = x.shape[0], x.shape[-1], hw[0] * hw[1]
    xn = rk._act(rk._interior(x, hw).reshape(n, s, c), a, b, False).reshape(n * s, c)
    wq, wo, bq, bo = wqkv.bfloat16(), wproj.bfloat16(), bqkv.bfloat16(), bproj.bfloat16()

    def library():
        qkv = torch.matmul(xn, wq) + bq
        q, k, v = qkv.view(n, s, c // ch, 3, ch).permute(3, 0, 2, 1, 4)
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        return torch.matmul(o.transpose(1, 2).reshape(n * s, c), wo) + bo

    return lambda: rk.fused_spatial_attention_padded(*args, want_stats=True), library


def _tconv_args(kernel, b, hw, c, emb, res, skip_cins, dev, f=7):
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def x_of(ch):
        x = randn(b, f, *hw, ch)
        return (x if kernel == "k2" else rk._place(x, *rk.padded_hw(*hw))).bfloat16()

    kern, bias = randn(3, c, c, scale=(3 * c) ** -0.5), randn(c, scale=0.1)
    e = randn(b, c).bfloat16() if emb else None
    r = x_of(c) if res else None
    if kernel == "k2":
        return x_of(c), kern, bias, e, r
    skips = [(x_of(cs), randn(cs, c, scale=cs ** -0.5)) for cs in skip_cins] or None
    return x_of(c), kern, bias, hw, e, r, skips, randn(c, scale=0.1) if skips else None


def _tconv_runs(kernel, args):
    """(K2's or K4b's call with statistics, as the path calls them; one matmul
    of the frame-stacked (B*F*S, 3C) interior and the (3C, C) weights, and
    for K4b one of its skip parts' (B*F*S, sum C_i) against theirs)"""
    x, kern = args[:2]
    b, f, c = x.shape[0], x.shape[1], x.shape[-1]
    hw = args[3] if kernel == "k4b" else tuple(x.shape[2:4])
    xi = x if kernel == "k2" else rk._interior(x, hw)
    xp = torch.nn.functional.pad(xi.reshape(b, f, -1, c), (0, 0, 0, 0, 1, 1))
    stacked = torch.cat([xp[:, :f], xp[:, 1:f + 1], xp[:, 2:]], -1).reshape(-1, 3 * c)
    w2d = kern.bfloat16().reshape(3 * c, c)
    skips = args[6] if kernel == "k4b" else None
    sx = sk = None
    if skips:
        sx = torch.cat([rk._interior(s, hw) for s, _ in skips], -1)
        sx = sx.reshape(-1, sx.shape[-1])
        sk = torch.cat([k for _, k in skips], 0).bfloat16()
    fn = rk.temporal_conv_fused if kernel == "k2" else rk.temporal_conv_padded

    def library():
        y = torch.matmul(stacked, w2d)
        return y if sx is None else (y, torch.matmul(sx, sk))

    return lambda: fn(*args, want_stats=True), library


def _k5_args(n, hw, c, d, dev):
    gen = torch.Generator(device=dev).manual_seed(8)
    x = rk._place(torch.randn(n, *hw, c, generator=gen, device=dev), *rk.padded_hw(*hw))
    k = torch.randn(3, 3, c, d, generator=gen, device=dev) * (9 * c) ** -0.5
    return x.bfloat16(), k, 0.1 * torch.randn(d, generator=gen, device=dev), hw


def _k5_runs(args):
    """(K5's call, `F.conv2d` on the 2x upsampled interior, channels_last bf16)"""
    x, k, bias, hw = args
    xu = rk._interior(x, hw).repeat_interleave(2, 1).repeat_interleave(2, 2).permute(0, 3, 1, 2)
    wl = k.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bl = bias.bfloat16()
    return (lambda: rk.fused_upconv3x3_padded(*args),
            lambda: torch.nn.functional.conv2d(xu, wl, bl, padding=1))


def _k11_args(b, s, c, emb, res, dev, f=7):
    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x = randn(b, f, s, c).bfloat16()
    return (x, randn(3, c, c, scale=(3 * c) ** -0.5), randn(c, scale=0.1),
            randn(b, c).bfloat16() if emb else None, randn(b, f, s, c).bfloat16() if res else None)


def _k11_runs(args):
    """(K11's call with statistics, as the path calls it; K2's on the same
    tensor; one matmul of the frame-stacked (B*F*S, 3C) operand)"""
    x, kern = args[:2]
    b, f, c = x.shape[0], x.shape[1], x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    stacked = torch.cat([xp[:, :f], xp[:, 1:f + 1], xp[:, 2:]], -1).reshape(-1, 3 * c)
    w2d = kern.bfloat16().reshape(3 * c, c)
    return (lambda: rk.temporal_conv_fused_hw(*args, want_stats=True),
            lambda: rk.temporal_conv_fused(*args, want_stats=True),
            lambda: torch.matmul(stacked, w2d))


def _k7_args(shape, silu, dev):
    gen = torch.Generator(device=dev).manual_seed(10)
    c = shape[-1]
    x = (torch.randn(*shape, generator=gen, device=dev) * 2 + 0.5).bfloat16()
    return (x, 1 + 0.2 * torch.randn(c, generator=gen, device=dev),
            0.2 * torch.randn(c, generator=gen, device=dev), silu)


def _k7_runs(args):
    """(K7's call as the path makes it; the same without the SiLU;
    `y.copy_(x)`, the same bytes read and written)"""
    from v2a_tpu_torch.ops import group_norm as gn

    x, scale, bias, silu = args
    y = torch.empty_like(x)
    return (lambda: gn.fused_group_norm_silu(x, scale, bias, 32, with_silu=silu),
            lambda: gn.fused_group_norm_silu(x, scale, bias, 32, with_silu=False),
            lambda: y.copy_(x))


def _k7_plan(shape):
    from v2a_tpu_torch.ops import group_norm as gn

    b, c = shape[0], shape[-1]
    s = 1
    for dim in shape[1:-1]:
        s *= dim
    plan = gn.group_norm_plan(b, s, c)
    return dict(threads=plan.threads, rows=plan.rows, ctas=plan.ctas, grid=b * plan.ctas)


def _k15_args(b, f, s, c, dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    return (torch.randn(b, f, s, c, generator=gen, device=dev).bfloat16(),
            torch.randn(3 * c, c, generator=gen, device=dev) * (3 * c) ** -0.5)


def _k15_runs(args):
    """(K15's call; K2's with a zero bias on the same x and w; one matmul of
    the frame-stacked (B*F*S, 3C) operand)"""
    x, w = args
    b, f, c = x.shape[0], x.shape[1], x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    stacked = torch.cat([xp[:, :f], xp[:, 1:f + 1], xp[:, 2:]], -1).reshape(-1, 3 * c)
    w2d, zero = w.bfloat16(), torch.zeros(c, device=x.device)
    return (lambda: perf_lab.temporal_conv_taps(x, w),
            lambda: rk.temporal_conv_fused(x, w.reshape(3, c, c), zero),
            lambda: torch.matmul(stacked, w2d))


def _variant_dir(csrc: str, build_dir: str, name: str, cuts) -> str:
    """A copy of `csrc` with `cuts` applied, under `build_dir`."""
    root = os.path.join(build_dir, "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(csrc, root)
    for old, new in cuts:
        hits = 0
        for fn in os.listdir(root):
            path = os.path.join(root, fn)
            with open(path) as fh:
                src = fh.read()
            if old in src:
                hits += 1
                with open(path, "w") as fh:
                    fh.write(src.replace(old, new))
        if not hits:
            raise RuntimeError(f"{name}: the kernel no longer has {old.strip()!r}")
    return root


def _use_sources(csrc: str, build_dir: str) -> None:
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    _build._libs.clear()
    rk._lib.cache_clear()


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", action="store_true", help="also time the cut copies")
    ap.add_argument("--kernels",
                    default="k3,k12,k13,k6,k1,k14,k4a,k9,k2,k4b,k10,k8,k5,k11,k7,k15",
                    help="comma-separated kernels")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_tconv_probe: needs a CUDA card")
    dev = torch.device("cuda")
    kernels = opts.kernels.split(",")
    rows = []
    cases = [(c, _case_args(*c[1:], dev)) for c in CASES if c[0] in kernels]
    k6 = [(c, _k6_args(*c[:5], dev)) for c in K6_CASES] if "k6" in kernels else []
    k1 = [(c, _k1_args(*c[:6], dev)) for c in K1_CASES] if "k1" in kernels else []
    k14 = [(c, _k14_args(*c, dev)) for c in K14_CASES] if "k14" in kernels else []
    k4a = [(c, _k4a_args(*c[:4], dev)) for c in K4A_CASES] if "k4a" in kernels else []
    k10 = [(c, _k10_args(*c[:5], dev)) for c in K10_CASES] if "k10" in kernels else []
    k8 = [(c, _k8_args(*c[:4], dev)) for c in K8_CASES] if "k8" in kernels else []
    k5 = [(c, _k5_args(*c[:4], dev)) for c in K5_CASES] if "k5" in kernels else []
    k11 = [(c, _k11_args(*c[:5], dev)) for c in K11_CASES] if "k11" in kernels else []
    k9 = [(c, _k9_args(*c[:4], dev)) for c in K9_CASES] if "k9" in kernels else []
    k7 = [(c, _k7_args(*c[:2], dev)) for c in K7_CASES] if "k7" in kernels else []
    k15 = [(c, _k15_args(*c, dev)) for c in K15_CASES] if "k15" in kernels else []
    tconv = [(c, _tconv_args(*c[:7], dev)) for c in TCONV_CASES if c[0] in kernels]
    with torch.no_grad():
        for case, args in cases:
            kernel, b, hw, cins, d = case
            fused, other = _runs(kernel, args)
            plan = rk.conv_tconv_plan(b, 7, *hw, d, ring=kernel == "k12")
            row = dict(kernel=kernel, b=b, hw=hw, cins=cins, d=d, ms=time_ms(fused),
                       pixels=plan.pixels, cluster=plan.cluster, grid=plan.grid)
            row["k3_ms" if kernel == "k13" else "k4a_k4b_ms"] = time_ms(other)
            rows.append(row)
            print(row, flush=True)
        for case, args in k6:
            kernel_fn, library = _k6_runs(args)
            plan = rk.wgrad_plan(*case[:5])
            row = dict(kernel="k6", shape=case[:5], calls=case[5], ms=time_ms(kernel_fn),
                       library_ms=time_ms(library), chunks=plan.chunks, grid=plan.grid)
            rows.append(row)
            print(row, flush=True)
        for case, args in k1:
            kernel_fn, library = _k1_runs(args)
            plan = rk.affine_conv_plan(*case[:5])
            row = dict(kernel="k1", shape=case[:5], silu=case[5], role=case[6], calls=case[7],
                       ms=time_ms(kernel_fn), library_ms=time_ms(library), pixels=plan.pixels,
                       nc=plan.nc, grid=plan.grid)
            rows.append(row)
            print(row, flush=True)
        for case, args in k14:
            kernel_fn, k10, library, weights = _k14_runs(args)
            plan = rk.winograd_plan(*case)
            row = dict(kernel="k14", shape=case, ms=time_ms(kernel_fn), k10_ms=time_ms(k10),
                       library_ms=time_ms(library), weights_ms=time_ms(weights),
                       patches=plan.patches, nc=plan.nc, resident=plan.resident, grid=plan.grid)
            rows.append(row)
            print(row, flush=True)
        for case, args in k4a:
            kernel_fn, library = _k4a_runs(args)
            n, (h, w), cins, d, calls = case
            plan = rk.affine_conv_plan(n, h, w, sum(cins), d)
            row = dict(kernel="k4a", shape=case[:4], calls=calls, ms=time_ms(kernel_fn),
                       library_ms=time_ms(library), pixels=plan.pixels, nc=plan.nc,
                       grid=plan.grid)
            rows.append(row)
            print(row, flush=True)
        for case, args in k10:
            kernel_fn, library = _k10_runs(args)
            plan = rk.affine_conv_plan(*case[:5])
            row = dict(kernel="k10", shape=case[:5], calls=case[5], ms=time_ms(kernel_fn),
                       library_ms=time_ms(library), pixels=plan.pixels, nc=plan.nc,
                       grid=plan.grid)
            rows.append(row)
            print(row, flush=True)
        for case, args in k8:
            kernel_fn, library = _k8_runs(args)
            n, (h, w), c, d, calls = case
            plan = rk.affine_conv_plan(n, h, w, c, d, stride=2)
            row = dict(kernel="k8", shape=case[:4], calls=calls, ms=time_ms(kernel_fn),
                       library_ms=time_ms(library), pixels=plan.pixels, nc=plan.nc,
                       grid=plan.grid, smem=plan.smem)
            rows.append(row)
            print(row, flush=True)
        for case, args in k5:
            kernel_fn, library = _k5_runs(args)
            n, (h, w), c, d, calls = case
            plan = rk.affine_conv_plan(n, h, w, c, d, up=True)
            row = dict(kernel="k5", shape=case[:4], calls=calls, ms=time_ms(kernel_fn),
                       library_ms=time_ms(library), pixels=plan.pixels, nc=plan.nc,
                       grid=plan.grid, smem=plan.smem)
            rows.append(row)
            print(row, flush=True)
        for case, args in k11:
            kernel_fn, k2_fn, library = _k11_runs(args)
            b, s, c, emb, res, calls = case
            plan = rk.temporal_conv_plan(b, 7, s, c)
            row = dict(kernel="k11", shape=case[:5], calls=calls, ms=time_ms(kernel_fn),
                       k2_ms=time_ms(k2_fn), host_ms=host_ms(kernel_fn),
                       k2_host_ms=host_ms(k2_fn), library_ms=time_ms(library),
                       pixels=plan.pixels, frames=plan.frames, nc=plan.nc, grid=plan.grid)
            rows.append(row)
            print(row, flush=True)
        for case, args in k7:
            kernel_fn, no_silu, copy = _k7_runs(args)
            shape, silu, calls = case
            row = dict(kernel="k7", shape=shape, silu=silu, calls=calls, ms=time_ms(kernel_fn),
                       no_silu_ms=time_ms(no_silu), host_ms=host_ms(kernel_fn),
                       copy_ms=time_ms(copy), **_k7_plan(shape))
            rows.append(row)
            print(row, flush=True)
        for case, args in k15:
            kernel_fn, k2_fn, library = _k15_runs(args)
            plan = rk.temporal_conv_plan(*case)
            row = dict(kernel="k15", shape=case, ms=time_ms(kernel_fn), k2_ms=time_ms(k2_fn),
                       host_ms=host_ms(kernel_fn), k2_host_ms=host_ms(k2_fn),
                       library_ms=time_ms(library), pixels=plan.pixels, frames=plan.frames,
                       nc=plan.nc, grid=plan.grid)
            rows.append(row)
            print(row, flush=True)
        for case, args in k9:
            kernel_fn, library = _k9_runs(args)
            n, (h, w), c, ch, calls = case
            plan = rk.attention_plan(n, h, w, c, ch)
            row = dict(kernel="k9", shape=case[:4], calls=calls, ms=time_ms(kernel_fn),
                       library_ms=time_ms(library), qkv_tokens=plan.qkv.tokens,
                       queries=plan.queries, slice=plan.slice, proj_tokens=plan.proj.tokens)
            rows.append(row)
            print(row, flush=True)
        for case, args in tconv:
            kernel_fn, library = _tconv_runs(case[0], args)
            kernel, b, (h, w), c, emb, res, skip_cins, calls = case
            plan = rk.temporal_conv_plan(b, 7, h * w, c)
            row = dict(kernel=kernel, shape=case[1:7], calls=calls, ms=time_ms(kernel_fn),
                       host_ms=host_ms(kernel_fn), library_ms=time_ms(library),
                       pixels=plan.pixels, frames=plan.frames, nc=plan.nc, grid=plan.grid)
            rows.append(row)
            print(row, flush=True)
        if opts.ablate:
            csrc, build_dir = _build.CSRC, _build.BUILD_DIR
            try:
                for name, (cut_kernels, cuts) in CUTS.items():
                    if not set(cut_kernels) & set(kernels):
                        continue
                    root = _variant_dir(csrc, build_dir, name, cuts)
                    _use_sources(root, root + "_build")
                    for case, args in cases:
                        if case[0] in cut_kernels:
                            row = dict(variant=name, kernel=case[0], b=case[1], hw=case[2],
                                       ms=time_ms(_runs(case[0], args)[0]))
                            rows.append(row)
                            print(row, flush=True)
                    for case, args in tconv:
                        if case[0] in cut_kernels:
                            row = dict(variant=name, kernel=case[0], shape=case[1:7],
                                       ms=time_ms(_tconv_runs(case[0], args)[0]))
                            rows.append(row)
                            print(row, flush=True)
                    for kernel, cases_k, runs in (("k6", k6, _k6_runs), ("k1", k1, _k1_runs),
                                                  ("k14", k14, _k14_runs),
                                                  ("k4a", k4a, _k4a_runs), ("k9", k9, _k9_runs),
                                                  ("k10", k10, _k10_runs), ("k8", k8, _k8_runs),
                                                  ("k5", k5, _k5_runs), ("k11", k11, _k11_runs)):
                        for case, args in cases_k if kernel in cut_kernels else ():
                            shape = case[:4] if kernel in ("k4a", "k9", "k8", "k5") else case[:5]
                            row = dict(variant=name, kernel=kernel, shape=shape,
                                       ms=time_ms(runs(args)[0]))
                            rows.append(row)
                            print(row, flush=True)
                    for case, args in k7 if "k7" in cut_kernels else ():
                        call, no_silu, _ = _k7_runs(args)
                        row = dict(variant=name, kernel="k7", shape=case[0], silu=case[1],
                                   ms=time_ms(call), no_silu_ms=time_ms(no_silu))
                        rows.append(row)
                        print(row, flush=True)
            finally:
                _use_sources(csrc, build_dir)
    return rows


if __name__ == "__main__":
    main()
