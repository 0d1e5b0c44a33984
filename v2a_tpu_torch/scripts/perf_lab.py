"""The port's perf lab: kernel benches at the video U-Net's level shapes, the
counterpart of the JAX package's `scripts/perf_lab.py` for its two benches
that reach a hand-written kernel.

    python -m v2a_tpu_torch.scripts.perf_lab winobench2 tconvbench2

- `winobench2` (JAX lab :485-531): the 3x3 conv at three level shapes
  through the library conv (`F.conv2d`), K10 (`spatial_conv3x3`) and K14
  (`winograd_conv3x3`), with K14's error relative to the library conv.
- `tconvbench2` (JAX lab :613-716): the plain 3-tap temporal conv at three
  level shapes through K15 (`temporal_conv_taps`, this module's wrapper of
  K2's launch) and the library yardstick, one `torch.matmul` of the
  frame-stacked (B*F*S, 3C) operand and the (3C, C) weights, the stacking
  included (the calls are chained, so each stacks its own input). The JAX
  bench's three TPU schedules of that kernel are TPU tiling experiments
  and have no counterpart here.

Each prints one line per (shape, implementation): ms per call over chained
calls (y = fn(y), timed by CUDA events on the card), and TFLOP/s. The JAX
lab's other subcommands (forward ablations, traces, the other benches) are
not ported and raise `NotImplementedError` (ROADMAP.md, Queue 1). The benches
run on the card; `device="cpu"` runs them on the plain versions and times
them by the host clock, which measures the CPU and no device.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from v2a_tpu_torch.device import resolve_device
from v2a_tpu_torch.ops import resblock_kernels as rk

# (level, N = B*F, H, W, C): the JAX lab's winobench2 shapes
WINO_SHAPES = [("L0", 56, 128, 128, 128), ("L1", 56, 64, 64, 256), ("L2", 56, 32, 32, 384)]
# (level, B, F, S, C): the JAX lab's tconvbench2 shapes
TCONV_SHAPES = [("L0", 8, 7, 128 * 128, 128), ("L1", 8, 7, 64 * 64, 256), ("L4", 8, 7, 64, 640)]


# -- K15: the lab's plain temporal conv --------------------------------------------


def temporal_conv_taps_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K15: y[f] = sum_t x[f + t - 1] @ W_t, frames
    zero-padded, the three taps' products of x.dtype operands summed in
    float32 and rounded once; x (B, F, S, C), w (3C, C) tap-major."""
    f, c = x.shape[1], x.shape[-1]
    xp = F.pad(x.float(), (0, 0, 0, 0, 1, 1))
    stacked = torch.cat([xp[:, :f], xp[:, 1:f + 1], xp[:, 2:]], -1)
    return (stacked @ w.to(x.dtype).float()).to(x.dtype)


# a float32 zero bias of C elements per (device, C): K15 is K2's launch without one
_zero_bias: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def temporal_conv_taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The JAX perf lab's temporal-conv kernel (`scripts/perf_lab.py:627`,
    `tconv_variants_bench.make_call`): y[f] = sum_t x[f + t - 1] @ W_t with
    zero frames outside, no bias. x (B, F, S, C); w (3C, C), rows t*C ..
    t*C + C - 1 for tap t. Returns (B, F, S, C) in x.dtype.

    Kernel note (csrc/temporal_conv.cu): K2's function with a zero bias, so
    this is K2's launch (`rk._temporal_conv_launch`: K2's Hopper body and
    plan, its float32 body for float32) on x's own memory with w as K2's
    (3, C, C) tap-major kernel, a cached float32 zero bias and no emb,
    residual or statistics; y is K2's bit for bit (adding +0.0 changes no
    value). Its own count is `launches["temporal_conv_taps"]`.
    """
    rk._no_grad_inputs("temporal_conv_taps", x, w)
    if x.dim() != 4:
        raise ValueError(f"x must be (B, F, S, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(w.shape) != (3 * c, c):
        raise ValueError(f"w {tuple(w.shape)} vs (3C, C) = {(3 * c, c)}")
    if x.device.type == "cpu":
        return temporal_conv_taps_plain(x, w)
    zero = _zero_bias.get((x.device, c))
    if zero is None:
        zero = _zero_bias[(x.device, c)] = torch.zeros(c, dtype=torch.float32, device=x.device)
    return rk._temporal_conv_launch("temporal_conv_taps", x, w.reshape(3, c, c), zero, None,
                                    None, False)


# -- timing ------------------------------------------------------------------------


def time_chained(fn: Callable, x: torch.Tensor, chain: int = 10, iters: int = 3) -> float:
    """Mean ms per call of `y = fn(y)` chained `chain` times, over `iters`
    chains after one warm-up chain: the counterpart of the JAX lab's
    `_time_chained` (:94). On the card, CUDA events around the chains; on
    the CPU, the host clock."""
    def run():
        y = x
        for _ in range(chain):
            y = fn(y)
        return y

    run()
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        return (time.perf_counter() - t0) * 1e3 / (iters * chain)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * chain)


def _device_label(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host clock)"


# -- the benches -------------------------------------------------------------------


def winobench2(shapes: Sequence = WINO_SHAPES, device=None, chain: int = 10, iters: int = 3,
               out: Callable = print) -> List[dict]:
    """The 3x3 conv (C -> C, bf16) at each (level, N, H, W, C) through the
    library conv, K10 and K14, chained; K14's max error relative to the
    library conv's largest magnitude, as the JAX bench prints it. Returns a
    row per (shape, implementation)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, n, h, w, c in shapes:
        x = torch.randn(n, h, w, c, generator=gen, device=dev).bfloat16()
        wgt = (torch.randn(3, 3, c, c, generator=gen, device=dev).bfloat16() * 0.02)
        bias = torch.zeros(c, device=dev)
        wl = wgt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        flops = 2.0 * 9 * c * c * h * w * n

        def library(y):  # NCHW views of channels_last data, back to (N, H, W, C)
            return F.conv2d(y.permute(0, 3, 1, 2), wl, padding=1).permute(0, 2, 3, 1)

        impls = (("library", library),
                 ("direct", lambda y: rk.spatial_conv3x3(y, wgt, bias)),
                 ("wino", lambda y: rk.winograd_conv3x3(y, wgt, bias)))
        ref = library(x).float()
        relerr = float((impls[2][1](x).float() - ref).abs().max() / (ref.abs().max() + 1e-6))
        for label, fn in impls:
            ms = time_chained(fn, x, chain, iters)
            rows.append(dict(bench="winobench2", shape=name, impl=label, ms=ms,
                             tflops=flops / ms / 1e9,
                             relerr=relerr if label == "wino" else None))
            out(f"winop {name:<4} {label:<7} {ms:8.3f} ms  {flops / ms / 1e9:6.1f} "
                f"TF/s(direct-equiv)" + (f"  relerr={relerr:.2e}" if label == "wino" else "")
                + f"  [{_device_label(dev)}]")
    return rows


def tconvbench2(shapes: Sequence = TCONV_SHAPES, device=None, chain: int = 10, iters: int = 3,
                out: Callable = print) -> List[dict]:
    """The plain 3-tap temporal conv (bf16) at each (level, B, F, S, C)
    through K15 and the library yardstick (one `torch.matmul` of the
    frame-stacked operand, which the chained call stacks first), chained.
    Returns a row per (shape, implementation)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, b, f, s, c in shapes:
        x = torch.randn(b, f, s, c, generator=gen, device=dev).bfloat16()
        w = (torch.randn(3 * c, c, generator=gen, device=dev) * 0.05).bfloat16()
        flops = 2.0 * 3 * c * c * s * b * f

        def library(y):
            yp = F.pad(y, (0, 0, 0, 0, 1, 1))
            stacked = torch.cat([yp[:, :f], yp[:, 1:f + 1], yp[:, 2:]], -1)
            return torch.matmul(stacked.reshape(-1, 3 * c), w).reshape(y.shape)

        for label, fn in (("kernel", lambda y: temporal_conv_taps(y, w)),
                          ("stacked-matmul", library)):
            ms = time_chained(fn, x, chain, iters)
            rows.append(dict(bench="tconvbench2", shape=name, impl=label, ms=ms,
                             tflops=flops / ms / 1e9))
            out(f"tconv2 {name} {label:<14} {ms:8.3f} ms  {flops / ms / 1e9:6.1f} TFLOP/s"
                f"  [{_device_label(dev)}]")
    return rows


BENCHES = {"winobench2": winobench2, "tconvbench2": tconvbench2}


def main(argv: Optional[Sequence[str]] = None, device=None) -> List[dict]:
    """Runs the named benches in order; with no names, the JAX lab's default
    (its forward ablations), which are not ported. Every name is checked
    before any bench runs."""
    want = list(sys.argv[1:] if argv is None else argv) or ["base", "no_attn", "no_temporal",
                                                            "no_gn", "conv_only"]
    for name in want:
        if name not in BENCHES:
            raise NotImplementedError(
                f"perf lab subcommand {name!r} is not ported (the port has {sorted(BENCHES)}); "
                "the JAX lab's ablations, traces and other benches are queued in ROADMAP.md, "
                "Queue 1")
    rows = []
    for name in want:
        rows += BENCHES[name](device=device)
    return rows


if __name__ == "__main__":
    main()
