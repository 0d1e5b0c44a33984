"""The video U-Net's ResBlock-interior kernels: wrappers, plain versions and
the GroupNorm statistics fold.

Counterpart of `v2a_tpu/ops/resblock_kernels.py`. The unpadded fused
routing runs:

- `fused_affine_conv3x3` (K1): y = conv3x3_same(act(x)) + bias with
  act = silu(a*x + b) per (N, C), or the plain conv. CUDA source
  `csrc/affine_conv3x3.cu`.
- `temporal_conv_fused` (K2): the 3-tap C x C conv over frames + bias
  [+ emb] [+ residual], optionally with per-(B, F, C) sum / sum of squares
  of the rounded output. CUDA source `csrc/temporal_conv.cu`, launch plan
  `temporal_conv_plan`.

The padded-stream routing (the JAX package's default) keeps the levels
with H*W > 512 in the (.., Hp, Wp, C) layout of `padded_hw` and runs:

- `fused_affine_conv3x3_padded` (K4a): K1 over a multi-part padded stream,
  all parts in one float32 accumulator; a second entry of K1's kernel,
  `csrc/affine_conv3x3.cu`.
- `temporal_conv_padded` (K4b): K2 over a padded stream, with the ResBlock's
  1x1 skip projection folded in; a second entry of K2's kernel,
  `csrc/temporal_conv.cu`.
- `fused_conv_tconv_padded` (K3): K4a then K4b in one pass; the conv output
  never reaches device memory. `csrc/conv_tconv_padded.cu`.
- `fused_upconv3x3_padded` (K5): conv3x3_same(nearest_2x(x)) as four
  parity convs over the low-res stream; a fifth entry of K1's kernel,
  `csrc/affine_conv3x3.cu`, with the parity tap sets.

Two further serving routings of the JAX package add:

- `fused_downconv3x3_padded` (K8): the stride-2 3x3 conv of the Downsample
  from a padded stream into one at half the size (`V2A_DOWNCONV=1` there,
  `VideoUNet(downconv=True)` here). A fourth entry of K1's kernel,
  `csrc/affine_conv3x3.cu`, at stride 2.
- `fused_spatial_attention_padded` (K9): GroupNorm affine, QKV, the legacy
  masked attention, projection and residual in one call, with the output's
  statistics (`V2A_PALLAS_ATTN=1` there, `VideoUNet(attn_kernel=True)`
  here). `csrc/spatial_attention_padded.cu`.

K7, the GroupNorm(+SiLU) of the non-fused forward, has its wrapper in
`ops/group_norm.py` and its entry and count here.

Two more serving routings of the JAX package add:

- `spatial_conv3x3` (K10): the plain 3x3 conv + bias of the routing
  without the K1 gate (`V2A_SPATIAL2_MIN_CH=0` with `PERF_PALLAS_SPATIAL`
  there, `VideoUNet(spatial2_min_ch=0, pallas_spatial=True)` here). A third
  entry of K1's kernel, `csrc/affine_conv3x3.cu`, in its plain-conv mode.
- `temporal_conv_fused_hw` (K11): K2's function on the (H*W, B, F, C) view
  (`PERF_TCONV_HW` there, `VideoUNet(tconv_hw=True)` here). K2's launch
  of `csrc/temporal_conv.cu` on the caller's (B, F, H*W, C) memory, the
  view being only another address map over it.
- `fused_conv_tconv_stream` (K12): K3's function without the skip fold,
  frames streamed through a 3-slot ring of conv outputs
  (`V2A_STREAM_KERNEL=1` there, `VideoUNet(stream_kernel=True)` here), taken
  before K3 where `stream_band_rows` admits it. `csrc/conv_tconv_stream.cu`.

The padded-stream contract: pad COLS are zero in the output of every conv
and temporal-conv producer; pad ROWS (0 and Hp-1) hold arbitrary values
(the kernels leave them unwritten, the plain versions write NaN there).
Every consumer removes pad values by selection (index ranges or a skipped
load), never by multiplying with a mask, and the statistics are exact
interior sums.

The training path adds:

- `wgrad_conv3x3` (K6): dW (3, 3, C, D) float32 of conv3x3_same(act(x))
  from the raw input and the output cotangent. `csrc/wgrad_conv3x3.cu`.
  `ops/conv_vjp.py` makes K1 differentiable with K1 as its dgrad and K6 as
  its wgrad.

Two kernels of the JAX package that its model never calls, reached through
the port's perf lab (`v2a_tpu_torch/scripts/perf_lab.py`) and `chip_smoke.py`:

- `fused_conv_tconv_dma` (K13): K3's contract and kernel with its copies
  issued by TMA; bit-equal to K3. `csrc/conv_tconv_dma.cu`.
- `winograd_conv3x3` (K14): K10's function by Winograd F(2x2, 3x3), even H
  and W. `csrc/winograd_conv3x3.cu`.

The perf lab's own temporal conv (K15, `temporal_conv_taps`) has its wrapper
in `scripts/perf_lab.py` and its entry and count here.

Each wrapper runs its kernel's plain PyTorch version (`*_plain`, beside it)
for a tensor on the CPU. For a CUDA tensor it launches the kernel on the
current stream or raises; there is no fallback. `launches[<wrapper name>]`
counts kernel launches. No wrapper has a backward: each raises when grad
mode is on and an input requires grad (on both devices, so the CPU tests see
what the card would do); training goes through `ops/conv_vjp.py`, and a
test that wants the plain versions' gradients calls `*_plain` directly.
"""

from __future__ import annotations

import ctypes
import functools
import importlib
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from v2a_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# what chip_smoke.py reports for each ported kernel
KERNELS = {
    "fused_affine_conv3x3": dict(
        source="v2a_tpu_torch/csrc/affine_conv3x3.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:662",
    ),
    "temporal_conv_fused": dict(
        source="v2a_tpu_torch/csrc/temporal_conv.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:177",
    ),
    "fused_affine_conv3x3_padded": dict(
        source="v2a_tpu_torch/csrc/affine_conv3x3.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:902",
    ),
    "temporal_conv_padded": dict(
        source="v2a_tpu_torch/csrc/temporal_conv.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:1090",
    ),
    "fused_conv_tconv_padded": dict(
        source="v2a_tpu_torch/csrc/conv_tconv_padded.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:1978",
    ),
    "fused_upconv3x3_padded": dict(
        source="v2a_tpu_torch/csrc/affine_conv3x3.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:1314",
    ),
    "wgrad_conv3x3": dict(
        source="v2a_tpu_torch/csrc/wgrad_conv3x3.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:3329",
    ),
    "fused_downconv3x3_padded": dict(
        source="v2a_tpu_torch/csrc/affine_conv3x3.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:1514",
    ),
    "fused_spatial_attention_padded": dict(
        source="v2a_tpu_torch/csrc/spatial_attention_padded.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:2962",
    ),
    "fused_group_norm_silu": dict(
        source="v2a_tpu_torch/csrc/group_norm_silu.cu",
        replaces="v2a_tpu/ops/pallas_kernels.py:111",
        module="v2a_tpu_torch.ops.group_norm",
    ),
    "spatial_conv3x3": dict(
        source="v2a_tpu_torch/csrc/affine_conv3x3.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:2796",
    ),
    "temporal_conv_fused_hw": dict(
        source="v2a_tpu_torch/csrc/temporal_conv.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:340",
    ),
    "fused_conv_tconv_stream": dict(
        source="v2a_tpu_torch/csrc/conv_tconv_stream.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:2656",
    ),
    "fused_conv_tconv_dma": dict(
        source="v2a_tpu_torch/csrc/conv_tconv_dma.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:2377",
    ),
    "winograd_conv3x3": dict(
        source="v2a_tpu_torch/csrc/winograd_conv3x3.cu",
        replaces="v2a_tpu/ops/resblock_kernels.py:3163",
    ),
    # the perf lab's temporal conv (a closure there: `make_call` :627, its
    # pallas_call :674): K2's launch with a zero bias
    "temporal_conv_taps": dict(
        source="v2a_tpu_torch/csrc/temporal_conv.cu",
        replaces="scripts/perf_lab.py:627",
        module="v2a_tpu_torch.scripts.perf_lab",
    ),
}

# kernel launches per wrapper; each wrapper adds one where it launches
launches = {name: 0 for name in KERNELS}


def wrapper_module(name: str):
    """The module that holds wrapper `name`: this one unless its `KERNELS`
    entry names another."""
    return importlib.import_module(KERNELS[name].get("module", __name__))

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib(name: str, fn: str, nargs_ptr: int, nargs_int: int, nargs_float: int = 0):
    """The C entry point `fn` of `csrc/<name>.cu`: pointers, ints, C floats,
    then the stream; returns the CUDA error code."""
    f = getattr(_build.load(name), fn)
    f.argtypes = [_P] * nargs_ptr + [_I] * nargs_int + [ctypes.c_float] * nargs_float + [_P]
    f.restype = _I
    return f


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_cuda(x: torch.Tensor, *others: Optional[torch.Tensor]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrapper got a tensor on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got {x.dtype}")
    for t in (x,) + others:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")


def _no_grad_inputs(what: str, *tensors) -> None:
    """Refuses a call that autograd would try to differentiate: the kernels'
    outputs have no grad_fn, so every gradient below them would be lost."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad() with frozen inputs, train "
            "through v2a_tpu_torch.ops.conv_vjp, or differentiate its *_plain version"
        )


def _parts_tensors(parts):
    return [t for part in parts for t in part]


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _stream(x: torch.Tensor) -> int:
    """The handle of x's device's current stream: the raw getter, which
    costs a tenth of a microsecond of host time where building a
    `torch.cuda.Stream` costs about five."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _stats_buffers(x: torch.Tensor, rows: int, tiles: int, c: int, want: bool):
    """(per-tile partial sums, statistics) for a kernel that reduces its
    tiles in a second, fixed-order pass; (None, None) without statistics."""
    if not want:
        return None, None
    partial = torch.empty((rows * tiles * 2 * c,), dtype=torch.float32, device=x.device)
    return partial, torch.empty((rows, 2, c), dtype=torch.float32, device=x.device)


# -- K1: fused affine (+SiLU) 3x3 conv -----------------------------------------


def _act(x: torch.Tensor, a, b, silu: bool) -> torch.Tensor:
    """silu(a*x + b) in float32 (or the affine alone), rounded to x.dtype;
    x (N, ..., C), a / b (N, C)."""
    if a is None:
        return x
    bc = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    xf = x.float() * a.float().reshape(bc) + b.float().reshape(bc)
    if silu:
        xf = xf * torch.sigmoid(xf)
    return xf.to(x.dtype)


def fused_affine_conv3x3_plain(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    silu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K1: the activation in float32, rounded to
    x.dtype, zero-padded AFTER the activation, conv summed in float32."""
    w = kernel.to(x.dtype).float().permute(3, 2, 0, 1)  # (D, C, 3, 3)
    y = F.conv2d(_act(x, a, b, silu).float().permute(0, 3, 1, 2), w, padding=1)
    y = y.permute(0, 2, 3, 1) + bias.float()
    return y.to(x.dtype).contiguous()


def widened(c: int) -> int:
    """The channels K4a (K1's body) and K3's mainloop (K3, K12, K13) compute
    on: C rounded up to the 32 of one chunk."""
    return c + (-c % 32)


def widen_channels(x: torch.Tensor, kernel: torch.Tensor, a=None, b=None):
    """One conv part (x (..., C), kernel (3, 3, C, D), a / b (N, C) or None)
    zero-extended to `widened(C)` channels, on x's device: zero input
    channels, zero kernel rows, zero affine. Each product they add is an
    exact 0, so the float32 sums and the rounded output do not change. The
    U-Net's 6-channel entry conv takes it on the padded stream
    (`entry_pad`); a part whose C is a multiple of 32 passes as it is."""
    pad = widened(x.shape[-1]) - x.shape[-1]
    if not pad:
        return x, kernel, a, b
    a, b = (None if t is None else F.pad(t, (0, pad)) for t in (a, b))
    return F.pad(x, (0, pad)).contiguous(), F.pad(kernel, (0, 0, 0, pad)), a, b


class AffineConvPlan(NamedTuple):
    """One bf16 K1, K4a, K10, K8 or K5 launch: pixels per tile
    (`hop::tile_of`; 128 with sixteen warps, else eight), output channels
    per CTA, pixel tiles over (N, H / stride, W / stride), CTAs in the grid
    (K5: x 4 parities) and shared memory per CTA in bytes."""
    pixels: int
    nc: int
    tiles: int
    grid: int
    smem: int


def _window_rows(th: int, tw: int, stride: int) -> int:
    """64-byte rows of one K1 window stage (`window_rows` in
    csrc/affine_conv3x3.cu): (th+2)(tw+2), or at stride 2 (2th+1)(2tw+1)."""
    return (stride * th + 3 - stride) * (stride * tw + 3 - stride)


def affine_conv_plan(n: int, h: int, w: int, c: int, d: int, stride: int = 1,
                     up: bool = False) -> AffineConvPlan:
    """The launch K1's bf16 body makes at this shape (csrc/affine_conv3x3.cu;
    K4a's launches take it with c the parts' summed channels, since the
    shared memory does not depend on C; K10's as K1's; K8's with stride 2,
    (h, w) its full-size input; K5's with `up`, (h, w) its low-res input,
    a CTA per tile and output parity); it depends on the shape only. A CTA
    owns P pixels of one sample x NC output channels (128, or 64 where 128
    does not divide D), tiles over the (h / stride, w / stride) grid;
    its shared memory holds a 3-stage ring of a tap row's three (32 x NC)
    weight slabs and a 3-stage ring of input windows with their a, b
    (`_window_rows`, each stage 512-byte aligned for a TMA box; the
    epilogue's P x NC tile aliases them). Of P = 128
    (sixteen warps), 64, 32, 16 (eight) whose shared memory fits, a larger
    one only where it needs fewer tiles than the next smaller, the largest
    whose grid has a CTA per SM (`HOPPER_SMS`), else 16 (the most CTAs)."""
    if c % 32 or d % 64:
        raise ValueError(f"K1 needs C % 32 == 0 and D % 64 == 0, got C={c} D={d}")
    if stride not in (1, 2) or h % stride or w % stride or (up and stride != 1):
        raise ValueError(f"stride {stride} (up {up}) needs H and W divisible by it, got {h}x{w}")
    oh, ow = h // stride, w // stride
    nc = 128 if d % 128 == 0 else 64
    parities = 4 if up else 1
    fits = []
    for p in (128, 64, 32, 16):
        th, tw, tiles = _hop_tile(oh, ow, p)
        # three windows with their a, b, each to 512 bytes, and six mbarriers
        stage = -(-(_window_rows(th, tw, stride) * 64 + 256) // 512) * 512
        ring = _HOP_STAGES * 3 * _HOP_KSTEP * nc * 2 + 3 * stage + 8 * 2 * _HOP_STAGES
        smem = _TMA_ALIGN_PAD + max(ring, p * nc * 2)
        if smem <= HOPPER_SMEM and (p == 16 or tiles < _hop_tile(oh, ow, p // 2)[2]):
            fits.append(AffineConvPlan(p, nc, n * tiles, n * tiles * (d // nc) * parities, smem))
    return next((pl for pl in fits if pl.grid >= HOPPER_SMS), fits[-1])


def fused_affine_conv3x3(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    silu: bool = False,
) -> torch.Tensor:
    """y = conv3x3_same(silu(a*x + b)) + bias, the ResBlock front half in one
    pass (`v2a_tpu/ops/resblock_kernels.py:662`).

    x: (N, H, W, C), N = B*F; kernel: (3, 3, C, D) HWIO, tap order di*3+dj;
    bias: (D,); a, b: optional per-(N, C) affine (the collapsed GroupNorm);
    `silu` applies SiLU after it. Without a/b it is the plain conv. Returns
    (N, H, W, D) in x.dtype.

    Kernel note (csrc/affine_conv3x3.cu): bound by operations. The conv half
    of K3's mainloop on the unpadded layout: a CTA of sixteen (P = 128) or
    eight warps owns a tile of P pixels x 128 output channels (64 where 128
    does not divide D; `affine_conv_plan`); per 32-channel chunk the raw
    window with its halo comes by cp.async into a 3-stage ring (without a/b:
    one TMA box, the halo zero-filled by the map's bounds) and is
    activated once in place (positions outside the image selected out), the
    nine taps read it at shifted ldmatrix rows into mma.sync m16n8k16, the
    weight slabs come by TMA through their own 3-stage ring; bias, one
    rounding, 16-byte stores.
    """
    _no_grad_inputs("fused_affine_conv3x3", x, kernel, bias, a, b)
    if x.device.type == "cpu":
        return fused_affine_conv3x3_plain(x, kernel, bias, a, b, silu)
    n, h, w, c = x.shape
    d = kernel.shape[-1]
    if tuple(kernel.shape) != (3, 3, c, d):
        raise ValueError(f"kernel {tuple(kernel.shape)} vs input C={c}")
    if c % 32 or d % 64:
        raise ValueError(f"K1 needs C % 32 == 0 and D % 64 == 0, got C={c} D={d}")
    if (a is None) != (b is None):
        raise ValueError("pass both a and b, or neither")
    w2d = kernel.to(x.dtype).reshape(9 * c, d).contiguous()
    bias32 = bias.float().contiguous()
    a32 = b32 = None
    if a is not None:
        if tuple(a.shape) != (n, c) or tuple(b.shape) != (n, c):
            raise ValueError(f"affine must be (N, C) = {(n, c)}")
        a32 = a.float().contiguous()
        b32 = b.float().contiguous()
    _check_cuda(x, w2d, bias32, a32, b32)
    plan = affine_conv_plan(n, h, w, c, d)
    y = torch.empty((n, h, w, d), dtype=x.dtype, device=x.device)
    mode = 0 if a is None else (2 if silu else 1)
    fn = _lib("affine_conv3x3", "v2a_affine_conv3x3", 6, 8)
    with torch.cuda.device(x.device):
        rc = fn(
            _ptr(x), _ptr(a32), _ptr(b32), _ptr(w2d), _ptr(bias32), _ptr(y),
            n, h, w, c, d, mode, plan.pixels, _DTYPE_CODE[x.dtype], _stream(x),
        )
    _raise_on(rc, "fused_affine_conv3x3")
    launches["fused_affine_conv3x3"] += 1
    return y


# -- K2: fused temporal conv ---------------------------------------------------


def _fold(x: torch.Tensor) -> Tuple[int, int, int, int]:
    b, f, c = x.shape[0], x.shape[1], x.shape[-1]
    s = 1
    for dim in x.shape[2:-1]:
        s *= dim
    return b, f, s, c


def temporal_conv_fused_plain(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    emb: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    want_stats: bool = False,
):
    """Plain PyTorch version of K2: taps summed in float32 from x.dtype
    operands, + bias + emb + residual in float32, rounded to x.dtype; stats
    from the rounded values."""
    b, f, s, c = _fold(x)
    w = kernel.to(x.dtype).float()
    xp = F.pad(x.reshape(b, f, s, c).float(), (0, 0, 0, 0, 1, 1))
    y = xp[:, 0:f] @ w[0] + xp[:, 1:f + 1] @ w[1] + xp[:, 2:f + 2] @ w[2]
    off = bias.float()
    if emb is not None:
        off = off + emb.reshape(b, 1, 1, c).float()
    y = y + off
    if residual is not None:
        r = residual.expand(x.shape).to(x.dtype).reshape(b, f, s, c)
        y = y + r.float()
    yr = y.to(x.dtype)
    out = yr.reshape(x.shape)
    if want_stats:
        yf = yr.float()
        return out, torch.stack([yf.sum(2), (yf * yf).sum(2)], dim=2)
    return out


def temporal_conv_fused(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    emb: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    want_stats: bool = False,
):
    """y = temporal_conv(x) + bias [+ emb] [+ residual], optionally with the
    per-(B, F, C) sum / sum of squares of y (`v2a_tpu/ops/resblock_kernels.py:177`).

    x: (B, F, H, W, C) or (B, F, S, C); kernel: (3, C, C) (tap, in, out);
    bias: (C,); emb: optional (B, C); residual: optional, broadcastable to x.
    Frames are zero-padded on both sides. Returns y in x.dtype [, stats
    (B, F, 2, C) float32 taken from the rounded y].

    Kernel note (csrc/temporal_conv.cu): bound by operations from C = 256
    on, by bytes below. An implicit GEMM on mma.sync m16n8k16: a CTA of
    sixteen (P = 128) or eight warps owns P pixels of T = 2 (or 1)
    consecutive frames x 128 output channels (64 where 128 does not divide
    C; `temporal_conv_plan`); a step is the three taps of a 32-channel
    chunk, its T + 2 A tiles by cp.async and its three weight slabs by TMA
    into a 3-stage ring, each A tile and slab shared by the frames that take
    it, a missing neighbour frame neither copied nor multiplied; bias, emb
    and residual in float32, one rounding, 16-byte stores, the tiles' column
    sums of the rounded y added by a deterministic second pass.
    """
    _no_grad_inputs("temporal_conv_fused", x, kernel, bias, emb, residual)
    if x.device.type == "cpu":
        return temporal_conv_fused_plain(x, kernel, bias, emb, residual, want_stats)
    return _temporal_conv_launch("temporal_conv_fused", x, kernel, bias, emb, residual,
                                 want_stats)


def _temporal_conv_launch(what: str, x, kernel, bias, emb, residual, want_stats):
    """K2's launch (`v2a_temporal_conv3`) on x's own memory, counted as
    `launches[what]`: K2's, K11's and K15's wrappers on a CUDA tensor."""
    b, f, s, c = _fold(x)
    if tuple(kernel.shape) != (3, c, c):
        raise ValueError(f"temporal kernel must be (3, C, C), got {tuple(kernel.shape)}")
    if c % 64:
        raise ValueError(f"K2 needs C % 64 == 0, got {c}")
    w2d = kernel.to(x.dtype).reshape(3 * c, c).contiguous()
    bias32 = bias.float().contiguous()
    emb32 = None
    if emb is not None:
        emb32 = emb.reshape(b, c).float().contiguous()
    res = None
    if residual is not None:
        res = residual.expand(x.shape).to(x.dtype).contiguous()
    _check_cuda(x, w2d, bias32, emb32, res)
    y = torch.empty_like(x)
    partial, stats = _stats_buffers(x, b * f, _tconv_tiles(x, b, f, s, c), c, want_stats)
    fn = _lib("temporal_conv", "v2a_temporal_conv3", 8, 5)
    with torch.cuda.device(x.device):
        rc = fn(
            _ptr(x), _ptr(w2d), _ptr(bias32), _ptr(emb32), _ptr(res), _ptr(y),
            _ptr(partial), _ptr(stats), b, f, s, c, _DTYPE_CODE[x.dtype], _stream(x),
        )
    _raise_on(rc, what)
    launches[what] += 1
    return (y, stats.reshape(b, f, 2, c)) if want_stats else y


class TemporalConvPlan(NamedTuple):
    """One bf16 K2 or K4b launch: pixels per tile (128 with sixteen warps,
    else eight), consecutive frames per CTA, output channels per CTA, pixel
    tiles per (b, f) slab, CTAs in the grid and shared memory per CTA in
    bytes."""
    pixels: int
    frames: int
    nc: int
    tiles: int
    grid: int
    smem: int


_TCONV_STAGES = 3  # the ring of a step's A tiles and three weight slabs
# (pixels, frames) a CTA, from the most work to the least (P * T, frame
# pairs first at a tie)
_TCONV_TILES = ((128, 2), (64, 2), (128, 1), (32, 2), (64, 1), (16, 2), (32, 1), (16, 1))


@functools.lru_cache(maxsize=None)
def temporal_conv_plan(b: int, f: int, s: int, c: int) -> TemporalConvPlan:
    """The launch K2's and K4b's bf16 body makes over B x F frames of s
    (interior) pixels x c channels (csrc/temporal_conv.cu, whose `plan_of`
    computes the same; `temporal_conv_plan_of_kernel` reads it back). A CTA
    owns a flat range of P pixels of T consecutive frames of one sample x NC
    output channels (128, or 64 where 128 does not divide C); its shared
    memory holds a 3-stage ring of a step's T + 2 (P x 32) A tiles and three
    (32 x NC) weight slabs (the epilogue's T (P x NC) tiles and their column
    sums alias it). Of (P, T) in `_TCONV_TILES` order, a larger P only where
    it needs fewer tiles than half of it, the first whose grid has a CTA per
    SM (`HOPPER_SMS`), else (16, 1) (the most CTAs)."""
    if c % 64:
        raise ValueError(f"K2 needs C % 64 == 0, got {c}")
    nc = 128 if c % 128 == 0 else 64
    plan = None
    for p, t in _TCONV_TILES:
        tiles = -(-s // p)
        if p > 16 and tiles >= -(-s // (p // 2)):
            continue
        ring = _TCONV_STAGES * (3 * _HOP_KSTEP * nc * 2 + (t + 2) * p * 64) + 8 * _TCONV_STAGES
        smem = _TMA_ALIGN_PAD + max(ring, t * (p * nc * 2 + 4 * 2 * nc * 4))
        plan = TemporalConvPlan(p, t, nc, tiles, b * -(-f // t) * tiles * (c // nc), smem)
        if plan.grid >= HOPPER_SMS:
            break
    return plan


def temporal_conv_plan_of_kernel(b: int, f: int, s: int, c: int) -> TemporalConvPlan:
    """The plan csrc/temporal_conv.cu's own `plan_of` makes (needs the built
    library, so the card), as a `TemporalConvPlan`."""
    fn = _build.load("temporal_conv").v2a_temporal_conv_plan
    fn.argtypes = [_I] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = _I
    out = (ctypes.c_longlong * 6)()
    _raise_on(fn(b, f, s, c, out), "v2a_temporal_conv_plan")
    return TemporalConvPlan(*(int(v) for v in out))


def _tconv_tiles(x: torch.Tensor, b: int, f: int, s: int, c: int) -> int:
    """Pixel tiles per slab of a K2 / K4b launch: the plan's for bf16, the
    float32 body's 64-pixel tiles."""
    return temporal_conv_plan(b, f, s, c).tiles if x.dtype == torch.bfloat16 else -(-s // 64)


def temporal_conv_reference(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    emb: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Float32 reference (`v2a_tpu/ops/resblock_kernels.py:418`): zero-padded
    3-tap conv over frames with full channel mixing, weights unrounded."""
    b, f, s, c = _fold(x)
    xp = F.pad(x.reshape(b, f, s, c).float(), (0, 0, 0, 0, 1, 1))
    k = kernel.float()
    y = sum(xp[:, t:t + f] @ k[t] for t in range(k.shape[0]))
    y = y + bias.float()
    if emb is not None:
        y = y + emb.reshape(b, 1, 1, c).float()
    if residual is not None:
        y = y + residual.expand(x.shape).reshape(b, f, s, c).float()
    return y.reshape(x.shape).to(x.dtype)


# -- the padded stream ------------------------------------------------------------


def padded_hw(h: int, w: int) -> Tuple[int, int]:
    """(Hp, Wp) of the padded-stream layout for an (H, W) interior: one halo
    row each side, the width rounded up to a multiple of 8 (16-byte rows in
    bf16) (`v2a_tpu/ops/resblock_kernels.py:784`)."""
    return h + 2, ((w + 2 + 7) // 8) * 8


# The JAX package's rule for where it runs K3 and where K4a + K4b
# (`v2a_tpu/ops/resblock_kernels.py:1890`, with its defaults MEGA_MIN_M 256
# and no tap join). Its budget is the TPU's VMEM, not anything on the H100:
# the port keeps the rule only so that it launches what the JAX package
# launches. The CUDA kernels pick their own tiles.
MEGA_MIN_M = 256
MEGA_VMEM_BUDGET = 13 * 1024 * 1024


def conv_tconv_band_rows(h: int, w: int, wp: int, cins, d: int, frames: int,
                         has_res: bool = True, skip_cins=()) -> int:
    """The TPU mega-kernel's band height at this shape, or 0 where the JAX
    package runs K4a + K4b instead of K3."""
    weights = (sum(9 * c * d * 2 for c in cins) + 3 * d * d * 2
               + sum(c * d * 2 for c in skip_cins))

    def cost(t):
        win = sum(2 * frames * (t + 2) * wp * c * 2 for c in cins)
        out = 2 * frames * t * wp * d * 2
        res = out if has_res else 0
        skip = sum(2 * frames * t * wp * c * 2 for c in skip_cins)
        yc = frames * t * w * d * 2
        acc = frames * t * w * d * 4
        ftmp = (t + 2) * wp * max(cins) * 4 + t * w * d * 4
        return weights + win + out + res + skip + yc + acc + ftmp

    best = 0
    for t in range(1, h + 1):
        if h % t == 0 and cost(t) <= MEGA_VMEM_BUDGET:
            best = t
    return 0 if best * w < MEGA_MIN_M else best


def _place(y: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """(..., H, W, D) interior -> (..., Hp, Wp, D) padded stream with zero pad
    cols and NaN pad rows (the contract lets pad rows hold anything; NaN
    makes a consumer that reads them show)."""
    h, w = y.shape[-3], y.shape[-2]
    out = y.new_zeros(y.shape[:-3] + (hp, wp, y.shape[-1]))
    out[..., 1:h + 1, 1:w + 1, :] = y
    out[..., 0, :, :] = float("nan")
    out[..., h + 1:, :, :] = float("nan")
    return out


def _interior(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """The interior of a padded stream (..., Hp, Wp, C), by index ranges."""
    h, w = hw
    return x[..., 1:h + 1, 1:w + 1, :]


def _affine32(a, b, rows: int, c: int):
    if a is None or b is None:
        raise ValueError("the padded-stream conv needs the affine a and b")
    if tuple(a.shape) != (rows, c) or tuple(b.shape) != (rows, c):
        raise ValueError(f"affine must be {(rows, c)}, got {tuple(a.shape)}, {tuple(b.shape)}")
    return a.float().contiguous(), b.float().contiguous()


# -- K4a: fused affine (+SiLU) 3x3 conv over a padded stream -------------------


def fused_affine_conv3x3_padded_plain(parts, bias: torch.Tensor, hw: Tuple[int, int],
                                      silu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K4a: per part the activation of the interior
    in float32, rounded to x.dtype, zero halo after it; every part's conv in
    one float32 sum, + bias, rounded once."""
    x0 = parts[0][0]
    hp, wp = x0.shape[1], x0.shape[2]
    acc = None
    for x, kernel, a, b in parts:
        xa = _act(_interior(x, hw), a, b, silu).float().permute(0, 3, 1, 2)
        wk = kernel.to(x.dtype).float().permute(3, 2, 0, 1)
        y = F.conv2d(xa, wk, padding=1)
        acc = y if acc is None else acc + y
    y = (acc.permute(0, 2, 3, 1) + bias.float()).to(x0.dtype)
    return _place(y, hp, wp)


def fused_affine_conv3x3_padded(parts, bias: torch.Tensor, hw: Tuple[int, int],
                                silu: bool = True) -> torch.Tensor:
    """y = sum_i conv3x3_same(mask(silu(a_i*x_i + b_i))) + bias over a padded
    stream (`v2a_tpu/ops/resblock_kernels.py:902`).

    parts: one or two (x (N, Hp, Wp, C_i), kernel (3, 3, C_i, D), a, b
    (N, C_i) float32) tuples, the channel parts of the up path's
    unconcatenated (h, skip) pair; silu=False applies the affine alone.
    hw: the interior (H, W). Returns (N, Hp, Wp, D) in x.dtype: the interior
    and zero pad cols; pad rows are left unwritten.

    Kernel note (csrc/affine_conv3x3.cu): bound by operations at the
    path's shapes. K1's bf16 body and plan (`affine_conv_plan` over the
    parts' summed C): the window of each 32-channel chunk comes by cp.async
    from the padded rows with the interior test as its zero-fill predicate
    (pad values are never loaded), activated once in place, the nine taps
    read at shifted ldmatrix rows into mma.sync; the step loop walks part
    0's chunks, then part 1's, into one float32 accumulator, each part's
    weight slabs by TMA through its own tensor map; bias, one rounding,
    16-byte stores at padded (h+1, w+1), the edge tiles also writing the
    zero pad cols. With one part it is bit-equal to K1 on the interior. A
    part's C is zero-extended to a multiple of 32 (`widen_channels`: the
    6-channel entry conv).
    """
    _no_grad_inputs("fused_affine_conv3x3_padded", bias, *_parts_tensors(parts))
    x0 = parts[0][0]
    if x0.device.type == "cpu":
        return fused_affine_conv3x3_padded_plain(parts, bias, hw, silu)
    h, w = hw
    hp, wp = padded_hw(h, w)
    n, d = x0.shape[0], parts[0][1].shape[-1]
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"K4a takes one or two parts, got {len(parts)}")
    if d % 64:
        raise ValueError(f"K4a needs D % 64 == 0, got {d}")
    args, cins = [], []
    for part in parts:
        x, kernel = part[:2]
        c = x.shape[-1]
        if tuple(x.shape) != (n, hp, wp, c) or x.dtype != x0.dtype:
            raise ValueError(f"part {tuple(x.shape)} {x.dtype} vs padded {(n, hp, wp)}")
        if tuple(kernel.shape) != (3, 3, c, d):
            raise ValueError(f"kernel {tuple(kernel.shape)} vs C={c}")
        x, kernel, a, b = widen_channels(*part)
        c = x.shape[-1]
        a32, b32 = _affine32(a, b, n, c)
        w2d = kernel.to(x.dtype).reshape(9 * c, d).contiguous()
        _check_cuda(x, w2d, a32, b32)
        args += [x, a32, b32, w2d]
        cins.append(c)
    if len(parts) == 1:
        args += [None] * 4
        cins.append(0)
    bias32 = bias.float().contiguous()
    _check_cuda(x0, bias32)
    plan = affine_conv_plan(n, h, w, sum(cins), d)
    y = torch.empty((n, hp, wp, d), dtype=x0.dtype, device=x0.device)
    fn = _lib("affine_conv3x3", "v2a_affine_conv3x3_padded", 10, 10)
    with torch.cuda.device(x0.device):
        rc = fn(*[_ptr(t) for t in args], _ptr(bias32), _ptr(y), n, h, w, wp, cins[0],
                cins[1], d, int(silu), plan.pixels, _DTYPE_CODE[x0.dtype], _stream(x0))
    _raise_on(rc, "fused_affine_conv3x3_padded")
    launches["fused_affine_conv3x3_padded"] += 1
    return y


# -- K4b: temporal conv over a padded stream, with the skip fold ------------------


def temporal_conv_padded_plain(x, kernel, bias, hw, emb=None, residual=None,
                               skip_parts=None, skip_bias=None, want_stats=False):
    """Plain PyTorch version of K4b on the interior: the taps in float32 from
    x.dtype operands, + (bias + emb), + the skip parts' 1x1 products,
    + skip bias, + residual, rounded once; stats from the rounded interior."""
    h, w = hw
    b, f, hp, wp, c = x.shape
    dt = x.dtype
    wt = kernel.to(dt).float()
    xp = F.pad(_interior(x, hw).float().reshape(b, f, h * w, c), (0, 0, 0, 0, 1, 1))
    y = xp[:, 1:f + 1] @ wt[1] + xp[:, 0:f] @ wt[0] + xp[:, 2:f + 2] @ wt[2]
    off = bias.float()
    if emb is not None:
        off = off + emb.reshape(b, 1, 1, c).float()
    y = y + off
    for xs, ks in skip_parts or ():
        cs = xs.shape[-1]
        xi = _interior(xs, hw).float().reshape(b, f, h * w, cs)
        y = y + xi @ ks.reshape(cs, c).to(dt).float()
    if skip_parts:
        y = y + skip_bias.float()
    if residual is not None:
        y = y + _interior(residual, hw).to(dt).float().reshape(b, f, h * w, c)
    yr = y.to(dt)
    out = _place(yr.reshape(b, f, h, w, c), hp, wp)
    if want_stats:
        yf = yr.float()
        return out, torch.stack([yf.sum(2), (yf * yf).sum(2)], dim=2)
    return out


def _skip_args(skip_parts, skip_bias, lead, c: int, dt):
    """[(xs, k2d, C_s)] * 2 (missing parts as (None, None, 0)) and the
    float32 skip bias, checked."""
    skip_parts = list(skip_parts or ())
    if len(skip_parts) > 2:
        raise ValueError(f"the skip fold takes at most two parts, got {len(skip_parts)}")
    if skip_parts and skip_bias is None:
        raise ValueError("the skip fold needs its bias")
    out = []
    for xs, ks in skip_parts:
        cs = xs.shape[-1]
        if tuple(xs.shape[:-1]) != tuple(lead) or xs.dtype != dt or cs % 32:
            raise ValueError(f"skip part {tuple(xs.shape)} {xs.dtype} vs {tuple(lead)} {dt}")
        if ks.numel() != cs * c:
            raise ValueError(f"skip kernel {tuple(ks.shape)} vs ({cs}, {c})")
        out.append((xs, ks.reshape(cs, c).to(dt).contiguous(), cs))
    out += [(None, None, 0)] * (2 - len(out))
    sb32 = skip_bias.float().contiguous() if skip_parts else None
    return out, sb32


def temporal_conv_padded(x, kernel, bias, hw, emb=None, residual=None, skip_parts=None,
                         skip_bias=None, want_stats=False):
    """The 3-tap temporal conv on a padded stream
    (`v2a_tpu/ops/resblock_kernels.py:1090`): y = taps(x) + bias [+ emb]
    [+ sum_s x_s @ K_s + skip_bias] [+ residual] on the interior, pad cols
    zero, pad rows unwritten.

    x: (B, F, Hp, Wp, C); kernel (3, C, C); bias (C,); emb optional (B, C);
    residual optional, a padded stream like x; skip_parts optional, up to
    two (x_s (B, F, Hp, Wp, C_s), kernel (C_s, C) or (1, 1, C_s, C)) pairs:
    the ResBlock's 1x1 skip projection, folded in so that the projected
    residual never reaches device memory. Returns y [, stats (B, F, 2, C)
    float32, the exact interior sum / sum of squares of the rounded y].

    Kernel note (csrc/temporal_conv.cu): bound by operations, narrowly
    (from C = 256 on). K2's bf16 body and plan (`temporal_conv_plan` over B x
    F frames of H*W interior pixels): the A tiles come by cp.async from the
    interior's padded rows (pad values are never loaded), the skip parts are
    further steps of the same float32 accumulators, each part's weight slabs
    by TMA through its own tensor map; the pixels at w = 0 and w = W - 1
    also write the zero pad cols. With no skip part it is bit-equal to K2 on
    a padded copy of K2's input.
    """
    _no_grad_inputs("temporal_conv_padded", x, kernel, bias, emb, residual, skip_bias,
                    *_parts_tensors(skip_parts or ()))
    if x.device.type == "cpu":
        return temporal_conv_padded_plain(x, kernel, bias, hw, emb, residual, skip_parts,
                                          skip_bias, want_stats)
    h, w = hw
    b, f, hp, wp, c = x.shape
    if (hp, wp) != padded_hw(h, w):
        raise ValueError(f"stream {tuple(x.shape)} vs interior {hw}")
    if tuple(kernel.shape) != (3, c, c) or c % 64:
        raise ValueError(f"temporal kernel {tuple(kernel.shape)} vs C={c} (C % 64 == 0)")
    w2d = kernel.to(x.dtype).reshape(3 * c, c).contiguous()
    bias32 = bias.float().contiguous()
    emb32 = None if emb is None else emb.reshape(b, c).float().contiguous()
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype} vs {tuple(x.shape)}")
    skips, sb32 = _skip_args(skip_parts, skip_bias, x.shape[:4], c, x.dtype)
    _check_cuda(x, w2d, bias32, emb32, residual, sb32, *[t for s in skips for t in s[:2]])
    y = torch.empty_like(x)
    partial, stats = _stats_buffers(x, b * f, _tconv_tiles(x, b, f, h * w, c), c, want_stats)
    fn = _lib("temporal_conv", "v2a_temporal_conv_padded", 13, 9)
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(w2d), _ptr(bias32), _ptr(emb32), _ptr(residual),
                _ptr(skips[0][0]), _ptr(skips[0][1]), _ptr(skips[1][0]), _ptr(skips[1][1]),
                _ptr(sb32), _ptr(y), _ptr(partial), _ptr(stats), b, f, h, w, wp, c,
                skips[0][2], skips[1][2], _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "temporal_conv_padded")
    launches["temporal_conv_padded"] += 1
    return (y, stats.reshape(b, f, 2, c)) if want_stats else y


# -- K3: K4a then K4b in one pass --------------------------------------------------


def fused_conv_tconv_padded_plain(parts, kbias, tkernel, tbias, hw, emb=None, residual=None,
                                  skip_parts=None, skip_bias=None, silu=True, want_stats=False):
    """Plain PyTorch version of K3: K4a's plain version, then K4b's, which is
    the JAX package's own definition of what K3 computes (the conv output is
    rounded to x.dtype before the temporal taps)."""
    b, f, hp, wp = parts[0][0].shape[:4]
    flat = [(x.reshape(b * f, hp, wp, x.shape[-1]), k, a, bb) for x, k, a, bb in parts]
    y = fused_affine_conv3x3_padded_plain(flat, kbias, hw, silu)
    return temporal_conv_padded_plain(y.reshape(b, f, hp, wp, y.shape[-1]), tkernel, tbias, hw,
                                      emb, residual, skip_parts, skip_bias, want_stats)


# -- the tile plan of K3, K12 and K13's shared mainloop (csrc/conv_tconv_hopper.cuh) --

HOPPER_SMS = 132  # the H100 SXM's streaming multiprocessors
HOPPER_SMEM = 232448  # shared memory a CTA can use
_HOP_STAGES = 3  # the weight-slab ring (the window ring has 3 too)
_HOP_SUBS = 3  # 32-deep products per pipeline step
_HOP_KSTEP = 32  # channels per product
_HOP_MAX_CLUSTER = 8
# what a kernel with a TMA weight ring (K1, K14) adds to its shared memory to
# align a 128-byte aligned base to the 128-byte swizzle's period
# (`hop::ALIGN_PAD`)
_TMA_ALIGN_PAD = 1024 - 128


class ConvTconvPlan(NamedTuple):
    """One launch of K3, K12 or K13: pixels per tile, CTAs per cluster (along D),
    weight-ring stages, CTAs in the grid, pixel tiles per sample-frame and
    shared memory per CTA in bytes."""
    pixels: int
    cluster: int
    stages: int
    grid: int
    tiles: int
    smem: int


def _hop_tile(h: int, w: int, p: int) -> Tuple[int, int, int]:
    """(rows, cols, tiles) of a P-pixel tile over an (H, W) interior, as
    `hop::tile_of`: 8 cols (4 at P=16, W where narrower), P // cols rows."""
    tw = min(w, 8 if p >= 32 else 4)
    th = p // tw
    return th, tw, -(-h // th) * -(-w // tw)


def conv_tconv_plan(b: int, f: int, h: int, w: int, d: int, ring: bool = False,
                    tma: bool = False) -> ConvTconvPlan:
    """The launch K3 and K13 (`ring=False`: the conv output of all F frames
    held) or K12 (`ring=True`: a 3-frame ring) make at this shape; `tma`
    (K13): its copies by TMA, whose ring stages align to the swizzles and
    whose mbarriers take up to 2.6 KB more (the same plan at every release
    shape). The cluster splits
    D into slices of 128 channels (64 where 128 does not divide D); of the
    pixel tiles 64, 32 and 16 whose shared memory fits a CTA, the largest
    whose grid has a CTA per SM, else the smallest (the most CTAs)."""
    nc = 128 if d % 128 == 0 else 64
    cluster = d // nc
    if d % 64 or cluster > _HOP_MAX_CLUSTER:
        raise ValueError(f"K3 / K12 need D % 64 == 0 and D / {nc} <= {_HOP_MAX_CLUSTER}, got D={d}")
    slots = 3 if ring else f
    fits = []
    for p in (64, 32, 16):
        th, tw, tiles = _hop_tile(h, w, p)
        # 3 windows with their chunk's a and b (TMA: 512-byte aligned), or 2
        # steps of temporal A tiles
        stage = (th + 2) * (tw + 2) * _HOP_KSTEP * 2 + 2 * _HOP_KSTEP * 4
        if tma:
            stage = -(-stage // 512) * 512
        window = max(3 * stage, 2 * _HOP_SUBS * p * _HOP_KSTEP * 2)
        smem = (slots * p * nc * 2 + _HOP_STAGES * _HOP_SUBS * _HOP_KSTEP * nc * 2 + window
                + (2 if p >= 32 else 1) * 2 * nc * 4)
        if tma:  # the base aligned to 1024 bytes, then 6 mbarriers
            smem += 1024 + 8 * 6
        if smem <= HOPPER_SMEM:
            fits.append(ConvTconvPlan(p, cluster, _HOP_STAGES, b * tiles * cluster, tiles, smem))
    if not fits:
        raise ValueError(f"no pixel tile of K3 / K12 fits shared memory at F={f}, D={d}")
    return next((pl for pl in fits if pl.grid >= HOPPER_SMS), fits[-1])


def fused_conv_tconv_padded(parts, kbias, tkernel, tbias, hw, emb=None, residual=None,
                            skip_parts=None, skip_bias=None, silu=True, want_stats=False,
                            conv_out=None):
    """The whole padded-stream PseudoConv3d in one kernel
    (`v2a_tpu/ops/resblock_kernels.py:1978`): K4a over one or two parts
    (x (B, F, Hp, Wp, C_i), kernel (3, 3, C_i, D), a, b (B*F, C_i)), its
    output rounded to x.dtype, then K4b with the same emb / residual / skip
    fold / statistics. Returns (B, F, Hp, Wp, D) [, stats (B, F, 2, D)].
    `conv_out` (optional, a (B, F, Hp, Wp, D) tensor of x.dtype): receives
    the kernel's own rounded conv half in its interior, so that a check can
    hold each rounding on its own.

    Kernel note (csrc/conv_tconv_padded.cu, csrc/conv_tconv_hopper.cuh):
    bound by operations (6.99 ms of bound per B=8 release forward). The
    temporal taps mix all D channels of three frames, so a cluster of D/128
    CTAs owns a pixel tile of one sample for ALL frames, each CTA its 128
    conv channels of every frame in shared memory (rounded, never stored to
    device memory); the temporal GEMM reads the other ranks' slices through
    distributed shared memory. Tensor-core products (mma.sync) fed by
    cp.async rings, the activation applied once per element of a staged
    window and read by the nine taps at shifted rows; the tile plan
    (`conv_tconv_plan`) keeps 64-row tiles and fills the card at B=1.
    """
    _no_grad_inputs("fused_conv_tconv_padded", kbias, tkernel, tbias, emb, residual, skip_bias,
                    *_parts_tensors(parts), *_parts_tensors(skip_parts or ()))
    x0 = parts[0][0]
    if x0.device.type == "cpu":
        _plain_conv_out(conv_out, parts, kbias, hw, silu)
        return fused_conv_tconv_padded_plain(parts, kbias, tkernel, tbias, hw, emb, residual,
                                             skip_parts, skip_bias, silu, want_stats)
    a = _conv_tconv_args("fused_conv_tconv_padded", parts, kbias, tkernel, tbias, hw, emb,
                         residual, skip_parts, skip_bias)
    b, f, _, _, d = a["out_shape"]
    plan = conv_tconv_plan(b, f, hw[0], hw[1], d)
    scratch = _conv_out_buffer(conv_out, a)
    partial, stats = _stats_buffers(x0, b * f, plan.tiles, d, want_stats)
    fn = _lib("conv_tconv_padded", "v2a_conv_tconv_padded", 22, 13)
    with torch.cuda.device(x0.device):
        rc = fn(*a["ptrs"], _ptr(a["y"]), _ptr(scratch), _ptr(partial), _ptr(stats),
                *a["ints"], plan.pixels, int(silu), _DTYPE_CODE[a["dt"]], _stream(x0))
    _raise_on(rc, "fused_conv_tconv_padded")
    launches["fused_conv_tconv_padded"] += 1
    return (a["y"], stats.reshape(b, f, 2, d)) if want_stats else a["y"]


def _plain_conv_out(conv_out, parts, kbias, hw, silu) -> None:
    """On the CPU: K4a's plain conv half into conv_out's interior."""
    if conv_out is None:
        return
    b, f, hp, wp = parts[0][0].shape[:4]
    flat = [(x.reshape(b * f, hp, wp, x.shape[-1]), k, a, bb) for x, k, a, bb in parts]
    y = fused_affine_conv3x3_padded_plain(flat, kbias, hw, silu)
    _interior(conv_out, hw).copy_(_interior(y, hw).reshape(_interior(conv_out, hw).shape))


def _conv_out_buffer(conv_out, a):
    """conv_out checked, or (float32, whose conv half goes through device
    memory) a scratch stream; None on the bf16 path without one."""
    if conv_out is not None:
        if tuple(conv_out.shape) != a["out_shape"] or conv_out.dtype != a["dt"]:
            raise ValueError(f"conv_out {tuple(conv_out.shape)} {conv_out.dtype} vs "
                             f"{a['out_shape']} {a['dt']}")
        _check_cuda(conv_out)
        return conv_out
    if a["dt"] == torch.float32:
        return torch.empty(a["out_shape"], dtype=a["dt"], device=a["y"].device)
    return None


def _conv_tconv_args(what: str, parts, kbias, tkernel, tbias, hw, emb, residual, skip_parts,
                     skip_bias, skips_allowed: bool = True):
    """Checks the arguments K3, K12 and K13 share and prepares them: the
    pointers up to `sbias` (K12: up to `res`) with the tensors behind them,
    a fresh y, the ints from B to the skip widths (K12: to D)."""
    x0 = parts[0][0]
    h, w = hw
    hp, wp = padded_hw(h, w)
    b, f = x0.shape[:2]
    d = parts[0][1].shape[-1]
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"{what} takes one or two parts, got {len(parts)}")
    if d % 64 or tuple(tkernel.shape) != (3, d, d):
        raise ValueError(f"{what} needs D % 64 == 0 and a (3, D, D) temporal kernel, got D={d}")
    args, cins = [], []
    for part in parts:
        x, kernel = part[:2]
        c = x.shape[-1]
        if tuple(x.shape) != (b, f, hp, wp, c) or x.dtype != x0.dtype:
            raise ValueError(f"part {tuple(x.shape)} {x.dtype} vs padded {(b, f, hp, wp)}")
        if tuple(kernel.shape) != (3, 3, c, d):
            raise ValueError(f"kernel {tuple(kernel.shape)} vs C={c}")
        x, kernel, a, bb = widen_channels(*part)
        c = x.shape[-1]
        a32, b32 = _affine32(a, bb, b * f, c)
        w2d = kernel.to(x.dtype).reshape(9 * c, d).contiguous()
        _check_cuda(x, w2d, a32, b32)
        args += [x, a32, b32, w2d]
        cins.append(c)
    if len(parts) == 1:
        args += [None] * 4
        cins.append(0)
    dt = x0.dtype
    kb32, tb32 = kbias.float().contiguous(), tbias.float().contiguous()
    tw = tkernel.to(dt).reshape(3 * d, d).contiguous()
    emb32 = None if emb is None else emb.reshape(b, d).float().contiguous()
    out_shape = (b, f, hp, wp, d)
    if residual is not None and (tuple(residual.shape) != out_shape or residual.dtype != dt):
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype} vs {out_shape}")
    args += [kb32, tw, tb32, emb32, residual]
    ints = [b, f, h, w, wp, cins[0], cins[1], d]
    if skips_allowed:
        skips, sb32 = _skip_args(skip_parts, skip_bias, out_shape[:4], d, dt)
        args += [skips[0][0], skips[0][1], skips[1][0], skips[1][1], sb32]
        ints += [skips[0][2], skips[1][2]]
    _check_cuda(x0, *[t for t in args[8:] if t is not None])
    y = torch.empty(out_shape, dtype=dt, device=x0.device)
    # `tensors` keeps the converted weights alive until the launch: freed
    # earlier, their memory would go to the launch's own buffers
    return dict(ptrs=[_ptr(t) for t in args], tensors=args, ints=ints, y=y, dt=dt,
                out_shape=out_shape)


# -- K13: K3 with its copies issued by TMA ----------------------------------------


def fused_conv_tconv_dma_plain(parts, kbias, tkernel, tbias, hw, emb=None, residual=None,
                               skip_parts=None, skip_bias=None, silu=True, want_stats=False,
                               tile_h=None):
    """Plain PyTorch version of K13: K3's (the contract is the same; the
    band height `tile_h` does not change the result)."""
    return fused_conv_tconv_padded_plain(parts, kbias, tkernel, tbias, hw, emb, residual,
                                         skip_parts, skip_bias, silu, want_stats)


def _dma_checks(parts, hw, d: int, has_res: bool, skip_parts, tile_h) -> None:
    """The JAX wrapper's guards (`v2a_tpu/ops/resblock_kernels.py:2400-2406`)."""
    h, w = hw
    wp = padded_hw(h, w)[1]
    tp = tile_h or conv_tconv_band_rows(h, w, wp, [x.shape[-1] for x, *_ in parts], d,
                                        parts[0][0].shape[1], has_res=has_res,
                                        skip_cins=[x.shape[-1] for x, _ in skip_parts or ()])
    if not tp:
        raise ValueError("mega-kernel not viable at this shape")
    if h % tp:
        raise ValueError(f"tile_h {tp} must divide H={h}")


def fused_conv_tconv_dma(parts, kbias, tkernel, tbias, hw, emb=None, residual=None,
                         skip_parts=None, skip_bias=None, silu=True, want_stats=False,
                         tile_h=None):
    """`fused_conv_tconv_padded` (K3) with its copies issued by the Tensor
    Memory Accelerator (`v2a_tpu/ops/resblock_kernels.py:2377`): the same
    contract, arguments and outputs as K3, and K3's tile plan
    (`conv_tconv_plan(..., tma=True)`, the same at every release shape).
    Raises where the JAX wrapper raises: where
    `conv_tconv_band_rows` admits no band (without `tile_h`), or where
    `tile_h` does not divide H. `tile_h` is the TPU's band height; the
    card's output does not depend on it.

    Kernel note (csrc/conv_tconv_dma.cu, csrc/conv_tconv_hopper.cuh): bound
    by operations, as K3. K3's mainloop with the copy policy `Copy::tma`:
    one thread issues each window (a 4-D TMA box of the padded stream, its
    a and b by bulk copies) and each weight slab (2-D boxes), each ring
    stage completing on an mbarrier, where K3's threads issue cp.async; the
    swizzles TMA writes are the ones the mainloop reads. The products and
    their order are K3's, so K13 is bit-equal to K3.
    """
    _no_grad_inputs("fused_conv_tconv_dma", kbias, tkernel, tbias, emb, residual, skip_bias,
                    *_parts_tensors(parts), *_parts_tensors(skip_parts or ()))
    _dma_checks(parts, hw, parts[0][1].shape[-1], residual is not None, skip_parts, tile_h)
    x0 = parts[0][0]
    if x0.device.type == "cpu":
        return fused_conv_tconv_dma_plain(parts, kbias, tkernel, tbias, hw, emb, residual,
                                          skip_parts, skip_bias, silu, want_stats)
    a = _conv_tconv_args("fused_conv_tconv_dma", parts, kbias, tkernel, tbias, hw, emb, residual,
                         skip_parts, skip_bias)
    b, f, _, _, d = a["out_shape"]
    plan = conv_tconv_plan(b, f, hw[0], hw[1], d, tma=True)
    scratch = _conv_out_buffer(None, a)
    partial, stats = _stats_buffers(x0, b * f, plan.tiles, d, want_stats)
    fn = _lib("conv_tconv_dma", "v2a_conv_tconv_dma", 22, 13)
    with torch.cuda.device(x0.device):
        rc = fn(*a["ptrs"], _ptr(a["y"]), _ptr(scratch), _ptr(partial), _ptr(stats),
                *a["ints"], plan.pixels, int(silu), _DTYPE_CODE[a["dt"]], _stream(x0))
    _raise_on(rc, "fused_conv_tconv_dma")
    launches["fused_conv_tconv_dma"] += 1
    return (a["y"], stats.reshape(b, f, 2, d)) if want_stats else a["y"]


# -- K5: 2x nearest upsample + 3x3 conv as four low-res parity convs -------------

# for output parity p, the 3x3 rows di that land on low-res offset a
_UP_ROWS = (((0,), (1, 2)), ((0, 1), (2,)))


def upconv_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, D) -> the collapsed (2, 2, 2, 2, C, D) parity kernels
    [p][p'][a][b], each the sum of the 3x3 taps that land on low-res offset
    (a, b) for output parity (p, p'), summed in the kernel's own dtype in
    the JAX package's order (`v2a_tpu/ops/resblock_kernels.py:1345-1359`)."""
    blocks = []
    for p in range(2):
        for pp in range(2):
            for a in range(2):
                for b in range(2):
                    kk = None
                    for di in _UP_ROWS[p][a]:
                        for dj in _UP_ROWS[pp][b]:
                            kk = kernel[di, dj] if kk is None else kk + kernel[di, dj]
                    blocks.append(kk)
    return torch.stack(blocks).reshape((2, 2, 2, 2) + tuple(kernel.shape[2:]))


def fused_upconv3x3_padded_plain(x, kernel, bias, hw_lo, a=None, b=None, silu=False):
    """Plain PyTorch version of K5: the optional activation of the low-res
    interior, rounded to x.dtype, zero halo; per output parity a 2x2 conv with
    the collapsed weights (cast to x.dtype after the collapse) in float32,
    + bias, rounded once."""
    h, w = hw_lo
    n, c = x.shape[0], x.shape[-1]
    d = kernel.shape[-1]
    dt = x.dtype
    xz = F.pad(_act(_interior(x, hw_lo), a, b, silu).float(), (0, 0, 1, 1, 1, 1))
    xz = xz.permute(0, 3, 1, 2)
    wk = upconv_weights(kernel).to(dt).float()
    y = torch.empty((n, 2 * h, 2 * w, d), dtype=torch.float32, device=x.device)
    for p in range(2):
        for pp in range(2):
            yp = F.conv2d(xz[:, :, p:p + h + 1, pp:pp + w + 1], wk[p, pp].permute(3, 2, 0, 1))
            y[:, p::2, pp::2, :] = yp.permute(0, 2, 3, 1)
    return _place((y + bias.float()).to(dt), *padded_hw(2 * h, 2 * w))


def fused_upconv3x3_padded(x, kernel, bias, hw_lo, a=None, b=None, silu=False):
    """y = conv3x3_same(nearest_2x(act(x))) + bias from a low-res padded
    stream (`v2a_tpu/ops/resblock_kernels.py:1314`).

    x: (N, Hp_lo, Wp_lo, C); kernel (3, 3, C, D); bias (D,); a / b optional
    per-(N, C) affine (+ SiLU with `silu`). Returns the (N, Hp_hi, Wp_hi, D)
    padded stream at (2 H_lo, 2 W_lo): interior and zero pad cols written,
    pad rows not. The collapsed weights are summed in the kernel's dtype and
    then cast to x.dtype, as the JAX package does.

    Kernel note (csrc/affine_conv3x3.cu): bound by operations; K1's bf16
    body with K4a's padded addressing (one part) and the parity tap sets,
    with K1's plan over the low-res grid x 4 parities
    (`affine_conv_plan(..., up=True)`): a CTA owns a tile of low-res pixels
    for one output parity (p, p'); per 32-channel chunk the tile's window
    comes by cp.async (mode 0: one TMA box) with the interior test as the
    zero-fill predicate (pad values are never loaded) and is activated once
    in place; a step is one tap row a of the parity's 2x2 taps, its two
    weight slabs of the collapsed (16 C, D) weights by TMA, the window read
    at rows and cols shifted by (p + a, p' + b) into mma.sync: 16/36 of the
    upsampled conv's products, and the upsampled input never exists. Bias,
    one rounding, 16-byte stores at padded (2i + p + 1, 2j + p' + 1), the
    edge tiles also writing the zero pad cols. Parity plane (p, p') is
    bit-equal to K1 on x's interior with a 3x3 kernel holding
    upconv_weights(kernel)[p, p'] at taps (p + a, p' + b), zeros elsewhere.
    """
    _no_grad_inputs("fused_upconv3x3_padded", x, kernel, bias, a, b)
    if x.device.type == "cpu":
        return fused_upconv3x3_padded_plain(x, kernel, bias, hw_lo, a, b, silu)
    h, w = hw_lo
    hp, wp = padded_hw(h, w)
    hph, wph = padded_hw(2 * h, 2 * w)
    n, c = x.shape[0], x.shape[-1]
    d = kernel.shape[-1]
    if tuple(x.shape) != (n, hp, wp, c):
        raise ValueError(f"stream {tuple(x.shape)} vs interior {hw_lo}")
    if tuple(kernel.shape) != (3, 3, c, d) or c % 32 or d % 64:
        raise ValueError(f"kernel {tuple(kernel.shape)}: K5 needs C % 32 == 0, D % 64 == 0")
    a32 = b32 = None
    if a is not None or b is not None:
        a32, b32 = _affine32(a, b, n, c)
    w16 = upconv_weights(kernel).to(x.dtype).reshape(16 * c, d).contiguous()
    bias32 = bias.float().contiguous()
    _check_cuda(x, w16, bias32, a32, b32)
    plan = affine_conv_plan(n, h, w, c, d, up=True)
    y = torch.empty((n, hph, wph, d), dtype=x.dtype, device=x.device)
    mode = 0 if a32 is None else (2 if silu else 1)
    fn = _lib("affine_conv3x3", "v2a_upconv3x3_padded", 6, 10)
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(a32), _ptr(b32), _ptr(w16), _ptr(bias32), _ptr(y), n, h, w, wp,
                wph, c, d, mode, plan.pixels, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "fused_upconv3x3_padded")
    launches["fused_upconv3x3_padded"] += 1
    return y


# -- K8: stride-2 3x3 conv from a padded stream to one at half the size ---------


def _downconv_checks(x: torch.Tensor, hw: Tuple[int, int]) -> None:
    """The JAX wrapper's guards (`v2a_tpu/ops/resblock_kernels.py:1540-1546`)."""
    h, w = hw
    hp, wp = padded_hw(h, w)
    if x.shape[1] != hp or x.shape[2] != wp:
        raise ValueError(f"x {tuple(x.shape)} vs padded ({hp},{wp})")
    if h % 2 or w % 2 or wp % 2:
        raise ValueError("stride-2 conv needs even H, W, Wp")


def fused_downconv3x3_padded_plain(x, kernel, bias, hw, a=None, b=None, silu=False):
    """Plain PyTorch version of K8: the optional activation of the interior in
    float32, rounded to x.dtype (`_act`), zero halo after it (pads selected
    away, never read); then per tap the stride-2 product in float32, the
    nine summed in tap order, + bias, rounded once."""
    _downconv_checks(x, hw)
    h, w = hw
    dt = x.dtype
    xz = F.pad(_act(_interior(x, hw), a, b, silu).float(), (0, 0, 1, 1, 1, 1))
    wk = kernel.to(dt).float()
    acc = None
    for di in range(3):
        for dj in range(3):
            part = xz[:, di:di + h:2, dj:dj + w:2, :] @ wk[di, dj]
            acc = part if acc is None else acc + part
    return _place((acc + bias.float()).to(dt), *padded_hw(h // 2, w // 2))


def fused_downconv3x3_padded(x, kernel, bias, hw, a=None, b=None, silu=False):
    """y = conv3x3_stride2_same(act(x)) + bias between padded streams
    (`v2a_tpu/ops/resblock_kernels.py:1514`).

    x: (N, Hp, Wp, C) at the full resolution (pad rows may hold anything);
    kernel (3, 3, C, D); bias (D,); a / b optional per-(N, C) affine (+ SiLU
    with `silu`); hw: the full-size interior (H, W), both even. Returns the
    (N, Hp2, Wp2, D) padded stream at (H/2, W/2): the interior and zero pad
    cols written, pad rows not. The SAME halo is (1, 1) on both sides, as the
    JAX module's explicit padding.

    Kernel note (csrc/affine_conv3x3.cu): K1's bf16 body at stride 2 on
    K4a's padded addressing, with K1's plan over the output grid
    (`affine_conv_plan(..., stride=2)`): output pixel (i, j) is K1's SAME
    conv centred on interior (2i, 2j). Per 32-channel chunk a tile's
    (2th+1) x (2tw+1) input window comes by cp.async (the interior test as
    the zero-fill predicate: pad values are never loaded) into two
    column-parity planes, so each ldmatrix reads consecutive rows; weight
    slabs by TMA; K1's steps and epilogue, the edge tiles also writing the
    half-size zero pad cols. Its interior is bit-equal to K1 on x's interior
    at even pixels.
    """
    _no_grad_inputs("fused_downconv3x3_padded", x, kernel, bias, a, b)
    if x.device.type == "cpu":
        return fused_downconv3x3_padded_plain(x, kernel, bias, hw, a, b, silu)
    _downconv_checks(x, hw)
    h, w = hw
    wp = x.shape[2]
    hp2, wp2 = padded_hw(h // 2, w // 2)
    n, c = x.shape[0], x.shape[-1]
    d = kernel.shape[-1]
    if tuple(kernel.shape) != (3, 3, c, d) or c % 32 or d % 64:
        raise ValueError(f"kernel {tuple(kernel.shape)}: K8 needs C % 32 == 0, D % 64 == 0")
    a32 = b32 = None
    if a is not None or b is not None:
        a32, b32 = _affine32(a, b, n, c)
    w2d = kernel.to(x.dtype).reshape(9 * c, d).contiguous()
    bias32 = bias.float().contiguous()
    _check_cuda(x, w2d, bias32, a32, b32)
    plan = affine_conv_plan(n, h, w, c, d, stride=2)
    y = torch.empty((n, hp2, wp2, d), dtype=x.dtype, device=x.device)
    mode = 0 if a32 is None else (2 if silu else 1)
    fn = _lib("affine_conv3x3", "v2a_downconv3x3_padded", 6, 10)
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(a32), _ptr(b32), _ptr(w2d), _ptr(bias32), _ptr(y), n, h, w, wp,
                wp2, c, d, mode, plan.pixels, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "fused_downconv3x3_padded")
    launches["fused_downconv3x3_padded"] += 1
    return y


# -- K6: the weight gradient of the (affine+SiLU+) 3x3 conv --------------------

def _wgrad_checks(x: torch.Tensor, g: torch.Tensor, a, b, silu: bool) -> None:
    """The JAX wrapper's guards (`v2a_tpu/ops/resblock_kernels.py:3346-3356`)."""
    if tuple(g.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(f"g {tuple(g.shape)} vs x {tuple(x.shape)}")
    if silu and a is None:
        # a silu-without-affine call would return the plain-conv wgrad, the
        # gradient of the wrong function
        raise NotImplementedError(
            "wgrad_conv3x3: silu=True requires the (a, b) affine; pass a=ones, b=zeros for a "
            "bare-SiLU operand")
    if (a is None) != (b is None):
        raise ValueError("pass both a and b, or neither")


def wgrad_conv3x3_plain(
    x: torch.Tensor,
    g: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    silu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K6: the activation as `_act` computes it (float32,
    rounded to x.dtype), zero-padded AFTER the activation, then per tap the
    (C, D) product of the shifted activation with g, summed in float32."""
    _wgrad_checks(x, g, a, b, silu)
    n, h, w, c = x.shape
    d = g.shape[-1]
    s = F.pad(_act(x, a, b, silu).float(), (0, 0, 1, 1, 1, 1))
    gf = g.float().reshape(n * h * w, d)
    taps = [s[:, di:di + h, dj:dj + w, :].reshape(n * h * w, c).t() @ gf
            for di in range(3) for dj in range(3)]
    return torch.stack(taps).reshape(3, 3, c, d)


# csrc/wgrad_conv3x3.cu's CTA: 32 input x 128 output channels (64 where 128
# does not divide D), a 4-stage ring of (64-pixel g tile, window, a, b)
_WGRAD_CB, _WGRAD_STAGES = 32, 4
_HOPPER_BF16 = 989e12  # the H100 SXM's dense bf16 tensor-core rate, FLOP/s
_HOPPER_BYTES = 3.35e12  # its memory rate, bytes/s


class WgradPlan(NamedTuple):
    """One K6 launch: the pixel tile (rows, cols) of `hop::tile_of(H, W, 64)`,
    tiles over (N, H, W), chunks of `per_chunk` consecutive tiles (the last
    may be shorter), CTAs in the grid and shared memory per CTA in bytes."""
    tile_h: int
    tile_w: int
    tiles: int
    chunks: int
    per_chunk: int
    grid: int
    smem: int


def wgrad_plan(n: int, h: int, w: int, c: int, d: int) -> WgradPlan:
    """The launch K6 makes at this shape; it depends on the shape only, so
    two launches add the same partial sums in the same order. A CTA per (32
    input channels, 128 output channels (64 where 128 does not divide D),
    chunk of consecutive tiles). Of the chunk counts from the least that
    gives the grid a CTA per SM (`HOPPER_SMS`; fewer where there are fewer
    tiles) up to eight times it, whose grid still has a CTA per SM once the
    tiles are dealt out with no chunk empty, the one with the least
    modelled time, the fewest on a tie: whole waves of one CTA per SM times
    the tiles a chunk holds, at the card's bf16 peak per SM, plus the
    float32 partials written and read back by the second pass at its memory
    rate (one chunk writes dW directly). The products taken at the peak
    overstate the partials' share; the card's times are in PERF.md."""
    th, tw, per_image = _hop_tile(h, w, 64)
    tiles = n * per_image
    db = 128 if d % 128 == 0 else 64
    blocks = (c // _WGRAD_CB) * (d // db)
    stage = -(-(2 * 64 * db + (th + 2) * (tw + 2) * 64 + 8 * _WGRAD_CB) // 128) * 128
    tile_s = 2.0 * 64 * 9 * _WGRAD_CB * db * HOPPER_SMS / _HOPPER_BF16
    slab_s = 2 * 9 * c * d * 4 / _HOPPER_BYTES

    def chunked(k):  # (chunks, tiles per chunk), no chunk empty
        per = -(-tiles // k)
        return -(-tiles // per), per

    def modelled_s(k):
        chunks, per = chunked(k)
        waves = -(-blocks * chunks // HOPPER_SMS)
        return waves * per * tile_s + (chunks * slab_s if chunks > 1 else 0.0)

    lo = min(tiles, -(-HOPPER_SMS // blocks))
    full = min(HOPPER_SMS, blocks * tiles)  # the CTAs the grid needs (fewer tiles: all)
    ks = [k for k in range(lo, min(tiles, 8 * lo) + 1) if blocks * chunked(k)[0] >= full]
    k = min(ks or [tiles], key=lambda k: (modelled_s(k), k))
    chunks, per = chunked(k)
    return WgradPlan(th, tw, tiles, chunks, per, blocks * chunks, _WGRAD_STAGES * stage)


def wgrad_conv3x3(
    x: torch.Tensor,
    g: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    silu: bool = False,
) -> torch.Tensor:
    """dW of y = conv3x3_same(act(x)) with respect to its (3, 3, C, D) kernel
    (`v2a_tpu/ops/resblock_kernels.py:3329`).

    x: (N, H, W, C), the raw pre-norm input, bf16 or float32; g: (N, H, W, D)
    output cotangent in x's dtype; a, b: optional per-(N, C) float32 affine
    (None: the plain conv's wgrad); `silu` applies SiLU after it. Returns
    (3, 3, C, D) float32, HWIO, tap order di*3+dj.

    Kernel note (csrc/wgrad_conv3x3.cu): bound by operations; a GEMM with
    M = 9C, N = D and K = N*H*W pixels. A CTA of twelve warps owns all nine
    taps x 32 input x 128 output channels (64 where 128 does not divide D)
    and walks a chunk of 8x8 pixel tiles: per tile the raw window (with its
    one-pixel halo), a, b and the g tile come by cp.async into a 4-stage
    ring, the window is activated in place once (about 1.6 visits per
    element and 128 outputs, against 9 per 64 in the kernel this replaced)
    and the nine taps read it by ldmatrix at shifted rows into mma.sync
    m16n8k16. The TPU kernel's sequential
    accumulation across the grid becomes chunks of tiles (`wgrad_plan`)
    that write float32 partial sums, added in a fixed-order second pass
    (deterministic, no atomics).
    """
    _no_grad_inputs("wgrad_conv3x3", x, g, a, b)
    if x.device.type == "cpu":
        return wgrad_conv3x3_plain(x, g, a, b, silu)
    _wgrad_checks(x, g, a, b, silu)
    n, h, w, c = x.shape
    d = g.shape[-1]
    if c % 64 or d % 64:
        raise ValueError(f"K6 needs C % 64 == 0 and D % 64 == 0, got C={c} D={d}")
    if g.dtype != x.dtype:
        raise TypeError(f"g is {g.dtype}, x is {x.dtype}")
    a32 = b32 = None
    if a is not None:
        if tuple(a.shape) != (n, c) or tuple(b.shape) != (n, c):
            raise ValueError(f"affine must be (N, C) = {(n, c)}")
        a32 = a.float().contiguous()
        b32 = b.float().contiguous()
    _check_cuda(x, g, a32, b32)
    plan = wgrad_plan(n, h, w, c, d)
    out = torch.empty((3, 3, c, d), dtype=torch.float32, device=x.device)
    partial = None
    if plan.chunks > 1:
        partial = torch.empty((plan.chunks * 9 * c * d,), dtype=torch.float32, device=x.device)
    mode = 0 if a is None else (2 if silu else 1)
    fn = _lib("wgrad_conv3x3", "v2a_wgrad_conv3x3", 6, 9)
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(a32), _ptr(b32), _ptr(g), _ptr(partial), _ptr(out), n, h, w, c, d,
                plan.chunks, plan.per_chunk, mode, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "wgrad_conv3x3")
    launches["wgrad_conv3x3"] += 1
    return out


# -- K9: fused spatial attention on a padded stream ---------------------------------

def _attn_checks(x: torch.Tensor, hw: Tuple[int, int], num_head_channels: int) -> int:
    """The JAX wrapper's guards (`v2a_tpu/ops/resblock_kernels.py:2992-2999`);
    returns the head count."""
    hp, wp = padded_hw(*hw)
    if tuple(x.shape[1:3]) != (hp, wp):
        raise ValueError(f"x {tuple(x.shape)} vs padded ({hp},{wp})")
    c = x.shape[-1]
    if c % num_head_channels:
        raise ValueError(f"C={c} not divisible by ch={num_head_channels}")
    return c // num_head_channels


def _interior_mask(hw: Tuple[int, int], device) -> torch.Tensor:
    """(Hp*Wp,) bool: True at the interior token positions of a padded stream."""
    h, w = hw
    hp, wp = padded_hw(h, w)
    m = torch.zeros(hp, wp, dtype=torch.bool, device=device)
    m[1:h + 1, 1:w + 1] = True
    return m.reshape(hp * wp)


def spatial_attention_heads_plain(x, hw, a, b, wqkv, bqkv, num_head_channels: int):
    """The first half of K9's plain version: (xs, att), xs the stream with
    its pads selected to zero (N, Hp*Wp, C) and att the heads' outputs
    (N, Hp*Wp, C) in x.dtype, the projection's input."""
    heads = _attn_checks(x, hw, num_head_channels)
    n, hp, wp, c = x.shape
    m, ch, dt = hp * wp, num_head_channels, x.dtype
    inside = _interior_mask(hw, x.device)[None, :, None]
    xs = torch.where(inside, x.reshape(n, m, c), torch.zeros((), dtype=dt, device=x.device))
    xn = (xs.float() * a.float()[:, None, :] + b.float()[:, None, :]).to(dt)
    qkv = (xn.float() @ wqkv.to(dt).float() + bqkv.float()).to(dt)
    qkv = qkv.reshape(n, m, heads, 3 * ch).permute(0, 2, 1, 3).float()
    q, k, v = qkv[..., :ch], qkv[..., ch:2 * ch], qkv[..., 2 * ch:]
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    logits = (q @ k.transpose(-1, -2)) * (scale * scale)
    logits = logits + torch.where(inside[0, :, 0], 0.0, -1e30)
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = (ex / ex.sum(-1, keepdim=True)).to(dt)
    return xs, (probs.float() @ v).to(dt).permute(0, 2, 1, 3).reshape(n, m, c)


def fused_spatial_attention_padded_plain(x, hw, a, b, wqkv, bqkv, wproj, bproj,
                                         num_head_channels: int, want_stats: bool = False):
    """Plain PyTorch version of K9, rounding by rounding as the Pallas body
    (`v2a_tpu/ops/resblock_kernels.py:2871-2959`), over all Hp*Wp tokens:
    pads selected to zero; xn = x*a + b rounded; qkv = xn @ Wqkv + bqkv in
    float32, rounded; per head (legacy layout, head base 3*ch*head) the
    logits dot(q, k) in float32 times scale^2 AFTER the dot, pad keys masked
    with an additive -1e30, the row max and row sum over all keys, then the
    probabilities ex / sum rounded before P @ V, each head's output rounded;
    y = x + (att @ Wproj + bproj) in float32, pads selected to zero, rounded
    ONCE; statistics from the unrounded float32 y. Any head width that
    divides C and any token count, as the Pallas kernel.
    (The port's `SpatialAttentionBlock` instead scales q and k in the compute
    dtype, adds the residual in it, and takes statistics of the rounded sum.)"""
    n, hp, wp, c = x.shape
    xs, att = spatial_attention_heads_plain(x, hw, a, b, wqkv, bqkv, num_head_channels)
    proj = att.float() @ wproj.to(x.dtype).float() + bproj.float()
    inside = _interior_mask(hw, x.device)[None, :, None]
    y = torch.where(inside, xs.float() + proj, 0.0)
    out = y.to(x.dtype).reshape(n, hp, wp, c)
    if want_stats:
        return out, torch.stack([y.sum(1), (y * y).sum(1)], dim=1)
    return out


class AttentionGemmPlan(NamedTuple):
    """One bf16 GEMM of K9 (the QKV or the projection): interior tokens per
    tile (never two samples), output columns per CTA, warps per CTA, token
    tiles per sample, CTAs in the grid and shared memory per CTA in bytes."""
    tokens: int
    nc: int
    warps: int
    tiles: int
    grid: int
    smem: int


class AttentionPlan(NamedTuple):
    """The bf16 launches of K9 (csrc/spatial_attention_padded.cu): the QKV
    GEMM, the attention (a CTA per (tile of `queries`, head, sample), a warp
    per 16 queries, keys in chunks of `keys` through a double-buffered ring,
    the head's lanes in slices of `slice` lanes, `slices` of them; its grid
    and shared memory) and the projection GEMM (whose token tiles are the
    statistics' partial sums)."""
    qkv: AttentionGemmPlan
    queries: int
    keys: int
    slice: int
    slices: int
    warps: int
    grid: int
    smem: int
    proj: AttentionGemmPlan


_ATT_GEMM_ASTAGES = 4  # the GEMMs' token-row ring
_ATT_KEYS = 64  # keys per chunk


def _attention_gemm_plan(n: int, s: int, ldw: int) -> AttentionGemmPlan:
    """K9's GEMM over n samples of s tokens into ldw columns, as K1 picks
    its pixel tile: eight warps, NC = 128 where 128 divides ldw, else 64;
    of P = 64, 32, 16 (shared memory: 3 stages of a step's two weight
    slabs, 4 of its two chunks' P 64-byte token rows with their a, b; the
    epilogue's float32 P x (NC + 4) tile aliases them; two CTAs an SM), a
    larger one only where it needs fewer tiles than the next smaller, the
    largest whose grid has a CTA per SM, else 16. (128-token tiles with
    sixteen warps, one CTA an SM, were slower at the release shapes.)"""
    nc = 128 if ldw % 128 == 0 else 64
    fits = []
    for p in (64, 32, 16):
        tiles = -(-s // p)
        ring = (_HOP_STAGES * 2 * _HOP_KSTEP * nc * 2 + _ATT_GEMM_ASTAGES * 2 * (p * 64 + 256)
                + 8 * _HOP_STAGES)
        smem = _TMA_ALIGN_PAD + max(ring, p * (nc + 4) * 4)
        if smem <= HOPPER_SMEM and (p == 16 or tiles < -(-s // (p // 2))):
            fits.append(AttentionGemmPlan(p, nc, 8, tiles, n * tiles * -(-ldw // nc), smem))
    return next((pl for pl in fits if pl.grid >= HOPPER_SMS), fits[-1])


def attention_plan(n: int, h: int, w: int, c: int, ch: int) -> AttentionPlan:
    """The launches K9's bf16 body makes at this shape; it depends on the
    shape only. The attention's lane slice is the next of 32, 64, 128 up
    from the head width ch (128-wide slices past 128); its shared memory
    holds Q's slices and two K and two V tiles of 64 keys x the slice. Of
    128, 64, 32 and 16 queries a CTA (a warp per 16) whose shared memory
    fits, a larger one only where it needs fewer tiles than the next
    smaller, the most whose grid has a CTA per SM, else the fewest: a
    larger tile reads each K and V chunk for more queries."""
    if c % ch or c % 8:
        raise ValueError(f"K9 needs C % 8 == 0 and a head width that divides C, got C={c} ch={ch}")
    s = h * w
    cs = 32 if ch <= 32 else 64 if ch <= 64 else 128
    slices = -(-ch // cs)
    fits = []
    for q in (128, 64, 32, 16):
        smem = (slices * q + 4 * _ATT_KEYS) * cs * 2
        if smem <= HOPPER_SMEM and (q == 16 or -(-s // q) < -(-s // (q // 2))):
            fits.append((q, -(-s // q) * (c // ch) * n, smem))
    if not fits:
        raise ValueError(f"K9's attention tiles do not fit shared memory at head width {ch}")
    q, grid, smem = next((f for f in fits if f[1] >= HOPPER_SMS), fits[-1])
    return AttentionPlan(_attention_gemm_plan(n, s, 3 * c), q, _ATT_KEYS, cs, slices, q // 16,
                         grid, smem, _attention_gemm_plan(n, s, c))


def fused_spatial_attention_padded(x, hw, a, b, wqkv, bqkv, wproj, bproj,
                                   num_head_channels: int, want_stats: bool = False):
    """Spatial self-attention of a (B*F)-folded padded stream in one call
    (`v2a_tpu/ops/resblock_kernels.py:2962`): the collapsed GroupNorm affine,
    QKV, the legacy-layout attention over the interior tokens, projection and
    residual.

    x: (N, Hp, Wp, C), N = B*F; hw: the interior (H, W); a, b: (N, C) float32
    affine (`stats_to_group_affine` with n = H*W); wqkv (C, 3C), bqkv (3C,),
    wproj (C, C), bproj (C,), the JAX Dense layout; num_head_channels: the
    head width, any that divides C, as the JAX kernel. Returns (N, Hp, Wp, C)
    with EVERY pad position zero [, stats (N, 2, C) float32: the interior sum
    / sum of squares of the unrounded output].

    Kernel note (csrc/spatial_attention_padded.cu): bound by operations (at
    16^2 x 512, N = 56: 38 GFLOP, 80% of it the two GEMMs, against 50 MB of
    stream in and out), and at narrow heads by the softmax's exp and
    division per logit. The TPU kernel holds one whole sample per grid
    step; here every phase runs on mma.sync (`attention_plan`): a QKV GEMM
    over the interior tokens (pad keys weigh exactly zero after the -1e30
    mask, so leaving them out changes no sum), its token rows by cp.async
    and activated once in place, its Wqkv slabs by TMA; the attention with
    one (sample, head, 64-query) tile per CTA, Q's fragments in registers,
    K and V in bf16 chunks of 64 keys through a double-buffered ring (pass
    1: row max and row sum over all keys; pass 2: ex / sum rounded, as the
    TPU kernel rounds them, straight into P @ V's fragments; a head's
    lanes in slices of 32-128, those past the width zero); a projection
    GEMM whose epilogue adds the bias and the residual in float32 and
    writes per-tile column sums, and a fixed-order pass over those
    (deterministic); the pad positions are zeroed by a small fill.
    """
    _no_grad_inputs("fused_spatial_attention_padded", x, a, b, wqkv, bqkv, wproj, bproj)
    if x.device.type == "cpu":
        return fused_spatial_attention_padded_plain(x, hw, a, b, wqkv, bqkv, wproj, bproj,
                                                    num_head_channels, want_stats)
    _attn_checks(x, hw, num_head_channels)
    h, w = hw
    n, hp, wp, c = x.shape
    s = h * w
    dt = x.dtype
    a32, b32 = _affine32(a, b, n, c)
    wq = wqkv.to(dt).reshape(c, 3 * c).contiguous()
    wo = wproj.to(dt).reshape(c, c).contiguous()
    bq, bo = bqkv.float().reshape(3 * c).contiguous(), bproj.float().reshape(c).contiguous()
    _check_cuda(x, a32, b32, wq, bq, wo, bo)
    y = torch.empty_like(x)
    qkv = torch.empty((n * s, 3 * c), dtype=dt, device=x.device)
    att = torch.empty((n * s, c), dtype=dt, device=x.device)
    plan = attention_plan(n, h, w, c, num_head_channels)
    # the projection's token tiles (the float32 body's: 64 tokens)
    tiles = plan.proj.tiles if dt == torch.bfloat16 else -(-s // 64)
    partial, stats = _stats_buffers(x, n, tiles, c, want_stats)
    fn = _lib("spatial_attention_padded", "v2a_spatial_attention_padded", 12, 10)
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(a32), _ptr(b32), _ptr(wq), _ptr(bq), _ptr(wo), _ptr(bo), _ptr(y),
                _ptr(qkv), _ptr(att), _ptr(partial), _ptr(stats), n, h, w, wp, c,
                num_head_channels, plan.qkv.tokens, plan.queries, plan.proj.tokens,
                _DTYPE_CODE[dt], _stream(x))
    _raise_on(rc, "fused_spatial_attention_padded")
    launches["fused_spatial_attention_padded"] += 1
    return (y, stats) if want_stats else y


# -- K10: the plain 3x3 conv + bias -------------------------------------------------


def spatial_conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10: the nine tap products of x.dtype
    operands summed in float32, + bias, rounded once (K1's plain version
    without the activation)."""
    return fused_affine_conv3x3_plain(x, kernel, bias)


def spatial_conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y = conv3x3_same(x) + bias (`v2a_tpu/ops/resblock_kernels.py:2796`).

    x: (N, H, W, C), already normed by the caller; kernel (3, 3, C, D) HWIO;
    bias (D,). Returns (N, H, W, D) in x.dtype.

    Kernel note (csrc/affine_conv3x3.cu): bound by operations; K1's bf16
    body and plan in its plain-conv mode (no a, b copied, no activation
    pass), so bit-equal to `fused_affine_conv3x3` without an affine: per
    32-channel chunk a P-pixel tile's window with its one-pixel halo comes
    as one TMA box (zero-filled outside the frame by the map's bounds, no
    padded copy of x), the nine taps read it at shifted ldmatrix rows into
    mma.sync, the weight slabs by TMA; bias, one rounding, 16-byte stores.
    """
    _no_grad_inputs("spatial_conv3x3", x, kernel, bias)
    n, h, w, c = x.shape
    if tuple(kernel.shape[:3]) != (3, 3, c):
        raise ValueError(f"kernel {tuple(kernel.shape)} vs input C={c}")
    if x.device.type == "cpu":
        return spatial_conv3x3_plain(x, kernel, bias)
    d = kernel.shape[-1]
    if c % 32 or d % 64:
        raise ValueError(f"K10 needs C % 32 == 0 and D % 64 == 0, got C={c} D={d}")
    w2d = kernel.to(x.dtype).reshape(9 * c, d).contiguous()
    bias32 = bias.float().contiguous()
    _check_cuda(x, w2d, bias32)
    plan = affine_conv_plan(n, h, w, c, d)
    y = torch.empty((n, h, w, d), dtype=x.dtype, device=x.device)
    fn = _lib("affine_conv3x3", "v2a_spatial_conv3x3", 4, 7)
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(w2d), _ptr(bias32), _ptr(y), n, h, w, c, d, plan.pixels,
                _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "spatial_conv3x3")
    launches["spatial_conv3x3"] += 1
    return y


# -- K14: the 3x3 conv by Winograd F(2x2, 3x3) ----------------------------------------

# the F(2x2, 3x3) weight transform G and the input combos B^T by index: combo
# k of a 4-vector is v[i1] + sign * v[i2] (rows d0 - d2, d1 + d2, d2 - d1,
# d1 - d3, and the same over the cols), and the inverse transform's rows A^T
_WINO_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
_WINO_COMBOS = ((0, 2, -1.0), (1, 2, 1.0), (2, 1, -1.0), (1, 3, -1.0))
_WINO_AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))


@functools.lru_cache(maxsize=None)
def _wino_g(device: torch.device) -> torch.Tensor:
    return torch.tensor(_WINO_G, dtype=torch.float32, device=device)


def winograd_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, D) kernel -> the 16 transform-domain matrices (16, C, D) in
    float32: W_ab = (G g G^T)[a, b] per channel pair
    (`v2a_tpu/ops/resblock_kernels.py:3044`), G over the first spatial axis,
    then over the second, each a sum of the three taps in order (ten
    elementwise ops over all components at once)."""
    k = kernel.float()
    g = _wino_g(k.device)  # (4, 3)
    # t[a] = k[0] g[a, 0] + k[1] g[a, 1] + k[2] g[a, 2]: (4, 3, C, D)
    t = (k[0][None] * g[:, 0, None, None, None] + k[1][None] * g[:, 1, None, None, None]
         + k[2][None] * g[:, 2, None, None, None])
    # out[a, b] = t[a, 0] g[b, 0] + t[a, 1] g[b, 1] + t[a, 2] g[b, 2]: (4, 4, C, D)
    gb = g[None, :, :, None, None]
    out = t[:, None, 0] * gb[:, :, 0] + t[:, None, 1] * gb[:, :, 1] + t[:, None, 2] * gb[:, :, 2]
    return out.reshape(16, *kernel.shape[2:]).contiguous()


def _wino_combo(v, k):
    i1, i2, sign = _WINO_COMBOS[k]
    return v[i1] + v[i2] if sign > 0 else v[i1] - v[i2]


def winograd_conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                           tile_h: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K14, rounding by rounding as the Pallas body
    (`v2a_tpu/ops/resblock_kernels.py:3062-3160`): the input transform in
    float32 (row combos, then col combos), rounded to x.dtype; the weights
    rounded to x.dtype; the 16 products summed in float32; the inverse
    transform in float32, each output parity summing its +-M_ab in (a, b)
    order; + bias, rounded once. `tile_h` is the TPU's band height and does
    not change the result."""
    n, h, w, c = x.shape
    d = kernel.shape[-1]
    if h % 2 or w % 2:
        raise ValueError("winograd_conv3x3 needs even H and W")
    dt = x.dtype
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # zero halo, float32
    # d[i][j]: the (N, H/2, W/2, C) grid of patch element (i, j)
    dpatch = [[xp[:, i:i + h:2, j:j + w:2] for j in range(4)] for i in range(4)]
    rows = [[_wino_combo([dpatch[i][j] for i in range(4)], a) for j in range(4)]
            for a in range(4)]
    wt = winograd_weights(kernel).to(dt).float()
    m = n * (h // 2) * (w // 2)
    y = [[None, None], [None, None]]
    for a in range(4):
        for b in range(4):
            u = _wino_combo(rows[a], b).to(dt).float().reshape(m, c)
            mab = u @ wt[4 * a + b]
            for pr in range(2):
                for pc in range(2):
                    sign = _WINO_AT[pr][a] * _WINO_AT[pc][b]
                    if sign == 0.0:
                        continue
                    contrib = mab if sign > 0 else -mab
                    y[pr][pc] = contrib if y[pr][pc] is None else y[pr][pc] + contrib
    out = torch.stack([torch.stack([y[pr][pc] + bias.float() for pc in range(2)], -2)
                       for pr in range(2)], -3)  # (M, 2, 2, D)
    out = out.reshape(n, h // 2, w // 2, 2, 2, d).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, h, w, d).to(dt)


class WinogradPlan(NamedTuple):
    """One bf16 K14 launch: 2x2-output patches per tile (`hop::tile_of` over
    the (H/2, W/2) patch grid: `tile_h` x `tile_w` patches), output channels
    per CTA, whether the tile's window of all of C stays resident in shared
    memory (else its 64-channel slices stream through a 3-slice ring once per
    component), CTAs in the grid and shared memory per CTA in bytes."""
    patches: int
    nc: int
    resident: bool
    tile_h: int
    tile_w: int
    tiles: int
    grid: int
    smem: int


_WINO_KC = 64  # channels per K14 step: a window slice, two 32-deep products


def winograd_plan(n: int, h: int, w: int, c: int, d: int) -> WinogradPlan:
    """The launch K14's bf16 body makes at this shape (csrc/winograd_conv3x3.cu,
    whose `plan_of` computes the same; the card tests compare the two). Shared
    memory: a 3-stage ring of a step's two (32 x NC) W_ab slabs, two buffers of
    the step's (patches x 64) U tile, the (2 th + 2) x (2 tw + 2) window in
    64-channel slices (all of C where resident, 3 slices where streamed) and
    the ring's three mbarriers, after the alignment of the TMA ring; the
    epilogue's 4 x patches x NC tile aliases them. Of 64, 32 and 16 patches
    a tile with the window resident, then the same streamed, that fit (a
    larger tile only where it needs fewer tiles than the next smaller one),
    the first whose grid has a CTA per SM (`HOPPER_SMS`), else the one with
    the largest grid."""
    if h % 2 or w % 2 or c % 32 or d % 64:
        raise ValueError(f"K14 needs even H, W, C % 32 == 0 and D % 64 == 0, got "
                         f"{h}x{w} C={c} D={d}")
    nc = 128 if d % 128 == 0 else 64
    nq = -(-c // _WINO_KC)
    best = None
    for resident in (True, False):
        for pt in (64, 32, 16):
            th, tw, tiles = _hop_tile(h // 2, w // 2, pt)
            window = (nq if resident else 3) * (2 * th + 2) * (2 * tw + 2) * _WINO_KC * 2
            smem = _TMA_ALIGN_PAD + max(3 * 2 * _HOP_KSTEP * nc * 2 + 2 * 2 * pt * 64 + window
                                        + 8 * 3, 4 * pt * nc * 2)
            if smem > HOPPER_SMEM or (pt > 16 and tiles >= _hop_tile(h // 2, w // 2, pt // 2)[2]):
                continue
            plan = WinogradPlan(pt, nc, resident, th, tw, n * tiles, n * tiles * (d // nc), smem)
            if plan.grid >= HOPPER_SMS:
                return plan
            if best is None or plan.grid > best.grid:
                best = plan
    if best is None:
        raise ValueError(f"no K14 tile fits shared memory at {h}x{w} C={c} D={d}")
    return best


def winograd_plan_of_kernel(n: int, h: int, w: int, c: int, d: int) -> WinogradPlan:
    """The plan csrc/winograd_conv3x3.cu's own `plan_of` makes (needs the
    built library, so the card), as a `WinogradPlan`."""
    fn = _build.load("winograd_conv3x3").v2a_winograd_plan
    fn.argtypes = [_I] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = _I
    out = (ctypes.c_longlong * 7)()
    _raise_on(fn(n, h, w, c, d, out), "v2a_winograd_plan")
    pt, nc, resident, grid, smem, th, tw = out
    return WinogradPlan(pt, nc, bool(resident), th, tw, grid // (d // nc), grid, smem)


def winograd_conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     tile_h: Optional[int] = None) -> torch.Tensor:
    """y = conv3x3_same(x) + bias by Winograd F(2x2, 3x3)
    (`v2a_tpu/ops/resblock_kernels.py:3163`), K10's interface: x (N, H, W,
    C) with even H and W, kernel (3, 3, C, D) HWIO, bias (D,). Returns
    (N, H, W, D) in x.dtype. `tile_h`, the TPU kernel's band height, is
    accepted and ignored: the card's tiling does not depend on it. The
    transform-domain weights `winograd_weights(kernel)` are made on every
    call, as the JAX body makes them.

    Kernel note (csrc/winograd_conv3x3.cu): bound by operations from 64^2 x
    256 on, by bytes at 128^2 x 128. A CTA owns 64 (sixteen warps), 32 or
    16 (eight) 2x2 output patches x 128 (or 64) channels (`winograd_plan`);
    the tile's raw window comes by cp.async into shared memory once (or,
    where all of C does not fit, in 64-channel slices once per component);
    in component order all threads form each step's U_ab tile from it in
    float32, rounded to bf16, a step ahead of its mma.sync products, the
    W_ab slabs by TMA through a 3-stage ring; each thread adds +-M_ab into
    four output-parity accumulators in registers in the TPU body's order;
    bias and one rounding at the end, 16-byte stores.
    """
    _no_grad_inputs("winograd_conv3x3", x, kernel, bias)
    n, h, w, c = x.shape
    if tuple(kernel.shape[:3]) != (3, 3, c):
        raise ValueError(f"kernel {tuple(kernel.shape)} vs input C={c}")
    if h % 2 or w % 2:
        raise ValueError("winograd_conv3x3 needs even H and W")
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, kernel, bias, tile_h)
    d = kernel.shape[-1]
    if c % 32 or d % 64:
        raise ValueError(f"K14 needs C % 32 == 0 and D % 64 == 0, got C={c} D={d}")
    wt = winograd_weights(kernel).to(x.dtype).reshape(16 * c, d).contiguous()
    bias32 = bias.float().contiguous()
    _check_cuda(x, wt, bias32)
    y = torch.empty((n, h, w, d), dtype=x.dtype, device=x.device)
    fn = _lib("winograd_conv3x3", "v2a_winograd_conv3x3", 4, 6)
    with torch.cuda.device(x.device):
        rc = fn(_ptr(x), _ptr(wt), _ptr(bias32), _ptr(y), n, h, w, c, d, _DTYPE_CODE[x.dtype],
                _stream(x))
    _raise_on(rc, "winograd_conv3x3")
    launches["winograd_conv3x3"] += 1
    return y


# -- K11: the temporal conv on the (H*W, B, F, C) view ------------------------------


def temporal_conv_fused_hw_plain(x, kernel, bias, emb=None, residual=None, want_stats=False):
    """Plain PyTorch version of K11, in the Pallas body's order
    (`v2a_tpu/ops/resblock_kernels.py:288-309`): per frame the centre tap,
    then the f-1 and f+1 taps, products of x.dtype operands in float32;
    + bias, + emb, + residual in float32, rounded once; statistics from the
    rounded values. The layout does not change the arithmetic, so this
    works on the (B, F, S, C) tensor."""
    b, f, s, c = _fold(x)
    w = kernel.to(x.dtype).float()
    xp = F.pad(x.reshape(b, f, s, c).float(), (0, 0, 0, 0, 1, 1))
    y = xp[:, 1:f + 1] @ w[1] + xp[:, 0:f] @ w[0] + xp[:, 2:f + 2] @ w[2]
    y = y + bias.float()
    if emb is not None:
        y = y + emb.reshape(b, 1, 1, c).float()
    if residual is not None:
        y = y + residual.expand(x.shape).to(x.dtype).reshape(b, f, s, c).float()
    yr = y.to(x.dtype)
    out = yr.reshape(x.shape)
    if want_stats:
        yf = yr.float()
        return out, torch.stack([yf.sum(2), (yf * yf).sum(2)], dim=2)
    return out


def temporal_conv_fused_hw(x, kernel, bias, emb=None, residual=None, want_stats=False):
    """`temporal_conv_fused`'s contract with the kernel on the (H*W, B, F, C)
    view (`v2a_tpu/ops/resblock_kernels.py:340`).

    x: (B, F, H, W, C) or (B, F, S, C); kernel (3, C, C); bias (C,); emb
    optional (B, C); residual optional, broadcastable to x. Returns y in
    x.dtype with x's shape [, stats (B, F, 2, C) float32 of the rounded y].

    Kernel note (csrc/temporal_conv.cu): K2's launch. The (S, B, F, C)
    view, which the JAX wrapper writes as transposes (:364, :386, :412) and
    the TPU took as layout bitcasts, is only another address map over x's
    own (B, F, S, C) memory, so this launches K2's kernel
    (`v2a_temporal_conv3`, K2's plan) on x itself: x, the residual and y are
    neither copied nor permuted, and y and the statistics are
    `temporal_conv_fused`'s bit for bit. Its own count is
    `launches["temporal_conv_fused_hw"]`.
    """
    _no_grad_inputs("temporal_conv_fused_hw", x, kernel, bias, emb, residual)
    b, f, s, c = _fold(x)
    if tuple(kernel.shape) != (3, c, c):
        raise ValueError(f"temporal kernel must be (3, C, C), got {tuple(kernel.shape)}")
    if x.device.type == "cpu":
        return temporal_conv_fused_hw_plain(x, kernel, bias, emb, residual, want_stats)
    return _temporal_conv_launch("temporal_conv_fused_hw", x, kernel, bias, emb, residual,
                                 want_stats)


# -- K12: K3's function with frames streamed through a 3-slot ring -------------------


def stream_band_rows(h: int, w: int, wp: int, cins, d: int,
                     budget_bytes: int = 11 * 1024 * 1024) -> int:
    """The JAX package's gate of the frame-streaming kernel, copied as it
    stands (`v2a_tpu/ops/resblock_kernels.py:2632`): the band height whose
    ONE frame's window plus the 3-slot ring fit a TPU VMEM budget, or 0
    where the JAX package does not stream. Like `conv_tconv_band_rows`, the
    port keeps it only so that it launches what the JAX package launches."""
    weights = sum(9 * c * d * 2 for c in cins) + 3 * d * d * 2

    def cost(t):
        win = sum(2 * (t + 2) * wp * c * 2 for c in cins)
        ring3 = 3 * t * w * d * 2
        out = 2 * t * wp * d * 2
        res = out
        acc = t * w * d * 4
        ftmp = (t + 2) * wp * max(cins) * 4
        return weights + win + ring3 + out + res + acc + ftmp

    best = 0
    for t in range(1, h + 1):
        if h % t == 0 and cost(t) <= budget_bytes:
            best = max(best, t)
    if best * w < 256:
        return 0
    return best


def fused_conv_tconv_stream_plain(parts, kbias, tkernel, tbias, hw, emb=None, residual=None,
                                  silu=True, want_stats=False):
    """Plain PyTorch version of K12: K3's plain chain without the skip fold
    (K4a's plain version, its conv output rounded to x.dtype, then K4b's),
    which is what the Pallas body computes frame by frame (:2540-2602)."""
    return fused_conv_tconv_padded_plain(parts, kbias, tkernel, tbias, hw, emb, residual,
                                         None, None, silu, want_stats)


def fused_conv_tconv_stream(parts, kbias, tkernel, tbias, hw, emb=None, residual=None,
                            silu=True, want_stats=False, conv_out=None):
    """The padded-stream PseudoConv3d without a skip fold, frames streamed
    (`v2a_tpu/ops/resblock_kernels.py:2656`): per part x (B, F, Hp, Wp, C_i),
    kernel (3, 3, C_i, D), a, b (B*F, C_i); the conv output of each frame
    rounded to x.dtype, then the temporal taps + tbias [+ emb (B, D)]
    [+ residual, a padded stream like y]. Returns (B, F, Hp, Wp, D) with its
    interior and zero pad cols, pad rows unwritten [, stats (B, F, 2, D) of
    the rounded interior]. `conv_out` as K3's.

    Kernel note (csrc/conv_tconv_stream.cu, csrc/conv_tconv_hopper.cuh):
    bound by operations (7.89 ms of bound per B=8 release forward). K3's
    Hopper mainloop with the TPU kernel's frame order: a cluster of D/128
    CTAs owns a pixel tile of one sample and walks the frames, frame f's
    conv (each CTA its 128 channels) into a 3-slot ring in shared memory,
    then frame f-1's temporal GEMM out of every rank's ring (a missing
    neighbour selected to zero), cluster barriers between. The ring holds 3
    frames where K3 holds all F, so the tile plan (`conv_tconv_plan`,
    `ring=True`) can shrink the pixel tile until a B=1 grid fills the card.
    Statistics as K3.
    """
    _no_grad_inputs("fused_conv_tconv_stream", kbias, tkernel, tbias, emb, residual,
                    *_parts_tensors(parts))
    x0 = parts[0][0]
    if x0.device.type == "cpu":
        _plain_conv_out(conv_out, parts, kbias, hw, silu)
        return fused_conv_tconv_stream_plain(parts, kbias, tkernel, tbias, hw, emb, residual,
                                             silu, want_stats)
    a = _conv_tconv_args("fused_conv_tconv_stream", parts, kbias, tkernel, tbias, hw, emb,
                         residual, None, None, skips_allowed=False)
    b, f, _, _, d = a["out_shape"]
    plan = conv_tconv_plan(b, f, hw[0], hw[1], d, ring=True)
    scratch = _conv_out_buffer(conv_out, a)
    partial, stats = _stats_buffers(x0, b * f, plan.tiles, d, want_stats)
    fn = _lib("conv_tconv_stream", "v2a_conv_tconv_stream", 17, 11)
    with torch.cuda.device(x0.device):
        rc = fn(*a["ptrs"], _ptr(a["y"]), _ptr(scratch), _ptr(partial), _ptr(stats),
                *a["ints"], plan.pixels, int(silu), _DTYPE_CODE[a["dt"]], _stream(x0))
    _raise_on(rc, "fused_conv_tconv_stream")
    launches["fused_conv_tconv_stream"] += 1
    return (a["y"], stats.reshape(b, f, 2, d)) if want_stats else a["y"]


# -- GroupNorm statistics fold --------------------------------------------------


def stats_to_group_affine(
    stats: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    n_per_channel: int,
    groups: int = 32,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) sum / sum of squares (B, 2, C) + GroupNorm affine ->
    per-(B, C) scale A and shift B with GroupNorm(h)*scale+bias = h*A + B
    (`v2a_tpu/ops/resblock_kernels.py:449`). Variance is E[x^2] - mean^2
    clamped at 0, in float32."""
    c = stats.shape[-1]
    gw = c // groups
    st = stats.float()
    n = float(n_per_channel * gw)
    sum_g = st[:, 0].reshape(-1, groups, gw).sum(-1)
    sumsq_g = st[:, 1].reshape(-1, groups, gw).sum(-1)
    mean_g = sum_g / n
    var_g = torch.clamp(sumsq_g / n - mean_g * mean_g, min=0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(gw, dim=1)
    rstd_c = rstd_g.repeat_interleave(gw, dim=1)
    a = rstd_c * scale.float()[None, :]
    return a, bias.float()[None, :] - mean_c * a
