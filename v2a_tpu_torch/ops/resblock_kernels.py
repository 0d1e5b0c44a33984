"""The video U-Net's ResBlock-interior kernels: wrappers, plain versions and
the GroupNorm statistics fold.

Counterpart of `v2a_tpu/ops/resblock_kernels.py` for the unpadded fused
routing:

- `fused_affine_conv3x3` (K1): y = conv3x3_same(act(x)) + bias with
  act = silu(a*x + b) per (N, C), or the plain conv. CUDA source
  `csrc/affine_conv3x3.cu`.
- `temporal_conv_fused` (K2): the 3-tap C x C conv over frames + bias
  [+ emb] [+ residual], optionally with per-(B, F, C) sum / sum of squares
  of the rounded output. CUDA source `csrc/temporal_conv.cu`.

Each wrapper runs its kernel's plain PyTorch version (`*_plain`, beside it)
for a tensor on the CPU. For a CUDA tensor it launches the kernel on the
current stream or raises; there is no fallback. `launches[<wrapper name>]`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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
}

# kernel launches per wrapper; each wrapper adds one where it launches
launches = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib(name: str, fn: str, nargs_ptr: int, nargs_int: int):
    f = getattr(_build.load(name), fn)
    f.argtypes = [_P] * nargs_ptr + [_I] * nargs_int + [_P]
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


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


# -- K1: fused affine (+SiLU) 3x3 conv -----------------------------------------


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
    if a is not None:
        xf = x.float() * a[:, None, None, :].float() + b[:, None, None, :].float()
        if silu:
            xf = xf * torch.sigmoid(xf)
        xa = xf.to(x.dtype)
    else:
        xa = x
    w = kernel.to(x.dtype).float().permute(3, 2, 0, 1)  # (D, C, 3, 3)
    y = F.conv2d(xa.float().permute(0, 3, 1, 2), w, padding=1)
    y = y.permute(0, 2, 3, 1) + bias.float()
    return y.to(x.dtype).contiguous()


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

    Kernel note (csrc/affine_conv3x3.cu): compute-bound at the release
    shapes; an implicit GEMM over (pixels, 9*C, D) on the tensor cores with
    the activation recomputed per tap in the gather, so the normed tensor
    never reaches device memory.
    """
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
    y = torch.empty((n, h, w, d), dtype=x.dtype, device=x.device)
    mode = 0 if a is None else (2 if silu else 1)
    fn = _lib("affine_conv3x3", "v2a_affine_conv3x3", 6, 7)
    with torch.cuda.device(x.device):
        rc = fn(
            _ptr(x), _ptr(a32), _ptr(b32), _ptr(w2d), _ptr(bias32), _ptr(y),
            n, h, w, c, d, mode, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
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

    Kernel note (csrc/temporal_conv.cu): memory-bound; one pass reads x (and
    the residual) and writes y, with emb / residual / the statistics in the
    epilogue, then a small deterministic second pass sums the per-tile
    statistics.
    """
    if x.device.type == "cpu":
        return temporal_conv_fused_plain(x, kernel, bias, emb, residual, want_stats)
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
    stats = partial = None
    if want_stats:
        tiles = -(-s // 64)
        partial = torch.empty((b * f * tiles * 2 * c,), dtype=torch.float32, device=x.device)
        stats = torch.empty((b, f, 2, c), dtype=torch.float32, device=x.device)
    fn = _lib("temporal_conv", "v2a_temporal_conv3", 8, 5)
    with torch.cuda.device(x.device):
        rc = fn(
            _ptr(x), _ptr(w2d), _ptr(bias32), _ptr(emb32), _ptr(res), _ptr(y),
            _ptr(partial), _ptr(stats), b, f, s, c, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(rc, "temporal_conv_fused")
    launches["temporal_conv_fused"] += 1
    return (y, stats) if want_stats else y


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
