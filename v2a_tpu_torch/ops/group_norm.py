"""K7: GroupNorm(32) with float32 statistics, affine and optional SiLU in one
kernel pair, for the non-fused forward's `use_pallas_gn` routing.

Counterpart of `v2a_tpu/ops/pallas_kernels.py` (`fused_group_norm_silu`
:111, bodies :40 and :72; `group_norm_silu_reference` :179). x is
channels-last; every leading dim after the first folds into S, and a group's
statistics span (S, C / G) per batch element.

The wrapper runs its plain PyTorch version for a tensor on the CPU and
launches `csrc/group_norm_silu.cu` (or raises) for a CUDA tensor, as the
wrappers of `ops/resblock_kernels.py` do (the same conventions, build and
refusal under grad mode). Its entry in the port's kernel registry and its
launch count are `resblock_kernels.KERNELS` / `resblock_kernels.launches`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from v2a_tpu_torch.ops import resblock_kernels as rk

# statistics blocks the K7 launch aims for: about four per SM of the H100's 132
_STATS_BLOCKS = 132 * 4


def _fold(x: torch.Tensor):
    b, c = x.shape[0], x.shape[-1]
    return b, x.numel() // max(b * c, 1), c


def fused_group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                groups: int = 32, eps: float = 1e-5,
                                with_silu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K7, as its two bodies compute it: per (batch,
    group) float32 sum and sum of squares; mean = sum / n, var = E[x^2] -
    mean^2 NOT clamped at zero (the XLA GroupNorm clamps),
    rstd = rsqrt(var + eps); y = (x - mean) * rstd * scale + bias [,
    y * sigmoid(y)], rounded to x.dtype."""
    if x.ndim < 2:
        raise ValueError(f"x must have rank >= 2, got {tuple(x.shape)}")
    b, s, c = _fold(x)
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    gw = c // groups
    xf = x.reshape(b, s, c).float()
    n = float(s * gw)
    mean_g = xf.sum(1).reshape(b, groups, gw).sum(-1) / n
    var_g = (xf * xf).sum(1).reshape(b, groups, gw).sum(-1) / n - mean_g * mean_g
    rstd_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(gw, dim=1)[:, None, :]
    rstd_c = rstd_g.repeat_interleave(gw, dim=1)[:, None, :]
    y = (xf - mean_c) * rstd_c * scale.float() + bias.float()
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


def group_norm_silu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              groups: int = 32, eps: float = 1e-5,
                              with_silu: bool = True) -> torch.Tensor:
    """Float32 reference (`v2a_tpu/ops/pallas_kernels.py:179`): the two-pass
    variance, the same semantics."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.reshape(b, -1, groups, c // groups).float()
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, -1, c)
    y = y * scale.float() + bias.float()
    if with_silu:
        y = F.silu(y)
    return y.reshape(x.shape).to(x.dtype)


def stats_splits(b: int, s: int) -> int:
    """Row splits per batch element of the statistics pass: about
    `_STATS_BLOCKS` blocks in all, at least 64 rows each. Depends on the
    shape only, so two launches sum in the same order."""
    return max(1, min(-(-_STATS_BLOCKS // b), s // 64))


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          groups: int = 32, eps: float = 1e-5,
                          with_silu: bool = True) -> torch.Tensor:
    """GroupNorm(groups) (+SiLU) of a channels-last x of any rank >= 2
    (`v2a_tpu/ops/pallas_kernels.py:111`): leading dims after the first fold
    into S; float32 statistics; output in x.dtype.

    Kernel note (csrc/group_norm_silu.cu): bound by bytes (one read for the
    statistics, then one read and one write; at (8, 114688, 128) bf16 each
    pass is 235 MB). The TPU kernel accumulates a batch row's sums across its
    sequential grid; here the statistics pass splits each batch row into
    `stats_splits` row ranges, each block writes per-group partial sums
    (coalesced 8-channel loads, a fixed-order reduction in shared memory), a
    one-block-per-batch pass adds the splits in order (deterministic, no
    atomics), and the apply pass normalises, scales and applies the SiLU in
    one read and one write.
    """
    rk._no_grad_inputs("fused_group_norm_silu", x, scale, bias)
    if x.device.type == "cpu":
        return fused_group_norm_silu_plain(x, scale, bias, groups, eps, with_silu)
    if x.ndim < 2:
        raise ValueError(f"x must have rank >= 2, got {tuple(x.shape)}")
    b, s, c = _fold(x)
    if c % groups or c % 8 or c > 8192:
        raise ValueError(f"channels {c}: K7 needs C % groups == 0, C % 8 == 0, C <= 8192")
    xc = x.contiguous()
    scale32, bias32 = scale.float().contiguous(), bias.float().contiguous()
    if scale32.numel() != c or bias32.numel() != c:
        raise ValueError(f"scale / bias must have {c} elements")
    rk._check_cuda(xc, scale32, bias32)
    splits = stats_splits(b, s)
    partial = torch.empty((b * splits * groups * 2,), dtype=torch.float32, device=x.device)
    mean_rstd = torch.empty((b * groups * 2,), dtype=torch.float32, device=x.device)
    y = torch.empty_like(xc)
    fn = rk._lib("group_norm_silu", "v2a_group_norm_silu", 6, 7, 1)
    with torch.cuda.device(x.device):
        rc = fn(rk._ptr(xc), rk._ptr(scale32), rk._ptr(bias32), rk._ptr(partial),
                rk._ptr(mean_rstd), rk._ptr(y), b, s, c, groups, splits, int(with_silu),
                rk._DTYPE_CODE[x.dtype], eps, rk._stream(x))
    rk._raise_on(rc, "fused_group_norm_silu")
    rk.launches["fused_group_norm_silu"] += 1
    return y.reshape(x.shape)
