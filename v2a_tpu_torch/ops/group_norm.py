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

import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from v2a_tpu_torch.ops import resblock_kernels as rk

# CTAs a K7 pass aims for: four 256-thread CTAs (64 registers a thread) on
# each SM of the H100, one wave
_CTAS_AIMED = rk.HOPPER_SMS * 4
_THREADS_AIMED = 256
# the kernel's ring (csrc/group_norm_silu.cu): STAGES chunks after RING_OFF
# bytes of mbarriers
_STAGES, _RING_OFF = 3, 128


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


class GroupNormPlan(NamedTuple):
    """One K7 call over (B, S, C): threads per CTA (C / 8 vector columns x
    `lanes` rows side by side), rows per chunk (what a CTA takes at once,
    a stage of its ring), CTAs per sample (the statistics pass and the
    apply pass both; CTA i takes chunks i, i + ctas, ...), a CTA's shared
    memory in bytes (the ring, or the statistics' reduction where that is
    larger) and the float32 scratch's elements (arrival counters, (mean,
    rstd) per group, (sum, sumsq) per group and CTA, each part rounded up to
    4 floats and the CTAs to a multiple of 4)."""
    threads: int
    lanes: int
    rows: int
    ctas: int
    smem: int
    scratch: int


@functools.lru_cache(maxsize=None)
def group_norm_plan(b: int, s: int, c: int, groups: int = 32,
                    itemsize: int = 2) -> GroupNormPlan:
    """The launches K7 makes over b samples of s rows x c channels of
    `itemsize`-byte elements (csrc/group_norm_silu.cu takes these integers
    and computes no plan of its own). A thread owns one 8-channel vector;
    `lanes` rows side by side fill about `_THREADS_AIMED` threads (one lane
    where C / 8 alone is more), and a chunk gives each lane 64 bytes of a
    thread's rows (bf16: 4 rows, float32: 2). Where a sample has fewer
    chunks than it needs CTAs for a CTA per SM (`rk.HOPPER_SMS`), chunks
    shrink, down to one row. CTAs per sample: about `_CTAS_AIMED` in all,
    none without a chunk. Depends on the shape only, so every launch sums
    in the same order."""
    if c % groups or c % 8 or c > 8192:
        raise ValueError(f"channels {c}: K7 needs C % groups == 0, C % 8 == 0, C <= 8192")
    v = c // 8
    lanes = max(1, _THREADS_AIMED // v)
    rows = lanes * 64 // (8 * itemsize)
    need = -(-rk.HOPPER_SMS // b)
    if -(-s // rows) < need:
        rows = max(1, s // need)
        lanes = min(lanes, rows)
    ctas = min(-(-s // rows), -(-_CTAS_AIMED // b))
    threads = v * lanes
    up4 = lambda n: -(-n // 4) * 4  # noqa: E731
    smem = _RING_OFF + max(_STAGES * rows * c * itemsize, 8 * lanes * c)
    return GroupNormPlan(threads, lanes, rows, ctas, smem,
                         up4(b) + up4(2 * b * groups) + 2 * b * groups * up4(ctas))


# (device, samples, plan, groups) -> the scratch of those launches; its
# counters are zeroed here once, and each launch leaves them zero
_scratch: Dict[Tuple[torch.device, int, GroupNormPlan, int], torch.Tensor] = {}


def _scratch_of(device: torch.device, b: int, plan: GroupNormPlan, groups: int) -> torch.Tensor:
    key = (device, b, plan, groups)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros(plan.scratch, dtype=torch.float32, device=device)
    return buf


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          groups: int = 32, eps: float = 1e-5,
                          with_silu: bool = True) -> torch.Tensor:
    """GroupNorm(groups) (+SiLU) of a channels-last x of any rank >= 2
    (`v2a_tpu/ops/pallas_kernels.py:111`): leading dims after the first fold
    into S; float32 statistics; output in x.dtype.

    Kernel note (csrc/group_norm_silu.cu): bound by bytes (one read for the
    statistics, then one read and one write; at (8, 114688, 128) bf16 each
    pass is 235 MB). The TPU kernel accumulates a batch row's sums across its
    sequential grid; here two launches over `group_norm_plan`, each CTA
    streaming its chunks of rows by TMA bulk copies through a three-slot
    shared-memory ring: the statistics pass's CTAs each write per-group
    partial sums (a fixed-order reduction in shared memory) and the last
    CTA of each sample to arrive folds them in a fixed order into (mean,
    rstd) (deterministic, no float atomics); the apply pass holds each
    thread's channel constants in registers and takes the chunks in the
    reverse order, so it first reads what the statistics pass left in L2.
    The scratch (counters, statistics, partials) is kept per device and
    plan: calls on one stream, as the port makes them, share it.
    """
    rk._no_grad_inputs("fused_group_norm_silu", x, scale, bias)
    if x.device.type == "cpu":
        return fused_group_norm_silu_plain(x, scale, bias, groups, eps, with_silu)
    if x.ndim < 2:
        raise ValueError(f"x must have rank >= 2, got {tuple(x.shape)}")
    b, s, c = _fold(x)
    plan = group_norm_plan(b, s, c, groups, x.element_size())
    xc = x.contiguous()
    scale32, bias32 = scale.float().contiguous(), bias.float().contiguous()
    if scale32.numel() != c or bias32.numel() != c:
        raise ValueError(f"scale / bias must have {c} elements")
    rk._check_cuda(xc, scale32, bias32)
    scratch = _scratch_of(x.device, b, plan, groups)
    y = torch.empty_like(xc)
    fn = rk._lib("group_norm_silu", "v2a_group_norm_silu", 5, 9, 1)
    with rk._launching("fused_group_norm_silu", x.device):
        rc = fn(rk._ptr(xc), rk._ptr(scale32), rk._ptr(bias32), rk._ptr(scratch), rk._ptr(y),
                b, s, c, groups, plan.threads, plan.rows, plan.ctas, int(with_silu),
                rk._DTYPE_CODE[x.dtype], eps, rk._stream(x))
    rk._raise_on(rc, "fused_group_norm_silu")
    rk.launches["fused_group_norm_silu"] += 1
    return y
