"""The ResNet trunk's 3x3 stride-2 pad-1 max pools with their own backward.

Counterpart of `v2a_tpu/ops/pool.py`, on the trunk's NCHW layout. Two
`torch.autograd.Function`s, each the counterpart of one experiment flag of
the JAX trunk (`v2a_tpu/models/vision.py:86-100`), selected by the
`pool` argument of `models/vision.py`:

- `max_pool_3x3s2` ("packed", `V2A_PACKED_POOL`): the bf16 activation's
  bits and the negated flat spatial index packed into one int32 key,
      key = sortable_u16(x) << bits | (H*W - 1 - flat_idx),
  whose window max gives both the pooled value (exact: the bf16 bits
  round-trip) and the window's argmax, ties going to the FIRST maximum in
  row-major order, torch's `max_pool2d` rule. The window max is the
  elementwise max of the nine strided slices of the padded key tensor
  (torch's CUDA `max_pool2d` takes no integer tensor). bf16 only, H*W <=
  2^15: other inputs raise, as in the JAX package.
- `max_pool_3x3s2_maskbwd` ("mask_bwd", `V2A_POOL_MASK_BWD`): the library
  forward, and a backward that sends each window's gradient to EVERY input
  equal to the window max, not only the first (a deliberate deviation of
  the JAX package's: ties at 0.0 after a ReLU are common).

Both backwards are the JAX package's four-candidate compare (no gather,
no scatter): with stride 2 and window 3, input row i lies in pooled rows
(i+1)//2 and, for odd i, (i-1)//2, read from a 2x nearest upsample of the
pooled grid shifted by one. The JAX package trims that upsample to H (W)
before the shift, which drops the last row's (column's) gradient when H
(W) is odd; here it keeps all 2*Ho rows, so the gradient is
`max_pool2d`'s at odd sizes too (equal to the JAX package's at even sizes,
the trunk's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_KEY_PAD = -(2 ** 31) + 1


def _sortable_u16(x: torch.Tensor) -> torch.Tensor:
    """Monotone bf16 -> [0, 0xFFFF] int32 map (IEEE total order, -0 < +0)."""
    u = x.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(u >= 0x8000, 0xFFFF - u, u | 0x8000)


def _unsortable_u16(key: torch.Tensor) -> torch.Tensor:
    u = torch.where(key >= 0x8000, key & 0x7FFF, 0xFFFF - key)
    return torch.where(u >= 0x8000, u - 0x10000, u).to(torch.int16).view(torch.bfloat16)


def _idx_bits(x: torch.Tensor) -> int:
    hw = x.shape[-2] * x.shape[-1]
    bits = int(hw - 1).bit_length()
    if x.dtype != torch.bfloat16 or bits > 15:
        raise ValueError(f"max_pool_3x3s2 needs bf16 and H*W<=2^15, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return bits


def _window_max(v: torch.Tensor, fill: int) -> torch.Tensor:
    """3x3 stride-2 pad-1 window max of (B, C, H, W) as the elementwise max
    of nine strided slices of the padded tensor."""
    h, w = v.shape[-2:]
    ho, wo = (h + 1) // 2, (w + 1) // 2
    vp = F.pad(v, (1, 1, 1, 1), value=fill)
    out = None
    for di in range(3):
        for dj in range(3):
            s = vp[..., di:di + 2 * ho - 1:2, dj:dj + 2 * wo - 1:2]
            out = s if out is None else torch.maximum(out, s)
    return out


def _flat_index(h: int, w: int, device) -> torch.Tensor:
    """(H, W) int32 row-major flat index of each position."""
    return torch.arange(h * w, dtype=torch.int32, device=device).reshape(h, w)


def _fwd_keys(x: torch.Tensor, bits: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    rev = (h * w - 1) - _flat_index(h, w, x.device)  # the max key <=> the min flat index
    return _window_max((_sortable_u16(x) << bits) | rev, _KEY_PAD)


def _up(v: torch.Tensor, fill: float) -> torch.Tensor:
    """(B, C, Ho, Wo) -> each element doubled along H and W (2Ho, 2Wo), then
    padded by one with `fill`."""
    u = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return F.pad(u, (1, 1, 1, 1), value=fill)


def _gather4(u_dy, u_ref, ref, shape):
    """The sum over each input position's four candidate pooled positions
    of dy where the candidate's reference (argmax or pooled value, both
    `_up`-sampled) matches `ref` there: the (i+1)//2 candidate for every
    row, the (i-1)//2 one for odd rows only, and so for columns."""
    h, w = shape[-2:]
    odd_i = (torch.arange(h, device=u_dy.device) % 2 == 1)[:, None]
    odd_j = (torch.arange(w, device=u_dy.device) % 2 == 1)[None, :]
    dx = torch.zeros(shape, dtype=torch.float32, device=u_dy.device)
    for si, mi, sj, mj in ((1, None, 1, None), (1, None, -1, odd_j), (-1, odd_i, 1, None),
                           (-1, odd_i, -1, odd_j)):
        g = u_dy[..., 1 + si:1 + si + h, 1 + sj:1 + sj + w]
        hit = u_ref[..., 1 + si:1 + si + h, 1 + sj:1 + sj + w] == ref
        if mi is not None:
            hit = hit & mi
        if mj is not None:
            hit = hit & mj
        dx = dx + torch.where(hit, g, 0.0)
    return dx


class _PackedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        bits = _idx_bits(x)
        key = _fwd_keys(x.contiguous(), bits)
        ctx.save_for_backward(key)
        ctx.shape, ctx.bits = x.shape, bits
        return _unsortable_u16(key >> bits)

    @staticmethod
    def backward(ctx, dy):
        (key,) = ctx.saved_tensors
        h, w = ctx.shape[-2:]
        argmax = (h * w - 1) - (key & ((1 << ctx.bits) - 1))
        # pad positions decode to argmax -1: no match
        dx = _gather4(_up(dy.float(), 0.0), _up(argmax + 1, 0) - 1,
                      _flat_index(h, w, key.device), ctx.shape)
        return dx.to(torch.bfloat16)


class _MaskBwdPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        pooled = F.max_pool2d(x, 3, 2, 1)
        ctx.save_for_backward(x, pooled)
        return pooled

    @staticmethod
    def backward(ctx, dy):
        x, pooled = ctx.saved_tensors
        # pad windows hold -inf: no activation equals them
        dx = _gather4(_up(dy.float(), 0.0), _up(pooled.float(), float("-inf")), x.float(),
                      x.shape)
        return dx.to(x.dtype)


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool, (B, C, H, W) bf16, H*W <= 2^15; its
    gradient goes to each window's first maximum (row-major)."""
    return _PackedPool.apply(x)


def max_pool_3x3s2_maskbwd(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool, (B, C, H, W), any float dtype; its
    gradient goes to every maximum of each window."""
    return _MaskBwdPool.apply(x)
