"""The differentiable fused conv of the video train step.

Counterpart of `v2a_tpu/ops/conv_vjp.py`: y = conv3x3_same(silu(a*x + b)) + bias
(`affine_silu_conv3x3`) and y = conv3x3_same(x) + bias (`plain_conv3x3`) as
`torch.autograd.Function`s whose forward is K1 (`rk.fused_affine_conv3x3`)
and whose backward is a kernel too:

- the elementwise front is recomputed in float32 from the saved raw x:
  z = a*x + b, s = silu(z), silu'(z) = sig(z) * (1 + z * (1 - sig(z)));
- ds = conv3x3_same(g, rot180(W)^T): K1 in plain-conv mode with the flipped,
  transposed weights (the JAX package's default dgrad); with
  `dgrad_kernel=False` the library's conv input gradient
  (`torch.nn.grad.conv2d_input`) on g rounded to x.dtype, as the JAX
  package's `dgrad_pallas=False` (its XLA conv backward);
- dW: K6 (`rk.wgrad_conv3x3`, the activation recomputed in the kernel) when
  `wgrad_kernel`, else the library's conv weight gradient on s rounded to
  x.dtype, as the JAX package's default XLA path;
- dz = ds * silu'(z); dx = a * dz in x.dtype; da, db = the (H, W) sums of
  dz * x and dz; dbias = the (N, H, W) sum of g in float32.

Gradient dtypes: dx in x.dtype, the rest float32 (`tests/test_conv_vjp.py:58-70`).
The library wgrad and dgrad are the JAX package's XLA paths ported, each
picked by its caller's routing; neither is a fallback for a kernel. The kernels' wrappers run inside `forward` and
`backward`, where grad mode is off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from v2a_tpu_torch.ops import resblock_kernels as rk


def _silu_fwd_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """xf, z, sig(z) in float32 from the saved raw input."""
    xf = x.float()
    z = xf * a[:, None, None, :] + b[:, None, None, :]
    return xf, z, torch.sigmoid(z)


def _conv_nhwc(s: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """conv3x3_same of an (N, H, W, C) operand with an HWIO kernel, in s.dtype."""
    w = kernel.to(s.dtype).permute(3, 2, 0, 1)
    return F.conv2d(s.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def _library_wgrad(s_op: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d kernel of `_conv_nhwc(s_op, kernel)` by the library's conv backward,
    the cotangent cast to s_op.dtype (the JAX package's `jax.vjp` of its XLA
    conv), in float32 after the dtype cast's transpose."""
    with torch.enable_grad():
        k = kernel.detach().requires_grad_(True)
        (dk,) = torch.autograd.grad(_conv_nhwc(s_op, k), (k,), g.to(s_op.dtype))
    return dk


def _dgrad_kernel(g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """A stride-1 SAME 3x3 conv's input gradient is itself one: K1 in
    plain-conv mode on g with the taps flipped and C / D swapped."""
    wt = kernel.flip(0, 1).permute(0, 1, 3, 2).contiguous()  # (3, 3, D, C)
    return rk.fused_affine_conv3x3(g, wt, kernel.new_zeros(kernel.shape[2]))


def _library_dgrad(g: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """d input of `_conv_nhwc(s, kernel)` for an s of `dtype` by the
    library's conv backward, the cotangent cast to `dtype` (the JAX
    package's `jax.vjp` of its XLA conv); (N, H, W, C) in `dtype`."""
    n, h, w, _ = g.shape
    wt = kernel.to(dtype).permute(3, 2, 0, 1)  # OIHW
    ds = torch.nn.grad.conv2d_input((n, kernel.shape[2], h, w), wt,
                                    g.to(dtype).permute(0, 3, 1, 2), padding=1)
    return ds.permute(0, 2, 3, 1)


def _dgrad(g, kernel, dtype, dgrad_kernel: bool):
    return _dgrad_kernel(g, kernel) if dgrad_kernel else _library_dgrad(g, kernel, dtype)


class _AffineSiluConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, a, b, wgrad_kernel, dgrad_kernel):
        x = x.contiguous()
        ctx.save_for_backward(x, kernel, a, b)
        ctx.wgrad_kernel, ctx.dgrad_kernel = wgrad_kernel, dgrad_kernel
        return rk.fused_affine_conv3x3(x, kernel, bias, a, b, silu=True)

    @staticmethod
    def backward(ctx, g):
        x, kernel, a, b = ctx.saved_tensors
        g = g.contiguous()
        xf, z, sig = _silu_fwd_bwd(x, a, b)
        if ctx.wgrad_kernel:
            # K6 recomputes silu(a*x+b) from the raw input in its gather
            dkernel = rk.wgrad_conv3x3(x, g, a, b, silu=True)
        else:  # on the forward's effective conv operand
            dkernel = _library_wgrad((z * sig).to(x.dtype), kernel, g)
        ds = _dgrad(g, kernel, x.dtype, ctx.dgrad_kernel)
        dz = ds.float() * (sig * (1.0 + z * (1.0 - sig)))
        dx = (dz * a[:, None, None, :]).to(x.dtype)
        da = (dz * xf).sum((1, 2)).to(a.dtype)
        db = dz.sum((1, 2)).to(b.dtype)
        dbias = g.float().sum((0, 1, 2))
        return dx, dkernel.to(kernel.dtype), dbias, da, db, None, None


class _PlainConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, wgrad_kernel, dgrad_kernel):
        x = x.contiguous()
        ctx.save_for_backward(x, kernel)
        ctx.wgrad_kernel, ctx.dgrad_kernel = wgrad_kernel, dgrad_kernel
        return rk.fused_affine_conv3x3(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()
        if ctx.wgrad_kernel:
            dkernel = rk.wgrad_conv3x3(x, g)
        else:
            dkernel = _library_wgrad(x, kernel, g)
        dx = _dgrad(g, kernel, x.dtype, ctx.dgrad_kernel)
        dbias = g.float().sum((0, 1, 2))
        return dx.to(x.dtype), dkernel.to(kernel.dtype), dbias, None, None


def affine_silu_conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        a: torch.Tensor, b: torch.Tensor,
                        wgrad_kernel: bool = False, dgrad_kernel: bool = True) -> torch.Tensor:
    """y = conv3x3_same(silu(a*x + b), kernel) + bias with K1 forward
    (`v2a_tpu/ops/conv_vjp.py:73`); the input gradient by K1
    (`dgrad_kernel`) or the library, the weight gradient by K6
    (`wgrad_kernel`) or the library.

    x: (N, H, W, C); kernel: (3, 3, C, D) float32 parameter; bias: (D,);
    a, b: (N, C) float32 per-sample channel affine (the collapsed GroupNorm).
    Returns (N, H, W, D) in x.dtype. Eligibility (K1's channel gate) is the
    caller's job, as in the JAX package.
    """
    return _AffineSiluConv3x3.apply(x, kernel, bias, a, b, wgrad_kernel, dgrad_kernel)


def plain_conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  wgrad_kernel: bool = False, dgrad_kernel: bool = True) -> torch.Tensor:
    """y = conv3x3_same(x, kernel) + bias with K1 forward, the no-affine
    variant for convs with no norm before them, the upsample conv
    (`v2a_tpu/ops/conv_vjp.py:156`)."""
    return _PlainConv3x3.apply(x, kernel, bias, wgrad_kernel, dgrad_kernel)


def affine_silu_conv3x3_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                                  a: torch.Tensor, b: torch.Tensor,
                                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain autograd reference of the same composite
    (`v2a_tpu/ops/conv_vjp.py:204`): float32 affine + SiLU, the operand cast
    to the compute dtype for the conv."""
    dt = compute_dtype or x.dtype
    z = x.float() * a[:, None, None, :] + b[:, None, None, :]
    s = (z * torch.sigmoid(z)).to(dt)
    return _conv_nhwc(s, kernel) + bias.to(dt)
