"""Perceiver resampler that pools CLIP text tokens for the video U-Net.

Counterpart of `v2a_tpu/models/perceiver.py` (imagen-pytorch's
`PerceiverResampler`, `imagen.py:254-372`): 64 learned latents + 4 latents
from the mean-pooled sequence, then per layer cross-attention over
[tokens ; latents] with l2-normed q/k and learned per-dim scales, and a
gain-only-LayerNorm feed-forward. Parameter names follow the JAX tree
(`convert/from_jax.py`); dense layers are `nn.Linear`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense with a compute dtype: operands and bias cast to `dtype`."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerNorm32(nn.Module):
    """flax LayerNorm(eps 1e-5) computed in float32: `scale`, `bias`."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, 1e-5)


class GainLayerNorm(nn.Module):
    """imagen's LayerNorm (`imagen.py:198-213`): gain `g` only, biased
    variance, eps 1e-5, float32; output in the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        mean = x32.mean(dim=-1, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + 1e-5) * self.g).to(self.dtype)


def _l2norm(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)


class PerceiverAttention(nn.Module):
    """`imagen.py:254-321`: latents query [tokens ; latents]; fixed logit
    scale 8."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, scale: float = 8.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads, self.scale, self.dtype = dim_head, heads, scale, dtype
        self.norm = LayerNorm32(dim)
        self.norm_latents = LayerNorm32(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.out_norm = LayerNorm32(dim)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.norm(x).to(dt)
        latents = self.norm_latents(latents).to(dt)
        q = _linear(latents, self.to_q, dt)
        k, v = _linear(torch.cat([x, latents], dim=-2), self.to_kv, dt).chunk(2, dim=-1)
        b, nq = q.shape[:2]
        q = q.reshape(b, nq, self.heads, self.dim_head)
        k = k.reshape(b, k.shape[1], self.heads, self.dim_head)
        v = v.reshape(b, v.shape[1], self.heads, self.dim_head)
        q = _l2norm(q.float()) * self.q_scale
        k = _l2norm(k.float()) * self.k_scale
        sim = torch.einsum("bihd,bjhd->bhij", q, k) * self.scale
        attn = torch.softmax(sim, dim=-1).to(dt)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, nq, -1)
        return self.out_norm(_linear(out, self.to_out, dt)).to(dt)


class FeedForward(nn.Module):
    """`imagen.py:1009-1017`: GainLN -> Dense(4x) -> GELU -> GainLN -> Dense."""

    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(dim * mult)
        self.dtype = dtype
        self.norm_in = GainLayerNorm(dim, dtype)
        self.dense_in = nn.Linear(dim, hidden, bias=False)
        self.norm_hidden = GainLayerNorm(hidden, dtype)
        self.dense_out = nn.Linear(hidden, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(_linear(self.norm_in(x), self.dense_in, self.dtype))
        return _linear(self.norm_hidden(x), self.dense_out, self.dtype)


class PerceiverResampler(nn.Module):
    """`imagen.py:321-372` with the Libero defaults (64 latents, 4 pooled
    latents, dim_head 64, 8 heads, learned positions over tokens)."""

    def __init__(self, dim: int, depth: int = 2, dim_head: int = 64, heads: int = 8,
                 num_latents: int = 64, num_latents_mean_pooled: int = 4,
                 max_seq_len: int = 512, ff_mult: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.depth, self.dtype = dim, depth, dtype
        self.num_latents_mean_pooled = num_latents_mean_pooled
        self.pos_emb = nn.Parameter(torch.empty(max_seq_len, dim))
        self.latents = nn.Parameter(torch.empty(num_latents, dim))
        self.init_std = {"pos_emb": 1.0, "latents": 1.0}
        if num_latents_mean_pooled > 0:
            self.pool_norm = GainLayerNorm(dim, dtype)
            self.pool_proj = nn.Linear(dim, dim * num_latents_mean_pooled)
        for i in range(depth):
            self.add_module(f"attn_{i}", PerceiverAttention(dim, dim_head, heads, dtype=dtype))
            self.add_module(f"ff_{i}", FeedForward(dim, ff_mult, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        x_with_pos = x + self.pos_emb[:n][None].to(x.dtype)
        latents = self.latents[None].to(x.dtype).expand(b, -1, -1)
        if self.num_latents_mean_pooled > 0:
            pooled = _linear(self.pool_norm(x.mean(dim=1)), self.pool_proj, self.dtype)
            pooled = pooled.reshape(b, self.num_latents_mean_pooled, self.dim)
            latents = torch.cat([pooled, latents], dim=-2)
        for i in range(self.depth):
            latents = getattr(self, f"attn_{i}")(x_with_pos, latents) + latents
            latents = getattr(self, f"ff_{i}")(latents) + latents
        return latents
