"""Cross-attention-conditioned 3D video U-Net (the alternative backbone).

Counterpart of `v2a_tpu/models/video_unet_xattn.py` (the reference's
diffusers `UNet3DConditionModel` family, `flowdiffusion/flowdiffusion/model/
unet_3d_condition.py:556`): per level a ResNet block (per-frame 2D convs,
then an identity-initialized temporal conv), a spatial transformer with
self-attention and cross-attention over the text tokens, and a temporal
transformer (the frames of each pixel attend to each other). Text enters
through cross-attention, not the Perceiver-pooled additive embedding of
`models/video_unet.py`; both take (x, timesteps, task tokens).

Plain PyTorch, as the JAX module is plain XLA: its GroupNorms are
`GroupNorm32` on the plain path (K7 never runs here) and attention is
`F.scaled_dot_product_attention` (materialized logits of the 128^2 level
would take 7 x 8 x 16384^2 x 4 B, about 60 GB at B=1), in chunks of 2^15
sequences from 2^16 on, where cuDNN's backward fails. Channels-last;
GroupNorm and LayerNorm statistics in float32, the rest in the compute
dtype; the output conv in float32. Parameters keep the JAX tree's names
and layouts (conv kernels HWIO, temporal kernels (k, C_in, C_out)); dense
layers are `nn.Linear`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from v2a_tpu_torch.models.perceiver import LayerNorm32, _linear
from v2a_tpu_torch.models.video_unet import GroupNorm32, _Conv, _TemporalConv, timestep_embedding


def _conv3x3(x: torch.Tensor, conv: _Conv, dtype: torch.dtype, stride: int = 1) -> torch.Tensor:
    """flax Conv (3x3, padding 1) on (N, H, W, C) in `dtype`, bias after."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.kernel.to(dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=1).permute(0, 2, 3, 1)
    return y + conv.bias.to(dtype)


# cuDNN's attention backward fails from 2^16 sequences on (the temporal
# attention of a 128^2 level at B=4 has 4 * 128^2): from there the batch goes
# through in chunks of this many sequences, each sequence its own problem
_SDPA_CHUNK = 1 << 15


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    n = q.shape[0]
    if n < 2 * _SDPA_CHUNK:
        return F.scaled_dot_product_attention(q, k, v)
    return torch.cat([F.scaled_dot_product_attention(q[i:i + _SDPA_CHUNK], k[i:i + _SDPA_CHUNK],
                                                     v[i:i + _SDPA_CHUNK])
                      for i in range(0, n, _SDPA_CHUNK)])


def _frames(fn, x: torch.Tensor) -> torch.Tensor:
    """A per-frame op on (B, F, H, W, C), F folded into the batch."""
    b, f = x.shape[:2]
    y = fn(x.reshape((b * f,) + tuple(x.shape[2:])))
    return y.reshape((b, f) + tuple(y.shape[1:]))


class _Attention(nn.Module):
    """Multi-head attention, cross when a context is given (kv from it)."""

    def __init__(self, dim: int, heads: int = 8, context_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        kv = context_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv, dim, bias=False)
        self.to_v = nn.Linear(kv, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        dt, n_h = self.dtype, self.heads

        def heads(t):  # (N, L, dim) -> (N, heads, L, d)
            return t.reshape(t.shape[0], t.shape[1], n_h, -1).transpose(1, 2)

        q = heads(_linear(x, self.to_q, dt))
        k, v = heads(_linear(ctx, self.to_k, dt)), heads(_linear(ctx, self.to_v, dt))
        out = _sdpa(q, k, v).transpose(1, 2)
        out = out.reshape(x.shape[0], x.shape[1], self.dim)
        return _linear(out, self.to_out, dt)


class _TransformerBlock(nn.Module):
    """Pre-LN: self-attention, cross-attention, GEGLU feed-forward with the
    exact GELU (the BasicTransformerBlock of `attention_processor.py`)."""

    def __init__(self, dim: int, heads: int, context_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln1, self.ln2, self.ln3 = LayerNorm32(dim), LayerNorm32(dim), LayerNorm32(dim)
        self.self_attn = _Attention(dim, heads, dtype=dtype)
        self.cross_attn = _Attention(dim, heads, context_dim, dtype)
        self.ff_in = nn.Linear(dim, dim * 8)
        self.ff_out = nn.Linear(dim * 4, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x + self.self_attn(self.ln1(x).to(dt))
        x = x + self.cross_attn(self.ln2(x).to(dt), context)
        a, g = _linear(self.ln3(x).to(dt), self.ff_in, dt).chunk(2, dim=-1)
        return x + _linear(a * F.gelu(g), self.ff_out, dt)


class SpatialCrossAttnBlock(nn.Module):
    """Per-frame spatial transformer with text cross-attention
    (`Transformer2DModel`): tokens are the H*W pixels, the context tokens
    repeated per frame."""

    def __init__(self, dim: int, context_dim: int, heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = GroupNorm32(dim)
        self.proj_in = nn.Linear(dim, dim)
        self.block = _TransformerBlock(dim, heads, context_dim, dtype)
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        dt = self.dtype
        y = _linear(self.norm(x.reshape(b * f, h * w, c)).to(dt), self.proj_in, dt)
        y = self.block(y, context.repeat_interleave(f, dim=0))
        return x + _linear(y, self.proj_out, dt).reshape(x.shape)


class TemporalAttnBlock(nn.Module):
    """The frames of each pixel attend to each other
    (`TransformerTemporalModel`)."""

    def __init__(self, dim: int, heads: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm32(dim)
        self.attn = _Attention(dim, heads, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        y = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c)
        y = y + self.attn(self.norm(y).to(self.dtype))
        return y.reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4)


class ResBlock2p1D(nn.Module):
    """Per-frame 2D ResNet block, then a temporal conv over the frames
    (identity-initialized, as `_dirac_init`), FiLM'd by the timestep
    (`resnet.py` + `TemporalConvLayer`); a 1x1 skip projection where the
    channels change."""

    def __init__(self, cin: int, out_channels: int, emb_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cin, self.out_channels, self.dtype = cin, out_channels, dtype
        self.norm1 = GroupNorm32(cin, with_silu=True)
        self.conv1 = _Conv(3, cin, out_channels)
        self.time_proj = nn.Linear(emb_dim, out_channels)
        self.norm2 = GroupNorm32(out_channels, with_silu=True)
        self.conv2 = _Conv(3, out_channels, out_channels)
        self.temporal_conv = _TemporalConv(out_channels)
        if cin != out_channels:
            self.skip = _Conv(1, cin, out_channels)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        dt, d = self.dtype, self.out_channels
        y = _frames(lambda t: _conv3x3(t, self.conv1, dt), self.norm1(x).to(dt))
        y = y + _linear(F.silu(emb.to(dt)), self.time_proj, dt)[:, None, None, None, :]
        y = _frames(lambda t: _conv3x3(t, self.conv2, dt), self.norm2(y).to(dt))
        # the 3-tap conv over zero-padded frames as one (3D, D) product
        f = y.shape[1]
        yp = F.pad(y, (0, 0, 0, 0, 0, 0, 1, 1))
        y = (torch.cat([yp[:, 0:f], yp[:, 1:f + 1], yp[:, 2:f + 2]], dim=-1)
             @ self.temporal_conv.kernel.to(dt).reshape(3 * d, d) + self.temporal_conv.bias.to(dt))
        if self.cin != d:
            x = x.to(dt) @ self.skip.kernel.to(dt).reshape(self.cin, d) + self.skip.bias.to(dt)
        return x + y


class VideoUNetXAttn(nn.Module):
    """The alternative video backbone, with `VideoUNet`'s calling convention:
    (B, F, H, W, in_channels) x timesteps x task tokens -> (B, F, H, W,
    out_channels) float32. `use_checkpoint`: each `ResBlock2p1D`,
    `SpatialCrossAttnBlock` and `TemporalAttnBlock` recomputed in the
    backward (`torch.utils.checkpoint(use_reentrant=False)` while grad mode
    is on; the JAX module's `nn.remat`, :185-199)."""

    def __init__(self, in_channels: int = 6, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (64, 128, 256), layers_per_block: int = 1,
                 attn_heads: int = 8, context_dim: int = 512,
                 dtype: torch.dtype = torch.float32, use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        chans = tuple(block_out_channels)
        self.chans, self.layers, self.dtype = chans, layers_per_block, dtype
        ch0, ctx = chans[0], chans[-1]
        temb = ch0 * 4
        self.time_dense0 = nn.Linear(ch0, temb)
        self.time_dense1 = nn.Linear(temb, temb)
        self.context_proj = nn.Linear(context_dim, ctx)
        self.conv_in = _Conv(3, in_channels, ch0)

        def block(name, i, cin, ch):  # the JAX names: {name}_res{i}, _xattn{i}, _tattn{i}
            self.add_module(f"{name}_res{i}", ResBlock2p1D(cin, ch, temb, dtype))
            self.add_module(f"{name}_xattn{i}", SpatialCrossAttnBlock(ch, ctx, attn_heads, dtype))
            self.add_module(f"{name}_tattn{i}", TemporalAttnBlock(ch, dtype=dtype))

        skips, cur = [ch0], ch0
        for lv, ch in enumerate(chans):
            for i in range(layers_per_block):
                block(f"down_{lv}", i, cur, ch)
                cur = ch
                skips.append(ch)
            if lv != len(chans) - 1:
                self.add_module(f"down_{lv}_downsample", _Conv(3, ch, ch))
                skips.append(ch)
        self.mid_res0 = ResBlock2p1D(cur, cur, temb, dtype)
        self.mid_xattn = SpatialCrossAttnBlock(cur, ctx, attn_heads, dtype)
        self.mid_tattn = TemporalAttnBlock(cur, dtype=dtype)
        self.mid_res1 = ResBlock2p1D(cur, cur, temb, dtype)
        for lv, ch in reversed(list(enumerate(chans))):
            for i in range(layers_per_block + 1):
                block(f"up_{lv}", i, cur + skips.pop(), ch)
                cur = ch
            if lv:
                self.add_module(f"up_{lv}_upsample", _Conv(3, ch, ch))
        self.out_norm = GroupNorm32(cur, with_silu=True)
        self.conv_out = _Conv(3, cur, out_channels)

    def _block(self, mod: nn.Module, *args):
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(mod, *args, use_reentrant=False)
        return mod(*args)

    def _triple(self, name: str, i: int, y, emb, ctx):
        y = self._block(getattr(self, f"{name}_res{i}"), y, emb)
        y = self._block(getattr(self, f"{name}_xattn{i}"), y, ctx)
        return self._block(getattr(self, f"{name}_tattn{i}"), y)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                task_tokens: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        emb = _linear(timestep_embedding(timesteps, self.chans[0]).to(dt), self.time_dense0, dt)
        emb = _linear(F.silu(emb), self.time_dense1, dt)
        ctx = _linear(task_tokens.to(dt), self.context_proj, dt)
        y = _frames(lambda t: _conv3x3(t, self.conv_in, dt), x.to(dt))
        skips = [y]
        for lv in range(len(self.chans)):
            for i in range(self.layers):
                y = self._triple(f"down_{lv}", i, y, emb, ctx)
                skips.append(y)
            if lv != len(self.chans) - 1:
                conv = getattr(self, f"down_{lv}_downsample")
                y = _frames(lambda t: _conv3x3(t, conv, dt, stride=2), y)
                skips.append(y)
        y = self._block(self.mid_res0, y, emb)
        y = self._block(self.mid_tattn, self._block(self.mid_xattn, y, ctx))
        y = self._block(self.mid_res1, y, emb)
        for lv in reversed(range(len(self.chans))):
            for i in range(self.layers + 1):
                y = self._triple(f"up_{lv}", i, torch.cat([y, skips.pop()], dim=-1), emb, ctx)
            if lv:
                conv = getattr(self, f"up_{lv}_upsample")
                b, f, h, w, c = y.shape
                y = y[:, :, :, None, :, None, :].expand(b, f, h, 2, w, 2, c).reshape(
                    b, f, 2 * h, 2 * w, c)
                y = _frames(lambda t: _conv3x3(t, conv, dt), y)
        y = self.out_norm(y).to(dt)
        return _frames(lambda t: _conv3x3(t, self.conv_out, torch.float32), y).float()
