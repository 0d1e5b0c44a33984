"""Image-mode guided-diffusion U-Net and noisy classifier (channels-last).

Counterpart of `v2a_tpu/models/image_unet.py` (the reference's 2D image
path: `guided_diffusion/unet.py:396-702` `UNetModel` with class
conditioning, `:704-830` `EncoderUNetModel`, and the super-resolution
conditioning of `:833-856` `SuperResModel`). They back the guided CLIs
(`v2a_tpu_torch/scripts/guided/`).

Plain PyTorch, as the JAX module is plain XLA: its GroupNorms are
`GroupNorm32` on the plain path (never `use_pallas`), its convs
`F.conv2d`, its attention a `torch.matmul` chain with the JAX rounding
points (the product in the compute dtype, cast to float32, the softmax in
float32, the probabilities cast back). No kernel of the port runs here.

- (B, H, W, C) at every boundary; parameters keep the JAX tree's names and
  layouts (conv kernels HWIO in `_Conv`, dense layers `nn.Linear`,
  `label_emb` an embedding (num_classes, 4 * model_channels)).
- Compute in `dtype` (float32, or bfloat16 for `--use_fp16`); GroupNorm
  statistics in float32; parameters float32; the output float32.
- The QKV projection is laid out per head: each head's 3 * dh columns are
  [q | k | v] (the JAX reshape to (b, hw, heads, 3 * dh), then the split).
- The layers JAX initializes to zero (`ResBlock2D.out_conv`,
  `AttentionBlock2D.proj`, `ImageUNet.out_conv`, the adaptive pool's
  `head_dense`) are flagged `zero_init`, which `models/init.py::init_params`
  leaves at zero: a fresh net outputs exactly zero, as the JAX one does.
- `use_checkpoint` recomputes each ResBlock and attention block in the
  backward pass (`torch.utils.checkpoint`, the JAX `nn.remat`).
- `EncoderUNet(pool="spatial")` needs `image_size` (its first dense layer's
  input width), which flax infers at the first call.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from v2a_tpu_torch.models.perceiver import _linear
from v2a_tpu_torch.models.video_unet import GroupNorm32, _Conv, timestep_embedding

POOLS = ("adaptive", "attention", "spatial")


def _groups(c: int) -> int:
    """32 groups at production widths (`nn.py:160-167`); the largest
    divisor <= 32 at the tiny widths hermetic tests use."""
    g = min(32, c)
    while c % g:
        g -= 1
    return g


def _norm(c: int, with_silu: bool = False) -> GroupNorm32:
    return GroupNorm32(c, with_silu=with_silu, num_groups=_groups(c))


def _zero(module: nn.Module) -> nn.Module:
    """A layer JAX initializes to zero: zeroed, and left so by
    `init_params`."""
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    module.zero_init = True
    return module


def _conv(x: torch.Tensor, conv: _Conv, dtype: torch.dtype, stride: int = 1) -> torch.Tensor:
    """flax Conv (k x k, padding k // 2, symmetric) on (N, H, W, C) in
    `dtype`, the bias added in `dtype`."""
    k = conv.kernel.shape[0]
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.kernel.to(dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=k // 2).permute(0, 2, 3, 1)
    return y + conv.bias.to(dtype)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")` to twice the size: a repeat."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.avg_pool` 2x2, stride 2."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _attend(q, k, v, dh: int, dtype: torch.dtype) -> torch.Tensor:
    """(b, q, heads, dh) x (b, k, heads, dh) -> (b, q, heads, dh): the product
    in `dtype`, the softmax in float32, the probabilities back in `dtype`."""
    logits = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)).float()
    probs = torch.softmax(logits / math.sqrt(dh), dim=-1).to(dtype)
    return torch.matmul(probs, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)


def _qkv(x: torch.Tensor, layer: nn.Linear, heads: int, dh: int, dtype: torch.dtype):
    """The per-head [q | k | v] split of one dense projection."""
    b, n = x.shape[:2]
    return torch.split(_linear(x, layer, dtype).reshape(b, n, heads, 3 * dh), dh, dim=-1)


class ResBlock2D(nn.Module):
    """GN -> SiLU -> conv -> (+emb, scale-shift optional) -> GN -> SiLU ->
    conv + skip, with optional built-in resampling (`unet.py:148-261`)."""

    def __init__(self, cin: int, features: int, emb_dim: int,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cin, self.features, self.dtype = cin, features, dtype
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_norm = _norm(cin, with_silu=True)
        self.in_conv = _Conv(3, cin, features)
        self.emb_dense = nn.Linear(emb_dim, features * (2 if use_scale_shift_norm else 1))
        self.out_norm = _norm(features, with_silu=not use_scale_shift_norm)
        self.out_conv = _zero(_Conv(3, features, features))
        if cin != features:
            self.skip_conv = _Conv(1, cin, features)

    def _resample(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            return _upsample2x(x)
        if self.down:
            return _avg_pool2x(x)
        return x

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self._resample(self.in_norm(x))
        x = self._resample(x)
        h = _conv(h, self.in_conv, dt)
        emb_out = _linear(F.silu(emb), self.emb_dense, dt)[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=-1)
            h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            h = self.out_norm(h + emb_out)
        h = _conv(h, self.out_conv, dt)
        if self.cin != self.features:
            x = _conv(x, self.skip_conv, dt)
        return x + h


class AttentionBlock2D(nn.Module):
    """Multi-head self-attention over spatial positions
    (`unet.py:263-330`), float32 softmax, zero-initialized output
    projection."""

    def __init__(self, c: int, num_head_channels: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = max(c // num_head_channels, 1)
        self.dh, self.dtype = c // self.heads, dtype
        self.norm = _norm(c)
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = _zero(nn.Linear(c, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        dt = self.dtype
        q, k, v = _qkv(self.norm(x).reshape(b, h * w, c), self.qkv, self.heads, self.dh, dt)
        o = _attend(q, k, v, self.dh, dt).reshape(b, h * w, c)
        return x + _linear(o, self.proj, dt).reshape(b, h, w, c)


def _downsample(parent: nn.Module, name: str, ch: int, emb_dim: int, sss: bool,
                resblock_updown: bool, dtype: torch.dtype) -> None:
    if resblock_updown:
        parent.add_module(name, ResBlock2D(ch, ch, emb_dim, sss, down=True, dtype=dtype))
    else:
        parent.add_module(name, _Conv(3, ch, ch))


class _Body(nn.Module):
    """The shared front of both nets: the timestep embedding, the entry
    conv, the down path (with its skip channels) and the middle."""

    def _build_front(self, in_channels, model_channels, num_res_blocks, attention_resolutions,
                     channel_mult, num_head_channels, use_scale_shift_norm, resblock_updown,
                     dtype, use_checkpoint):
        mc = model_channels
        self.model_channels, self.num_res_blocks = mc, num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.resblock_updown, self.dtype = resblock_updown, dtype
        self.use_checkpoint = use_checkpoint
        emb_dim, sss = mc * 4, use_scale_shift_norm
        self.time_dense0 = nn.Linear(mc, emb_dim)
        self.time_dense1 = nn.Linear(emb_dim, emb_dim)
        self.in_conv = _Conv(3, in_channels, mc)
        ch, ds, skips = mc, 1, [mc]
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                out = int(mult * mc)
                self.add_module(f"down_{level}_{i}", ResBlock2D(ch, out, emb_dim, sss, dtype=dtype))
                ch = out
                if ds in self.attention_resolutions:
                    self.add_module(f"down_{level}_{i}_attn",
                                    AttentionBlock2D(ch, num_head_channels, dtype))
                skips.append(ch)
            if level != len(self.channel_mult) - 1:
                _downsample(self, f"down_{level}_down", ch, emb_dim, sss, resblock_updown, dtype)
                skips.append(ch)
                ds *= 2
        mid = int(self.channel_mult[-1] * mc)
        self.mid_res0 = ResBlock2D(ch, mid, emb_dim, sss, dtype=dtype)
        self.mid_attn = AttentionBlock2D(mid, num_head_channels, dtype)
        self.mid_res1 = ResBlock2D(mid, mid, emb_dim, sss, dtype=dtype)
        return mid, ds, skips

    def _block(self, module: nn.Module, *args):
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def _embed(self, timesteps: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        emb = _linear(timestep_embedding(timesteps, self.model_channels).to(dt),
                      self.time_dense0, dt)
        return _linear(F.silu(emb), self.time_dense1, dt)

    def _front(self, x: torch.Tensor, emb: torch.Tensor, skips: Optional[list]):
        dt = self.dtype
        h = _conv(x, self.in_conv, dt)
        if skips is not None:
            skips.append(h)
        ds = 1
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = self._block(getattr(self, f"down_{level}_{i}"), h, emb)
                if ds in self.attention_resolutions:
                    h = self._block(getattr(self, f"down_{level}_{i}_attn"), h)
                if skips is not None:
                    skips.append(h)
            if level != len(self.channel_mult) - 1:
                down = getattr(self, f"down_{level}_down")
                if self.resblock_updown:
                    h = self._block(down, h, emb)
                else:
                    h = _conv(h, down, dt, stride=2)
                if skips is not None:
                    skips.append(h)
                ds *= 2
        h = self._block(self.mid_res0, h, emb)
        h = self._block(self.mid_attn, h)
        return self._block(self.mid_res1, h, emb), ds


class ImageUNet(_Body):
    """2D guided-diffusion U-Net (`unet.py:396-702`): (B, H, W, in_channels)
    x timesteps [x labels] -> (B, H, W, out_channels) float32.

    `num_classes` enables class conditioning (the label embedding added to
    the timestep embedding, `unet.py:538-541`); `learn_sigma` callers set
    `out_channels = 2 * in_channels`. Super-res conditioning is the caller
    concatenating the upsampled low-res image on channels
    (`superres_condition`)."""

    def __init__(self, in_channels: int = 3, model_channels: int = 128, out_channels: int = 3,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (16, 8),
                 channel_mult: Sequence[float] = (1, 2, 4, 8),
                 num_classes: Optional[int] = None, num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True, resblock_updown: bool = False,
                 dtype: torch.dtype = torch.float32, use_checkpoint: bool = False):
        super().__init__()
        mc = model_channels
        self.num_classes = num_classes
        ch, ds, skips = self._build_front(
            in_channels, mc, num_res_blocks, attention_resolutions, channel_mult,
            num_head_channels, use_scale_shift_norm, resblock_updown, dtype, use_checkpoint)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, mc * 4)
        emb_dim, sss = mc * 4, use_scale_shift_norm
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            out = int(mult * mc)
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_{i}",
                                ResBlock2D(ch + skips.pop(), out, emb_dim, sss, dtype=dtype))
                ch = out
                if ds in self.attention_resolutions:
                    self.add_module(f"up_{level}_{i}_attn",
                                    AttentionBlock2D(ch, num_head_channels, dtype))
            if level:
                if resblock_updown:
                    self.add_module(f"up_{level}_up",
                                    ResBlock2D(ch, out, emb_dim, sss, up=True, dtype=dtype))
                else:
                    self.add_module(f"up_{level}_up", _Conv(3, ch, out))
                ds //= 2
        self.out_norm = _norm(ch, with_silu=True)
        self.out_conv = _zero(_Conv(3, ch, out_channels))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("y must be passed iff num_classes is set")
        dt = self.dtype
        emb = self._embed(timesteps)
        if self.num_classes is not None:
            emb = emb + self.label_emb(y).to(dt)
        skips = []
        h, ds = self._front(x, emb, skips)
        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = self._block(getattr(self, f"up_{level}_{i}"), h, emb)
                if ds in self.attention_resolutions:
                    h = self._block(getattr(self, f"up_{level}_{i}_attn"), h)
            if level:
                up = getattr(self, f"up_{level}_up")
                if self.resblock_updown:
                    h = self._block(up, h, emb)
                else:
                    h = _conv(_upsample2x(h), up, dt)
                ds //= 2
        return _conv(self.out_norm(h), self.out_conv, dt).float()


def superres_condition(x: torch.Tensor, low_res: torch.Tensor) -> torch.Tensor:
    """SuperResModel conditioning (`unet.py:843-851`): bilinear-upsample the
    low-res image to the model resolution and concat on channels.
    Half-pixel centres, edges clamped: at integer up-scales the same values
    as `jax.image.resize(..., "bilinear")`."""
    h, w = x.shape[1:3]
    up = F.interpolate(low_res.float().permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)
    return torch.cat([x, up.to(x.dtype)], dim=-1)


class EncoderUNet(_Body):
    """Half-U-Net classifier (`unet.py:704-830`): the down path of
    `ImageUNet` followed by a pooling head; (B, H, W, in_channels) x
    timesteps -> (B, out_channels) float32. The noisy classifier of guided
    sampling.

    Pools: 'adaptive' (mean-pool -> dense, `unet.py:786-793`), 'attention'
    (the mean token prepended and only it queries, `:794-802`), 'spatial'
    (flatten -> MLP, `:803-817`; needs `image_size`)."""

    def __init__(self, in_channels: int = 3, model_channels: int = 128,
                 out_channels: int = 1000, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (16, 8),
                 channel_mult: Sequence[float] = (1, 2, 4, 8), num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True, resblock_updown: bool = True,
                 pool: str = "adaptive", dtype: torch.dtype = torch.float32,
                 use_checkpoint: bool = False, image_size: Optional[int] = None):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"unknown pool {pool!r}")
        self.pool = pool
        ch, ds, _ = self._build_front(
            in_channels, model_channels, num_res_blocks, attention_resolutions, channel_mult,
            num_head_channels, use_scale_shift_norm, resblock_updown, dtype, use_checkpoint)
        self.heads = max(ch // num_head_channels, 1)
        self.dh = ch // self.heads
        if pool == "adaptive":
            self.head_norm = _norm(ch, with_silu=True)
            self.head_dense = _zero(nn.Linear(ch, out_channels))
        elif pool == "attention":
            self.head_norm = _norm(ch, with_silu=True)
            self.pool_qkv = nn.Linear(ch, 3 * ch)
            self.head_dense = nn.Linear(ch, out_channels)
        else:
            if image_size is None:
                raise ValueError("the spatial pool needs image_size")
            side = image_size // ds
            self.head_dense0 = nn.Linear(side * side * ch, 2048)
            self.head_dense1 = nn.Linear(2048, out_channels)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h, _ = self._front(x, self._embed(timesteps), None)
        if self.pool == "adaptive":
            h = self.head_norm(h).mean(dim=(1, 2))
            return _linear(h, self.head_dense, dt).float()
        if self.pool == "attention":
            b, hh, ww, c = h.shape
            tokens = self.head_norm(h).reshape(b, hh * ww, c)
            q_tok = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
            q, k, v = _qkv(q_tok, self.pool_qkv, self.heads, self.dh, dt)
            o = _attend(q[:, :1], k, v, self.dh, dt).reshape(b, c)
            return _linear(o, self.head_dense, dt).float()
        h = F.relu(_linear(h.reshape(h.shape[0], -1), self.head_dense0, dt))
        return _linear(h, self.head_dense1, dt).float()
