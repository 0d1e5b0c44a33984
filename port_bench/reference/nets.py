"""The plain networks of the video model in float32: the video U-Net, the
Perceiver that pools the text tokens, the CLIP text tower and the hash
tokenizer.

A frozen copy of the port's plain path (`models/video_unet.py`,
`models/perceiver.py`, `models/clip_text.py`), written from the
equations: one path, no kernels, no routing, every operation in float32.
Module and parameter names are the port's, so one state dict loads into
both. Videos are (B, F, H, W, C) channels-last.

`Precision` says how matmul and conv operands are rounded: not at all
(`"float32"`) or to float8 e4m3 with one scale per tensor (`"fp8"`, the
control: the reference computed one precision below the bfloat16 that the
configurations state). Gradients pass the rounding unchanged.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # largest finite float8 e4m3 value


class Precision:
    """The rounding of every matmul and conv operand."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
        q = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return t + (q - t).detach()


def linear(x, layer: nn.Linear, q: Precision):
    return F.linear(q(x), q(layer.weight), layer.bias)


# -- the U-Net ------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                       device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm32(nn.Module):
    """32 groups, statistics over every non-batch axis, eps 1e-5."""

    def __init__(self, channels: int, with_silu: bool = False):
        super().__init__()
        self.with_silu = with_silu
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[0], x.shape[-1]
        xg = x.reshape(b, -1, 32, c // 32)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean
        y = ((xg - mean) * torch.rsqrt(var.clamp(min=0.0) + 1e-5)).reshape(x.shape)
        y = y * self.scale + self.bias
        return F.silu(y) if self.with_silu else y


class _Conv(nn.Module):
    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k, k, cin, cout))
        self.bias = nn.Parameter(torch.empty(cout))


class _TemporalConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, c, c))
        self.bias = nn.Parameter(torch.empty(c))


class PseudoConv3d(nn.Module):
    """A k x k conv per frame (SAME, symmetric padding k // 2), then, for
    k > 1, a 3-tap conv over the frames with zero frames at both ends."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.spatial_conv = _Conv(k, cin, cout)
        if k > 1:
            self.temporal_conv = _TemporalConv(cout)

    def forward(self, x, q: Precision):
        b, f, h, w, c = x.shape
        wk = self.spatial_conv.kernel.permute(3, 2, 0, 1)
        y = F.conv2d(q(x.reshape(b * f, h, w, c).permute(0, 3, 1, 2)), q(wk),
                     self.spatial_conv.bias, stride=self.stride, padding=self.k // 2)
        y = y.permute(0, 2, 3, 1)
        y = y.reshape(b, f, y.shape[1], y.shape[2], y.shape[3])
        if self.k == 1:
            return y
        tk = self.temporal_conv.kernel
        yp = q(F.pad(y, (0, 0, 0, 0, 0, 0, 1, 1)))
        out = self.temporal_conv.bias
        for t in range(3):
            out = out + yp[:, t:t + f] @ q(tk[t])
        return out


class ResBlock3D(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.in_norm = GroupNorm32(cin, with_silu=True)
        self.in_conv = PseudoConv3d(cin, cout, 3)
        self.emb_proj = nn.Linear(emb_dim, cout)
        self.out_norm = GroupNorm32(cout, with_silu=True)
        self.out_conv = PseudoConv3d(cout, cout, 3)
        if cin != cout:
            self.skip_conv = PseudoConv3d(cin, cout, 1)

    def forward(self, x, emb, q: Precision):
        h = self.in_conv(self.in_norm(x), q)
        h = h + linear(F.silu(emb), self.emb_proj, q)[:, None, None, None, :]
        h = self.out_conv(self.out_norm(h), q)
        if self.cin != self.cout:
            x = self.skip_conv(x, q)
        return x + h


class SpatialAttentionBlock(nn.Module):
    """Self-attention within each frame; qkv split into heads before the
    q / k / v split; q and k each scaled by ch^-1/4."""

    def __init__(self, channels: int, head_channels: int):
        super().__init__()
        self.ch = head_channels
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, q: Precision):
        b, f, h, w, c = x.shape
        y = x.reshape(b * f, h * w, c)
        qkv = linear(self.norm(y), self.qkv, q).reshape(b * f, h * w, c // self.ch, 3 * self.ch)
        qq, kk, vv = qkv.chunk(3, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(self.ch))
        logits = torch.einsum("bthc,bshc->bhts", q(qq * scale), q(kk * scale))
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhts,bshc->bthc", q(weights), q(vv)).reshape(b * f, h * w, c)
        return (y + linear(out, self.proj_out, q)).reshape(x.shape)

    def parts(self, leaf: str, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A `qkv` leaf as its q, k and v projections in the heads' layout
        above (`<leaf>[q]`, `[k]`, `[v]`: each a leaf of its own in an
        unfused model); any other leaf whole."""
        if not leaf.startswith("qkv."):
            return {leaf: t}
        split = t.reshape(t.shape[0] // (3 * self.ch), 3, self.ch, *t.shape[1:])
        return {f"{leaf}[{p}]": split[:, i] for i, p in enumerate("qkv")}


class Downsample3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = PseudoConv3d(c, c, 3, stride=2)

    def forward(self, x, q: Precision):
        return self.conv(x, q)


class Upsample3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = PseudoConv3d(c, c, 3)

    def forward(self, x, q: Precision):
        b, f, h, w, c = x.shape
        x = x[:, :, :, None, :, None, :].expand(b, f, h, 2, w, 2, c).reshape(b, f, 2 * h, 2 * w, c)
        return self.conv(x, q)


class LayerNorm32(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, 1e-5)


class GainLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        return (x - x.mean(dim=-1, keepdim=True)) * torch.rsqrt(var + 1e-5) * self.g


def _l2norm(t):
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp(min=1e-12)


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm = LayerNorm32(dim)
        self.norm_latents = LayerNorm32(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.out_norm = LayerNorm32(dim)

    def forward(self, x, latents, q: Precision):
        x, latents = self.norm(x), self.norm_latents(latents)
        qq = linear(latents, self.to_q, q)
        kk, vv = linear(torch.cat([x, latents], dim=-2), self.to_kv, q).chunk(2, dim=-1)
        b, nq = qq.shape[:2]
        qq = _l2norm(qq.reshape(b, nq, self.heads, self.dim_head)) * self.q_scale
        kk = _l2norm(kk.reshape(b, kk.shape[1], self.heads, self.dim_head)) * self.k_scale
        vv = vv.reshape(b, vv.shape[1], self.heads, self.dim_head)
        attn = torch.softmax(torch.einsum("bihd,bjhd->bhij", q(qq), q(kk)) * 8.0, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", q(attn), q(vv)).reshape(b, nq, -1)
        return self.out_norm(linear(out, self.to_out, q))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.norm_in = GainLayerNorm(dim)
        self.dense_in = nn.Linear(dim, dim * mult, bias=False)
        self.norm_hidden = GainLayerNorm(dim * mult)
        self.dense_out = nn.Linear(dim * mult, dim, bias=False)

    def forward(self, x, q: Precision):
        x = F.gelu(linear(self.norm_in(x), self.dense_in, q))
        return linear(self.norm_hidden(x), self.dense_out, q)


class PerceiverResampler(nn.Module):
    """64 learned latents and 4 from the mean-pooled tokens; 2 layers of
    cross-attention over [tokens ; latents] and feed-forward."""

    def __init__(self, dim: int, depth: int = 2, num_latents: int = 64, pooled: int = 4,
                 max_seq_len: int = 512):
        super().__init__()
        self.dim, self.depth, self.pooled = dim, depth, pooled
        self.pos_emb = nn.Parameter(torch.empty(max_seq_len, dim))
        self.latents = nn.Parameter(torch.empty(num_latents, dim))
        self.pool_norm = GainLayerNorm(dim)
        self.pool_proj = nn.Linear(dim, dim * pooled)
        for i in range(depth):
            self.add_module(f"attn_{i}", PerceiverAttention(dim))
            self.add_module(f"ff_{i}", FeedForward(dim))

    def forward(self, x, q: Precision):
        b, n, _ = x.shape
        x_pos = x + self.pos_emb[:n][None]
        pooled = linear(self.pool_norm(x.mean(dim=1)), self.pool_proj, q)
        latents = torch.cat([pooled.reshape(b, self.pooled, self.dim),
                             self.latents[None].expand(b, -1, -1)], dim=-2)
        for i in range(self.depth):
            latents = getattr(self, f"attn_{i}")(x_pos, latents, q) + latents
            latents = getattr(self, f"ff_{i}")(latents, q) + latents
        return latents


class VideoUNet(nn.Module):
    """The video U-Net of `model` (the configuration's model section):
    input (B, F, H, W, channels + cond_channels), output (B, F, H, W,
    channels)."""

    def __init__(self, model: dict):
        super().__init__()
        mc, mult, nrb = model["model_channels"], tuple(model["channel_mult"]), \
            model["num_res_blocks"]
        self.mc, self.nrb, self.mult = mc, nrb, mult
        self.attn_res = tuple(model["attention_resolutions"])
        ted, ch, td = mc * 4, model["num_head_channels"], model["text_dim"]
        cin = model["channels"] + (model.get("cond_channels") or model["channels"])
        self.time_dense0 = nn.Linear(mc, ted)
        self.time_dense1 = nn.Linear(ted, ted)
        self.task_attnpool = PerceiverResampler(td)
        self.task_proj = nn.Linear(td, ted)
        self.in_conv = PseudoConv3d(cin, mc, 3)
        skips, cur, ds, bi = [mc], mc, 1, 0
        for level, m in enumerate(mult):
            c = m * mc
            for _ in range(nrb):
                self.add_module(f"down_res_{bi}", ResBlock3D(cur, c, ted))
                cur = c
                if ds in self.attn_res:
                    self.add_module(f"down_attn_{bi}", SpatialAttentionBlock(c, ch))
                skips.append(c)
                bi += 1
            if level != len(mult) - 1:
                self.add_module(f"downsample_{level}", Downsample3D(c))
                skips.append(c)
                ds *= 2
        self.mid_res0 = ResBlock3D(cur, cur, ted)
        self.mid_attn = SpatialAttentionBlock(cur, ch)
        self.mid_res1 = ResBlock3D(cur, cur, ted)
        bi = 0
        for level, m in reversed(list(enumerate(mult))):
            c = m * mc
            for i in range(nrb + 1):
                self.add_module(f"up_res_{bi}", ResBlock3D(cur + skips.pop(), c, ted))
                cur = c
                if ds in self.attn_res:
                    self.add_module(f"up_attn_{bi}", SpatialAttentionBlock(c, ch))
                if level and i == nrb:
                    self.add_module(f"upsample_{level}", Upsample3D(c))
                    ds //= 2
                bi += 1
        self.out_norm = GroupNorm32(cur, with_silu=True)
        self.out_conv = PseudoConv3d(cur, model["channels"], 3)

    def split_leaves(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`tensors`, named as this module's parameters, with each attention
        block's fused projection split into its q, k and v parts."""
        out = {}
        for name, t in tensors.items():
            owner, _, leaf = name.partition(".")
            block = getattr(self, owner, None)
            if isinstance(block, SpatialAttentionBlock):
                out.update({f"{owner}.{k}": v for k, v in block.parts(leaf, t).items()})
            else:
                out[name] = t
        return out

    def forward(self, x, t, task_embed, q: Precision):
        emb = linear(timestep_embedding(t, self.mc), self.time_dense0, q)
        emb = linear(F.silu(emb), self.time_dense1, q)
        latents = self.task_attnpool(task_embed, q)
        emb = emb + linear(latents, self.task_proj, q).mean(dim=1)
        h = self.in_conv(x, q)
        hs, ds, bi = [h], 1, 0
        for level in range(len(self.mult)):
            for _ in range(self.nrb):
                h = getattr(self, f"down_res_{bi}")(h, emb, q)
                if ds in self.attn_res:
                    h = getattr(self, f"down_attn_{bi}")(h, q)
                hs.append(h)
                bi += 1
            if level != len(self.mult) - 1:
                h = getattr(self, f"downsample_{level}")(h, q)
                hs.append(h)
                ds *= 2
        h = self.mid_res1(self.mid_attn(self.mid_res0(h, emb, q), q), emb, q)
        bi = 0
        for level in reversed(range(len(self.mult))):
            for i in range(self.nrb + 1):
                h = getattr(self, f"up_res_{bi}")(torch.cat([h, hs.pop()], dim=-1), emb, q)
                if ds in self.attn_res:
                    h = getattr(self, f"up_attn_{bi}")(h, q)
                if level and i == self.nrb:
                    h = getattr(self, f"upsample_{level}")(h, q)
                    ds //= 2
                bi += 1
        return self.out_conv(self.out_norm(h), q)


# -- the text tower ------------------------------------------------------------


VOCAB_SIZE, MAX_POSITIONS, BOS_ID, EOS_ID = 49408, 77, 49406, 49407


def tokenize(texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """The hash tokenizer of the port's offline text path: '-' and '_' to
    spaces, whitespace words to sha1-derived ids in the CLIP vocabulary,
    BOS / EOS, padded to the longest sequence; (ids, mask)."""
    seqs = []
    for t in texts:
        words = t.replace("-", " ").replace("_", " ").split()
        ids = [int.from_bytes(hashlib.sha1(wd.lower().encode()).digest()[:4], "little")
               % (BOS_ID - 1) + 1 for wd in words]
        seqs.append([BOS_ID] + ids[:MAX_POSITIONS - 2] + [EOS_ID])
    n = max(len(s) for s in seqs)
    ids = np.zeros((len(seqs), n), np.int64)
    mask = np.zeros((len(seqs), n), np.int64)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
        mask[i, :len(s)] = 1
    return ids, mask


class ClipTextBlock(nn.Module):
    def __init__(self, width: int, heads: int = 8):
        super().__init__()
        self.width, self.heads = width, heads
        self.ln1 = LayerNorm32(width)
        self.q = nn.Linear(width, width)
        self.k = nn.Linear(width, width)
        self.v = nn.Linear(width, width)
        self.proj = nn.Linear(width, width)
        self.ln2 = LayerNorm32(width)
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x, attn_bias, q: Precision):
        h = self.ln1(x)
        b, n, _ = h.shape
        hd = self.width // self.heads
        qq, kk, vv = (linear(h, lin, q).reshape(b, n, self.heads, hd)
                      for lin in (self.q, self.k, self.v))
        logits = torch.einsum("bihd,bjhd->bhij", q(qq), q(kk)) / math.sqrt(hd)
        weights = torch.softmax(logits + attn_bias, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", q(weights), q(vv)).reshape(b, n, self.width)
        x = x + linear(out, self.proj, q)
        h = linear(self.ln2(x), self.fc1, q)
        return x + linear(h * torch.sigmoid(1.702 * h), self.fc2, q)


class ClipTextEncoder(nn.Module):
    """CLIP's text tower (12 layers, 8 heads, quick-GELU, causal and padding
    masks); the last hidden state."""

    def __init__(self, width: int, layers: int = 12):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Embedding(VOCAB_SIZE, width)
        self.position_embedding = nn.Parameter(torch.empty(MAX_POSITIONS, width))
        for i in range(layers):
            self.add_module(f"block_{i}", ClipTextBlock(width))
        self.final_ln = LayerNorm32(width)

    def forward(self, ids, mask, q: Precision):
        n = ids.shape[1]
        x = self.token_embedding(ids) + self.position_embedding[:n][None]
        bias = torch.triu(torch.full((n, n), float("-inf"), device=ids.device), diagonal=1)
        bias = bias[None, None] + torch.zeros(mask.shape, device=ids.device).masked_fill(
            mask <= 0, float("-inf"))[:, None, None, :]
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, bias, q)
        return self.final_ln(x)

    def encode(self, tasks: List[str], q: Precision) -> torch.Tensor:
        dev = self.position_embedding.device
        ids, mask = tokenize(tasks)
        return self(torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev), q)


class VideoNets(nn.Module):
    """`unet.*` and `text.*` under one state dict, as the port's."""

    def __init__(self, model: dict):
        super().__init__()
        self.unet = VideoUNet(model)
        self.text = ClipTextEncoder(model["text_dim"])
