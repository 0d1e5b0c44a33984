"""3D video diffusion U-Net (channels-last), with the fused routings.

Counterpart of `v2a_tpu/models/video_unet.py` (the guided-diffusion
`UNetModel` as configured by `Unet_Libero`): model_channels 128,
channel_mult (1,2,3,4,5), 2 res blocks per level, spatial attention at
downsample rates 8 and 16, head width 32, factorized pseudo-3D convs,
Perceiver-pooled CLIP text conditioning.

- Activations are (B, F, H, W, C); spatial convs fold F into the batch.
- The temporal conv is a 3-tap identity-initialized conv over F, zero-padded
  on both sides (not causal, as in the reference).
- GroupNorm(32) statistics and softmax run in float32; convs and matmuls in
  the compute dtype.
- `fused=True` routes through the kernels of `ops/resblock_kernels.py`, as
  the JAX package's fused forward does with its default flags. 3x3
  stride-1 convs whose channels are multiples of 128 run through K1
  (`fused_affine_conv3x3`, the GroupNorm collapsed to a per-(B, C) affine
  applied inside the conv), temporal convs with 128-multiple features
  through K2 (`temporal_conv_fused`, which also adds the embedding /
  residual and emits the next GroupNorm's statistics). Each (activation,
  statistics) pair travels together through the network. The K1 gate's
  bounds are `ConvRouting.spatial2_min_ch` / `spatial2_max_s`, at the JAX
  defaults (MIN_CH 128, MAX_S 16384).
- `padded_stream=True` (the default, used only with `fused`) keeps the
  levels with H*W > 512 in the `PaddedStream` layout: their convs run K3
  (`fused_conv_tconv_padded`) or K4a + K4b where the JAX package's rule
  says K3 does not fit, the upsample convs into them run K5, and the
  ResBlocks' 1x1 skip projections fold into K3 / K4b. `padded_stream=False`
  is the unpadded routing (K1 / K2 only).
- `train_fused=True` (without `fused`) is the training routing of the JAX
  package: every ResBlock GN -> SiLU -> conv3x3 half and every upsample
  conv whose channels pass K1's gate runs through the autograd Functions of
  `ops/conv_vjp.py` (K1 forward, K1 dgrad, and K6 as the wgrad with
  `wgrad_kernel=True`); the GroupNorm reaches them as a per-(B, C) affine.
  Everything else is the plain path. The fused forward kernels have no
  backward; training never takes `fused`.
- Three more serving routings, each an argument off by default as its JAX
  flag is: `downconv` (the padded downsamples through K8,
  `fused_downconv3x3_padded`), `attn_kernel` (the attention blocks through
  K9, `fused_spatial_attention_padded`), both with `fused`; and
  `use_pallas_gn` (the non-fused forward's GroupNorms without forwarded
  statistics through K7, `ops/group_norm.py`).
- The conv switches of `ConvRouting`, with `fused`: `spatial2_min_ch=0`
  (the JAX package's `V2A_SPATIAL2_MIN_CH=0`) turns the K1 gate off, and
  with it the padded stream; `spatial2_max_s` bounds the gate's H*W
  (`V2A_SPATIAL2_MAX_S`: at 512 K1 runs only at 16^2 and 8^2, and no level
  is padded); `pallas_spatial` sends the 3x3 stride-1 convs the gate leaves
  with 128-multiple channels to K10 (`spatial_conv3x3`, one launch per
  channel part, the parts summed in the compute dtype); `tconv_hw` swaps K2
  for K11 (`temporal_conv_fused_hw`); `stream_kernel` takes K12
  (`fused_conv_tconv_stream`) before K3 in every padded conv without a skip
  fold where `rk.stream_band_rows` admits it; `mega_kernel=False`
  (`V2A_MEGA_KERNEL=0`) runs K4a then K4b where K3 would run;
  `upconv=False` (`V2A_UPCONV=0`) runs an upsample conv into a padded level
  as nearest-2x, pad, then the padded conv (K3, or K4a then K4b) where K5
  ran; `entry_pad` (`V2A_ENTRY_PAD=1`) runs the 6-channel entry conv on the
  padded stream (K3, or K4a then K4b), the kernels' wrappers zero-extending
  its channels to 32.
- The JAX package's `V2A_ATTN_HMAJOR=1` has no switch here: its head-major
  attention is the same math with the same roundings as the one plain path
  below (it only spares XLA some layout copies), and the tests hold that
  path against the JAX module with the flag on and off.

Parameters keep the JAX tree's names and layouts (conv kernels HWIO,
temporal kernels (k, C_in, C_out)); dense layers are `nn.Linear`. Both
routings take the same parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from v2a_tpu_torch.models.perceiver import PerceiverResampler, _linear
from v2a_tpu_torch.ops import conv_vjp
from v2a_tpu_torch.ops import group_norm as gn
from v2a_tpu_torch.ops import resblock_kernels as rk

@dataclasses.dataclass(frozen=True)
class ConvRouting:
    """The fused forward's conv switches, each a module flag of the JAX
    package (`v2a_tpu/models/video_unet.py:53-161`), each at its JAX default.

    spatial2_min_ch, spatial2_max_s: the K1 gate (`spatial2_eligible`: 3x3
        stride-1 convs with 128-multiple channels, features >= MIN_CH, H*W
        <= MAX_S), and with it the padded stream and `train_fused`; 0 turns
        it off (`V2A_SPATIAL2_MIN_CH`, `V2A_SPATIAL2_MAX_S`, :103, :108).
    pallas_spatial: K10 for the 3x3 stride-1 convs the K1 gate leaves
        (`PERF_PALLAS_SPATIAL`, :531-577, :679-694).
    tconv_hw: K11 in place of K2 (`PERF_TCONV_HW`, :784).
    stream_kernel: K12 before K3 in the padded conv (`V2A_STREAM_KERNEL=1`,
        :945-979).
    mega_kernel: K3 where `rk.conv_tconv_band_rows` admits it; False runs
        K4a then K4b there (`PERF_MEGA_KERNEL`, `V2A_MEGA_KERNEL=0`, :981).
    upconv: K5 for the upsample convs into a padded level; False runs
        nearest-2x, pad, then the padded conv (`PERF_UPCONV`, :130, :1592).
    entry_pad: the entry conv on the padded stream (`PERF_ENTRY_PAD`, :142,
        :1737)."""

    spatial2_min_ch: int = 128
    spatial2_max_s: int = 16384
    pallas_spatial: bool = False
    tconv_hw: bool = False
    stream_kernel: bool = False
    mega_kernel: bool = True
    upconv: bool = True
    entry_pad: bool = False

    def spatial2_eligible(self, features: int, cins, hw: int, k: int, stride: int) -> bool:
        """Shape gate for K1 (`v2a_tpu/models/video_unet.py:206`)."""
        if not self.spatial2_min_ch or k != 3 or stride != 1:
            return False
        if features % 128 or features < self.spatial2_min_ch or hw > self.spatial2_max_s:
            return False
        return all(c % 128 == 0 for c in cins)

    def padded_eligible(self, features: int, cins, hw: int) -> bool:
        """Gate of the padded-stream layout (`v2a_tpu/models/video_unet.py:197`):
        the K1 gate and H*W > 512, i.e. the 128^2 .. 32^2 levels."""
        return self.spatial2_eligible(features, cins, hw, 3, 1) and hw > 512


class PaddedStream:
    """A (B, F, Hp, Wp, C) activation in the padded-stream layout of
    `rk.padded_hw`: the interior at rows 1..H, cols 1..W. Pad cols are zero
    in the output of every conv / temporal-conv producer; pad rows hold
    anything (NaN included), so every consumer takes the interior by
    selection, and statistics are interior sums (`video_unet.py:164-173`)."""

    __slots__ = ("x", "hw")

    def __init__(self, x: torch.Tensor, hw):
        self.x, self.hw = x, tuple(hw)


def pad_stream(h: torch.Tensor) -> PaddedStream:
    """(B, F, H, W, C) -> PaddedStream with zero pads."""
    hh, ww = h.shape[2], h.shape[3]
    hp, wp = rk.padded_hw(hh, ww)
    return PaddedStream(F.pad(h, (0, 0, 1, wp - ww - 1, 1, hp - hh - 1)), (hh, ww))


def unpad_stream(ps: PaddedStream) -> torch.Tensor:
    """The interior view (B, F, H, W, C)."""
    hh, ww = ps.hw
    return ps.x[:, :, 1:hh + 1, 1:ww + 1, :]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """[cos | sin] with `arange(half)/half` frequencies (`nn.py:171-189`)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _channel_stats(x: torch.Tensor) -> torch.Tensor:
    """(B, 2, C) float32 sum / sum of squares over every non-batch axis."""
    xf = x.float().reshape(x.shape[0], -1, x.shape[-1])
    return torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1)


class GroupNorm32(nn.Module):
    """GroupNorm(32) with float32 statistics, E[x^2] - mean^2, eps 1e-5
    (`nn.py:26-28`). `stats` (B, 2, C) forwarded from the producer of x
    replaces the statistics read; `return_affine` hands back the collapsed
    per-(B, C) scale / shift instead of applying it. `use_pallas`: with
    neither, K7 (`ops/group_norm.py`, output in x.dtype) normalises
    (`v2a_tpu/models/video_unet.py:297-303`)."""

    def __init__(self, channels: int, with_silu: bool = False, num_groups: int = 32,
                 use_pallas: bool = False):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by groups {num_groups}")
        self.with_silu, self.num_groups, self.use_pallas = with_silu, num_groups, use_pallas
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, stats: Optional[torch.Tensor] = None, return_affine: bool = False):
        b, c = x.shape[0], x.shape[-1]
        n_pc = x[0, ..., 0].numel()
        if return_affine or stats is not None:
            st = stats if stats is not None else _channel_stats(x)
            a, shift = rk.stats_to_group_affine(st, self.scale, self.bias, n_pc, self.num_groups)
            if return_affine:
                return a, shift
            bc = (b,) + (1,) * (x.ndim - 2) + (c,)
            y = x.float() * a.reshape(bc) + shift.reshape(bc)
            return F.silu(y) if self.with_silu else y
        if self.use_pallas:
            return gn.fused_group_norm_silu(x, self.scale, self.bias, self.num_groups,
                                            with_silu=self.with_silu)
        g = self.num_groups
        gw = c // g
        xf = x.float().reshape(b, -1, c)
        n = float(xf.shape[1] * gw)
        mean_g = xf.sum(1).reshape(b, g, gw).sum(-1) / n
        var_g = torch.clamp((xf * xf).sum(1).reshape(b, g, gw).sum(-1) / n - mean_g**2, min=0.0)
        rstd_g = torch.rsqrt(var_g + 1e-5)
        mean_c = mean_g.repeat_interleave(gw, dim=1)[:, None, :]
        rstd_c = rstd_g.repeat_interleave(gw, dim=1)[:, None, :]
        y = (xf - mean_c) * rstd_c * self.scale + self.bias
        if self.with_silu:
            y = F.silu(y)
        return y.reshape(x.shape)


class _Conv(nn.Module):
    """A flax Conv's {kernel (k, k, C, D), bias} pair."""

    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k, k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.init_std = {"kernel": 1.0 / math.sqrt(k * k * cin)}


class _TemporalConv(nn.Module):
    """{kernel (k, C, C), bias}: identity-initialized (`nn.py:48-50` dirac_)."""

    def __init__(self, c: int, k: int = 3):
        super().__init__()
        w = torch.zeros(k, c, c)
        w[k // 2] = torch.eye(c)
        self.kernel = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(c))


class PseudoConv3d(nn.Module):
    """Factorized space-time conv (`nn.py:30-88`): a 2D conv per frame, then
    (kernel_size > 1) a temporal conv over F. Takes a tensor or a tuple of
    channel parts (conv of their concatenation as a sum of per-part convs);
    `emb` / `residual` / `want_stats` ride the temporal conv. `PaddedStream`
    inputs take the padded-stream kernels (`_padded`). `train_fused` at the
    call (a single tensor, not `fused`) sends a K1-eligible spatial conv
    through `ops/conv_vjp.py`, with K6 as its wgrad when `wgrad_kernel`
    (`v2a_tpu/models/video_unet.py:613-657`). `routing`: the K1 gate, K10,
    K11 and K12 (`ConvRouting`)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 wgrad_kernel: bool = False, routing: ConvRouting = ConvRouting()):
        super().__init__()
        self.features, self.k, self.stride = features, kernel_size, stride
        self.dtype, self.fused, self.wgrad_kernel = dtype, fused, wgrad_kernel
        self.routing = routing
        self.spatial_conv = _Conv(kernel_size, cin, features)
        if kernel_size > 1:
            self.temporal_conv = _TemporalConv(features, kernel_size)

    def forward(self, x, emb=None, residual=None, want_stats: bool = False, pre_affine=None,
                upsample2x: bool = False, skip=None, train_fused: bool = False):
        parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        if isinstance(parts[0], PaddedStream):
            return self._padded(parts, emb, residual, want_stats, pre_affine, upsample2x, skip)
        if upsample2x or skip is not None:
            raise ValueError("upsample2x and the skip fold need a PaddedStream input")
        if pre_affine is not None and not isinstance(x, (tuple, list)):
            pre_affine = [pre_affine]
        b, f, h, w = parts[0].shape[:4]
        dt, k, feat = self.dtype, self.k, self.features
        kernel, kbias = self.spatial_conv.kernel, self.spatial_conv.bias
        cins = [p.shape[-1] for p in parts]
        eligible = self.routing.spatial2_eligible(feat, cins, h * w, k, self.stride)
        use_k1 = self.fused and eligible
        use_tf = train_fused and not self.fused and len(parts) == 1 and eligible
        # K10: what the K1 gate leaves of the 3x3 stride-1 convs, channels in
        # multiples of 128 (:531-545, :679-685)
        use_k10 = (self.fused and not use_k1 and self.routing.pallas_spatial and k == 3
                   and self.stride == 1 and feat % 128 == 0 and all(c % 128 == 0 for c in cins))
        if pre_affine is not None and not (use_k1 or use_tf):
            raise ValueError("pre_affine requires the K1-eligible fused path")
        y, off = None, 0
        for pi, p in enumerate(parts):
            pc = p.shape[-1]
            wpart = kernel[:, :, off:off + pc]
            x4 = p.reshape(b * f, h, w, pc).to(dt)
            af = bf_ = None
            if pre_affine is not None:
                a0, b0 = pre_affine[pi]  # (B, pc) float32
                af = a0[:, None, :].expand(b, f, pc).reshape(b * f, pc)
                bf_ = b0[:, None, :].expand(b, f, pc).reshape(b * f, pc)
            if use_tf:
                if af is not None:
                    yp = conv_vjp.affine_silu_conv3x3(x4, wpart, kbias, af, bf_,
                                                      wgrad_kernel=self.wgrad_kernel)
                else:
                    yp = conv_vjp.plain_conv3x3(x4, wpart, kbias, wgrad_kernel=self.wgrad_kernel)
            elif use_k1:
                # only the first part carries the bias; parts sum in dtype
                yp = rk.fused_affine_conv3x3(
                    x4.contiguous(), wpart, kbias if y is None else torch.zeros_like(kbias),
                    af, bf_, silu=pre_affine is not None,
                )
            elif use_k10:
                # one launch per part, the bias with the first; the parts sum
                # in dtype, rounded after each (:568-577, :599)
                yp = rk.spatial_conv3x3(x4.contiguous(), wpart,
                                        kbias if y is None else torch.zeros_like(kbias))
            elif k == 1 and self.stride == 1:
                yp = x4 @ wpart.reshape(pc, feat).to(dt)
            else:
                yp = F.conv2d(
                    x4.permute(0, 3, 1, 2), wpart.to(dt).permute(3, 2, 0, 1),
                    stride=self.stride, padding=k // 2,
                ).permute(0, 2, 3, 1)
            y = yp if y is None else y + yp
            off += pc
        if not (use_k1 or use_tf or use_k10):
            y = y + kbias.to(dt)
        y = y.reshape(b, f, y.shape[1], y.shape[2], feat)
        if k > 1:
            tk, tb = self.temporal_conv.kernel, self.temporal_conv.bias
            if self.fused and feat % 128 == 0:
                tconv = (rk.temporal_conv_fused_hw if self.routing.tconv_hw
                         else rk.temporal_conv_fused)
                return tconv(y.to(dt).contiguous(), tk, tb, emb=emb, residual=residual,
                             want_stats=want_stats)
            # zero-padded frames, the three taps as one (3C, C) product
            yp = F.pad(y, (0, 0, 0, 0, 0, 0, 1, 1))
            cat = torch.cat([yp[:, 0:f], yp[:, 1:f + 1], yp[:, 2:f + 2]], dim=-1)
            y = cat @ tk.to(dt).reshape(3 * feat, feat) + tb.to(dt)
        if emb is not None:
            y = y + emb.reshape(b, 1, 1, 1, feat).to(y.dtype)
        if residual is not None:
            y = y + residual.to(y.dtype)
        if want_stats:
            yf = y.float()
            return y, torch.stack([yf.sum((2, 3)), (yf * yf).sum((2, 3))], dim=2)
        return y

    def _padded(self, parts, emb, residual, want_stats, pre_affine, upsample2x, skip):
        """The padded-stream conv (`v2a_tpu/models/video_unet.py:806-1032`),
        3x3 only. Stride 2 (the Downsample's): K8 to the halved size, then
        K4b there. `upsample2x`: K5 from the low-res stream, then K4b at the
        doubled size. Otherwise, with `routing.stream_kernel` and no skip
        fold, K12 where `rk.stream_band_rows` admits it; else, with
        `routing.mega_kernel`, K3 where the JAX package's rule
        (`rk.conv_tconv_band_rows`) admits it; else K4a then K4b. Without
        `pre_affine` (the entry conv, an upsample conv without K5) the
        affine is the identity and there is no SiLU. `skip` is (streams,
        kernel (C_in, D), bias): the ResBlock's 1x1 skip projection, folded
        into the temporal conv. Returns a PaddedStream [, stats (B, F, 2,
        D)]."""
        if self.k != 3 or self.stride not in (1, 2):
            raise ValueError("the padded stream takes 3x3 stride-1 or stride-2 convs")
        dt, feat, hw = self.dtype, self.features, parts[0].hw
        b, f, hp, wp = parts[0].x.shape[:4]
        kernel, kbias = self.spatial_conv.kernel, self.spatial_conv.bias
        tk, tb = self.temporal_conv.kernel, self.temporal_conv.bias
        if self.stride == 2:
            if (len(parts) != 1 or pre_affine is not None or residual is not None
                    or skip is not None):
                raise ValueError("the padded stride-2 conv is the bare Downsample conv")
            y = rk.fused_downconv3x3_padded(parts[0].x.reshape(b * f, hp, wp, -1).to(dt),
                                            kernel, kbias, hw)
            hw = (hw[0] // 2, hw[1] // 2)
            hp, wp = rk.padded_hw(*hw)
            out = rk.temporal_conv_padded(y.reshape(b, f, hp, wp, feat), tk, tb, hw, emb=emb,
                                          want_stats=want_stats)
        elif upsample2x:
            if len(parts) != 1 or pre_affine is not None or skip is not None:
                raise ValueError("the upsample conv is single-part, without affine or skip")
            y = rk.fused_upconv3x3_padded(parts[0].x.reshape(b * f, hp, wp, -1).to(dt),
                                          kernel, kbias, hw)
            hw = (2 * hw[0], 2 * hw[1])
            hp, wp = rk.padded_hw(*hw)
            out = rk.temporal_conv_padded(y.reshape(b, f, hp, wp, feat), tk, tb, hw, emb=emb,
                                          want_stats=want_stats)
        else:
            silu = pre_affine is not None
            pre = pre_affine
            if pre is None:
                dev = parts[0].x.device
                pre = [(torch.ones(b, p.x.shape[-1], device=dev),
                        torch.zeros(b, p.x.shape[-1], device=dev)) for p in parts]
            elif not isinstance(pre[0], (tuple, list)):
                pre = [pre]
            mparts, off = [], 0
            for (a0, b0), p in zip(pre, parts):
                pc = p.x.shape[-1]
                mparts.append((p.x.to(dt), kernel[:, :, off:off + pc],
                               a0[:, None, :].expand(b, f, pc).reshape(b * f, pc),
                               b0[:, None, :].expand(b, f, pc).reshape(b * f, pc)))
                off += pc
            skip_parts = s_bias = None
            if skip is not None:
                streams, s_kernel, s_bias = skip
                skip_parts, off = [], 0
                for p in streams:
                    pc = p.x.shape[-1]
                    skip_parts.append((p.x.to(dt), s_kernel[off:off + pc]))
                    off += pc
            res = residual.x if residual is not None else None
            cins = [p.x.shape[-1] for p in parts]
            stream = (self.routing.stream_kernel and skip is None
                      and rk.stream_band_rows(hw[0], hw[1], wp, cins, feat) > 0)
            mega = not stream and self.routing.mega_kernel and rk.conv_tconv_band_rows(
                hw[0], hw[1], wp, cins, feat, f,
                has_res=res is not None, skip_cins=[p[0].shape[-1] for p in skip_parts or ()],
            ) > 0
            if stream:
                out = rk.fused_conv_tconv_stream(mparts, kbias, tk, tb, hw, emb, res, silu=silu,
                                                 want_stats=want_stats)
            elif mega:
                out = rk.fused_conv_tconv_padded(mparts, kbias, tk, tb, hw, emb, res, skip_parts,
                                                 s_bias, silu=silu, want_stats=want_stats)
            else:
                flat = [(x.reshape(b * f, hp, wp, x.shape[-1]), kk, a, bb)
                        for x, kk, a, bb in mparts]
                y = rk.fused_affine_conv3x3_padded(flat, kbias, hw, silu=silu)
                out = rk.temporal_conv_padded(y.reshape(b, f, hp, wp, feat), tk, tb, hw, emb, res,
                                              skip_parts, s_bias, want_stats)
        if want_stats:
            return PaddedStream(out[0], hw), out[1]
        return PaddedStream(out, hw)


class ResBlock3D(nn.Module):
    """`ResBlock` (`unet.py:148-262`), plain-norm and dropout-free as the
    release config runs it. The fused form returns (out, out_stats) and takes
    the (h, skip) pair of the up path unconcatenated. `train_fused` (without
    `fused`): where C and out_channels pass K1's gate, both GroupNorms hand
    their affine to the differentiable convs of `ops/conv_vjp.py`
    (`v2a_tpu/models/video_unet.py:1077-1133`). Where the K1 gate
    (`routing.spatial2_eligible`) fails, the fused norms run as tensor ops
    before the convs (:1150-1190)."""

    def __init__(self, cin: int, out_channels: int, emb_dim: int,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 train_fused: bool = False, wgrad_kernel: bool = False,
                 use_pallas_gn: bool = False, routing: ConvRouting = ConvRouting()):
        super().__init__()
        self.cin, self.out_channels, self.dtype, self.fused = cin, out_channels, dtype, fused
        self.train_fused, self.routing = train_fused, routing
        # K7 only on the non-fused path, as the JAX block (its fused norms
        # pass use_pallas=False, :1168-1176)
        k7 = use_pallas_gn and not fused
        self.in_norm = GroupNorm32(cin, with_silu=True, use_pallas=k7)
        self.in_conv = PseudoConv3d(cin, out_channels, 3, dtype=dtype, fused=fused,
                                    wgrad_kernel=wgrad_kernel, routing=routing)
        self.emb_proj = nn.Linear(emb_dim, out_channels)
        self.out_norm = GroupNorm32(out_channels, with_silu=True, use_pallas=k7)
        self.out_conv = PseudoConv3d(out_channels, out_channels, 3, dtype=dtype, fused=fused,
                                     wgrad_kernel=wgrad_kernel, routing=routing)
        if cin != out_channels:
            self.skip_conv = PseudoConv3d(cin, out_channels, 1, dtype=dtype)

    def _emb_out(self, emb):
        return _linear(F.silu(emb.to(self.dtype)), self.emb_proj, self.dtype)

    def forward(self, x, emb: torch.Tensor, stats=None):
        if self.fused:
            if isinstance(x, tuple):
                if isinstance(x[0], PaddedStream):
                    return self._fused_split_padded(x, emb, stats)
                return self._fused_split(x, emb, stats)
            if isinstance(x, PaddedStream):
                return self._fused_padded(x, emb, stats)
            return self._fused(x, emb, stats)
        dt = self.dtype
        tf = self.train_fused and self._sp2([x.shape[-1]], x.shape[2] * x.shape[3])
        if tf:  # the normed tensor is never built: the conv applies the affine
            h = self.in_conv(x, pre_affine=self.in_norm(x, return_affine=True), train_fused=True)
        else:
            h = self.in_conv(self.in_norm(x).to(dt))
        h = h + self._emb_out(emb)[:, None, None, None, :]
        if tf:
            h = self.out_conv(h, pre_affine=self.out_norm(h, return_affine=True), train_fused=True)
        else:
            h = self.out_conv(self.out_norm(h).to(dt))
        if self.cin != self.out_channels:
            x = self.skip_conv(x)
        return x + h

    def _sp2(self, cins, hw):
        return self.routing.spatial2_eligible(
            self.out_channels, list(cins) + [self.out_channels], hw, 3, 1)

    def _second_half(self, h, h_stats, sp2, x_skip):
        st2 = h_stats.sum(1)  # (B, 2, C) over frames
        pre2 = None
        if sp2:
            pre2 = self.out_norm(h, stats=st2, return_affine=True)
        else:
            h = self.out_norm(h, stats=st2).to(self.dtype)
        return self.out_conv(h, residual=x_skip, want_stats=True, pre_affine=pre2)

    def _fused(self, x, emb, stats):
        c = x.shape[-1]
        st_in = stats.sum(1) if stats is not None else None
        sp2 = self._sp2([c], x.shape[2] * x.shape[3])
        if sp2:
            pre1, h = self.in_norm(x, stats=st_in, return_affine=True), x
        else:
            pre1, h = None, self.in_norm(x, stats=st_in).to(self.dtype)
        h, h_stats = self.in_conv(h, emb=self._emb_out(emb), want_stats=True, pre_affine=pre1)
        if c != self.out_channels:
            x = self.skip_conv(x)
        return self._second_half(h, h_stats, sp2, x)

    def _fused_split(self, parts, emb, part_stats):
        """GroupNorm collapses to per-channel affines applied per part; the
        in / skip convs run as channel-split sums, so the concatenation is
        never built."""
        if part_stats is None:
            part_stats = (None,) * len(parts)
        if sum(p.shape[-1] for p in parts) == self.out_channels:
            raise ValueError("split path expects a channel-changing block")
        sts = [st.sum(1) if st is not None else _channel_stats(p)
               for p, st in zip(parts, part_stats)]
        n_pc = parts[0][0, ..., 0].numel()
        a, shift = rk.stats_to_group_affine(
            torch.cat(sts, dim=-1), self.in_norm.scale, self.in_norm.bias, n_pc, 32
        )
        sp2 = self._sp2([p.shape[-1] for p in parts], parts[0].shape[2] * parts[0].shape[3])
        pre1, conv_in, off = [], [], 0
        for p in parts:
            pc = p.shape[-1]
            ai, bi = a[:, off:off + pc], shift[:, off:off + pc]
            if sp2:
                pre1.append((ai, bi))
            else:
                bc = (p.shape[0],) + (1,) * (p.ndim - 2) + (pc,)
                conv_in.append(F.silu(p.float() * ai.reshape(bc) + bi.reshape(bc)).to(self.dtype))
            off += pc
        h, h_stats = self.in_conv(
            parts if sp2 else tuple(conv_in), emb=self._emb_out(emb), want_stats=True,
            pre_affine=pre1 if sp2 else None,
        )
        return self._second_half(h, h_stats, sp2, self.skip_conv(parts))

    # -- the padded stream: both norms collapse to affines from exact interior
    # statistics (n_pc = F*H*W of the interior, never of the padded tensor),
    # the convs run K3 or K4a -> K4b, and the residual add or the 1x1 skip
    # projection rides the second temporal conv.

    def _skip_fold(self, streams, cin: int):
        sc = self.skip_conv.spatial_conv
        return tuple(streams), sc.kernel.reshape(cin, self.out_channels), sc.bias

    def _fused_padded(self, x: PaddedStream, emb, stats):
        """`_fused` on a padded stream (`v2a_tpu/models/video_unet.py:1217`)."""
        f, c = x.x.shape[1], x.x.shape[-1]
        n_pc = f * x.hw[0] * x.hw[1]
        st_in = stats.sum(1) if stats is not None else _channel_stats(unpad_stream(x))
        pre1 = rk.stats_to_group_affine(st_in, self.in_norm.scale, self.in_norm.bias, n_pc)
        h, h_stats = self.in_conv(x, emb=self._emb_out(emb), want_stats=True, pre_affine=pre1)
        pre2 = rk.stats_to_group_affine(h_stats.sum(1), self.out_norm.scale, self.out_norm.bias,
                                        n_pc)
        if c == self.out_channels:
            return self.out_conv(h, residual=x, want_stats=True, pre_affine=pre2)
        return self.out_conv(h, want_stats=True, pre_affine=pre2, skip=self._skip_fold((x,), c))

    def _fused_split_padded(self, parts, emb, part_stats):
        """`_fused_split` on padded streams (`v2a_tpu/models/video_unet.py:1268`):
        the (h, skip) pair goes into one conv call as two parts."""
        if part_stats is None:
            part_stats = (None,) * len(parts)
        f = parts[0].x.shape[1]
        n_pc = f * parts[0].hw[0] * parts[0].hw[1]
        sts = [st.sum(1) if st is not None else _channel_stats(unpad_stream(p))
               for p, st in zip(parts, part_stats)]
        a, shift = rk.stats_to_group_affine(torch.cat(sts, dim=-1), self.in_norm.scale,
                                            self.in_norm.bias, n_pc)
        pre1, off = [], 0
        for p in parts:
            pc = p.x.shape[-1]
            pre1.append((a[:, off:off + pc], shift[:, off:off + pc]))
            off += pc
        h, h_stats = self.in_conv(parts, emb=self._emb_out(emb), want_stats=True,
                                  pre_affine=pre1)
        pre2 = rk.stats_to_group_affine(h_stats.sum(1), self.out_norm.scale, self.out_norm.bias,
                                        n_pc)
        return self.out_conv(h, want_stats=True, pre_affine=pre2, skip=self._skip_fold(parts, off))


class SpatialAttentionBlock(nn.Module):
    """Per-frame spatial self-attention (`unet.py:263-330`) with the legacy
    layout: qkv reshaped to heads BEFORE the q/k/v split, q and k each
    scaled by ch^-1/4, softmax in float32.

    `attn_kernel` (the JAX package's `V2A_PALLAS_ATTN=1`,
    `v2a_tpu/models/video_unet.py:1441-1483`): with forwarded `stats` the
    whole block is K9 (`rk.fused_spatial_attention_padded`), which rounds as
    the TPU kernel does, not as this block's plain path. A PaddedStream
    stays padded (every pad zero); a plain tensor enters the padded layout
    for the call and leaves it after. `use_pallas_gn`: the norm without
    forwarded stats is K7."""

    def __init__(self, channels: int, num_head_channels: int = 32,
                 dtype: torch.dtype = torch.float32, attn_kernel: bool = False,
                 use_pallas_gn: bool = False):
        super().__init__()
        self.ch, self.dtype, self.attn_kernel = num_head_channels, dtype, attn_kernel
        self.norm = GroupNorm32(channels, use_pallas=use_pallas_gn)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = nn.Linear(channels, channels)

    def _kernel(self, x, stats, want_stats: bool):
        entered = not isinstance(x, PaddedStream)
        ps = pad_stream(x.to(self.dtype)) if entered else x
        (hh, ww), (b, f, hp, wp, c) = ps.hw, ps.x.shape
        a, shift = rk.stats_to_group_affine(stats.reshape(b * f, 2, c), self.norm.scale,
                                            self.norm.bias, hh * ww)
        out = rk.fused_spatial_attention_padded(
            ps.x.reshape(b * f, hp, wp, c), (hh, ww), a, shift, self.qkv.weight.t(),
            self.qkv.bias, self.proj_out.weight.t(), self.proj_out.bias, self.ch,
            want_stats=want_stats)
        y, st = out if want_stats else (out, None)
        y = PaddedStream(y.reshape(b, f, hp, wp, c), (hh, ww))
        if entered:
            y = unpad_stream(y)
        return (y, st.reshape(b, f, 2, c)) if want_stats else y

    def forward(self, x, stats=None, want_stats: bool = False):
        if self.attn_kernel and stats is not None:
            return self._kernel(x, stats, want_stats)
        if isinstance(x, PaddedStream):
            # attention needs the exact token set: the interior in, the
            # padded layout back out (the stats describe the interior)
            out = self.forward(unpad_stream(x), stats, want_stats)
            if want_stats:
                return pad_stream(out[0]), out[1]
            return pad_stream(out)
        b, f, h, w, c = x.shape
        ch, dt = self.ch, self.dtype
        y = x.reshape(b * f, h * w, c)
        # the norm is per (batch, frame) sample, so per-frame stats fit it
        st = stats.reshape(b * f, 2, c) if stats is not None else None
        qkv = _linear(self.norm(y, stats=st).to(dt), self.qkv, dt)
        qkv = qkv.reshape(b * f, h * w, c // ch, 3 * ch)
        q, k, v = qkv.chunk(3, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        logits = torch.einsum("bthc,bshc->bhts", (q * scale).float(), (k * scale).float())
        weights = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhts,bshc->bthc", weights, v).reshape(b * f, h * w, c)
        res = y + _linear(out, self.proj_out, dt)
        result = res.reshape(b, f, h, w, c)
        if want_stats:
            of = res.float().reshape(b, f, h * w, c)
            return result, torch.stack([of.sum(2), (of * of).sum(2)], dim=2)
        return result


class Downsample3D(nn.Module):
    """Stride-2 pseudo-3D conv (`unet.py:119-145`). `downconv` (the JAX
    package's `V2A_DOWNCONV=1`) with `padded_out`: K8 from the full-size
    padded stream into one at half the size, then K4b there
    (`v2a_tpu/models/video_unet.py:1558-1567`)."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32, fused: bool = False,
                 downconv: bool = False, routing: ConvRouting = ConvRouting()):
        super().__init__()
        self.downconv = downconv
        self.conv = PseudoConv3d(c, c, 3, stride=2, dtype=dtype, fused=fused, routing=routing)

    def forward(self, x, want_stats: bool = False, padded_out: bool = False):
        if padded_out and self.downconv:
            if not isinstance(x, PaddedStream):
                x = pad_stream(x)
            return self.conv(x, want_stats=want_stats)
        if isinstance(x, PaddedStream):
            # the stride-2 conv's SAME halo must be zeros: take the interior
            x = unpad_stream(x)
        return self.conv(x, want_stats=want_stats)


class Upsample3D(nn.Module):
    """Nearest 2x spatial upsample + pseudo-3D conv (`unet.py:86-116`).
    `padded_out`: K5 from the low-res stream into a PaddedStream at twice
    the size (`v2a_tpu/models/video_unet.py:1592-1599`), or, with
    `routing.upconv` off, the upsampled input padded and the padded conv
    (:1612-1615); `train_fused`: the conv through `conv_vjp.plain_conv3x3`
    (:1614-1617)."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32, fused: bool = False,
                 train_fused: bool = False, wgrad_kernel: bool = False,
                 routing: ConvRouting = ConvRouting()):
        super().__init__()
        self.train_fused, self.upconv = train_fused, routing.upconv
        self.conv = PseudoConv3d(c, c, 3, dtype=dtype, fused=fused, wgrad_kernel=wgrad_kernel,
                                 routing=routing)

    def forward(self, x, want_stats: bool = False, padded_out: bool = False):
        if padded_out and self.upconv:
            if not isinstance(x, PaddedStream):
                x = pad_stream(x)
            return self.conv(x, want_stats=want_stats, upsample2x=True)
        if isinstance(x, PaddedStream):
            x = unpad_stream(x)
        b, f, h, w, c = x.shape
        x = x[:, :, :, None, :, None, :].expand(b, f, h, 2, w, 2, c).reshape(b, f, 2 * h, 2 * w, c)
        if padded_out:
            x = pad_stream(x)
        return self.conv(x, want_stats=want_stats, train_fused=self.train_fused)


class VideoUNet(nn.Module):
    """Input (B, F, H, W, in_channels) with the conditioning frame already on
    the channel axis; output (B, F, H, W, out_channels) float32.

    `train_fused` is the training routing (ignored with `fused`, as in the
    JAX package: `tfused = train_fused and not fused`, :1718);
    `wgrad_kernel` makes its convs' weight gradient K6, as the JAX package's
    `V2A_TRAIN_WGRAD_PALLAS=1` (an argument here, not an environment
    variable; off by default, as there). Likewise, each off by default as
    in the JAX package: `downconv` (`V2A_DOWNCONV=1`: with `fused` and the
    padded stream, the downsamples into a padded level run K8),
    `attn_kernel` (`V2A_PALLAS_ATTN=1`: with `fused`, every attention block
    runs K9), `use_pallas_gn` (the JAX field: without `fused`, every
    GroupNorm that has no forwarded statistics runs K7). `spatial2_min_ch`, `spatial2_max_s`,
    `pallas_spatial`, `tconv_hw`, `stream_kernel`, `mega_kernel`, `upconv`
    and `entry_pad` are the `ConvRouting` switches (the K1 gate, K10, K11,
    K12, K3, K5, the padded entry conv), each at its JAX default."""

    def __init__(self, in_channels: int = 6, model_channels: int = 128, out_channels: int = 3,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (8, 16),
                 channel_mult: Sequence[int] = (1, 2, 3, 4, 5), num_head_channels: int = 32,
                 task_token_dim: int = 512, dtype: torch.dtype = torch.float32,
                 fused: bool = False, padded_stream: bool = True, train_fused: bool = False,
                 wgrad_kernel: bool = False, downconv: bool = False, attn_kernel: bool = False,
                 use_pallas_gn: bool = False, spatial2_min_ch: int = 128,
                 spatial2_max_s: int = 16384, pallas_spatial: bool = False,
                 tconv_hw: bool = False, stream_kernel: bool = False, mega_kernel: bool = True,
                 upconv: bool = True, entry_pad: bool = False):
        super().__init__()
        mc = model_channels
        ted = mc * 4
        self.mc, self.nrb, self.dtype, self.fused = mc, num_res_blocks, dtype, fused
        self.padded_stream = padded_stream
        self.routing = routing = ConvRouting(
            spatial2_min_ch=spatial2_min_ch, spatial2_max_s=spatial2_max_s,
            pallas_spatial=pallas_spatial, tconv_hw=tconv_hw, stream_kernel=stream_kernel,
            mega_kernel=mega_kernel, upconv=upconv, entry_pad=entry_pad)
        self.train_fused = tfused = train_fused and not fused
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.time_dense0 = nn.Linear(mc, ted)
        self.time_dense1 = nn.Linear(ted, ted)
        self.task_attnpool = PerceiverResampler(dim=task_token_dim, depth=2, dtype=dtype)
        self.task_proj = nn.Linear(task_token_dim, ted)
        self.in_conv = PseudoConv3d(in_channels, mc, 3, dtype=dtype, fused=fused, routing=routing)

        def res(name, cin, cout):
            self.add_module(name, ResBlock3D(cin, cout, ted, dtype, fused, tfused, wgrad_kernel,
                                             use_pallas_gn, routing))

        def attn(name, c):
            self.add_module(name, SpatialAttentionBlock(c, num_head_channels, dtype, attn_kernel,
                                                        use_pallas_gn))

        skips, cur, ds, bi = [mc], mc, 1, 0
        for level, mult in enumerate(self.channel_mult):
            ch = mult * mc
            for _ in range(num_res_blocks):
                res(f"down_res_{bi}", cur, ch)
                cur = ch
                if ds in self.attention_resolutions:
                    attn(f"down_attn_{bi}", ch)
                skips.append(ch)
                bi += 1
            if level != len(self.channel_mult) - 1:
                self.add_module(f"downsample_{level}",
                                Downsample3D(ch, dtype, fused, downconv, routing))
                skips.append(ch)
                ds *= 2
        res("mid_res0", cur, cur)
        attn("mid_attn", cur)
        res("mid_res1", cur, cur)
        bi = 0
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            ch = mult * mc
            for i in range(num_res_blocks + 1):
                res(f"up_res_{bi}", cur + skips.pop(), ch)
                cur = ch
                if ds in self.attention_resolutions:
                    attn(f"up_attn_{bi}", ch)
                if level and i == num_res_blocks:
                    self.add_module(f"upsample_{level}",
                                    Upsample3D(ch, dtype, fused, tfused, wgrad_kernel, routing))
                    ds //= 2
                bi += 1
        self.out_norm = GroupNorm32(cur, with_silu=True, use_pallas=use_pallas_gn and not fused)
        self.out_conv = PseudoConv3d(cur, out_channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                task_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt, fused = self.dtype, self.fused
        emb = _linear(timestep_embedding(timesteps, self.mc).to(dt), self.time_dense0, dt)
        emb = _linear(F.silu(emb), self.time_dense1, dt)
        if task_embed is not None:
            latents = self.task_attnpool(task_embed)
            emb = emb + _linear(latents, self.task_proj, dt).mean(dim=1)

        def step(out):  # fused blocks return (activation, stats)
            return out if fused else (out, None)

        # the padded-stream layout where `routing.padded_eligible` holds
        # (`v2a_tpu/models/video_unet.py:1736-1886`)
        padded = fused and self.padded_stream
        hh, ww = x.shape[2], x.shape[3]
        l0_padded = padded and self.routing.padded_eligible(self.mc, [self.mc], hh * ww)
        if l0_padded and self.routing.entry_pad:
            h, st = step(self.in_conv(pad_stream(x.to(dt)), want_stats=fused))
        else:
            h, st = step(self.in_conv(x.to(dt), want_stats=fused))
        if l0_padded and not isinstance(h, PaddedStream):
            h = pad_stream(h)
        hs = [(h, st)]
        ds, bi = 1, 0
        for level, mult in enumerate(self.channel_mult):
            for _ in range(self.nrb):
                h, st = step(getattr(self, f"down_res_{bi}")(h, emb, st))
                if ds in self.attention_resolutions:
                    h, st = step(getattr(self, f"down_attn_{bi}")(h, st, fused))
                hs.append((h, st))
                bi += 1
            if level != len(self.channel_mult) - 1:
                ch, next_ch = mult * self.mc, self.channel_mult[level + 1] * self.mc
                next_padded = padded and self.routing.padded_eligible(
                    next_ch, [ch, next_ch], (hh // 2) * (ww // 2))
                h, st = step(getattr(self, f"downsample_{level}")(h, want_stats=fused,
                                                                  padded_out=next_padded))
                hh, ww = hh // 2, ww // 2
                if next_padded and not isinstance(h, PaddedStream):
                    h = pad_stream(h)
                hs.append((h, st))
                ds *= 2
        h, st = step(self.mid_res0(h, emb, st))
        h, st = step(self.mid_attn(h, st, fused))
        h, st = step(self.mid_res1(h, emb, st))
        bi = 0
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(self.nrb + 1):
                skip, skip_st = hs.pop()
                if fused:  # the pair travels unconcatenated, in one layout
                    if isinstance(h, PaddedStream) != isinstance(skip, PaddedStream):
                        if isinstance(h, PaddedStream):
                            skip = pad_stream(skip)
                        else:
                            h = pad_stream(h)
                    h, st = getattr(self, f"up_res_{bi}")((h, skip), emb, (st, skip_st))
                else:
                    h = getattr(self, f"up_res_{bi}")(torch.cat([h, skip], dim=-1), emb)
                if ds in self.attention_resolutions:
                    h, st = step(getattr(self, f"up_attn_{bi}")(h, st, fused))
                if level and i == self.nrb:
                    ch = mult * self.mc
                    padded_out = padded and self.routing.padded_eligible(ch, [ch], hh * ww * 4)
                    h, st = step(getattr(self, f"upsample_{level}")(h, want_stats=fused,
                                                                    padded_out=padded_out))
                    hh, ww = hh * 2, ww * 2
                    ds //= 2
                bi += 1
        if isinstance(h, PaddedStream):
            h = unpad_stream(h)
        st2 = st.sum(1) if st is not None else None
        h = self.out_conv(self.out_norm(h, stats=st2).to(dt))
        return h.float()
