"""Vision encoder of the diffusion policy.

Counterpart of `v2a_tpu/models/vision.py` (robomimic's stack):
`ResNet18Conv` (no avgpool / fc, GroupNorm(features // 16) in place of
BatchNorm) -> `SpatialSoftmax` (32 keypoints) -> flatten -> Linear(64), one
encoder per image key, concatenated in sorted-key order. Public inputs are
channels-last (B, H, W, 3); the trunk runs NCHW inside. GroupNorm in
float32, convs in the compute dtype.

The trunk's max pool (`pool`): "max" is `F.max_pool2d` (the release's);
"packed" and "mask_bwd" are the two pools of `ops/pool.py`, the
counterparts of the JAX trunk's `V2A_PACKED_POOL=1` and
`V2A_POOL_MASK_BWD=1` (`v2a_tpu/models/vision.py:86-100`). As there,
"packed" applies only to a bf16 trunk (a float32 trunk pools with
`F.max_pool2d`), and "mask_bwd" changes the gradient at ties.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2a_tpu_torch.models.perceiver import _linear
from v2a_tpu_torch.ops.pool import max_pool_3x3s2, max_pool_3x3s2_maskbwd
from v2a_tpu_torch.ops.resize import resize_bilinear

POOLS = ("max", "packed", "mask_bwd")


def _conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    bias = None if m.bias is None else m.bias.to(dtype)
    return F.conv2d(x.to(dtype), m.weight.to(dtype), bias, m.stride, m.padding)


def _gn(x: torch.Tensor, m: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    return F.group_norm(x.float(), m.num_groups, m.weight, m.bias, m.eps).to(dtype)


class BasicBlock(nn.Module):
    """ResNet-v1 basic block with GroupNorm."""

    def __init__(self, cin: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        g = features // 16
        self.conv1 = nn.Conv2d(cin, features, 3, strides, 1, bias=False)
        self.norm1 = nn.GroupNorm(g, features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.norm2 = nn.GroupNorm(g, features, eps=1e-5)
        if cin != features or strides != 1:
            self.downsample_conv = nn.Conv2d(cin, features, 1, strides, 0, bias=False)
            self.downsample_norm = nn.GroupNorm(g, features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(_gn(_conv(x, self.conv1, dt), self.norm1, dt))
        y = _gn(_conv(y, self.conv2, dt), self.norm2, dt)
        if hasattr(self, "downsample_conv"):
            x = _gn(_conv(x, self.downsample_conv, dt), self.downsample_norm, dt)
        return F.relu(y + x)


def _max_pool(x: torch.Tensor, pool: str) -> torch.Tensor:
    """The trunk's 3x3 stride-2 pad-1 max pool by `pool` (`POOLS`)."""
    if pool == "packed" and x.dtype == torch.bfloat16:
        return max_pool_3x3s2(x)
    if pool == "mask_bwd":
        return max_pool_3x3s2_maskbwd(x)
    return F.max_pool2d(x, 3, 2, 1)  # pads with -inf, like flax max_pool


class ResNet18Conv(nn.Module):
    """ResNet-18 trunk (`vision_nets.py:9-63`): NCHW (B, 3, H, W) ->
    (B, 512, H/32, W/32). `pool`: the max pool after the stem (`POOLS`)."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_features: Sequence[int] = (64, 128, 256, 512), pool: str = "max"):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool {pool!r} not in {POOLS}")
        self.dtype, self.pool = dtype, pool
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.norm1 = nn.GroupNorm(64 // 16, 64, eps=1e-5)
        self.blocks = []
        cur = 64
        for stage, (n_blocks, feats) in enumerate(zip(stage_sizes, stage_features)):
            for block in range(n_blocks):
                name = f"layer{stage + 1}_{block}"
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(name, BasicBlock(cur, feats, strides, dtype))
                self.blocks.append(name)
                cur = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.relu(_gn(_conv(x, self.conv1, dt), self.norm1, dt))
        x = _max_pool(x, self.pool)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


class SpatialSoftmax(nn.Module):
    """Soft-argmax keypoints (`base_nets.py:153-260`): 1x1 conv to `num_kp`
    maps, softmax over positions in float32, expected (x, y) on [-1, 1]."""

    def __init__(self, cin: int, num_kp: int = 32, temperature: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_kp, self.temperature, self.dtype = num_kp, temperature, dtype
        self.kp_conv = nn.Conv2d(cin, num_kp, 1)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        b, _, h, w = feature.shape
        flat = _conv(feature, self.kp_conv, self.dtype).reshape(b, self.num_kp, h * w)
        attention = torch.softmax(flat.float() / self.temperature, dim=-1)
        pos_x, pos_y = np.meshgrid(np.linspace(-1.0, 1.0, w), np.linspace(-1.0, 1.0, h))
        pos = torch.as_tensor(np.stack([pos_x.reshape(-1), pos_y.reshape(-1)], -1),
                              dtype=torch.float32, device=feature.device)  # (HW, 2)
        return (attention @ pos).to(self.dtype)  # (B, K, 2) as (x, y)


class VisualCore(nn.Module):
    """Backbone -> SpatialSoftmax -> flatten -> Linear (`vision_nets.py:65-177`).
    Input channels-last (B, H, W, 3)."""

    def __init__(self, feature_dimension: int = 64, num_kp: int = 32,
                 dtype: torch.dtype = torch.float32,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_features: Sequence[int] = (64, 128, 256, 512), pool: str = "max"):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet18Conv(dtype, stage_sizes, stage_features, pool)
        self.pool = SpatialSoftmax(stage_features[-1], num_kp, dtype=dtype)
        self.proj = nn.Linear(num_kp * 2, feature_dimension)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pool(self.backbone(x.permute(0, 3, 1, 2)))
        return _linear(x.reshape(x.shape[0], -1), self.proj, self.dtype)


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class MultiImageObsEncoder(nn.Module):
    """One VisualCore per rgb key (not shared), concatenated in sorted-key
    order (`multi_image_obs_encoder.py:130,144-196`). Inputs (B, H, W, 3)
    already in [-1, 1]; output (B, n_keys * feature_dimension).

    The reference encoder's optional preprocessing
    (`multi_image_obs_encoder.py:79-124`; the JAX `_preprocess`,
    `v2a_tpu/models/vision.py:205-218`), all off in the release config:
    `resize_shape` (bilinear, anti-aliased when shrinking, as
    `jax.image.resize`), `crop_shape` (the centre crop), `imagenet_norm`
    ((x - mean) / std, for inputs in [0, 1]), in that order."""

    def __init__(self, rgb_keys: Tuple[str, ...] = ("img_goal_1", "img_obs_1"),
                 feature_dimension: int = 64, num_kp: int = 32,
                 dtype: torch.dtype = torch.float32,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_features: Sequence[int] = (64, 128, 256, 512), pool: str = "max",
                 resize_shape: Optional[Tuple[int, int]] = None,
                 crop_shape: Optional[Tuple[int, int]] = None, imagenet_norm: bool = False):
        super().__init__()
        self.rgb_keys, self.dtype = tuple(sorted(rgb_keys)), dtype
        self.resize_shape, self.crop_shape = resize_shape, crop_shape
        self.imagenet_norm = imagenet_norm
        for key in self.rgb_keys:
            self.add_module(f"enc_{key}", VisualCore(feature_dimension, num_kp, dtype,
                                                     stage_sizes, stage_features, pool))

    def _preprocess(self, img: torch.Tensor) -> torch.Tensor:
        if self.resize_shape is not None:
            img = resize_bilinear(img, self.resize_shape).to(img.dtype)
        if self.crop_shape is not None:
            ch, cw = self.crop_shape
            top, left = (img.shape[1] - ch) // 2, (img.shape[2] - cw) // 2
            img = img[:, top:top + ch, left:left + cw, :]
        if self.imagenet_norm:
            mean = torch.tensor(_IMAGENET_MEAN, device=img.device)
            std = torch.tensor(_IMAGENET_STD, device=img.device)
            img = ((img - mean) / std).to(img.dtype)
        return img

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat(
            [getattr(self, f"enc_{k}")(self._preprocess(obs[k].to(self.dtype)))
             for k in self.rgb_keys], dim=-1
        )
