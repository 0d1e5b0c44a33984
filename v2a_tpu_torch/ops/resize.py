"""Bilinear image resize with the JAX package's semantics.

`jax.image.resize(..., method="bilinear")` samples at half-pixel centres
and, when it shrinks an axis, widens its triangle kernel by the scale
(anti-aliasing). `F.interpolate(mode="bilinear", align_corners=False,
antialias=True)` computes the same function, growing and shrinking; without
`antialias` a shrink reads only the two nearest pixels per axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W, C) -> (N, size[0], size[1], C) in float32."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)
