"""Constant-limits normalization to [-1, 1].

Counterpart of `v2a_tpu/models/normalizer.py` (the reference's
`LimitsConstNormalizer`): fixed per-dimension [min, max] mapped linearly to
[-1, 1], clamped on the way back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Libero action bounds (`diffuser/datasets/__init__.py:20-35`)
LB_ACTION_MIN = np.full((7,), -1.0, dtype=np.float32)
LB_ACTION_MAX = np.full((7,), 1.0, dtype=np.float32)
LB_ACTION_MIN_ORN01 = np.asarray([-1.0] * 3 + [-0.1] * 3 + [-1.0], dtype=np.float32)
LB_ACTION_MAX_ORN01 = np.asarray([1.0] * 3 + [0.1] * 3 + [1.0], dtype=np.float32)
IMAGE_MIN = np.zeros((3,), dtype=np.float32)
IMAGE_MAX = np.ones((3,), dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class LimitsNormalizer:
    """Maps [mins, maxs] -> [-1, 1] elementwise over the trailing axis."""

    mins: np.ndarray
    maxs: np.ndarray

    def _lims(self, x: torch.Tensor):
        return (torch.as_tensor(self.mins, device=x.device),
                torch.as_tensor(self.maxs, device=x.device))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self._lims(x)
        return 2.0 * ((x - lo) / (hi - lo)) - 1.0

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self._lims(x)
        return (x.clamp(-1.0, 1.0) + 1.0) * 0.5 * (hi - lo) + lo


def image_normalizer() -> LimitsNormalizer:
    return LimitsNormalizer(IMAGE_MIN, IMAGE_MAX)


def lb_action_normalizer(orn01: bool = False) -> LimitsNormalizer:
    if orn01:
        return LimitsNormalizer(LB_ACTION_MIN_ORN01, LB_ACTION_MAX_ORN01)
    return LimitsNormalizer(LB_ACTION_MIN, LB_ACTION_MAX)
