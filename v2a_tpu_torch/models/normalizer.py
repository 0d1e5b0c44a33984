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
# the other environment families' bounds (`diffuser/datasets/__init__.py`):
# MetaWorld Sawyer (:4-6), iThor's discrete 4-dim (:50-58), Calvin relative
# and absolute (:62-80), the CLIP task-embedding placeholder (:42-45)
MW_SAWYER_ACTION_MIN = np.full((4,), -1.0, dtype=np.float32)
MW_SAWYER_ACTION_MAX = np.full((4,), 1.0, dtype=np.float32)
THOR_ACTION_MIN_DIM4 = np.full((4,), -1.0, dtype=np.float32)
THOR_ACTION_MAX_DIM4 = np.full((4,), 1.0, dtype=np.float32)
CAL_ACTION_MIN = np.full((7,), -1.0, dtype=np.float32)
CAL_ACTION_MAX = np.full((7,), 1.0, dtype=np.float32)
CAL_ABS_ACTION_MIN = (
    np.asarray([-0.20, -0.50, 0.3, -3.15, -0.50, -3.15, -1.0], np.float32) - 0.01
)
CAL_ABS_ACTION_MAX = (
    np.asarray([0.36, 0.12, 0.70, 3.15, 0.30, 3.15, 1.0], np.float32) + 0.01
)
TASK_EMBED_MIN = np.zeros((512,), dtype=np.float32)
TASK_EMBED_MAX = np.ones((512,), dtype=np.float32)
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
