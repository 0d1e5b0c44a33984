"""Image preprocessing and episode visualization utilities (host side).

A copy of `v2a_tpu/data/img_utils.py`; imageio stays optional.

The reference converts rendered uint8 HWC frames to float CHW [0,1] tensors
on the host (`diffuser/datasets/img_utils.py:62-71`, the no-crop Libero
path). Here images stay uint8 HWC on the host; the [0,1] scaling happens on
device (`to_float01`) so host->device transfers move 4x fewer bytes. A
center-crop variant matching the MetaWorld path (`img_utils.py:5-27`) is
provided for capability parity.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

try:  # imageio is available in the image; degrade gracefully without it
    import imageio.v2 as imageio
except Exception:  # pragma: no cover
    imageio = None


def to_float01(imgs):
    """uint8 [0,255] -> float32 [0,1]; works on numpy arrays and torch tensors.
    """
    return imgs.astype("float32") / 255.0


def center_crop(imgs: np.ndarray, crop_hw) -> np.ndarray:
    """Center-crop HWC or BHWC uint8 images (MetaWorld preproc parity,
    `diffuser/datasets/img_utils.py:5-27`)."""
    ch, cw = crop_hw
    h, w = imgs.shape[-3], imgs.shape[-2]
    top = (h - ch) // 2
    left = (w - cw) // 2
    return imgs[..., top : top + ch, left : left + cw, :]


def check_uint8_hwc(imgs: np.ndarray):
    if imgs.dtype != np.uint8:
        raise TypeError(f"expected uint8 images, got {imgs.dtype}")
    if imgs.shape[-1] != 3:
        raise ValueError(f"expected HWC with 3 channels, got {imgs.shape}")


def save_episode_png(path: str, imgs: np.ndarray, max_frames: int = 16):
    """Save a horizontal strip of episode frames for debugging (counterpart
    of the grid savers at `diffuser/datasets/img_utils.py:74-89`)."""
    check_uint8_hwc(imgs)
    if imageio is None:
        return
    idxs = np.linspace(0, len(imgs) - 1, min(max_frames, len(imgs))).astype(int)
    strip = np.concatenate([imgs[i] for i in idxs], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imageio.imwrite(path, strip)


def save_episode_mp4(path: str, imgs: Sequence[np.ndarray], fps: int = 50):
    """Save an episode rollout video (eval artifact parity with
    `diffuser/libero/lb_eval_helper.py:119-144`)."""
    if imageio is None:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        imageio.mimwrite(path, list(imgs), fps=fps, macro_block_size=1)
    except Exception:
        # fall back to gif when no ffmpeg backend is present
        alt = os.path.splitext(path)[0] + ".gif"
        imageio.mimwrite(alt, list(imgs), duration=1.0 / fps)
