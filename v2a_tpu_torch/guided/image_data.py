"""Image-folder dataset for the guided-diffusion CLIs.

A copy of `v2a_tpu/guided/image_data.py` (the reference's
`guided_diffusion/image_datasets.py:1-167`): recursive listing, class
labels from the filename's underscore prefix, center-crop-to-square and
nearest resize, values scaled to [-1, 1]. Batches are NHWC numpy arrays; a
numpy `Generator` drives the shuffling, so a seed gives the JAX package's
batches. The port keeps its own copy: it imports nothing of the JAX
package.

`.npy` files (a single HWC uint8/float array) are accepted alongside
images so hermetic tests need no image codecs; PIL is imported only for
the other files.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_IMG_EXTS = ("jpg", "jpeg", "png", "gif", "bmp", "npy")


def list_image_files(data_dir: str) -> List[str]:
    """`image_datasets.py:70-80` — recursive, sorted."""
    out: List[str] = []
    for root, dirs, files in os.walk(data_dir):
        dirs.sort()
        for name in sorted(files):
            if name.split(".")[-1].lower() in _IMG_EXTS:
                out.append(os.path.join(root, name))
    return out


def _load_image(path: str, image_size: int) -> np.ndarray:
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        from PIL import Image

        with Image.open(path) as img:
            img = img.convert("RGB")
            arr = np.asarray(img)
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    # center-crop to square then nearest-resize (`image_datasets.py:124-157`
    # uses BICUBIC downsampling halves + BOX; capability-equivalent here)
    h, w = arr.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    arr = arr[top:top + s, left:left + s]
    if s != image_size:
        idx = (np.arange(image_size) * s) // image_size
        arr = arr[idx][:, idx]
    return arr / 127.5 - 1.0


def load_data(
    *,
    data_dir: str,
    batch_size: int,
    image_size: int,
    class_cond: bool = False,
    deterministic: bool = False,
    low_res: Optional[int] = None,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """Infinite iterator of (batch NHWC float32 in [-1,1], model_kwargs)
    (`image_datasets.py:15-67`). `class_cond` labels come from the
    filename's "_"-prefix (`:46-48`). `low_res` adds area-downsampled
    conditioning images for super-res training
    (`scripts/super_res_train.py:63-72`)."""
    if not data_dir:
        raise ValueError("unspecified data directory")
    files = list_image_files(data_dir)
    if not files:
        raise ValueError(f"no image files under {data_dir}")
    labels = None
    if class_cond:
        names = [os.path.basename(p).split("_")[0] for p in files]
        index = {name: i for i, name in enumerate(sorted(set(names)))}
        labels = np.asarray([index[n] for n in names], np.int32)

    rng = np.random.default_rng(seed)
    order = np.arange(len(files))
    pos = len(files)  # trigger (re)shuffle on first use
    while True:
        batch, ys = [], []
        for _ in range(batch_size):
            if pos >= len(files):
                if not deterministic:
                    rng.shuffle(order)
                pos = 0
            i = order[pos]
            pos += 1
            batch.append(_load_image(files[i], image_size))
            if labels is not None:
                ys.append(labels[i])
        x = np.stack(batch)
        kwargs: Dict[str, np.ndarray] = {}
        if labels is not None:
            kwargs["y"] = np.asarray(ys, np.int32)
        if low_res is not None:
            kwargs["low_res"] = area_downsample(x, low_res)
        yield x, kwargs


def area_downsample(x: np.ndarray, size: int) -> np.ndarray:
    """Box/area downsample NHWC to (size, size) — torch
    `F.interpolate(mode="area")` equivalent (`super_res_train.py:70`)."""
    b, h, w, c = x.shape
    fh, fw = h // size, w // size
    if fh * size != h or fw * size != w:
        raise ValueError(f"{(h, w)} not a multiple of {size}")
    return x.reshape(b, size, fh, size, fw, c).mean(axis=(2, 4))
