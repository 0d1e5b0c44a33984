"""Device selection for the port's entry points: the card unless the caller
asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`cuda` by default; raises when that is asked for and there is no card
    (the CPU runs only when the caller passes `device="cpu"`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def dtype_of(name: Optional[str]) -> torch.dtype:
    """'float32' / 'bfloat16' config strings -> torch dtypes."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported dtype {name!r}")
    return table[name]
