"""What the drivers of the traffic kinds share: seeds drawn from the run's
seed, the video model's weights made from a seed on the device, the port's
video model and the reference built from them, and the comparisons.

A traffic kind's driver is `kinds/<kind>.py`, found by the `kind` of a
traffic file (`spec.load_driver`). It makes the weights and the inputs from
the seed, warms up the cell's own shapes (`setup`), runs the window
(`window(seconds)` -> the end-to-end metrics it measures, with `counts`
and `attempted` set), lets the program go (`free_program`), and holds what
the window produced against the plain float32 reference (`check()` -> the
numbers that decide `correct`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch

from port_bench.reference import nets as ref_nets


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose, drawn from the run's seed."""
    a, b = np.random.SeedSequence([seed % 2 ** 64, purpose]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


WEIGHTS, INPUTS, STREAM, TRAIN, CHECK = range(5)


def weight_shapes(model: dict) -> Dict[str, torch.Size]:
    """The video model's leaves (`unet.*`, `text.*`) and their shapes, in the
    reference's order."""
    with torch.device("meta"):
        nets = ref_nets.VideoNets(model)
    return {k: v.shape for k, v in nets.state_dict().items()}


@torch.no_grad()
def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from one standard-normal draw on `device`, scaled by its
    role: norm gains 1 + 0.1 n, biases 0.1 n, the text tower's position
    embedding 0.01 n, the Perceiver's latents and positions n, conv kernels
    n / sqrt(fan-in), dense and embedding weights n / sqrt(their input
    width). Nothing is left at zero or at the identity, so every leaf
    shapes the output."""
    shapes = weight_shapes(model)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        t = flat[off:off + math.prod(shape)].view(shape)
        off += math.prod(shape)
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) == 1:
            if leaf in ("scale", "g", "q_scale", "k_scale"):
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.1)
        elif leaf == "position_embedding":
            t.mul_(0.01)
        elif leaf in ("pos_emb", "latents"):
            pass
        elif leaf == "kernel":
            t.mul_(1.0 / math.sqrt(math.prod(shape[:-1])))
        else:
            t.mul_(1.0 / math.sqrt(shape[-1]))
        out[name] = t
    return out


def model_config(model: dict):
    """The port's `VideoModelConfig` of a configuration's model section (the
    kinds that serve or train the video model)."""
    from v2a_tpu_torch.models.video_model import VideoModelConfig

    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in model.items()}
    return VideoModelConfig(**fields)


def build_model(model: dict, seed: int, device):
    """The port's `VideoPredModel` with the seed's weights, built on
    `device`."""
    from v2a_tpu_torch.models.video_model import VideoPredModel

    with torch.device(device):
        vm = VideoPredModel(model_config(model), device=device)
    vm.load_state_dict(make_weights(model, seed, device))
    return vm


def reference_nets(model: dict, seed: int, device) -> ref_nets.VideoNets:
    with torch.device(device):
        nets = ref_nets.VideoNets(model)
    nets.load_state_dict(make_weights(model, seed, device))
    return nets


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convs in float32, not TF32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rel_rows(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's |got - want| / |want| (L2 over each row)."""
    d = (got.float() - want.float()).reshape(got.shape[0], -1).norm(dim=1)
    return float((d / want.float().reshape(want.shape[0], -1).norm(dim=1)).max())


def norm_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's gap between the norms |got| and |want|, over the
    larger of |want| and the median leaf's |want|."""
    wn = {k: float(want[k].float().norm()) for k in want}
    median = float(np.median(list(wn.values())))
    return max(abs(float(got[k].float().norm()) - wn[k]) / max(wn[k], median, 1e-30)
               for k in want)
