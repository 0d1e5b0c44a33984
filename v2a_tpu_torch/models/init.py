"""Seeded random initialization of the port's modules.

Draws every weight from one `torch.Generator`, with the JAX package's
initializer scales: lecun-normal (std 1/sqrt(fan_in)) for dense and conv
weights, zero biases, unit norm scales, and the per-module `init_std` of
learned embeddings. Parameters a module builds with fixed values (norm
scales, the identity temporal kernel) keep them, and a module flagged
`zero_init` (a layer the JAX package initializes to zero) stays zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    for m in module.modules():
        if getattr(m, "zero_init", False):
            for p in m.parameters(recurse=False):
                p.zero_()
            continue
        for name, std in getattr(m, "init_std", {}).items():
            getattr(m, name).normal_(0.0, std, generator=generator)
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        elif isinstance(m, nn.ConvTranspose1d):  # weight (in, out, k)
            fan_in = m.weight.shape[0] * m.weight.shape[2]
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[1]), generator=generator)
        else:
            continue
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
    return module
