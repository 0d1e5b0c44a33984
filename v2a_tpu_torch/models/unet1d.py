"""Conditional 1D U-Net over action trajectories.

Counterpart of `v2a_tpu/models/unet1d.py` (the reference's
`ConditionalUnet1D`, `conditional_unet1d.py:69-246`): per level two
FiLM-conditioned residual blocks, strided-conv down / transposed-conv up,
two mid blocks, skip concatenation, and the reference's quirk that the
outermost skip is never consumed. `no_down_up=True` drops the down and up
convs (the levels keep T; `v2a_tpu/models/unet1d.py:159,204,230`), and
with them their parameters. Public tensors are (B, T, C); the convs run
(B, C, T) inside. GroupNorm in float32, convs in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from v2a_tpu_torch.models.perceiver import _linear


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin | cos] with the (half_dim - 1) denominator (`positional_embedding.py`)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _conv1d(x: torch.Tensor, m: nn.Conv1d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv1d(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype), m.stride, m.padding)


class Conv1dBlock(nn.Module):
    """Conv1d -> GroupNorm (float32) -> Mish (`conv1d_components.py:24-41`)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, n_groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv1d(cin, cout, kernel_size, padding=kernel_size // 2)
        self.norm = nn.GroupNorm(n_groups, cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv1d(x, self.conv, self.dtype).float()
        y = F.group_norm(y, self.norm.num_groups, self.norm.weight, self.norm.bias, 1e-5)
        return mish(y).to(self.dtype)


class ConditionalResidualBlock1D(nn.Module):
    """FiLM residual block (`conditional_unet1d.py:14-66`)."""

    def __init__(self, cin: int, cout: int, cond_dim: int, kernel_size: int = 3,
                 n_groups: int = 8, cond_predict_scale: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.cond_predict_scale = dtype, cond_predict_scale
        self.block0 = Conv1dBlock(cin, cout, kernel_size, n_groups, dtype)
        self.cond_encoder = nn.Linear(cond_dim, cout * 2 if cond_predict_scale else cout)
        self.block1 = Conv1dBlock(cout, cout, kernel_size, n_groups, dtype)
        if cin != cout:
            self.residual_conv = nn.Conv1d(cin, cout, 1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        out = self.block0(x)
        embed = _linear(mish(cond), self.cond_encoder, self.dtype)[:, :, None]
        if self.cond_predict_scale:
            scale, bias = embed.chunk(2, dim=1)
            out = scale * out + bias
        else:
            out = out + embed
        out = self.block1(out)
        if hasattr(self, "residual_conv"):
            x = _conv1d(x, self.residual_conv, self.dtype)
        return out + x


class ConditionalUnet1D(nn.Module):
    """(B, T, input_dim) noisy trajectory + timestep + global cond (B, G) ->
    (B, T, input_dim) float32 epsilon prediction."""

    def __init__(self, input_dim: int = 7, global_cond_dim: int = 128,
                 down_dims: Sequence[int] = (256, 512, 1024),
                 diffusion_step_embed_dim: int = 128, kernel_size: int = 5, n_groups: int = 8,
                 cond_predict_scale: bool = True, dtype: torch.dtype = torch.float32,
                 no_down_up: bool = False):
        super().__init__()
        self.dtype, self.dsed, self.no_down_up = dtype, diffusion_step_embed_dim, no_down_up
        dsed = diffusion_step_embed_dim
        cond_dim = dsed + global_cond_dim
        self.time_dense0 = nn.Linear(dsed, dsed * 4)
        self.time_dense1 = nn.Linear(dsed * 4, dsed)
        all_dims = [input_dim] + list(down_dims)
        in_out = list(zip(all_dims[:-1], all_dims[1:]))
        self.n_levels = len(in_out)

        def res(name, cin, cout):
            self.add_module(name, ConditionalResidualBlock1D(
                cin, cout, cond_dim, kernel_size, n_groups, cond_predict_scale, dtype))

        for idx, (din, dout) in enumerate(in_out):
            res(f"down_{idx}_res0", din, dout)
            res(f"down_{idx}_res1", dout, dout)
            if idx < len(in_out) - 1 and not no_down_up:
                self.add_module(f"down_{idx}_downsample", nn.Conv1d(dout, dout, 3, 2, 1))
        mid = all_dims[-1]
        res("mid_res0", mid, mid)
        res("mid_res1", mid, mid)
        for idx, (din, dout) in enumerate(reversed(in_out[1:])):
            res(f"up_{idx}_res0", dout * 2, din)
            res(f"up_{idx}_res1", din, din)
            if not no_down_up:
                self.add_module(f"up_{idx}_upsample", nn.ConvTranspose1d(din, din, 4, 2, 1))
        self.final_block = Conv1dBlock(down_dims[0], down_dims[0], kernel_size, n_groups, dtype)
        self.final_conv = nn.Conv1d(down_dims[0], input_dim, 1)

    def forward(self, sample: torch.Tensor, timestep: torch.Tensor,
                global_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        b = sample.shape[0]
        timestep = torch.as_tensor(timestep, device=sample.device)
        if timestep.ndim == 0:
            timestep = timestep.expand(b)
        t_emb = _linear(sinusoidal_pos_emb(timestep, self.dsed).to(dt), self.time_dense0, dt)
        t_emb = _linear(mish(t_emb), self.time_dense1, dt)
        cond = t_emb if global_cond is None else torch.cat([t_emb, global_cond.to(dt)], -1)

        x = sample.to(dt).transpose(1, 2)
        skips = []
        for idx in range(self.n_levels):
            x = getattr(self, f"down_{idx}_res0")(x, cond)
            x = getattr(self, f"down_{idx}_res1")(x, cond)
            skips.append(x)
            if idx < self.n_levels - 1 and not self.no_down_up:
                x = _conv1d(x, getattr(self, f"down_{idx}_downsample"), dt)
        x = self.mid_res1(self.mid_res0(x, cond), cond)
        for idx in range(self.n_levels - 1):  # the level-0 skip is never used
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"up_{idx}_res0")(x, cond)
            x = getattr(self, f"up_{idx}_res1")(x, cond)
            if not self.no_down_up:
                up = getattr(self, f"up_{idx}_upsample")
                x = F.conv_transpose1d(x, up.weight.to(dt), up.bias.to(dt), 2, 1)
        x = _conv1d(self.final_block(x), self.final_conv, dt)
        return x.transpose(1, 2).float()
