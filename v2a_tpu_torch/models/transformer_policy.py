"""Transformer action denoiser (the diffusion-policy baseline family).

Counterpart of `v2a_tpu/models/transformer_policy.py` (the reference's
`TransformerForDiffusion`, `flowdiffusion/flowdiffusion/
diffusion_policy_baseline/transformer_for_diffusion.py:23-360`), the
alternative to `ConditionalUnet1D`: a pre-LN encoder / decoder transformer
whose decoder tokens are the noisy action trajectory and whose memory is
[timestep token ; per-step observation tokens]. The modes of the JAX
module: `time_as_cond` (off: the BERT-style time token prepended to an
encoder-only trunk), observation conditioning with `cond_dim > 0` (a 2-D
`global_cond` reshaped to `n_obs_steps` tokens of `cond_dim`), causal
self-attention with the reference's shifted memory mask (`t >= s - 1`), a
Mish MLP (`n_cond_layers == 0`) or transformer layers over the memory;
exact GELU, learned position embeddings (zeros at init).

Dtypes as the JAX module's: dense layers in the compute dtype, LayerNorms
and softmax in float32 (a LayerNorm's output stays float32 until the next
dense layer casts it), the final LayerNorm and head in float32. Plain
PyTorch: the JAX module reaches no Pallas kernel. It takes (sample (B, T,
input_dim), timestep, global_cond), as `ConditionalUnet1D` does; no
`DiffusionPolicy` field selects it, in the JAX package or here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from v2a_tpu_torch.models.perceiver import LayerNorm32, _linear
from v2a_tpu_torch.models.unet1d import mish, sinusoidal_pos_emb


def _mask(allowed: torch.Tensor) -> torch.Tensor:
    """0 where attention is allowed, -inf where not (float32)."""
    return torch.zeros(allowed.shape, device=allowed.device).masked_fill(~allowed, float("-inf"))


class _MHA(nn.Module):
    def __init__(self, n_emb: int, n_head: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_emb, self.n_head, self.dtype = n_emb, n_head, dtype
        self.q, self.k = nn.Linear(n_emb, n_emb), nn.Linear(n_emb, n_emb)
        self.v, self.proj = nn.Linear(n_emb, n_emb), nn.Linear(n_emb, n_emb)

    def forward(self, q_in, kv_in, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt, h, d = self.dtype, self.n_head, self.n_emb // self.n_head
        b, tq, tk = q_in.shape[0], q_in.shape[1], kv_in.shape[1]
        q = _linear(q_in, self.q, dt).reshape(b, tq, h, d)
        k = _linear(kv_in, self.k, dt).reshape(b, tk, h, d)
        v = _linear(kv_in, self.v, dt).reshape(b, tk, h, d)
        # float32 logits of the rounded operands (preferred_element_type)
        logits = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) / math.sqrt(d)
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhij,bjhd->bihd", w, v).reshape(b, tq, self.n_emb)
        return _linear(out, self.proj, dt)


class _FFN(nn.Module):
    def __init__(self, n_emb: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1, self.fc2 = nn.Linear(n_emb, 4 * n_emb), nn.Linear(4 * n_emb, n_emb)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class _EncoderLayer(nn.Module):
    """Pre-LN encoder layer (norm_first=True)."""

    def __init__(self, n_emb: int, n_head: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1, self.ln2 = LayerNorm32(n_emb), LayerNorm32(n_emb)
        self.attn = _MHA(n_emb, n_head, dtype)
        self.ffn = _FFN(n_emb, dtype)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        h = self.ln1(x)
        x = x + self.attn(h, h, mask)
        return x + self.ffn(self.ln2(x))


class _DecoderLayer(nn.Module):
    """Pre-LN decoder layer: self-attention, cross-attention, FFN."""

    def __init__(self, n_emb: int, n_head: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1, self.ln2, self.ln3 = LayerNorm32(n_emb), LayerNorm32(n_emb), LayerNorm32(n_emb)
        self.self_attn = _MHA(n_emb, n_head, dtype)
        self.cross_attn = _MHA(n_emb, n_head, dtype)
        self.ffn = _FFN(n_emb, dtype)

    def forward(self, x, memory, self_mask=None, memory_mask=None) -> torch.Tensor:
        h = self.ln1(x)
        x = x + self.self_attn(h, h, self_mask)
        x = x + self.cross_attn(self.ln2(x), memory, memory_mask)
        return x + self.ffn(self.ln3(x))


class TransformerForDiffusion(nn.Module):
    """(sample (B, T, input_dim), timestep () or (B,), global_cond (B,
    n_obs_steps * cond_dim) or (B, n_obs_steps, cond_dim)) -> (B, T,
    output_dim) float32. T is `horizon` (the position embeddings' length)."""

    def __init__(self, input_dim: int = 7, output_dim: int = 7, horizon: int = 16,
                 n_obs_steps: int = 1, cond_dim: int = 0, n_layer: int = 8, n_head: int = 4,
                 n_emb: int = 256, causal_attn: bool = False, time_as_cond: bool = True,
                 n_cond_layers: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_emb, self.n_obs_steps, self.dtype = n_emb, n_obs_steps, dtype
        self.causal_attn, self.time_as_cond = causal_attn, time_as_cond
        self.obs_as_cond = cond_dim > 0
        self.input_emb = nn.Linear(input_dim, n_emb)
        if not time_as_cond:
            self.pos_emb = nn.Parameter(torch.zeros(horizon + 1, n_emb))
            self._stack("enc", _EncoderLayer, n_layer, n_head)
        else:
            t_cond = 1
            if self.obs_as_cond:
                self.cond_obs_emb = nn.Linear(cond_dim, n_emb)
                t_cond += n_obs_steps
            self.cond_pos_emb = nn.Parameter(torch.zeros(t_cond, n_emb))
            if n_cond_layers > 0:
                self._stack("cond_enc", _EncoderLayer, n_cond_layers, n_head)
            else:
                self.cond_mlp_in = nn.Linear(n_emb, 4 * n_emb)
                self.cond_mlp_out = nn.Linear(4 * n_emb, n_emb)
            self.pos_emb = nn.Parameter(torch.zeros(horizon, n_emb))
            self._stack("dec", _DecoderLayer, n_layer, n_head)
        self.ln_f = LayerNorm32(n_emb)
        self.head = nn.Linear(n_emb, output_dim)

    def _stack(self, name: str, layer, n: int, n_head: int) -> None:
        """`n` layers named as the JAX module's: {name}_0, {name}_1, ..."""
        for i in range(n):
            self.add_module(f"{name}_{i}", layer(self.n_emb, n_head, self.dtype))
        setattr(self, f"_{name}", [getattr(self, f"{name}_{i}") for i in range(n)])

    def forward(self, sample: torch.Tensor, timestep, global_cond: Optional[torch.Tensor] = None,
                ) -> torch.Tensor:
        dt = self.dtype
        b, t = sample.shape[:2]
        dev = sample.device
        timestep = torch.as_tensor(timestep, device=dev)
        if timestep.ndim == 0:
            timestep = timestep[None].expand(b)
        time_tok = sinusoidal_pos_emb(timestep, self.n_emb)[:, None].to(dt)  # (B, 1, E)
        x = _linear(sample, self.input_emb, dt)
        tril = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
        causal = _mask(tril) if self.causal_attn else None
        if not self.time_as_cond:  # BERT-style: the time token leads the trunk
            x = torch.cat([time_tok, x], dim=1) + self.pos_emb[None].to(dt)
            mask = None
            if self.causal_attn:
                mask = _mask(torch.ones(t + 1, t + 1, dtype=torch.bool, device=dev).tril())
            for layer in self._enc:
                x = layer(x, mask)
            x = x[:, 1:]
        else:
            toks = [time_tok]
            if self.obs_as_cond:
                if global_cond is None:
                    raise ValueError("cond_dim > 0 requires conditioning input")
                cond = global_cond.to(dt)
                if cond.ndim == 2:
                    cond = cond.reshape(b, self.n_obs_steps, -1)
                toks.append(_linear(cond, self.cond_obs_emb, dt))
            memory = torch.cat(toks, dim=1) + self.cond_pos_emb[None].to(dt)
            if hasattr(self, "_cond_enc"):
                for layer in self._cond_enc:
                    memory = layer(memory)
            else:
                memory = _linear(mish(_linear(memory, self.cond_mlp_in, dt)), self.cond_mlp_out,
                                 dt)
            x = x + self.pos_emb[None].to(dt)
            memory_mask = None
            if self.causal_attn and self.obs_as_cond:
                # action token t may attend to cond token s iff t >= s - 1
                # (the time token is s = 0)
                tt = torch.arange(t, device=dev)[:, None]
                ss = torch.arange(memory.shape[1], device=dev)[None, :]
                memory_mask = _mask(tt >= ss - 1)
            for layer in self._dec:
                x = layer(x, memory, causal, memory_mask)
        return _linear(self.ln_f(x), self.head, torch.float32)
