"""CLIP text encoder and the offline tokenizer.

Counterpart of `v2a_tpu/models/clip_text.py`: the ViT-B/32 text tower
(vocab 49408, width 512, 12 layers, 8 heads, MLP 2048, 77 positions,
quick-GELU, causal + padding masks, final LayerNorm in float32), the
deterministic `HashTokenizer`, `ClipTokenizerWrapper` (the HF BPE
`CLIPTokenizer` read from a local directory, such as the `tokenizer/` that
`scripts/convert_ckpt.py --clip` writes beside converted CLIP weights; it
needs `transformers`) and the task-string sanitization.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from v2a_tpu_torch.models.perceiver import LayerNorm32, _linear

VOCAB_SIZE = 49408
MAX_POSITIONS = 77
BOS_ID = 49406
EOS_ID = 49407


def sanitize_task_strings(tasks: List[str]) -> List[str]:
    """Strip '-' and '_' (`diffuser/models/helpers.py:27-48`)."""
    return [t.replace("-", " ").replace("_", " ") for t in tasks]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipTextBlock(nn.Module):
    def __init__(self, width: int = 512, heads: int = 8, mlp_dim: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.ln1 = LayerNorm32(width)
        self.q = nn.Linear(width, width)
        self.k = nn.Linear(width, width)
        self.v = nn.Linear(width, width)
        self.proj = nn.Linear(width, width)
        self.ln2 = LayerNorm32(width)
        self.fc1 = nn.Linear(width, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self.ln1(x).to(dt)
        b, n, _ = h.shape
        hd = self.width // self.heads
        q = _linear(h, self.q, dt).reshape(b, n, self.heads, hd)
        k = _linear(h, self.k, dt).reshape(b, n, self.heads, hd)
        v = _linear(h, self.v, dt).reshape(b, n, self.heads, hd)
        logits = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) / np.sqrt(hd)
        weights = torch.softmax(logits + attn_bias, dim=-1).to(dt)
        out = torch.einsum("bhij,bjhd->bihd", weights, v).reshape(b, n, self.width)
        x = x + _linear(out, self.proj, dt)
        h = quick_gelu(_linear(self.ln2(x).to(dt), self.fc1, dt))
        return x + _linear(h, self.fc2, dt)


class ClipTextEncoder(nn.Module):
    """Returns the last hidden state (B, N, width) in float32."""

    def __init__(self, vocab_size: int = VOCAB_SIZE, width: int = 512, layers: int = 12,
                 heads: int = 8, mlp_dim: int = 2048, max_positions: int = MAX_POSITIONS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Parameter(torch.empty(max_positions, width))
        self.init_std = {"position_embedding": 0.01}
        for i in range(layers):
            self.add_module(f"block_{i}", ClipTextBlock(width, heads, mlp_dim, dtype))
        self.final_ln = LayerNorm32(width)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n = input_ids.shape
        tok = self.token_embedding(input_ids).to(self.dtype)
        x = tok + self.position_embedding[:n][None].to(self.dtype)
        dev = input_ids.device
        bias = torch.triu(torch.full((n, n), float("-inf"), device=dev), diagonal=1)[None, None]
        if attention_mask is not None:
            pad = torch.zeros(attention_mask.shape, device=dev).masked_fill(
                attention_mask <= 0, float("-inf"))
            bias = bias + pad[:, None, None, :]
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, bias)
        return self.final_ln(x)


class HashTokenizer:
    """Deterministic offline tokenizer: whitespace words -> stable ids in the
    CLIP vocab range, with BOS/EOS and padding to the longest sequence. Not
    the real BPE."""

    def __init__(self, max_length: int = MAX_POSITIONS):
        self.max_length = max_length

    def _word_id(self, word: str) -> int:
        digest = hashlib.sha1(word.lower().encode()).digest()
        return int.from_bytes(digest[:4], "little") % (BOS_ID - 1) + 1

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        seqs = [
            [BOS_ID] + [self._word_id(w) for w in t.split()][: self.max_length - 2] + [EOS_ID]
            for t in texts
        ]
        n = max(len(s) for s in seqs)
        input_ids = np.zeros((len(seqs), n), np.int64)
        mask = np.zeros((len(seqs), n), np.int64)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return input_ids, mask


class ClipTokenizerWrapper:
    """The HF `CLIPTokenizer` from local assets when `local_path` is given,
    else the `HashTokenizer`. A path that is given must load: without
    `transformers` it raises `ImportError` rather than tokenize with the
    hash stand-in, whose ids would not be the ones converted CLIP weights
    were trained on. Nothing is fetched (`from_pretrained` on a local
    directory only)."""

    def __init__(self, local_path: Optional[str] = None, max_length: int = MAX_POSITIONS):
        self.max_length = max_length
        self._hf = None
        if local_path:
            from transformers import CLIPTokenizer

            self._hf = CLIPTokenizer.from_pretrained(local_path, local_files_only=True)
        self._fallback = HashTokenizer(max_length)

    @property
    def is_real(self) -> bool:
        return self._hf is not None

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        if self._hf is None:
            return self._fallback(texts)
        out = self._hf(texts, padding=True, truncation=True, max_length=self.max_length,
                       return_tensors="np")
        return out["input_ids"].astype(np.int64), out["attention_mask"].astype(np.int64)
