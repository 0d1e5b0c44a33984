"""Carries the JAX package's parameters into the port.

Each function takes a JAX parameter tree as nested dicts of numpy arrays
(with or without the outer 'params' key) and returns the port model's
`state_dict` (float32 tensors). One set of weights then makes both packages
compute the same function.

Layout changes:
- flax Dense kernel (in, out) -> torch Linear weight (out, in);
- flax Embed `embedding` -> torch Embedding `weight`;
- video U-Net convs keep the flax layouts: spatial kernels (kh, kw, C, D)
  HWIO (what K1 reads as a (9C, D) matrix) and temporal kernels
  (k, C_in, C_out) (what K2 reads as (3C, C));
- policy convs become torch layouts: Conv2d (D, C, kh, kw), Conv1d
  (D, C, k), and the transposed up-conv (C_in, C_out, k) flipped along k
  (flax's ConvTranspose correlates with the unflipped kernel);
- GroupNorm `scale` -> `weight` in the policy (torch GroupNorm modules);
- the Inception trunk's folded HWIO kernels -> OIHW conv weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v, np.float32)
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def video_tree(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """One video-side module's JAX tree -> its port state dict."""
    sd = {}
    for name, a in _flatten(tree).items():
        if name.endswith(".kernel") and a.ndim == 2:
            name, a = name[: -len("kernel")] + "weight", a.T
        elif name.endswith(".embedding"):
            name = name[: -len("embedding")] + "weight"
        sd[prefix + name] = _tensor(a)
    return sd


def video_model_from_jax(unet_params: Mapping, text_params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `VideoPredModel.params['unet']` / `['text']` -> state dict of the
    port's `VideoPredModel.nets` (`unet.*`, `text.*`), for either backbone:
    `VideoUNetXAttn` keeps the JAX names and layouts as `VideoUNet` does."""
    sd = video_tree(unet_params, "unet.")
    sd.update(video_tree(text_params, "text."))
    return sd


def transformer_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `TransformerForDiffusion` params -> state dict of the port's
    module (its layers keep the JAX names, `enc_0`, `dec_0`, ...; LayerNorm
    `scale` / `bias`; the position embeddings as they are)."""
    return video_tree(params)


def image_net_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `ImageUNet` or `EncoderUNet` params (`models/image_unet.py`) ->
    state dict of the port's net of the same name, for a strict
    `load_state_dict`: the port keeps the JAX names and the HWIO conv
    kernels; dense kernels transpose, `label_emb.embedding` is the
    embedding's weight."""
    return video_tree(params)


def inception_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A folded Inception params tree (`ops/inception.py::
    convert_inception_state_dict` or `load_inception_params`, either
    package's) -> state dict of the port's `InceptionV3`: each conv's HWIO
    kernel as an OIHW `weight`, its `bias`, and the optional `fc` head's
    (2048, n) kernel as a Linear weight (n, 2048)."""
    sd = {}
    for name, leaves in params.items():
        kernel = np.asarray(leaves["kernel"], np.float32)
        sd[f"{name}.weight"] = _tensor(kernel.T if name == "fc" else kernel.transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _tensor(leaves["bias"])
    return sd


def policy_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `DiffusionPolicy.init` params -> state dict of the port's
    `PolicyNets`."""
    sd = {}
    for name, a in _flatten(params).items():
        stem, leaf = name.rsplit(".", 1)
        if stem.endswith("_downsample.conv") or stem.endswith("_upsample.conv"):
            stem = stem[: -len(".conv")]
        if leaf == "kernel":
            leaf = "weight"
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif stem.endswith("_upsample"):
                a = a[::-1].transpose(1, 2, 0)
            else:
                a = a.transpose(2, 1, 0)
        elif leaf == "scale":
            leaf = "weight"
        sd[f"{stem}.{leaf}"] = _tensor(a)
    return sd


def train_state_from_jax(params: Mapping, ema_params: Mapping, step) -> Dict[str, object]:
    """A JAX `PolicyTrainState`'s trees (numpy) -> {"params", "ema_params":
    state dicts of the port's `PolicyNets`, "step": int}, what
    `OnlineTrainer.start_from` takes: the trained and the EMA policy of the
    port then compute the JAX package's functions."""
    return {"params": policy_from_jax(params), "ema_params": policy_from_jax(ema_params),
            "step": int(np.asarray(step))}
