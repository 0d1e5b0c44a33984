"""The reference's torch checkpoints into the port.

The port's copy of the JAX package's `convert/torch_import.py`. It reads the
reference's `model-{milestone}.pt` video checkpoints (an `ema_pytorch.EMA`
state dict around `GoalGaussianDiffusion(Unet_Libero(UNetModel))`, loaded at
`diffuser/models/video_model.py:38-46`), the HF CLIP text tower and the
reference trainer's policy checkpoints (`lb_online_trainer_v7.py:364-383`).

Two stages:

1. numpy, a copy of the JAX converter's: the reference state dict -> the
   JAX package's parameter tree (nested dicts of numpy arrays). Layouts:

       torch Linear   (O, I)         -> Dense kernel (I, O)
       torch Conv2d   (O, I, kh, kw) -> Conv kernel (kh, kw, I, O)
       torch Conv1d   (O, I, k)      -> Conv kernel (k, I, O)
       torch Conv1d k=1 (attn qkv/proj) -> Dense kernel (I, O)
       torch ConvTranspose1d (I, O, k) -> ConvTranspose kernel (k, I, O), k flipped
       GroupNorm/LayerNorm weight/bias -> scale/bias
       Embedding weight               -> table, unchanged

   The structural enumeration (which `input_blocks.{i}` index is which
   module) replays the U-Net constructor loops of
   `guided_diffusion/guided_diffusion/unet.py:532-648`; the optional parts
   (a temporal conv, a skip conv, `task_attnpool`) are taken where their
   keys are present, so a config that disagrees with the file fails in the
   strict load.
2. `convert/from_jax.py` (`video_tree`, `policy_from_jax`): the tree -> the
   port's state dicts. There is one layout map from the JAX tree into the
   port, and this module does not write a second.

The converted video file is `torch.save` of {"unet": state dict, "text":
state dict} (text optional, as in the JAX package's msgpack), read back
with `weights_only=True`; the converted policy file is the `PolicyNets`
state dict. `reference_video_keys` / `reference_policy_keys` give the
reference state dicts' keys and shapes for a config, and
`synthetic_video_checkpoint` / `synthetic_policy_checkpoint` fill them from
a numpy `Generator(seed)` in the trainer layout, and
`write_synthetic_tokenizer` writes BPE tokenizer assets: the counterpart of
`scripts/bringup.py::make_synthetic_assets(real_shape=True)`, which builds
its checkpoint from the live reference model instead.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import zipfile
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from v2a_tpu_torch.convert.from_jax import policy_from_jax, video_tree
from v2a_tpu_torch.models.policy import PolicyConfig
from v2a_tpu_torch.models.video_model import VideoModelConfig

VIDEO_PREFIX = "ema_model.model.unet."
TOKENIZER_ASSETS = ("vocab.json", "merges.txt", "tokenizer.json", "tokenizer_config.json",
                    "special_tokens_map.json")


# -- primitive transforms --------------------------------------------------


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def linear_w(w) -> np.ndarray:
    return _np(w).T


def conv2d_w(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)


def conv1d_w(w) -> np.ndarray:
    return _np(w).transpose(2, 1, 0)


def conv1x1_to_dense(w) -> np.ndarray:
    return _np(w)[..., 0].T


def convtranspose1d_w(w) -> np.ndarray:
    """ConvTranspose1d weight (in, out, k) -> kernel (k, in, out) with the tap
    axis flipped."""
    return np.ascontiguousarray(_np(w).transpose(2, 0, 1)[::-1])


def _norm(sd, p) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}


def _dense(sd, p, bias=True) -> Dict[str, np.ndarray]:
    out = {"kernel": linear_w(sd[f"{p}.weight"])}
    if bias and f"{p}.bias" in sd:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


# -- the video U-Net's modules ---------------------------------------------


def convert_pseudo_conv(sd, p) -> Dict[str, Any]:
    """`Conv3d` = spatial Conv2d + optional temporal Conv1d (`nn.py:30-88`)."""
    out: Dict[str, Any] = {
        "spatial_conv": {
            "kernel": conv2d_w(sd[f"{p}.spatial_conv.weight"]),
            "bias": _np(sd[f"{p}.spatial_conv.bias"]),
        }
    }
    if f"{p}.temporal_conv.weight" in sd:
        out["temporal_conv"] = {
            "kernel": conv1d_w(sd[f"{p}.temporal_conv.weight"]),
            "bias": _np(sd[f"{p}.temporal_conv.bias"]),
        }
    return out


def convert_resblock(sd, p) -> Dict[str, Any]:
    out = {
        "in_norm": _norm(sd, f"{p}.in_layers.0"),
        "in_conv": convert_pseudo_conv(sd, f"{p}.in_layers.2"),
        "emb_proj": _dense(sd, f"{p}.emb_layers.1"),
        "out_norm": _norm(sd, f"{p}.out_layers.0"),
        "out_conv": convert_pseudo_conv(sd, f"{p}.out_layers.3"),
    }
    if f"{p}.skip_connection.spatial_conv.weight" in sd:
        out["skip_conv"] = convert_pseudo_conv(sd, f"{p}.skip_connection")
    return out


def convert_attention(sd, p) -> Dict[str, Any]:
    return {
        "norm": _norm(sd, f"{p}.norm"),
        "qkv": {"kernel": conv1x1_to_dense(sd[f"{p}.qkv.weight"]),
                "bias": _np(sd[f"{p}.qkv.bias"])},
        "proj_out": {"kernel": conv1x1_to_dense(sd[f"{p}.proj_out.weight"]),
                     "bias": _np(sd[f"{p}.proj_out.bias"])},
    }


def convert_perceiver(sd, p, depth: int = 2) -> Dict[str, Any]:
    """`PerceiverResampler` (`imagen.py:321-372`)."""
    out: Dict[str, Any] = {
        "latents": _np(sd[f"{p}.latents"]),
        "pos_emb": _np(sd[f"{p}.pos_emb.weight"]),
        "pool_norm": {"g": _np(sd[f"{p}.to_latents_from_mean_pooled_seq.0.g"])},
        "pool_proj": _dense(sd, f"{p}.to_latents_from_mean_pooled_seq.1"),
    }
    for i in range(depth):
        a = f"{p}.layers.{i}.0"
        out[f"attn_{i}"] = {
            "norm": _norm(sd, f"{a}.norm"),
            "norm_latents": _norm(sd, f"{a}.norm_latents"),
            "to_q": _dense(sd, f"{a}.to_q", bias=False),
            "to_kv": _dense(sd, f"{a}.to_kv", bias=False),
            "q_scale": _np(sd[f"{a}.q_scale"]),
            "k_scale": _np(sd[f"{a}.k_scale"]),
            "to_out": _dense(sd, f"{a}.to_out.0", bias=False),
            "out_norm": _norm(sd, f"{a}.to_out.1"),
        }
        f = f"{p}.layers.{i}.1"
        out[f"ff_{i}"] = {
            "norm_in": {"g": _np(sd[f"{f}.0.g"])},
            "dense_in": _dense(sd, f"{f}.1", bias=False),
            "norm_hidden": {"g": _np(sd[f"{f}.3.g"])},
            "dense_out": _dense(sd, f"{f}.4", bias=False),
        }
    return out


def convert_video_unet(
    sd: Dict[str, Any],
    channel_mult: Sequence[int] = (1, 2, 3, 4, 5),
    num_res_blocks: int = 2,
    attention_resolutions: Sequence[int] = (8, 16),
    perceiver_depth: int = 2,
) -> Dict[str, Any]:
    """A torch `UNetModel` state dict (keys relative to the model root) ->
    the `VideoUNet` parameter tree."""
    p: Dict[str, Any] = {}
    p["time_dense0"] = _dense(sd, "time_embed.0")
    p["time_dense1"] = _dense(sd, "time_embed.2")
    if "task_attnpool.0.latents" in sd:
        p["task_attnpool"] = convert_perceiver(sd, "task_attnpool.0", perceiver_depth)
        p["task_proj"] = _dense(sd, "task_attnpool.1")

    p["in_conv"] = convert_pseudo_conv(sd, "input_blocks.0.0")

    # the down path (constructor loop `unet.py:532-582`)
    tidx = 1
    block_idx = 0
    ds = 1
    last = len(channel_mult) - 1
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            p[f"down_res_{block_idx}"] = convert_resblock(sd, f"input_blocks.{tidx}.0")
            if ds in attention_resolutions:
                p[f"down_attn_{block_idx}"] = convert_attention(sd, f"input_blocks.{tidx}.1")
            tidx += 1
            block_idx += 1
        if level != last:
            p[f"downsample_{level}"] = {
                "conv": convert_pseudo_conv(sd, f"input_blocks.{tidx}.0.op")
            }
            tidx += 1
            ds *= 2

    p["mid_res0"] = convert_resblock(sd, "middle_block.0")
    p["mid_attn"] = convert_attention(sd, "middle_block.1")
    p["mid_res1"] = convert_resblock(sd, "middle_block.2")

    # the up path (constructor loop `unet.py:610-648`)
    tidx = 0
    block_idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            p[f"up_res_{block_idx}"] = convert_resblock(sd, f"output_blocks.{tidx}.0")
            sub = 1
            if ds in attention_resolutions:
                p[f"up_attn_{block_idx}"] = convert_attention(
                    sd, f"output_blocks.{tidx}.{sub}")
                sub += 1
            if level and i == num_res_blocks:
                p[f"upsample_{level}"] = {
                    "conv": convert_pseudo_conv(sd, f"output_blocks.{tidx}.{sub}.conv")
                }
                ds //= 2
            tidx += 1
            block_idx += 1

    p["out_norm"] = _norm(sd, "out.0")
    p["out_conv"] = convert_pseudo_conv(sd, "out.2")
    return {"params": p}


def extract_unet_state(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """The EMA U-Net's weights out of a whole `model-{milestone}.pt` dict
    (`Video_PredModel.load` reads `ckpt['ema']`, whose U-Net lives under
    `ema_model.model.unet.*`, `video_model.py:38-46`)."""
    sd = ckpt.get("ema", ckpt)
    out = {k[len(VIDEO_PREFIX):]: v for k, v in sd.items() if k.startswith(VIDEO_PREFIX)}
    if not out:  # maybe already U-Net-rooted
        out = {k: v for k, v in sd.items() if k.startswith("input_blocks")}
        if out:
            return dict(sd)
        raise KeyError(f"could not locate U-Net weights; expected keys under '{VIDEO_PREFIX}'")
    return out


# -- the CLIP text tower -----------------------------------------------------


def convert_clip_text(sd: Dict[str, Any], layers: int = 12) -> Dict[str, Any]:
    """An HF `CLIPTextModel` state dict -> the `ClipTextEncoder` tree."""
    pre = "text_model."
    if not any(k.startswith(pre) for k in sd):
        pre = ""
    p: Dict[str, Any] = {
        "token_embedding": {"embedding": _np(sd[f"{pre}embeddings.token_embedding.weight"])},
        "position_embedding": _np(sd[f"{pre}embeddings.position_embedding.weight"]),
        "final_ln": _norm(sd, f"{pre}final_layer_norm"),
    }
    for i in range(layers):
        b = f"{pre}encoder.layers.{i}"
        p[f"block_{i}"] = {
            "ln1": _norm(sd, f"{b}.layer_norm1"),
            "ln2": _norm(sd, f"{b}.layer_norm2"),
            "q": _dense(sd, f"{b}.self_attn.q_proj"),
            "k": _dense(sd, f"{b}.self_attn.k_proj"),
            "v": _dense(sd, f"{b}.self_attn.v_proj"),
            "proj": _dense(sd, f"{b}.self_attn.out_proj"),
            "fc1": _dense(sd, f"{b}.mlp.fc1"),
            "fc2": _dense(sd, f"{b}.mlp.fc2"),
        }
    return {"params": p}


# -- the diffusion policy ----------------------------------------------------
#
# Trainer checkpoints hold the policy twice: `gcp_model` (the online weights)
# and `ema.ema_model.*` (the EMA used for rollouts and eval). Both are
# `DiffusionUnetImagePolicy` state dicts with the submodules `obs_encoder`
# (MultiImageObsEncoder) and `model` (ConditionalUnet1D).


def _conv1d(sd, p) -> Dict[str, np.ndarray]:
    return {"kernel": conv1d_w(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}


def _unet1d_resblock(sd, p) -> Dict[str, Any]:
    """`ConditionalResidualBlock1D` (`conditional_unet1d.py:14-66`)."""
    out = {
        "block0": {"conv": _conv1d(sd, f"{p}.blocks.0.block.0"),
                   "norm": _norm(sd, f"{p}.blocks.0.block.1")},
        "block1": {"conv": _conv1d(sd, f"{p}.blocks.1.block.0"),
                   "norm": _norm(sd, f"{p}.blocks.1.block.1")},
        "cond_encoder": _dense(sd, f"{p}.cond_encoder.1"),
    }
    if f"{p}.residual_conv.weight" in sd:
        out["residual_conv"] = _conv1d(sd, f"{p}.residual_conv")
    return out


def convert_unet1d(sd: Dict[str, Any],
                   down_dims: Sequence[int] = (256, 512, 1024)) -> Dict[str, Any]:
    """A torch `ConditionalUnet1D` state dict (keys relative to the net) ->
    the `ConditionalUnet1D` tree."""
    p: Dict[str, Any] = {
        "time_dense0": _dense(sd, "diffusion_step_encoder.1"),
        "time_dense1": _dense(sd, "diffusion_step_encoder.3"),
        "mid_res0": _unet1d_resblock(sd, "mid_modules.0"),
        "mid_res1": _unet1d_resblock(sd, "mid_modules.1"),
        "final_block": {"conv": _conv1d(sd, "final_conv.0.block.0"),
                        "norm": _norm(sd, "final_conv.0.block.1")},
        "final_conv": _conv1d(sd, "final_conv.1"),
    }
    n_levels = len(down_dims)
    for lv in range(n_levels):
        p[f"down_{lv}_res0"] = _unet1d_resblock(sd, f"down_modules.{lv}.0")
        p[f"down_{lv}_res1"] = _unet1d_resblock(sd, f"down_modules.{lv}.1")
        if f"down_modules.{lv}.2.conv.weight" in sd:
            p[f"down_{lv}_downsample"] = {"conv": _conv1d(sd, f"down_modules.{lv}.2.conv")}
    for lv in range(n_levels - 1):
        p[f"up_{lv}_res0"] = _unet1d_resblock(sd, f"up_modules.{lv}.0")
        p[f"up_{lv}_res1"] = _unet1d_resblock(sd, f"up_modules.{lv}.1")
        p[f"up_{lv}_upsample"] = {
            "conv": {"kernel": convtranspose1d_w(sd[f"up_modules.{lv}.2.conv.weight"]),
                     "bias": _np(sd[f"up_modules.{lv}.2.conv.bias"])}
        }
    return p


_RESNET_STAGE = {4: "layer1", 5: "layer2", 6: "layer3", 7: "layer4"}


def _resnet_basic_block(sd, p) -> Dict[str, Any]:
    out = {
        "conv1": {"kernel": conv2d_w(sd[f"{p}.conv1.weight"])},
        "norm1": _norm(sd, f"{p}.bn1"),
        "conv2": {"kernel": conv2d_w(sd[f"{p}.conv2.weight"])},
        "norm2": _norm(sd, f"{p}.bn2"),
    }
    if f"{p}.downsample.0.weight" in sd:
        out["downsample_conv"] = {"kernel": conv2d_w(sd[f"{p}.downsample.0.weight"])}
        out["downsample_norm"] = _norm(sd, f"{p}.downsample.1")
    return out


def convert_visual_core(sd: Dict[str, Any], p: str) -> Dict[str, Any]:
    """One robomimic `VisualCore` = ResNet18Conv -> SpatialSoftmax -> flatten
    -> Linear (`vision_nets.py:65-177`). Keys relative to the VisualCore
    root: `nets.0.nets.{i}` the trunk, `nets.1.nets` the keypoint conv,
    `nets.3` the linear. The reference replaced its BatchNorms by GroupNorms
    (`multi_image_obs_encoder.py:66-77`), so the bn* keys hold GroupNorm
    scales and biases."""
    backbone: Dict[str, Any] = {
        "conv1": {"kernel": conv2d_w(sd[f"{p}.nets.0.nets.0.weight"])},
        "norm1": _norm(sd, f"{p}.nets.0.nets.1"),
    }
    for idx, stage in _RESNET_STAGE.items():
        for blk in (0, 1):
            backbone[f"{stage}_{blk}"] = _resnet_basic_block(sd, f"{p}.nets.0.nets.{idx}.{blk}")
    return {
        "backbone": backbone,
        "pool": {"kp_conv": {"kernel": conv2d_w(sd[f"{p}.nets.1.nets.weight"]),
                             "bias": _np(sd[f"{p}.nets.1.nets.bias"])}},
        "proj": _dense(sd, f"{p}.nets.3"),
    }


def convert_policy(sd: Dict[str, Any],
                   obs_keys: Sequence[str] = ("img_obs_1", "img_goal_1"),
                   down_dims: Sequence[int] = (256, 512, 1024)) -> Dict[str, Any]:
    """A torch `DiffusionUnetImagePolicy` state dict -> the `PolicyNets`
    tree."""
    unet_sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    p: Dict[str, Any] = {"unet": convert_unet1d(unet_sd, down_dims)}
    p["obs_encoder"] = {f"enc_{key}": convert_visual_core(sd, f"obs_encoder.key_model_map.{key}")
                        for key in obs_keys}
    return {"params": p}


def extract_policy_state(ckpt: Dict[str, Any], use_ema: bool = True) -> Dict[str, Any]:
    """The policy's weights out of a trainer `model-{milestone}.pt`
    (`lb_online_trainer_v7.py:364-383`)."""
    if use_ema and "ema" in ckpt:
        prefix = "ema_model."
        out = {k[len(prefix):]: v for k, v in ckpt["ema"].items() if k.startswith(prefix)}
        if out:
            return out
    if "gcp_model" in ckpt:
        return dict(ckpt["gcp_model"])
    return dict(ckpt)


# -- files -----------------------------------------------------------------


def read_checkpoint(path: str) -> Dict[str, Any]:
    """`torch.load` of a reference checkpoint on the host: tensors and plain
    containers only (`weights_only`), memory-mapped where the file is in
    `torch.save`'s zip format. A file that cannot be read raises."""
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=zipfile.is_zipfile(path))


def save_video_params(params: Dict[str, Dict[str, torch.Tensor]], path: str):
    """The port's converted video file: {"unet": state dict, "text": state
    dict}, `text` optional."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(params, path)


def load_video_params(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    params = read_checkpoint(path)
    if not isinstance(params, dict) or "unet" not in params or set(params) - {"unet", "text"}:
        raise ValueError(f"{path} is not a converted video file ({{'unet', 'text'}} state dicts)")
    return params


def convert_video_checkpoint(pt_path: str, out_path: str,
                             config: Optional[VideoModelConfig] = None,
                             clip_path: Optional[str] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The whole conversion: a reference `.pt` (and local HF CLIP weights)
    -> one `torch-model-*.pt` with {'unet': ..., 'text': ...}, the state
    dicts of the port's `VideoNets.unet` / `.text`."""
    cfg = config or VideoModelConfig()
    unet = convert_video_unet(
        extract_unet_state(read_checkpoint(pt_path)),
        channel_mult=tuple(cfg.channel_mult), num_res_blocks=cfg.num_res_blocks,
        attention_resolutions=tuple(cfg.attention_resolutions))
    params = {"unet": video_tree(unet)}
    if clip_path:
        clip_sd = read_checkpoint(os.path.join(clip_path, "pytorch_model.bin"))
        params["text"] = video_tree(convert_clip_text(clip_sd))
        # the tokenizer assets go beside the converted weights: real CLIP
        # weights with the hash tokenizer would give garbage conditioning
        # (`VideoPredModel.load_converted` refuses that combination)
        tok_dir = os.path.join(os.path.dirname(out_path) or ".", "tokenizer")
        os.makedirs(tok_dir, exist_ok=True)
        copied = 0
        for name in TOKENIZER_ASSETS:
            src = os.path.join(clip_path, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(tok_dir, name))
                copied += 1
        if copied == 0:
            raise FileNotFoundError(
                f"no tokenizer assets (vocab.json/merges.txt) in {clip_path}"
                " — converted CLIP weights require the real tokenizer")
    save_video_params(params, out_path)
    return params


def convert_policy_checkpoint(pt_path: str, out_path: str,
                              config: Optional[PolicyConfig] = None,
                              use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference trainer `.pt` -> the `PolicyNets` state dict, saved to
    `out_path` (`DiffusionPolicy.load_state_dict` takes it)."""
    cfg = config or PolicyConfig()
    sd = extract_policy_state(read_checkpoint(pt_path), use_ema=use_ema)
    state = policy_from_jax(convert_policy(sd, tuple(cfg.obs_keys), tuple(cfg.down_dims)))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.save(state, out_path)
    return state


# -- synthetic reference checkpoints ---------------------------------------
#
# Each key maps to (shape, kind); the kind says how `fill_reference` draws
# it: "w" a weight (normal / sqrt(fan-in)), "b" a bias, "g" a norm gain or
# scale (near 1), "t" a temporal conv (near the identity, the reference's
# dirac init), "e" an embedding or latent table (unit normal).

Keys = Dict[str, Tuple[Tuple[int, ...], str]]

# imagen's PerceiverResampler at the Libero settings (`imagen.py:321-372`)
_PERCEIVER = dict(depth=2, dim_head=64, heads=8, num_latents=64, mean_pooled=4,
                  max_seq_len=512, ff_mult=4)


def _linear_keys(out: Keys, p: str, cin: int, cout: int, bias: bool = True):
    out[f"{p}.weight"] = ((cout, cin), "w")
    if bias:
        out[f"{p}.bias"] = ((cout,), "b")


def _norm_keys(out: Keys, p: str, c: int):
    out[f"{p}.weight"] = ((c,), "g")
    out[f"{p}.bias"] = ((c,), "b")


def _conv3d_keys(out: Keys, p: str, cin: int, cout: int, k: int = 3):
    out[f"{p}.spatial_conv.weight"] = ((cout, cin, k, k), "w")
    out[f"{p}.spatial_conv.bias"] = ((cout,), "b")
    if k > 1:
        out[f"{p}.temporal_conv.weight"] = ((cout, cout, k), "t")
        out[f"{p}.temporal_conv.bias"] = ((cout,), "b")


def _resblock_keys(out: Keys, p: str, cin: int, cout: int, emb: int):
    _norm_keys(out, f"{p}.in_layers.0", cin)
    _conv3d_keys(out, f"{p}.in_layers.2", cin, cout)
    _linear_keys(out, f"{p}.emb_layers.1", emb, cout)
    _norm_keys(out, f"{p}.out_layers.0", cout)
    _conv3d_keys(out, f"{p}.out_layers.3", cout, cout)
    if cin != cout:
        _conv3d_keys(out, f"{p}.skip_connection", cin, cout, k=1)


def _attention_keys(out: Keys, p: str, c: int):
    _norm_keys(out, f"{p}.norm", c)
    out[f"{p}.qkv.weight"] = ((3 * c, c, 1), "w")
    out[f"{p}.qkv.bias"] = ((3 * c,), "b")
    out[f"{p}.proj_out.weight"] = ((c, c, 1), "w")
    out[f"{p}.proj_out.bias"] = ((c,), "b")


def _perceiver_keys(out: Keys, p: str, dim: int):
    s = _PERCEIVER
    inner, hidden = s["dim_head"] * s["heads"], dim * s["ff_mult"]
    out[f"{p}.latents"] = ((s["num_latents"], dim), "e")
    out[f"{p}.pos_emb.weight"] = ((s["max_seq_len"], dim), "e")
    out[f"{p}.to_latents_from_mean_pooled_seq.0.g"] = ((dim,), "g")
    _linear_keys(out, f"{p}.to_latents_from_mean_pooled_seq.1", dim, dim * s["mean_pooled"])
    for i in range(s["depth"]):
        a = f"{p}.layers.{i}.0"
        _norm_keys(out, f"{a}.norm", dim)
        _norm_keys(out, f"{a}.norm_latents", dim)
        _linear_keys(out, f"{a}.to_q", dim, inner, bias=False)
        _linear_keys(out, f"{a}.to_kv", dim, 2 * inner, bias=False)
        out[f"{a}.q_scale"] = ((s["dim_head"],), "g")
        out[f"{a}.k_scale"] = ((s["dim_head"],), "g")
        _linear_keys(out, f"{a}.to_out.0", inner, dim, bias=False)
        _norm_keys(out, f"{a}.to_out.1", dim)
        f = f"{p}.layers.{i}.1"
        out[f"{f}.0.g"] = ((dim,), "g")
        _linear_keys(out, f"{f}.1", dim, hidden, bias=False)
        out[f"{f}.3.g"] = ((hidden,), "g")
        _linear_keys(out, f"{f}.4", hidden, dim, bias=False)


def reference_video_keys(cfg: VideoModelConfig) -> Keys:
    """The reference `UNetModel`'s state dict keys (relative to the U-Net)
    and torch shapes for `cfg` (`unet.py:404-684` with dims=3 and task
    tokens, the release's `lb_video_model_utils.py:33-39`): the constructor
    loops replayed over the channels."""
    mc, ted = cfg.model_channels, cfg.model_channels * 4
    out: Keys = {}
    _linear_keys(out, "time_embed.0", mc, ted)
    _linear_keys(out, "time_embed.2", ted, ted)
    _perceiver_keys(out, "task_attnpool.0", cfg.text_dim)
    _linear_keys(out, "task_attnpool.1", cfg.text_dim, ted)
    _conv3d_keys(out, "input_blocks.0.0", cfg.channels + cfg.cond_ch, mc)
    skips, cur, ds, tidx = [mc], mc, 1, 1
    for level, mult in enumerate(cfg.channel_mult):
        ch = mult * mc
        for _ in range(cfg.num_res_blocks):
            _resblock_keys(out, f"input_blocks.{tidx}.0", cur, ch, ted)
            cur = ch
            if ds in cfg.attention_resolutions:
                _attention_keys(out, f"input_blocks.{tidx}.1", ch)
            skips.append(ch)
            tidx += 1
        if level != len(cfg.channel_mult) - 1:
            _conv3d_keys(out, f"input_blocks.{tidx}.0.op", ch, ch)
            skips.append(ch)
            tidx += 1
            ds *= 2
    _resblock_keys(out, "middle_block.0", cur, cur, ted)
    _attention_keys(out, "middle_block.1", cur)
    _resblock_keys(out, "middle_block.2", cur, cur, ted)
    tidx = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        ch = mult * mc
        for i in range(cfg.num_res_blocks + 1):
            _resblock_keys(out, f"output_blocks.{tidx}.0", cur + skips.pop(), ch, ted)
            cur, sub = ch, 1
            if ds in cfg.attention_resolutions:
                _attention_keys(out, f"output_blocks.{tidx}.{sub}", ch)
                sub += 1
            if level and i == cfg.num_res_blocks:
                _conv3d_keys(out, f"output_blocks.{tidx}.{sub}.conv", ch, ch)
                ds //= 2
            tidx += 1
    _norm_keys(out, "out.0", cur)
    _conv3d_keys(out, "out.2", cur, cfg.channels)
    return out


def _conv1d_keys(out: Keys, p: str, cin: int, cout: int, k: int):
    out[f"{p}.weight"] = ((cout, cin, k), "w")
    out[f"{p}.bias"] = ((cout,), "b")


def _unet1d_resblock_keys(out: Keys, p: str, cin: int, cout: int, cond: int,
                          cfg: PolicyConfig):
    for i, c in enumerate((cin, cout)):
        _conv1d_keys(out, f"{p}.blocks.{i}.block.0", c, cout, cfg.kernel_size)
        _norm_keys(out, f"{p}.blocks.{i}.block.1", cout)
    _linear_keys(out, f"{p}.cond_encoder.1", cond, 2 * cout if cfg.cond_predict_scale else cout)
    if cin != cout:
        _conv1d_keys(out, f"{p}.residual_conv", cin, cout, 1)


def _visual_core_keys(out: Keys, p: str, cfg: PolicyConfig):
    out[f"{p}.nets.0.nets.0.weight"] = ((64, 3, 7, 7), "w")
    _norm_keys(out, f"{p}.nets.0.nets.1", 64)
    cur = 64
    for stage, (n, feats) in enumerate(zip(cfg.vision_stage_sizes, cfg.vision_stage_features)):
        for blk in range(n):
            b = f"{p}.nets.0.nets.{4 + stage}.{blk}"
            strides = 2 if stage > 0 and blk == 0 else 1
            out[f"{b}.conv1.weight"] = ((feats, cur, 3, 3), "w")
            _norm_keys(out, f"{b}.bn1", feats)
            out[f"{b}.conv2.weight"] = ((feats, feats, 3, 3), "w")
            _norm_keys(out, f"{b}.bn2", feats)
            if cur != feats or strides != 1:
                out[f"{b}.downsample.0.weight"] = ((feats, cur, 1, 1), "w")
                _norm_keys(out, f"{b}.downsample.1", feats)
            cur = feats
    out[f"{p}.nets.1.nets.weight"] = ((cfg.num_kp, cur, 1, 1), "w")
    out[f"{p}.nets.1.nets.bias"] = ((cfg.num_kp,), "b")
    _linear_keys(out, f"{p}.nets.3", 2 * cfg.num_kp, cfg.obs_feature_dim)


def reference_policy_keys(cfg: PolicyConfig) -> Keys:
    """The reference `DiffusionUnetImagePolicy`'s state dict keys and torch
    shapes for `cfg`: `model.*` the `ConditionalUnet1D`
    (`conditional_unet1d.py:69-190`), `obs_encoder.key_model_map.<key>.*`
    one robomimic `VisualCore` per image key."""
    dsed = cfg.diffusion_step_embed_dim
    cond = dsed + cfg.global_cond_dim
    out: Keys = {}
    _linear_keys(out, "model.diffusion_step_encoder.1", dsed, dsed * 4)
    _linear_keys(out, "model.diffusion_step_encoder.3", dsed * 4, dsed)
    dims = [cfg.action_dim] + list(cfg.down_dims)
    in_out = list(zip(dims[:-1], dims[1:]))
    for lv, (din, dout) in enumerate(in_out):
        _unet1d_resblock_keys(out, f"model.down_modules.{lv}.0", din, dout, cond, cfg)
        _unet1d_resblock_keys(out, f"model.down_modules.{lv}.1", dout, dout, cond, cfg)
        if lv < len(in_out) - 1:
            _conv1d_keys(out, f"model.down_modules.{lv}.2.conv", dout, dout, 3)
    for i in range(2):
        _unet1d_resblock_keys(out, f"model.mid_modules.{i}", dims[-1], dims[-1], cond, cfg)
    for lv, (din, dout) in enumerate(reversed(in_out[1:])):
        _unet1d_resblock_keys(out, f"model.up_modules.{lv}.0", 2 * dout, din, cond, cfg)
        _unet1d_resblock_keys(out, f"model.up_modules.{lv}.1", din, din, cond, cfg)
        out[f"model.up_modules.{lv}.2.conv.weight"] = ((din, din, 4), "w")  # (in, out, k)
        out[f"model.up_modules.{lv}.2.conv.bias"] = ((din,), "b")
    d0 = cfg.down_dims[0]
    _conv1d_keys(out, "model.final_conv.0.block.0", d0, d0, cfg.kernel_size)
    _norm_keys(out, "model.final_conv.0.block.1", d0)
    _conv1d_keys(out, "model.final_conv.1", d0, cfg.action_dim, 1)
    for key in cfg.obs_keys:
        _visual_core_keys(out, f"obs_encoder.key_model_map.{key}", cfg)
    return out


def fill_reference(keys: Keys, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
    """Float32 tensors for `keys`, drawn from `rng` in key order."""
    out = {}
    for name, (shape, kind) in keys.items():
        a = rng.standard_normal(shape, dtype=np.float32)
        if kind == "w":
            a *= np.float32(1.0 / math.sqrt(max(1, int(np.prod(shape[1:])))))
        elif kind == "b":
            a *= np.float32(0.1)
        elif kind == "g":
            a = np.float32(1.0) + np.float32(0.1) * a
        elif kind == "t":  # (O, O, k): the centre tap near the identity
            a *= np.float32(0.05 / math.sqrt(shape[1]))
            a[:, :, shape[2] // 2] += np.eye(shape[0], dtype=np.float32)
        out[name] = torch.from_numpy(a)
    return out


def synthetic_video_checkpoint(cfg: VideoModelConfig, seed: int = 0) -> Dict[str, Any]:
    """A reference-format video checkpoint for `cfg` from `Generator(seed)`,
    in the trainer layout: {"ema": {"ema_model.model.unet.<key>": tensor}}."""
    sd = fill_reference(reference_video_keys(cfg), np.random.default_rng(seed))
    return {"ema": {VIDEO_PREFIX + k: v for k, v in sd.items()}}


def synthetic_policy_checkpoint(cfg: PolicyConfig, seed: int = 0) -> Dict[str, Any]:
    """A reference trainer checkpoint of the policy for `cfg` from
    `Generator(seed)`: {"ema": {"ema_model.<key>": ...}, "gcp_model":
    {<key>: ...}}, the EMA and the online weights drawn apart."""
    rng = np.random.default_rng(seed)
    keys = reference_policy_keys(cfg)
    ema = fill_reference(keys, rng)
    return {"ema": {"ema_model." + k: v for k, v in ema.items()},
            "gcp_model": fill_reference(keys, rng)}


def _bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 / CLIP byte-level BPE base alphabet (a public algorithm)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def write_synthetic_tokenizer(out_dir: str) -> str:
    """Valid `CLIPTokenizer` assets in `out_dir`, as
    `scripts/bringup.py::make_synthetic_assets` writes them: the byte
    alphabet, its word-final variants and the two specials, and no merges,
    so that every word tokenizes to its characters (ids far below 49408)."""
    os.makedirs(out_dir, exist_ok=True)
    alpha = list(_bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for tok in alpha + [a + "</w>" for a in alpha] + ["<|startoftext|>", "<|endoftext|>"]:
        vocab[tok] = len(vocab)
    with open(os.path.join(out_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(out_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return out_dir
