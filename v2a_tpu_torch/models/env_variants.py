"""Per-environment video-model variants (MetaWorld / iThor / Bridge).

Counterpart of `v2a_tpu/models/env_variants.py`: the reference's adapter
modules per environment (`flowdiffusion/flowdiffusion/unet.py:7-221`, the
MW / Thor factories `diffuser/models/video_model_utils.py:15-105`) each
collapse to a `VideoModelConfig` preset, since the U-Net takes (B, F, H, W,
C) directly. The flow variants predict 2-channel optical flow conditioned
on a 3-channel rgb frame (`unet.py:69-123`), hence `cond_channels`. The
action ranges of these environments are in `models/normalizer.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from v2a_tpu_torch.device import DeviceLike
from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel

# name -> preset; the hyperparameters cite the reference adapters' constructors
VIDEO_MODEL_VARIANTS: Dict[str, VideoModelConfig] = {
    # `Unet_Libero` (`unet.py:195-221`): the release model
    "libero": VideoModelConfig(),
    # `UnetMW` (`unet.py:39-67`): Libero's trunk at 128x128
    "mw": VideoModelConfig(),
    # `UnetMWFlow` (`unet.py:69-97`): 2-channel flow, rgb condition
    "mw_flow": VideoModelConfig(channels=2, cond_channels=3),
    # `UnetThor` (`unet.py:125-156`): 64x64, mult (1,2,4), 3 res blocks,
    # attention at ds 4/8
    "thor": VideoModelConfig(
        image_size=(64, 64), channel_mult=(1, 2, 4), num_res_blocks=3,
        attention_resolutions=(4, 8),
    ),
    # `UnetThor_Luo` (`unet.py:164-193`): Luo's 128x128 retrain
    "thor_luo": VideoModelConfig(),
    # `UnetBridge` (`unet.py:7-37`): 48x64, 160 base channels, mult (1,2,4)
    "bridge": VideoModelConfig(
        image_size=(48, 64), model_channels=160, channel_mult=(1, 2, 4),
        num_res_blocks=3, attention_resolutions=(4, 8),
    ),
}


def video_model_variant(name: str, device: DeviceLike = None, **overrides) -> VideoPredModel:
    """A `VideoPredModel` of a named environment family (the counterpart of
    `get_video_model_gcp{,_v2}`, `diffuser/models/video_model_utils.py:15-105`),
    with `overrides` replacing preset fields; on the card unless `device`
    says otherwise. Raises `KeyError` on an unknown name."""
    if name not in VIDEO_MODEL_VARIANTS:
        raise KeyError(f"unknown variant {name!r}; have {sorted(VIDEO_MODEL_VARIANTS)}")
    cfg = VIDEO_MODEL_VARIANTS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return VideoPredModel(cfg, device=device)
