"""Builders and CLI plumbing for the guided-diffusion CLIs.

Counterpart of `v2a_tpu/guided/script_util.py` (the reference's
`guided_diffusion/script_util.py:1-453`): the same defaults dicts and flag
names, `_default_channel_mult` and `_attention_ds` copied, and builders
that return the port's nets (`models/image_unet.py`) and a
`GuidedDiffusion` (`ops/guided_diffusion_core.py`) on a device: `cuda`
unless the caller passes `cpu`. The nets come uninitialized: the CLIs draw
them from a seed or load a snapshot (`scripts/guided/_common.py`).

`use_fp16` maps to bfloat16 compute, as in the JAX package (no loss
scaling). `use_checkpoint` is block-level recomputation in the backward
pass. `dropout`, `num_heads`, `num_heads_upsample` and
`use_new_attention_order` are not flags of either package.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

from v2a_tpu_torch.device import DeviceLike, resolve_device
from v2a_tpu_torch.models.image_unet import EncoderUNet, ImageUNet
from v2a_tpu_torch.ops.guided_diffusion_core import (
    GuidedDiffusion,
    named_beta_schedule,
    space_timesteps,
    spaced_diffusion,
)

NUM_CLASSES = 1000


def diffusion_defaults() -> dict:
    """`script_util.py:11-26`."""
    return dict(
        learn_sigma=False,
        diffusion_steps=1000,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
    )


def model_defaults() -> dict:
    return dict(
        image_size=64,
        num_channels=128,
        num_res_blocks=2,
        num_head_channels=64,
        attention_resolutions="16,8",
        channel_mult="",
        class_cond=False,
        use_checkpoint=False,
        use_scale_shift_norm=True,
        resblock_updown=False,
        use_fp16=False,
    )


def model_and_diffusion_defaults() -> dict:
    """`script_util.py:43-66`."""
    res = model_defaults()
    res.update(diffusion_defaults())
    return res


def classifier_defaults() -> dict:
    """`script_util.py:27-41`."""
    return dict(
        image_size=64,
        classifier_use_fp16=False,
        classifier_width=128,
        classifier_depth=2,
        classifier_attention_resolutions="32,16,8",
        classifier_use_scale_shift_norm=True,
        classifier_resblock_updown=True,
        classifier_pool="attention",
    )


def classifier_and_diffusion_defaults() -> dict:
    res = classifier_defaults()
    res.update(diffusion_defaults())
    return res


def sr_model_and_diffusion_defaults() -> dict:
    """`script_util.py:269-278`: image_size becomes large_size/small_size."""
    res = model_and_diffusion_defaults()
    res.pop("image_size")
    res.update(large_size=256, small_size=64)
    return res


def _default_channel_mult(image_size: int) -> Tuple[float, ...]:
    """`script_util.py:150-161` (plus small sizes for hermetic tests)."""
    table = {
        512: (0.5, 1, 1, 2, 2, 4, 4),
        256: (1, 1, 2, 2, 4, 4),
        128: (1, 1, 2, 3, 4),
        64: (1, 2, 3, 4),
        32: (1, 2, 2),
        16: (1, 2),
    }
    if image_size not in table:
        raise ValueError(f"unsupported image size: {image_size}")
    return table[image_size]


def _attention_ds(image_size: int, attention_resolutions: str) -> Tuple[int, ...]:
    if not attention_resolutions:
        return ()
    return tuple(
        image_size // int(r) for r in str(attention_resolutions).split(",")
    )


def _dtype(use_fp16: bool) -> torch.dtype:
    return torch.bfloat16 if use_fp16 else torch.float32


def create_model(
    image_size: int,
    num_channels: int,
    num_res_blocks: int,
    channel_mult: str = "",
    learn_sigma: bool = False,
    class_cond: bool = False,
    attention_resolutions: str = "16",
    num_head_channels: int = 64,
    use_scale_shift_norm: bool = False,
    resblock_updown: bool = False,
    use_fp16: bool = False,
    use_checkpoint: bool = False,
    in_channels: int = 3,
    device: DeviceLike = None,
) -> ImageUNet:
    """`script_util.py:130-185`."""
    if channel_mult:
        mult = tuple(float(m) for m in str(channel_mult).split(","))
    else:
        mult = _default_channel_mult(image_size)
    with torch.device(resolve_device(device)):
        return ImageUNet(
            in_channels=in_channels,
            model_channels=num_channels,
            out_channels=(6 if learn_sigma else 3),
            num_res_blocks=num_res_blocks,
            attention_resolutions=_attention_ds(image_size, attention_resolutions),
            channel_mult=mult,
            num_classes=(NUM_CLASSES if class_cond else None),
            num_head_channels=num_head_channels,
            use_scale_shift_norm=use_scale_shift_norm,
            resblock_updown=resblock_updown,
            use_checkpoint=use_checkpoint,
            dtype=_dtype(use_fp16),
        )


def create_gaussian_diffusion(
    *,
    steps: int = 1000,
    learn_sigma: bool = False,
    sigma_small: bool = False,
    noise_schedule: str = "linear",
    use_kl: bool = False,
    predict_xstart: bool = False,
    rescale_timesteps: bool = False,
    rescale_learned_sigmas: bool = False,
    timestep_respacing: str = "",
    device: DeviceLike = None,
) -> GuidedDiffusion:
    """`script_util.py:386-424`."""
    betas = named_beta_schedule(noise_schedule, steps)
    if use_kl:
        loss_type = "rescaled_kl"
    elif rescale_learned_sigmas:
        loss_type = "rescaled_mse"
    else:
        loss_type = "mse"
    if learn_sigma:
        var_type = "learned_range"
    else:
        var_type = "fixed_small" if sigma_small else "fixed_large"
    mean_type = "xstart" if predict_xstart else "eps"
    if not timestep_respacing:
        timestep_respacing = str(steps)
    return spaced_diffusion(
        space_timesteps(steps, timestep_respacing),
        betas,
        mean_type=mean_type,
        var_type=var_type,
        loss_type=loss_type,
        rescale_timesteps=rescale_timesteps,
        device=device,
    )


def _diffusion(steps, learn_sigma, noise_schedule, use_kl, predict_xstart, rescale_timesteps,
               rescale_learned_sigmas, timestep_respacing, device) -> GuidedDiffusion:
    return create_gaussian_diffusion(
        steps=steps, learn_sigma=learn_sigma,
        noise_schedule=noise_schedule, use_kl=use_kl,
        predict_xstart=predict_xstart, rescale_timesteps=rescale_timesteps,
        rescale_learned_sigmas=rescale_learned_sigmas,
        timestep_respacing=timestep_respacing, device=device,
    )


def create_model_and_diffusion(
    image_size: int,
    class_cond: bool,
    learn_sigma: bool,
    num_channels: int,
    num_res_blocks: int,
    channel_mult: str,
    num_head_channels: int,
    attention_resolutions: str,
    use_scale_shift_norm: bool,
    resblock_updown: bool,
    use_fp16: bool,
    diffusion_steps: int,
    noise_schedule: str,
    timestep_respacing: str,
    use_kl: bool,
    predict_xstart: bool,
    rescale_timesteps: bool,
    rescale_learned_sigmas: bool,
    use_checkpoint: bool = False,
    device: DeviceLike = None,
) -> Tuple[ImageUNet, GuidedDiffusion]:
    """`script_util.py:74-128`."""
    model = create_model(
        image_size, num_channels, num_res_blocks,
        channel_mult=channel_mult, learn_sigma=learn_sigma,
        class_cond=class_cond, attention_resolutions=attention_resolutions,
        num_head_channels=num_head_channels,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown, use_fp16=use_fp16,
        use_checkpoint=use_checkpoint, device=device,
    )
    diffusion = _diffusion(diffusion_steps, learn_sigma, noise_schedule, use_kl, predict_xstart,
                           rescale_timesteps, rescale_learned_sigmas, timestep_respacing, device)
    return model, diffusion


def sr_create_model_and_diffusion(
    large_size: int,
    small_size: int,
    class_cond: bool,
    learn_sigma: bool,
    num_channels: int,
    num_res_blocks: int,
    channel_mult: str,
    num_head_channels: int,
    attention_resolutions: str,
    use_scale_shift_norm: bool,
    resblock_updown: bool,
    use_fp16: bool,
    diffusion_steps: int,
    noise_schedule: str,
    timestep_respacing: str,
    use_kl: bool,
    predict_xstart: bool,
    rescale_timesteps: bool,
    rescale_learned_sigmas: bool,
    use_checkpoint: bool = False,
    device: DeviceLike = None,
) -> Tuple[ImageUNet, GuidedDiffusion]:
    """`script_util.py:280-383`: the SR model is the image model with
    6 input channels (x_t ++ upsampled low_res, `superres_condition`)."""
    del small_size  # conditioning resolution is data-side (bilinear resize)
    model = create_model(
        large_size, num_channels, num_res_blocks,
        channel_mult=channel_mult, learn_sigma=learn_sigma,
        class_cond=class_cond, attention_resolutions=attention_resolutions,
        num_head_channels=num_head_channels,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown, use_fp16=use_fp16,
        use_checkpoint=use_checkpoint,
        in_channels=6, device=device,
    )
    diffusion = _diffusion(diffusion_steps, learn_sigma, noise_schedule, use_kl, predict_xstart,
                           rescale_timesteps, rescale_learned_sigmas, timestep_respacing, device)
    return model, diffusion


def create_classifier(
    image_size: int,
    classifier_use_fp16: bool,
    classifier_width: int,
    classifier_depth: int,
    classifier_attention_resolutions: str,
    classifier_use_scale_shift_norm: bool,
    classifier_resblock_updown: bool,
    classifier_pool: str,
    device: DeviceLike = None,
) -> EncoderUNet:
    """`script_util.py:228-266`."""
    with torch.device(resolve_device(device)):
        return EncoderUNet(
            in_channels=3,
            model_channels=classifier_width,
            out_channels=NUM_CLASSES,
            num_res_blocks=classifier_depth,
            attention_resolutions=_attention_ds(
                image_size, classifier_attention_resolutions),
            channel_mult=_default_channel_mult(image_size),
            num_head_channels=64,
            use_scale_shift_norm=classifier_use_scale_shift_norm,
            resblock_updown=classifier_resblock_updown,
            pool=classifier_pool,
            dtype=_dtype(classifier_use_fp16),
            image_size=image_size,
        )


def create_classifier_and_diffusion(
    image_size: int,
    classifier_use_fp16: bool,
    classifier_width: int,
    classifier_depth: int,
    classifier_attention_resolutions: str,
    classifier_use_scale_shift_norm: bool,
    classifier_resblock_updown: bool,
    classifier_pool: str,
    learn_sigma: bool,
    diffusion_steps: int,
    noise_schedule: str,
    timestep_respacing: str,
    use_kl: bool,
    predict_xstart: bool,
    rescale_timesteps: bool,
    rescale_learned_sigmas: bool,
    device: DeviceLike = None,
) -> Tuple[EncoderUNet, GuidedDiffusion]:
    """`script_util.py:187-226`."""
    classifier = create_classifier(
        image_size, classifier_use_fp16, classifier_width, classifier_depth,
        classifier_attention_resolutions, classifier_use_scale_shift_norm,
        classifier_resblock_updown, classifier_pool, device=device,
    )
    diffusion = _diffusion(diffusion_steps, learn_sigma, noise_schedule, use_kl, predict_xstart,
                           rescale_timesteps, rescale_learned_sigmas, timestep_respacing, device)
    return classifier, diffusion


def _flag_type(default):
    if isinstance(default, bool):
        return lambda s: str(s).lower() in ("1", "true", "t", "yes", "y")
    if default is None:
        return str
    return type(default)


def parser_from_defaults(*default_dicts: dict) -> argparse.ArgumentParser:
    """An argparser whose flags mirror the reference CLIs
    (`script_util.py:427-452`): one `--key` per defaults entry, bools
    accepting True/False strings."""
    parser = argparse.ArgumentParser()
    seen = set()
    for defaults in default_dicts:
        for key, value in defaults.items():
            if key in seen:
                continue
            seen.add(key)
            parser.add_argument(
                f"--{key}", default=value, type=_flag_type(value))
    return parser


def args_subset(args: argparse.Namespace, keys) -> dict:
    """`script_util.py:437-438`."""
    return {k: getattr(args, k) for k in keys}
