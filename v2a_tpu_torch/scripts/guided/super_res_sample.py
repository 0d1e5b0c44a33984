"""Upsample a batch of low-res images with a super-res diffusion model.

    python -m v2a_tpu_torch.scripts.guided.super_res_sample --model_path PT \\
        --base_samples NPZ --large_size 256 --small_size 64 [flags] [--device cpu]

Counterpart of `scripts/guided/super_res_sample.py` (the reference's
`guided_diffusion/scripts/super_res_sample.py:1-119`): `--base_samples` is
an npz of uint8 NHWC low-res images (with a label array when
`--class_cond`), the output a uint8 npz at `large_size`. The tail batch is
padded with its last image, as the JAX CLI does, and the output cut back to
the number asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from v2a_tpu_torch.guided import sr_create_model_and_diffusion, sr_model_and_diffusion_defaults
from v2a_tpu_torch.guided.script_util import args_subset
from v2a_tpu_torch.models.image_unet import superres_condition
from v2a_tpu_torch.scripts.guided._common import (
    frozen,
    init_or_restore,
    parse,
    save_samples_npz,
)

SR_SAMPLE_DEFAULTS = dict(
    clip_denoised=True,
    num_samples=16,
    batch_size=16,
    use_ddim=False,
    base_samples="",
    model_path="",
    out_dir="guided_out",
    seed=0,
)


def main(argv=None) -> str:
    args = parse(argv, SR_SAMPLE_DEFAULTS, sr_model_and_diffusion_defaults())

    model, diffusion = sr_create_model_and_diffusion(
        **args_subset(args, sr_model_and_diffusion_defaults().keys()), device=args.device
    )
    model = frozen(init_or_restore(model, args.model_path))

    with np.load(args.base_samples) as obj:
        base = obj["arr_0"].astype(np.float32) / 127.5 - 1.0
        labels = obj["arr_1"] if args.class_cond else None

    def model_fn(x_t, tt, low_res=None, y=None):
        return model(superres_condition(x_t, low_res), tt, y)

    shape = (args.batch_size, args.large_size, args.large_size, 3)
    loop = diffusion.ddim_sample_loop if args.use_ddim else diffusion.p_sample_loop
    gen = torch.Generator(device=args.device).manual_seed(args.seed)

    out, done = [], 0
    n = min(args.num_samples, len(base))
    with torch.no_grad():
        while done < n:
            lo = base[done:done + args.batch_size]
            y = labels[done:done + args.batch_size] if labels is not None else None
            if len(lo) < args.batch_size:  # pad the tail batch, as the JAX CLI
                pad = args.batch_size - len(lo)
                lo = np.concatenate([lo, lo[-1:].repeat(pad, 0)])
                if y is not None:
                    y = np.concatenate([y, y[-1:].repeat(pad, 0)])
            kwargs = {"low_res": torch.as_tensor(lo, device=args.device)}
            if args.class_cond:
                kwargs["y"] = torch.as_tensor(y, device=args.device).long()
            img = loop(model_fn, gen, shape, clip_denoised=args.clip_denoised,
                       model_kwargs=kwargs).cpu().numpy()
            out.append(img[: n - done])
            done += len(out[-1])
            print(f"upsampled {done}", flush=True)

    return save_samples_npz(args.out_dir, np.concatenate(out),
                            labels[:n] if labels is not None else None)


if __name__ == "__main__":
    main()
