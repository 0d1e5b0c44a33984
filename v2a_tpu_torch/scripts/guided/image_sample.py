"""Sample from a trained image diffusion model: the guided-diffusion CLI.

    python -m v2a_tpu_torch.scripts.guided.image_sample --model_path PT \\
        [model and diffusion flags] [--use_ddim True] [--device cpu]

Counterpart of `scripts/guided/image_sample.py` (the reference's
`guided_diffusion/scripts/image_sample.py:1-108`): batched ancestral or
DDIM (`--use_ddim` / `timestep_respacing=ddimN`) sampling to the uint8
npz the evaluator reads. Labels and noise come from a `torch.Generator`
seeded by `--seed`: the port's samples are its own.
"""

from __future__ import annotations

import numpy as np
import torch

from v2a_tpu_torch.guided import (
    NUM_CLASSES,
    create_model_and_diffusion,
    model_and_diffusion_defaults,
)
from v2a_tpu_torch.guided.script_util import args_subset
from v2a_tpu_torch.scripts.guided._common import (
    frozen,
    init_or_restore,
    parse,
    save_samples_npz,
)

SAMPLE_DEFAULTS = dict(
    clip_denoised=True,
    num_samples=16,
    batch_size=16,
    use_ddim=False,
    model_path="",
    out_dir="guided_out",
    seed=0,
)


def main(argv=None) -> str:
    args = parse(argv, SAMPLE_DEFAULTS, model_and_diffusion_defaults())

    model, diffusion = create_model_and_diffusion(
        **args_subset(args, model_and_diffusion_defaults().keys()), device=args.device
    )
    model = frozen(init_or_restore(model, args.model_path))

    shape = (args.batch_size, args.image_size, args.image_size, 3)
    loop = diffusion.ddim_sample_loop if args.use_ddim else diffusion.p_sample_loop
    gen = torch.Generator(device=args.device).manual_seed(args.seed)

    images, labels = [], []
    with torch.no_grad():
        while sum(x.shape[0] for x in images) < args.num_samples:
            y = torch.randint(0, NUM_CLASSES, (args.batch_size,), generator=gen,
                              device=args.device)
            kwargs = {"y": y} if args.class_cond else None
            images.append(loop(model, gen, shape, clip_denoised=args.clip_denoised,
                               model_kwargs=kwargs).cpu().numpy())
            labels.append(y.cpu().numpy())
            print(f"sampled {sum(x.shape[0] for x in images)}", flush=True)

    images = np.concatenate(images)[: args.num_samples]
    labels = np.concatenate(labels)[: args.num_samples]
    return save_samples_npz(
        args.out_dir, images, labels if args.class_cond else None)


if __name__ == "__main__":
    main()
