"""Train a super-resolution diffusion model: the guided-diffusion CLI.

    python -m v2a_tpu_torch.scripts.guided.super_res_train --data_dir DIR \\
        --large_size 256 --small_size 64 [flags] [--device cpu]

Counterpart of `scripts/guided/super_res_train.py` (the reference's
`guided_diffusion/scripts/super_res_train.py:1-98`): the large / small
size flags, area-downsampled low-res conditioning concatenated on channels
(`models/image_unet.py::superres_condition`).
"""

from __future__ import annotations

from v2a_tpu_torch.guided import sr_create_model_and_diffusion, sr_model_and_diffusion_defaults
from v2a_tpu_torch.guided.image_data import load_data
from v2a_tpu_torch.guided.script_util import args_subset
from v2a_tpu_torch.guided.train_loop import GuidedTrainLoop
from v2a_tpu_torch.models.image_unet import superres_condition
from v2a_tpu_torch.ops.resample import create_named_schedule_sampler
from v2a_tpu_torch.scripts.guided._common import (
    TRAIN_DEFAULTS,
    init_or_restore,
    parse,
    run_train_loop,
)


def main(argv=None) -> GuidedTrainLoop:
    args = parse(argv, TRAIN_DEFAULTS, sr_model_and_diffusion_defaults())

    model, diffusion = sr_create_model_and_diffusion(
        **args_subset(args, sr_model_and_diffusion_defaults().keys()), device=args.device
    )
    init_or_restore(model, args.resume_checkpoint)

    data = load_data(
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        image_size=args.large_size,
        class_cond=args.class_cond,
        low_res=args.small_size,
        seed=args.seed,
    )

    def model_fn(x_t, tt, low_res=None, y=None):
        return model(superres_condition(x_t, low_res), tt, y)

    loop = GuidedTrainLoop(
        model=model,
        diffusion=diffusion,
        data=data,
        batch_size=args.batch_size,
        microbatch=args.microbatch,
        lr=args.lr,
        ema_rate=args.ema_rate,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps,
        schedule_sampler=create_named_schedule_sampler(
            args.schedule_sampler, diffusion.num_timesteps),
        out_dir=args.out_dir,
        seed=args.seed,
        model_fn=model_fn,
    )
    return run_train_loop(loop, args.max_steps)


if __name__ == "__main__":
    main()
