"""Train an image diffusion model: the guided-diffusion CLI.

    python -m v2a_tpu_torch.scripts.guided.image_train --data_dir DIR \\
        [model and diffusion flags] [--device cpu]

Counterpart of `scripts/guided/image_train.py` (the reference's
`guided_diffusion/scripts/image_train.py:1-83`), with its flags; runs the
port's `GuidedTrainLoop`. Writes `model{step:06d}.pt` and one
`ema_{rate}_{step:06d}.pt` per EMA rate under `--out_dir`.
"""

from __future__ import annotations

from v2a_tpu_torch.guided import create_model_and_diffusion, model_and_diffusion_defaults
from v2a_tpu_torch.guided.image_data import load_data
from v2a_tpu_torch.guided.script_util import args_subset
from v2a_tpu_torch.guided.train_loop import GuidedTrainLoop
from v2a_tpu_torch.ops.resample import create_named_schedule_sampler
from v2a_tpu_torch.scripts.guided._common import (
    TRAIN_DEFAULTS,
    init_or_restore,
    parse,
    run_train_loop,
)


def main(argv=None) -> GuidedTrainLoop:
    args = parse(argv, TRAIN_DEFAULTS, model_and_diffusion_defaults())

    model, diffusion = create_model_and_diffusion(
        **args_subset(args, model_and_diffusion_defaults().keys()), device=args.device
    )
    init_or_restore(model, args.resume_checkpoint)

    data = load_data(
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        image_size=args.image_size,
        class_cond=args.class_cond,
        seed=args.seed,
    )

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
    )
    return run_train_loop(loop, args.max_steps)


if __name__ == "__main__":
    main()
