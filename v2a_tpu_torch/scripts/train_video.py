"""Standalone video-model training CLI.

Counterpart of `scripts/train_video.py` (the reference trains its video
model in the AVDC codebase: `GoalGaussianDiffusion` + `Trainer`,
`flowdiffusion/flowdiffusion/goal_diffusion.py:762-1055`): a
`VideoClipDataset` over the framework's HDF5 episode files,
`VideoModelTrainer` (EMA, loss-aware timestep resampling, milestone
checkpoints, the `train_fused` routing on the card at B <= 4), resume, and
a validation sample through the padded routing at the end.

Examples:
    python -m v2a_tpu_torch.scripts.train_video --data clips.hdf5 \
        --workdir logs/vid --batch-size 4 --n-steps 200000
    python -m v2a_tpu_torch.scripts.train_video --data clips.hdf5 --device cpu \
        --image-size 16 --model-channels 32 --channel-mult 1,2 --n-steps 2

The models run on the card unless `--device cpu` is given. `main` opens
`--data` (this needs `h5py`); `run` takes the parsed arguments and any
dataset with `sample_batch(batch, rng)` and `__len__`. Not ported (each
raises `NotImplementedError`; ROADMAP.md, Queue 1): `--mesh`,
`--use-checkpoint` and `--backbone xattn`.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

from v2a_tpu_torch.device import resolve_device
from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
from v2a_tpu_torch.train.video_trainer import (
    VideoClipDataset, VideoModelTrainer, VideoTrainerConfig,
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True,
                   help="HDF5 episode file (data/h5_ingest.py layout)")
    p.add_argument("--tasks", default="",
                   help="comma-separated task keys (default: all in file)")
    p.add_argument("--workdir", default="logs/video")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--n-steps", type=int, default=200_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save-freq", type=int, default=5000)
    p.add_argument("--log-freq", type=int, default=100)
    p.add_argument("--stride", type=int, default=4,
                   help="frame subsampling stride within an episode")
    p.add_argument("--schedule-sampler", default="uniform",
                   choices=["uniform", "loss-second-moment"])
    p.add_argument("--use-checkpoint", action="store_true",
                   help="gradient checkpointing (not ported)")
    p.add_argument("--remat-policy", default="blocks",
                   choices=["blocks", "levels"])
    p.add_argument("--mesh", default="",
                   help="e.g. dp=4 or dp=4,tp=2 (not ported: one card)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest milestone from --workdir")
    p.add_argument("--sample-after", action="store_true",
                   help="sample one validation video per task at the end")
    # model surface (reference factory defaults, lb_video_model_utils.py)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--frames", type=int, default=7,
                   help="future frames per clip (sample_per_seq - 1)")
    p.add_argument("--model-channels", type=int, default=128)
    p.add_argument("--channel-mult", default="1,2,3,4,5")
    p.add_argument("--num-res-blocks", type=int, default=2)
    p.add_argument("--attention-resolutions", default="8,16")
    p.add_argument("--timesteps", type=int, default=100)
    p.add_argument("--text-dim", type=int, default=512)
    p.add_argument("--dtype", default="",
                   help="compute dtype (default: bf16 on the card, f32 on CPU)")
    p.add_argument("--backbone", default="unet", choices=["unet", "xattn"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    return p


def parse_args(argv=None):
    """The parsed arguments; raises on the options that are not ported."""
    args = build_parser().parse_args(argv)
    left_out = {"--mesh": bool(args.mesh), "--use-checkpoint": args.use_checkpoint,
                "--backbone xattn": args.backbone == "xattn"}
    for flag, given in left_out.items():
        if given:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md, Queue 1)")
    return args


def run(args, dataset, tasks):
    """Trains on `dataset` from the parsed `args`; prints the JSON header
    line, then saves, and with `--sample-after` writes one validation video
    per task. Returns the trainer."""
    dev = resolve_device(args.device)
    dtype = args.dtype or ("bfloat16" if dev.type == "cuda" else "float32")
    vcfg = VideoModelConfig(
        image_size=(args.image_size, args.image_size),
        sample_per_seq=args.frames + 1,
        timesteps=args.timesteps,
        sampling_timesteps=args.timesteps,
        model_channels=args.model_channels,
        channel_mult=tuple(int(m) for m in args.channel_mult.split(",")),
        num_res_blocks=args.num_res_blocks,
        attention_resolutions=tuple(
            int(r) for r in args.attention_resolutions.split(",") if r
        ),
        text_dim=args.text_dim,
        dtype=dtype,
    )
    model = VideoPredModel(vcfg, device=dev).init(0)
    tcfg = VideoTrainerConfig(
        lr=args.lr, batch_size=args.batch_size, n_train_steps=args.n_steps,
        save_freq=args.save_freq, log_freq=args.log_freq,
        schedule_sampler=args.schedule_sampler,
        use_checkpoint=args.use_checkpoint, remat_policy=args.remat_policy,
    )
    trainer = VideoModelTrainer(model, dataset, tcfg, workdir=args.workdir)
    if args.resume:
        trainer.load()
        print(f"resumed at step {trainer.step}", flush=True)
    print(json.dumps({
        "tasks": tasks, "clips": len(dataset),
        "params": model.param_count(), "dtype": dtype,
        "mesh": args.mesh or None, "workdir": args.workdir,
    }), flush=True)

    trainer.train(args.n_steps)
    trainer.save()

    if args.sample_after:
        frames = torch.zeros(len(tasks), args.image_size, args.image_size, 3, device=dev)
        out = model.sample(frames, tasks, generator=torch.Generator(device=dev).manual_seed(0))
        out = out.cpu().numpy()
        path = os.path.join(args.workdir, "validation_videos.npy")
        np.save(path, out)
        print(f"wrote {path} {tuple(out.shape)}", flush=True)
    return trainer


def main(argv=None):
    args = parse_args(argv)
    if args.tasks:
        tasks = [t.strip() for t in args.tasks.split(",")]
    else:
        import h5py

        with h5py.File(args.data, "r") as f:
            tasks = list(f.keys())
    ds = VideoClipDataset(args.data, tasks, frames=args.frames, stride=args.stride)
    try:
        trainer = run(args, ds, tasks)
    finally:
        ds.close()
    trainer.close()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
