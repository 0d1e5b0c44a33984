"""Train a noisy classifier for guided sampling.

    python -m v2a_tpu_torch.scripts.guided.classifier_train --data_dir DIR \\
        [classifier and diffusion flags] [--device cpu]

Counterpart of `scripts/guided/classifier_train.py` (the reference's
`guided_diffusion/scripts/classifier_train.py:1-226`): cross-entropy on
q_sample-noised images (`--noised`), AdamW, no EMA (the reference keeps
none either), snapshots `classifier{step:06d}.pt` under `--out_dir`.
`--anneal_lr` is a flag of the JAX CLI that nothing reads; here too.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from v2a_tpu_torch.guided import (
    classifier_and_diffusion_defaults,
    create_classifier_and_diffusion,
)
from v2a_tpu_torch.guided.image_data import load_data
from v2a_tpu_torch.guided.script_util import args_subset
from v2a_tpu_torch.guided.train_loop import classifier_loss_fn
from v2a_tpu_torch.ops.resample import create_named_schedule_sampler
from v2a_tpu_torch.scripts.guided._common import TRAIN_DEFAULTS, init_or_restore, parse

CLS_DEFAULTS = dict(TRAIN_DEFAULTS, noised=True, anneal_lr=False,
                    weight_decay=0.05, lr=3e-4)


def main(argv=None) -> str:
    args = parse(argv, CLS_DEFAULTS, classifier_and_diffusion_defaults())

    classifier, diffusion = create_classifier_and_diffusion(
        **args_subset(args, classifier_and_diffusion_defaults().keys()), device=args.device
    )
    init_or_restore(classifier, args.resume_checkpoint)

    data = load_data(
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        image_size=args.image_size,
        class_cond=True,
        seed=args.seed,
    )

    loss_fn = classifier_loss_fn(classifier, diffusion)
    opt = torch.optim.AdamW(classifier.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=args.weight_decay)
    sampler = create_named_schedule_sampler(
        args.schedule_sampler, diffusion.num_timesteps)

    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    np_rng = np.random.default_rng(args.seed)
    dev = args.device
    i = 0
    while not args.max_steps or i < args.max_steps:
        x, kwargs = next(data)
        if args.noised:
            t, _ = sampler.sample(x.shape[0], np_rng)
        else:
            t = np.zeros(x.shape[0], np.int32)
        opt.zero_grad(set_to_none=True)
        loss, acc = loss_fn(gen, torch.as_tensor(x, device=dev),
                            torch.as_tensor(kwargs["y"], device=dev).long(),
                            torch.as_tensor(t, device=dev).long())
        loss.backward()
        opt.step()
        i += 1
        if i % args.log_interval == 0:
            print(f"step {i}  loss {float(loss.detach()):.4f}  acc {float(acc):.3f}",
                  flush=True)
        if args.save_interval and i % args.save_interval == 0:
            _save(args.out_dir, classifier, i)
    return _save(args.out_dir, classifier, i)


def _save(out_dir, classifier, step) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"classifier{step:06d}.pt")
    torch.save({k: v.detach().cpu().clone() for k, v in classifier.state_dict().items()}, path)
    print(f"saved {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
