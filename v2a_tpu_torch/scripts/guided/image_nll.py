"""Bits/dimension evaluation of an image diffusion model.

    python -m v2a_tpu_torch.scripts.guided.image_nll --data_dir DIR \\
        --model_path PT [model and diffusion flags] [--device cpu]

Counterpart of `scripts/guided/image_nll.py` (the reference's
`guided_diffusion/scripts/image_nll.py:1-96`): the full-VLB sweep
(`calc_bpd_loop`) over a deterministic pass of the data, printing the
running `bpd=` and saving the per-term npz breakdowns (`vb_terms.npz`,
`mse_terms.npz`, `xstart_mse_terms.npz`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from v2a_tpu_torch.guided import create_model_and_diffusion, model_and_diffusion_defaults
from v2a_tpu_torch.guided.image_data import load_data
from v2a_tpu_torch.guided.script_util import args_subset
from v2a_tpu_torch.scripts.guided._common import frozen, init_or_restore, parse

NLL_DEFAULTS = dict(
    data_dir="",
    clip_denoised=True,
    num_samples=1000,
    batch_size=1,
    model_path="",
    out_dir="guided_out",
    seed=0,
)


def main(argv=None) -> float:
    args = parse(argv, NLL_DEFAULTS, model_and_diffusion_defaults())

    model, diffusion = create_model_and_diffusion(
        **args_subset(args, model_and_diffusion_defaults().keys()), device=args.device
    )
    model = frozen(init_or_restore(model, args.model_path))

    data = load_data(
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        image_size=args.image_size,
        class_cond=args.class_cond,
        deterministic=True,
        seed=args.seed,
    )

    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    all_bpd, terms = [], {"vb": [], "mse": [], "xstart_mse": []}
    done = 0
    with torch.no_grad():
        while done < args.num_samples:
            x, kwargs = next(data)
            y = kwargs.get("y")
            out = diffusion.calc_bpd_loop(
                model, gen, torch.as_tensor(x, device=args.device),
                clip_denoised=args.clip_denoised,
                model_kwargs=({"y": torch.as_tensor(y, device=args.device)}
                              if args.class_cond else None),
            )
            for key in terms:
                terms[key].append(out[key].cpu().numpy().mean(axis=0))
            all_bpd.append(float(out["total_bpd"].mean()))
            done += x.shape[0]
            print(f"done {done} samples: bpd={np.mean(all_bpd):.4f}", flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    for key, vals in terms.items():
        path = os.path.join(args.out_dir, f"{key}_terms.npz")
        np.savez(path, np.mean(np.stack(vals), axis=0))
        print(f"saved {path}", flush=True)
    return float(np.mean(all_bpd))


if __name__ == "__main__":
    main()
