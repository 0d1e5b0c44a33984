"""Classifier-guided sampling.

    python -m v2a_tpu_torch.scripts.guided.classifier_sample --model_path PT \\
        --classifier_path PT [flags] [--classifier_scale 1.0] [--device cpu]

Counterpart of `scripts/guided/classifier_sample.py` (the reference's
`guided_diffusion/scripts/classifier_sample.py:1-131`):
`cond_fn = classifier_scale * grad_x log p(y | x_t, t)` steered through
`GuidedDiffusion.condition_mean` / `condition_score`. The chain runs under
`torch.no_grad()` (not `inference_mode`: autograd refuses inference
tensors); `cond_fn` takes its gradient under `torch.enable_grad()` with
respect to a detached copy of x, the classifier's parameters frozen.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from v2a_tpu_torch.guided import (
    NUM_CLASSES,
    classifier_and_diffusion_defaults,
    create_classifier_and_diffusion,
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

GUIDED_DEFAULTS = dict(
    clip_denoised=True,
    num_samples=16,
    batch_size=16,
    use_ddim=False,
    model_path="",
    classifier_path="",
    classifier_scale=1.0,
    out_dir="guided_out",
    seed=0,
)


def make_cond_fn(classifier, scale: float):
    """`classifier_sample.py:55-62`: the gradient of the selected
    log-probabilities with respect to x, times `scale`."""

    def cond_fn(x, t, y=None):
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            logp = F.log_softmax(classifier(x_in, t), dim=-1)
            selected = torch.gather(logp, -1, y.long()[:, None]).sum()
            return torch.autograd.grad(selected, x_in)[0] * scale

    return cond_fn


def main(argv=None) -> str:
    args = parse(argv, GUIDED_DEFAULTS, model_and_diffusion_defaults(),
                 classifier_and_diffusion_defaults())
    # the diffusion model here is class-conditional (`classifier_sample.py:27`)
    args.class_cond = True

    model, diffusion = create_model_and_diffusion(
        **args_subset(args, model_and_diffusion_defaults().keys()), device=args.device
    )
    classifier, _ = create_classifier_and_diffusion(
        **args_subset(args, classifier_and_diffusion_defaults().keys()), device=args.device
    )
    model = frozen(init_or_restore(model, args.model_path))
    classifier = frozen(init_or_restore(classifier, args.classifier_path, seed=1))
    cond_fn = make_cond_fn(classifier, args.classifier_scale)

    shape = (args.batch_size, args.image_size, args.image_size, 3)
    loop = diffusion.ddim_sample_loop if args.use_ddim else diffusion.p_sample_loop
    gen = torch.Generator(device=args.device).manual_seed(args.seed)

    images, labels = [], []
    with torch.no_grad():
        while sum(x.shape[0] for x in images) < args.num_samples:
            y = torch.randint(0, NUM_CLASSES, (args.batch_size,), generator=gen,
                              device=args.device)
            images.append(loop(model, gen, shape, clip_denoised=args.clip_denoised,
                               cond_fn=cond_fn, model_kwargs={"y": y}).cpu().numpy())
            labels.append(y.cpu().numpy())
            print(f"sampled {sum(x.shape[0] for x in images)}", flush=True)

    images = np.concatenate(images)[: args.num_samples]
    labels = np.concatenate(labels)[: args.num_samples]
    return save_samples_npz(args.out_dir, images, labels)


if __name__ == "__main__":
    main()
