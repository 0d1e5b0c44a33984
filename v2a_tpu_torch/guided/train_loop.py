"""Generic guided-diffusion train loop (image / super-res / classifier).

Counterpart of `v2a_tpu/guided/train_loop.py` (the reference's
`guided_diffusion/train_util.py:31-236` `TrainLoop`): Adam, or AdamW with
optax's decoupled weight decay, on the diffusion `training_losses`; one EMA
per comma-separated rate; microbatches whose gradients are summed and
divided by their number; loss-aware timestep resampling; periodic
snapshots; the linear learning-rate anneal. No loss scaling (bfloat16
needs none).

The timestep sampler draws from the loop's `np.random.default_rng(seed)`,
as the JAX loop's does, so both draw the same timesteps and weights at
one seed; the noise comes from a `torch.Generator` seeded with the seed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2a_tpu_torch.ops.guided_diffusion_core import GuidedDiffusion
from v2a_tpu_torch.ops.resample import UniformSampler


def _host(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in state.items()}


@dataclasses.dataclass
class GuidedTrainLoop:
    """`train_util.py:31-116`. Trains `model`'s parameters in place;
    `model_fn(x_t, t, **kwargs)` returns the model output (2C channels when
    learn_sigma) and defaults to `model` itself."""

    model: nn.Module
    diffusion: GuidedDiffusion
    data: Iterator
    batch_size: int
    microbatch: int = -1
    lr: float = 1e-4
    ema_rate: str = "0.9999"
    log_interval: int = 10
    save_interval: int = 10_000
    weight_decay: float = 0.0
    lr_anneal_steps: int = 0
    schedule_sampler: Any = None
    out_dir: str = "."
    seed: int = 0
    model_fn: Optional[Callable[..., torch.Tensor]] = None

    def __post_init__(self):
        self.ema_rates = tuple(
            float(r) for r in str(self.ema_rate).split(",") if r
        )
        self.sampler = self.schedule_sampler or UniformSampler(
            self.diffusion.num_timesteps
        )
        self.step = 0
        self.device = self.diffusion.device
        self._np_rng = np.random.default_rng(self.seed)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model_fn = self.model_fn or self.model
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        # optax's adam / adamw: b1 0.9, b2 0.999, eps 1e-8 outside the root;
        # AdamW's decay is decoupled and scaled by the scheduled rate
        if self.weight_decay:
            self.opt = torch.optim.AdamW(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=self.weight_decay)
        else:
            self.opt = torch.optim.Adam(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        self.ema_params = [
            [p.detach().clone() for p in self.params] for _ in self.ema_rates
        ]

    def _lr_schedule(self, step: int) -> float:
        """`train_util.py:287-293` linear anneal to zero, evaluated at optax's
        count: the update numbered n (from 0) uses schedule(n)."""
        if not self.lr_anneal_steps:
            return self.lr
        frac = min(step / self.lr_anneal_steps, 1.0)
        return self.lr * (1.0 - frac)

    def _losses(self, x, t, weights, kwargs):
        terms = self.diffusion.training_losses(
            self.model_fn, self._gen, x, t, model_kwargs=kwargs
        )
        return torch.mean(terms["loss"] * weights), terms["loss"]

    def compute_gradients(self, x, t, weights, kwargs):
        """The mean weighted loss's gradient into `.grad`: one microbatch
        at a time, summed, divided by their number (`train_util.py:
        91-119`). Returns (loss, per-sample losses)."""
        micro = self.microbatch if self.microbatch > 0 else x.shape[0]
        n_micro = max(x.shape[0] // micro, 1)
        if n_micro > 1 and n_micro * micro != x.shape[0]:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of microbatch {micro}")
        self.opt.zero_grad(set_to_none=True)
        losses, per_sample = [], []
        for i in range(n_micro):
            sl = slice(i * micro, (i + 1) * micro) if n_micro > 1 else slice(None)
            loss_i, per_i = self._losses(x[sl], t[sl], weights[sl],
                                         {k: v[sl] for k, v in kwargs.items()})
            loss_i.backward()
            losses.append(loss_i.detach())
            per_sample.append(per_i.detach())
        if n_micro > 1:
            with torch.no_grad():
                for p in self.params:
                    if p.grad is not None:
                        p.grad.div_(n_micro)
        return torch.stack(losses).mean(), torch.cat(per_sample)

    @torch.no_grad()
    def apply_gradients(self):
        """One optimizer update at the scheduled rate of the updates made
        so far, then every EMA; counts the step."""
        for group in self.opt.param_groups:
            group["lr"] = self._lr_schedule(self.step)
        self.opt.step()
        for rate, ema in zip(self.ema_rates, self.ema_params):
            for e, p in zip(ema, self.params):
                e.copy_(e * rate + p * (1.0 - rate))
        self.step += 1

    # -- driver ----------------------------------------------------------

    def run_step(self, x: np.ndarray, kwargs: Dict[str, np.ndarray]) -> float:
        t, weights = self.sampler.sample(x.shape[0], self._np_rng)
        dev = self.device
        loss, per_sample = self.compute_gradients(
            torch.as_tensor(np.asarray(x, np.float32), device=dev),
            torch.as_tensor(t, device=dev).long(),
            torch.as_tensor(weights, device=dev),
            {k: torch.as_tensor(v, device=dev) for k, v in kwargs.items()},
        )
        self.apply_gradients()
        self.sampler.update_with_losses(t, per_sample.float().cpu().numpy())
        return float(loss)

    def run_loop(self, max_steps: Optional[int] = None):
        """`train_util.py:118-145`."""
        while (
            (max_steps is None or self.step < max_steps)
            and (not self.lr_anneal_steps or self.step < self.lr_anneal_steps)
        ):
            x, kwargs = next(self.data)
            loss = self.run_step(x, kwargs)
            if self.step % self.log_interval == 0:
                print(f"step {self.step}  loss {loss:.4f}", flush=True)
            if self.save_interval and self.step % self.save_interval == 0:
                self.save()
        self.save()

    def ema_state_dict(self, index: int) -> Dict[str, torch.Tensor]:
        """The model's state dict with the `index`-th EMA's parameters."""
        ema = {id(p): e for p, e in zip(self.params, self.ema_params[index])}
        named = dict(self.model.named_parameters())
        return {k: ema.get(id(named[k]), v) if k in named else v
                for k, v in self.model.state_dict().items()}

    def save(self):
        """Model and EMA snapshots, `torch.save` of host state dicts named
        as the JAX pickles (`train_util.py:230-251`)."""
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"model{self.step:06d}.pt")
        torch.save(_host(self.model.state_dict()), path)
        for i, rate in enumerate(self.ema_rates):
            ema_path = os.path.join(
                self.out_dir, f"ema_{rate}_{self.step:06d}.pt")
            torch.save(_host(self.ema_state_dict(i)), ema_path)
        return path


def classifier_loss_fn(
    apply_fn: Callable[..., torch.Tensor],
    diffusion: GuidedDiffusion,
) -> Callable:
    """Noisy-classifier objective (`scripts/classifier_train.py:87-137`):
    cross-entropy of the classifier on q_sample-noised images.
    `loss(generator, x, y, t, noise=None) -> (mean nll, accuracy)`."""

    def loss(generator, x, y, t, noise=None):
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device)
        x_t = diffusion.q_sample(x, t, noise)
        logits = apply_fn(x_t, t)
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, y.long()[:, None])[:, 0]
        acc = torch.mean((torch.argmax(logits, -1) == y).float())
        return torch.mean(nll), acc

    return loss
