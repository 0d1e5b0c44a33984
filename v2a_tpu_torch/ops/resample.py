"""Timestep samplers for diffusion training, host-side numpy.

A copy of `v2a_tpu/ops/resample.py` (the vendored guided-diffusion
`resample.py:7-124`: uniform and loss-second-moment importance sampling of
timesteps). The port keeps its own copy: it imports nothing of the JAX
package. The samplers draw from a numpy generator, so the same seed gives
the JAX trainer's timesteps and weights. `merge` folds in the (t, loss)
pairs of the other dp ranks (the mesh video trainer all-gathers them), so
every rank keeps the same history.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class UniformSampler:
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, batch: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        t = rng.integers(0, self.num_timesteps, size=batch)
        weights = np.ones(batch, np.float32)
        return t.astype(np.int32), weights

    def update_with_losses(self, ts: np.ndarray, losses: np.ndarray):
        pass


class LossSecondMomentResampler:
    """Importance-sample timesteps proportional to sqrt(E[loss^2]) with a
    uniform floor (`resample.py:70-124`): p_t ∝ sqrt(mean of the last
    `history` squared losses at t), mixed with `uniform_prob`; weights are
    1/(T p_t) so the loss estimate stays unbiased."""

    def __init__(
        self,
        num_timesteps: int,
        history_per_term: int = 10,
        uniform_prob: float = 1e-3,
    ):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros(
            (num_timesteps, history_per_term), np.float64
        )
        self._loss_counts = np.zeros(num_timesteps, np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones(self.num_timesteps, np.float64)
        w = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        w = w / w.sum()
        w = w * (1 - self.uniform_prob) + self.uniform_prob / len(w)
        return w

    def sample(self, batch: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        p = self.weights()
        p = p / p.sum()
        t = rng.choice(len(p), size=batch, p=p)
        weights = 1.0 / (len(p) * p[t])
        return t.astype(np.int32), weights.astype(np.float32)

    def update_with_losses(self, ts: np.ndarray, losses: np.ndarray):
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            t = int(t)
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def merge(self, other_ts: np.ndarray, other_losses: np.ndarray):
        """Fold in (t, loss) pairs gathered from other ranks: the cross-rank
        sync of `resample.py:70-98` (`v2a_tpu/ops/resample.py:80-84`)."""
        self.update_with_losses(other_ts, other_losses)


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """`resample.py:12-24` factory."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
