"""Heuristic random-action episode sampler.

A copy of `v2a_tpu/envs/randsam.py` without `generate_randsam_dataset`,
whose output is the H5 file that `data/h5_ingest.py` reads: H5 ingestion is
not ported yet (ROADMAP.md, Queue 1).

Counterpart of `environment/libero/lb_data/lb_randsam_utils.py:5-167`,
re-targeted at the `EnvList` interface so it drives either the Libero
backend or the fake backend.

Sampling heuristic (identical semantics):
- base action: uniform delta-xyz in [-1,1] with per-axis reflection — when
  the end effector is outside the workspace box, the next delta is drawn
  only from the half-range that pushes it back in;
- orientation dims: uniform in `orn_sample_range` (tiny, ±0.01);
- gripper: one of the bimodal ranges around ±0.98, uniform within;
- each base action repeated `rand_act_full_len` (24) steps with Gaussian
  noise (separate stds for xyz+gripper vs orientation), clipped to bounds;
- the repeat loop breaks early when the EE leaves the box
  (`is_stop_when_out`);
- episode continues until ≥ `rand_ep_len` (120) actions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from v2a_tpu_torch.envs.base import EnvList


@dataclasses.dataclass(frozen=True)
class RandSamConfig:
    """The `lb_randsam_8tk_perTk500` YAML surface
    (`environment/libero/lb_data/lb_randsam_confs.yaml:36-60`)."""

    x_limit: Tuple[float, float] = (-0.28, 0.21)
    y_limit: Tuple[float, float] = (-0.33, 0.38)
    z_limit: Tuple[float, float] = (0.0, 0.80)
    is_stop_when_out: bool = True
    rand_act_noise_std: float = 0.003
    rand_act_noise_std_orn: float = 0.00001
    act_min: Tuple[float, ...] = (-1, -1, -1, -0.01, -0.01, -0.01, -1)
    act_max: Tuple[float, ...] = (1, 1, 1, 0.01, 0.01, 0.01, 1)
    gripper_ranges: Tuple[Tuple[float, float], ...] = (
        (-0.981, -0.98), (0.98, 0.981),
    )
    rand_ep_len: int = 120
    rand_act_full_len: int = 24
    orn_sample_range: Tuple[float, float] = (-0.01, 0.01)


def _sample_axis(cur: float, lim: Tuple[float, float], rng) -> float:
    """Reflective uniform: full range inside the box, inward-only outside
    (`lb_randsam_utils.py:93-116`)."""
    if cur < lim[0]:
        return float(rng.uniform(0.0, 1.0))
    if cur > lim[1]:
        return float(rng.uniform(-1.0, 0.0))
    return float(rng.uniform(-1.0, 1.0))


def rand_sample_1_ep(
    envs: EnvList,
    task: str,
    env_idx: int,
    cfg: RandSamConfig,
    rng: np.random.Generator,
    cam: str = "agent",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Roll one random episode in an ALREADY-INITIALIZED env.

    Returns (imgs (T+1,H,W,3) uint8, acts (T,7) float32,
    ee_poses (T+1,3) float32), T >= cfg.rand_ep_len.
    """
    act_min = np.asarray(cfg.act_min, np.float32)
    act_max = np.asarray(cfg.act_max, np.float32)

    obs = envs.get_an_env_obs(task, env_idx)
    ee_poses: List[np.ndarray] = [np.asarray(obs["robot0_eef_pos"], np.float32)]
    imgs: List[np.ndarray] = [envs.render_an_env(task, cam, env_idx)]
    acts: List[np.ndarray] = []

    while len(acts) < cfg.rand_ep_len:
        x_cur, y_cur, z_cur = ee_poses[-1]
        if z_cur < cfg.z_limit[0]:
            z_rd = float(rng.uniform(-1.0, 1.0))  # reference asserts unreachable
        else:
            z_rd = _sample_axis(z_cur, cfg.z_limit, rng)
        base = np.empty(7, np.float32)
        base[0] = _sample_axis(x_cur, cfg.x_limit, rng)
        base[1] = _sample_axis(y_cur, cfg.y_limit, rng)
        base[2] = z_rd
        base[3:6] = rng.uniform(*cfg.orn_sample_range, size=3)
        lo, hi = cfg.gripper_ranges[int(rng.integers(len(cfg.gripper_ranges)))]
        base[6] = rng.uniform(lo, hi)

        for _ in range(cfg.rand_act_full_len):
            noise = np.empty(7, np.float32)
            noise[:3] = rng.normal(0, cfg.rand_act_noise_std, 3)
            noise[3:6] = rng.normal(0, cfg.rand_act_noise_std_orn, 3)
            noise[6] = rng.normal(0, cfg.rand_act_noise_std)
            act = np.clip(base + noise, act_min, act_max).astype(np.float32)

            envs.step_an_env(task, env_idx, act)
            acts.append(act)
            imgs.append(envs.render_an_env(task, cam, env_idx))
            ee = np.asarray(
                envs.get_an_env_obs(task, env_idx)["robot0_eef_pos"], np.float32
            )
            ee_poses.append(ee)

            if cfg.is_stop_when_out:
                out = (
                    not (cfg.x_limit[0] <= ee[0] <= cfg.x_limit[1])
                    or not (cfg.y_limit[0] <= ee[1] <= cfg.y_limit[1])
                    or not (cfg.z_limit[0] <= ee[2] <= cfg.z_limit[1])
                )
                if out:
                    break

    return (
        np.stack(imgs, axis=0),
        np.stack(acts, axis=0),
        np.stack(ee_poses, axis=0),
    )

