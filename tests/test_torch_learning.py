"""The port's learning gate, tier (a): the supervised overfit of
`tests/test_learning.py::test_policy_learns_oracle_behavior`, on the port's
`DiffusionPolicy`, `make_train_step` (with `fused_clip_adamw`, optax's
`chain(clip_by_global_norm(1.0), adamw(1e-3, weight_decay=1e-6))`) and
`ReplayBuffer`, with the JAX gate's thresholds: the diffusion loss falls by
more than 8x; on approach-phase windows the EMA policy's DDIM actions point
in the oracle direction (mean cosine > 0.6, positive on > 90%); the gripper
channel agrees with the goal frame's > 80%.

Every other port test holds equivalence; this one holds that the port
learns. `slow`: tier-1 does not run it. It runs on the card when one is
present, else on the CPU:

    python -m pytest -m slow tests/test_torch_learning.py
"""

import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from v2a_tpu_torch.data.replay_buffer import ReplayBuffer
from v2a_tpu_torch.envs.fake import FakeEnvList
from v2a_tpu_torch.envs.fake_oracle import collect_oracle_episodes, decode_frame
from v2a_tpu_torch.models.policy import DiffusionPolicy, PolicyConfig
from v2a_tpu_torch.train.train_state import (
    EMAConfig, OptimizerConfig, PolicyTrainState, fused_clip_adamw, make_train_step)

HORIZON = 8


def _oracle_buffer(envs, rng, eps_per_task=6, ep_len=16, noise=0.1):
    eps = collect_oracle_episodes(envs, eps_per_task=eps_per_task, ep_len=ep_len, rng=rng,
                                  action_noise=noise)
    buf = ReplayBuffer(max_episodes=32, min_len=10, sample_act_seq_len=HORIZON,
                       backend="python")
    for e in eps:
        buf.add_episode(e["task"], e["cam"], e["env_idx"], e["imgs"], e["acts"])
    return buf


@pytest.mark.slow
def test_policy_learns_oracle_behavior():
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    t0 = time.perf_counter()
    envs = FakeEnvList(num_tasks=2, img_hw=(32, 32), step_scale=0.05, grasp_radius=0.15)
    rng = np.random.default_rng(0)
    buf = _oracle_buffer(envs, rng)

    cfg = PolicyConfig(image_size=(32, 32), down_dims=(64, 128), horizon=HORIZON,
                       n_action_steps=4, num_train_timesteps=10, num_inference_steps=10,
                       num_inference_steps_ddim=5, obs_feature_dim=32, num_kp=16,
                       diffusion_step_embed_dim=64, vision_stage_sizes=(1, 1),
                       vision_stage_features=(32, 64))
    policy = DiffusionPolicy.create(cfg, device=dev).init(0)
    policy.nets.requires_grad_(True)
    ema = dataclasses.replace(policy, nets=copy.deepcopy(policy.nets).requires_grad_(False))
    tx = fused_clip_adamw(OptimizerConfig(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                                          weight_decay=1e-6, grad_clip=1.0))
    state = PolicyTrainState(policy.nets, tx, ema_module=ema.nets)
    step_fn = make_train_step(policy.loss, tx, EMAConfig())
    gen = torch.Generator(device=dev).manual_seed(1)

    def to_batch(hb):
        return {"obs": {"img_obs_1": torch.as_tensor(hb["img_obs"], device=dev).float() / 255.0,
                        "img_goal_1": torch.as_tensor(hb["img_goal"], device=dev).float() / 255.0},
                "action": torch.as_tensor(hb["action"], device=dev)}

    losses = []
    for _ in range(250):
        hb = buf.sample_batch(32, rng, horizon=HORIZON)
        losses.append(float(step_fn(state, to_batch(hb), gen).loss))
    first, last = np.mean(losses[:5]), np.mean(losses[-20:])
    t_train = time.perf_counter() - t0

    # -- oracle-direction check on approach-phase windows -------------------
    hb = buf.sample_batch(256, rng, horizon=HORIZON)
    with torch.no_grad():
        pred = ema.predict_action(to_batch(hb)["obs"], use_ddim=True,
                                  generator=torch.Generator(device=dev).manual_seed(42))
    ap = pred["action_pred"].float().cpu().numpy()  # (B, H, 7)

    cos, grip_true, grip_pred = [], [], []
    for b in range(ap.shape[0]):
        st = decode_frame(hb["img_obs"][b])
        gl = decode_frame(hb["img_goal"][b])
        grip_true.append(gl["gripper_closed"])
        grip_pred.append(float(ap[b, :, 6].mean()) > 0)
        delta = st["obj_pos"] - st["ee_pos"]
        dist = float(np.linalg.norm(delta))
        if dist < 0.18:  # hover/grasp: direction ill-defined
            continue
        pm = ap[b, :4, :3].mean(axis=0)
        nm = float(np.linalg.norm(pm))
        cos.append(0.0 if nm < 1e-6 else float(pm / nm @ (delta / dist)))
    cos = np.asarray(cos)
    grip_agree = float(np.mean(np.asarray(grip_true) == np.asarray(grip_pred)))
    print(f"[learning] device {dev}: loss {first:.4f} -> {last:.4f} ({first / last:.1f}x), "
          f"cosine {cos.mean():.3f} over {len(cos)} windows, positive {np.mean(cos > 0):.3f}, "
          f"gripper agreement {grip_agree:.3f}, 250 steps in {t_train:.1f} s, "
          f"all {time.perf_counter() - t0:.1f} s")
    assert last < first / 8.0, f"loss did not fall 8x: {first:.3f} -> {last:.3f}"
    assert len(cos) >= 50, f"too few approach windows sampled: {len(cos)}"
    assert cos.mean() > 0.6, f"oracle-direction cosine too low: {cos.mean():.3f}"
    assert np.mean(cos > 0) > 0.9, f"direction sign wrong on {np.mean(cos <= 0):.0%}"
    assert grip_agree > 0.8, f"gripper does not track goal stripe: {grip_agree:.3f}"
