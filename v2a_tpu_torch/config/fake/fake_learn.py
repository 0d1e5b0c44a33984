"""The closed-loop learning-gate config, a copy of
`v2a_tpu/config/fake/fake_learn.py`.

Hermetic counterpart of the release experiment
(`config/libero/lb_tk8_65to72.py`): the fake reach-and-grasp world stands in
for LIBERO, and the scripted oracle goal-frame generator
(`envs/fake_oracle.py`) stands in for the frozen pretrained video diffusion
model. `python -m v2a_tpu_torch.scripts.train --config .../fake_learn.py`
runs the full online loop (live rand phase -> video-guided exploration with
the grasp heuristic -> hindsight-relabeled mixed-buffer training), after
which `python -m v2a_tpu_torch.scripts.eval --workdir <savepath>` reports
the success rate. `tests/test_torch_learning_closed_loop.py` (`slow`) holds
that rate against the step-1 checkpoint's.
"""

base = {
    "dataset": "fake-2tk-learn-v0",
    "env_backend": "fake",
    "video_model_kind": "oracle",
    "logbase": "logs",
    "policy": {
        "image_size": (32, 32),
        "down_dims": (64, 128),
        "horizon": 8,
        "n_action_steps": 4,
        "num_train_timesteps": 10,
        "num_inference_steps": 10,
        "num_inference_steps_ddim": 5,
        "obs_feature_dim": 32,
        "num_kp": 16,
        "diffusion_step_embed_dim": 64,
        "vision_stage_sizes": (1, 1),
        "vision_stage_features": (32, 64),
    },
    # only image_size / sample_per_seq matter for the oracle generator
    "video": {
        "image_size": (32, 32),
        "sample_per_seq": 8,  # 7 future guidance frames, like the release
    },
    "trainer": {
        "num_init_rand_ep_per_tk": 75,  # //25 -> 3 live rand eps per task
        "init_rand_steps": 30,
        "video_explo_freq": 25,
        "rand_explo_freq": 200,
        "rand_explo_num_ep_per_tk": 1,
        "rand_explo_type": "live",
        "live_rand_ep_len": 20,
        "n_train_steps": 2500,
        "save_freq": 1250,
        "log_freq": 100,
        "buf_sample_batch_size": 16,
        "min_len_uB": 9,
        "max_len_uB": 300,
        "model_act_horizon": 8,
        "max_episodes_rand": 60,
        "max_episodes_vid": 120,
        "randsam_path": "",
    },
    "explore": {
        "n_acts_per_pred": 4,
        "n_preds_betw_vframes": (1, 2),
        # deep scripted descent (z covers the full approach in 16 steps at
        # step_scale 0.05) + a trigger that fires only when the wrist-cam
        # window actually sees the object (fake.py obj_window_xy=0.12 for
        # this env; z_diff 0.46 over the object vs 0.40 over the table)
        "act_down_val": -0.9,
        "grasp_z_diff_limit": 0.42,
        "grasp_abs_z_limit": 0.7,
    },
    "eval": {
        "n_seeds": 4,
        "eval_n_preds_betw_vframes": 2,
        "num_vid_pred_per_ep": 2,
        "use_vid_first_n_frames": 2,
        "n_acts_per_pred": 4,
        "vis": False,
    },
}
