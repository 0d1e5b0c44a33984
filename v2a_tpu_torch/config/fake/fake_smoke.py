"""Hermetic smoke config: fake env backend, tiny nets, short loop.

A copy of `v2a_tpu/config/fake/fake_smoke.py`; add `--device cpu` to run it
without a card.

The reference has no sim-free config (SURVEY §4); this one exercises the
full online loop (rand phase -> video exploration -> mixed sampling ->
checkpoints) in under a minute on CPU."""

base = {
    "dataset": "fake-2tk-v0",
    "env_backend": "fake",
    "logbase": "logs",
    "policy": {
        "image_size": (32, 32),
        "down_dims": (32, 64),
        "horizon": 8,
        "n_action_steps": 4,
        "num_train_timesteps": 10,
        "num_inference_steps": 10,
        "num_inference_steps_ddim": 2,
    },
    "video": {
        "image_size": (32, 32),
        "sample_per_seq": 4,
        "timesteps": 8,
        "sampling_timesteps": 4,
        "model_channels": 32,
        "channel_mult": (1, 2),
        "num_res_blocks": 1,
        "attention_resolutions": (8,),
        "text_dim": 64,
    },
    "trainer": {
        "init_rand_steps": 4,
        "video_explo_freq": 6,
        "rand_explo_freq": 1000,
        "n_train_steps": 20,
        "save_freq": 10,
        "log_freq": 5,
        "buf_sample_batch_size": 8,
        "min_len_uB": 9,
        "model_act_horizon": 8,
        "max_episodes_rand": 20,
        "max_episodes_vid": 20,
        "randsam_path": "",
        "rand_explo_type": "live",
        "live_rand_ep_len": 12,
    },
    "explore": {
        "n_acts_per_pred": 4,
        "n_preds_betw_vframes": (1, 2),
        "act_down_val": -0.1,
    },
    "eval": {
        "n_seeds": 2,
        "eval_n_preds_betw_vframes": 2,
        "num_vid_pred_per_ep": 2,
        "use_vid_first_n_frames": 1,
        "n_acts_per_pred": 4,
    },
}
