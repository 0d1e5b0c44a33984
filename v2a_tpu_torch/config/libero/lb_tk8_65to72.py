"""Release experiment config: Libero 8 tasks (65-72), online training.

A copy of `v2a_tpu/config/libero/lb_tk8_65to72.py`. Mirrors the
hyperparameter surface of the reference release config
`config/libero/lb_tk8_65to72.py:33-177` mapped onto the typed config
tree. Differences are layout-only (one unified tree instead of
trainer_dict / opt_params / ema_params / YAML)."""

# `LB_GRASP_actdown_value_range_1` (`diffuser/libero/lb_constants.py:15-24`)
GRASP_ACTDOWN = {
    65: (-0.11, -0.10),
    66: (-0.11, -0.10),
    67: (-0.11, -0.10),
    68: (-0.11, -0.10),
    69: (-0.99, -0.98),
    70: (-0.99, -0.98),
    71: (-0.11, -0.10),
    72: (-0.11, -0.10),
}

base = {
    "dataset": "libero-8tk-65to72-v3",
    "env_backend": "libero",
    "logbase": "logs",
    "prefix": "diffusion/",
    "video_ckpt_dir": "./ckpts/libero/libero_ep20_bs12_aug",
    "video_ckpt_milestone": 180000,

    # the policy YAML surface
    # (`config/diff_policy/lb_train_diffusion_unet_image_orn10.yaml`)
    "policy": {
        "action_dim": 7,
        "horizon": 16,
        "n_action_steps": 8,
        "n_obs_steps": 1,
        "image_size": (128, 128),
        "num_train_timesteps": 100,
        "num_inference_steps": 100,
        "num_inference_steps_ddim": 8,
        "down_dims": (256, 512, 1024),
        "kernel_size": 5,
        "diffusion_step_embed_dim": 128,
        "obs_feature_dim": 64,
        "num_kp": 32,
        "dtype": "bfloat16",
    },

    # the frozen video model (`vid_diffusion` + `lb_video_model_utils.py`)
    "video": {
        "image_size": (128, 128),
        "sample_per_seq": 8,
        "timesteps": 100,
        "sampling_timesteps": 100,
        "objective": "pred_v",
        "beta_schedule": "cosine",
        "guidance_weight": 0.0,
        "model_channels": 128,
        "channel_mult": (1, 2, 3, 4, 5),
        "num_res_blocks": 2,
        "attention_resolutions": (8, 16),
        "num_head_channels": 32,
        "dtype": "bfloat16",
    },

    # `trainer_dict` (`config/libero/lb_tk8_65to72.py:70-133`)
    "trainer": {
        "num_init_rand_ep_per_tk": 50,
        "max_episodes_rand": 1200,
        "max_episodes_vid": 600,
        "max_len_uB": 700,
        "min_len_uB": 30,
        "model_act_horizon": 16,
        "is_stop_at_suc": False,
        "init_rand_steps": 10000,
        "rand_cycle_steps": 100,
        "vid_cycle_steps": 400,
        "video_explo_freq": 200,
        "rand_explo_freq": 500,
        "rand_explo_num_ep_per_tk": 2,
        "buf_sample_batch_size": 64,
        "buf_sample_method": "rand_prob",
        "buf_sample_randBuf_prob": 0.3,
        "buf_sample_ratio_rand": (0.75, 0.25),
        "buf_sample_ratio_vid": (0.25, 0.75),
        "enable_noExp": True,
        "noExp_start_buf_len_rand": 500,
        "noExp_start_buf_len_vid": 500,
        "Exp_noExp_rand": (1000, 1000),
        "Exp_noExp_vid": (1000, 1000),
        "n_train_steps": 200_000,
        "gradient_accumulate_every": 1,
        "save_freq": 1000,
        "log_freq": 100,
        "n_saves": 5,
        "randsam_path": "./data/lb_randsam_8tk_perTk500.hdf5",
        "h5_total_num_ep_per_task": 500,
    },

    # guided-rollout knobs (`trainer_dict` rows 95-127)
    "explore": {
        "n_acts_per_pred": 8,
        "n_preds_betw_vframes": (4, 6),
        "n_acts_down_range": (16, 16),
        "n_acts_close_grp": 8,
        "close_grp_force": 0.98,
        "close_grp_act_down_val": 0.0,
        "act_down_val": None,
        "act_down_val_range_per_tk": GRASP_ACTDOWN,
        "grasp_z_diff_limit": 0.36,
        "grasp_abs_z_limit": 0.56,
    },

    # `opt_params` + grad clip
    "opt": {
        "lr": 1.0e-4,
        "b1": 0.95,
        "b2": 0.999,
        "eps": 1.0e-8,
        "weight_decay": 1.0e-6,
        "grad_clip": 1.0,
    },

    # `ema_params`
    "ema": {
        "update_after_step": 0,
        "inv_gamma": 1.0,
        "power": 0.75,
        "min_value": 0.0,
        "beta": 0.9999,
        "update_every": 1,
    },

    # eval protocol (`plan_lb.py:140-151`)
    "eval": {
        "n_seeds": 25,
        "seed_start": 100,
        "eval_n_preds_betw_vframes": 5,
        "num_vid_pred_per_ep": 5,
        "use_vid_first_n_frames": 2,
        "n_acts_per_pred": 8,
        "is_stop_at_suc": True,
    },
}
