"""Evaluation entry point.

Counterpart of `scripts/eval.py` (the reference's
`diffuser/libero/plan_lb.py:26-156`):

    python -m v2a_tpu_torch.scripts.eval --workdir logs/<dataset>/diffusion/<exp> \
        [--n_seeds 25] [--epoch latest] [--vis 1] [--eval_seed 0] [--workers N]

Reconstructs the experiment from the config snapshot in the workdir (the
train->eval contract; its `device` too), loads the chosen checkpoint,
applies the eval-time overrides of `plan_lb.py:67-74` (policy DDIM steps 8,
ddpm_var_temp 0.5, 8 actions per prediction), runs the eval protocol with
the EMA policy, and writes the result JSON + per-episode mp4/png artifacts.
`--workers N` (N > 1) runs the parallel protocol (`eval/parallel.py`): N
spawned env workers, N episodes in lock-step, one B=N policy call per round
and B=N goal-video calls; its closures draw from the same one generator as
the serial ones.
"""

import dataclasses
import os
import sys
from datetime import datetime

import numpy as np
import torch

from v2a_tpu_torch.config import load_snapshot, parse_cli
from v2a_tpu_torch.eval.harness import Evaluator, save_result_json
from v2a_tpu_torch.train.build import build_experiment


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    _, kv = parse_cli(argv)  # validating: rejects bare tokens/missing values
    args = {f"--{k}": v for k, v in kv.items()}
    workdir = args.get("--workdir")
    if not workdir:
        raise SystemExit(
            "usage: eval.py --workdir <exp dir> [--n_seeds N] [--epoch E]"
            " [--vis 0|1] [--eval_seed S] [--workers N]"
        )
    cfg = load_snapshot(workdir)

    # eval-time overrides (`plan_lb.py:67-74`)
    eval_cfg = cfg.eval
    if "--n_seeds" in args:
        eval_cfg = dataclasses.replace(eval_cfg, n_seeds=int(args["--n_seeds"]))
    if "--vis" in args:
        eval_cfg = dataclasses.replace(eval_cfg, vis=bool(int(args["--vis"])))
    eval_seed = int(args.get("--eval_seed", 0))
    # full eval-time overrides of `plan_lb.py:67-74`: DDIM steps 8,
    # 8 actions per prediction (clamped to the horizon), ddpm_var_temp 0.5
    cfg = cfg.replace(
        eval=dataclasses.replace(
            eval_cfg, n_acts_per_pred=min(8, cfg.policy.horizon)
        ),
        policy=dataclasses.replace(
            cfg.policy,
            num_inference_steps_ddim=8,
            n_action_steps=min(8, cfg.policy.horizon),
            ddpm_var_temp=0.5,
        ),
    )
    eval_cfg = cfg.eval

    # the trainer only carries the weights here: no exploration pool for it
    trainer, policy, env_list, video_model = build_experiment(
        cfg.replace(n_env_workers=0), workdir, snapshot=False
    )
    label = args.get("--epoch", "latest")
    trainer.load(None if label == "latest" else int(label))
    epoch = trainer.step
    print(f"[eval] loaded checkpoint at step {epoch}")

    dev = policy.device
    gen = torch.Generator(device=dev).manual_seed(eval_seed)

    def policy_fn(img_obs01, img_goal01):
        out = trainer.ema_policy.predict_action(
            {
                "img_obs_1": torch.as_tensor(img_obs01, device=dev),
                "img_goal_1": torch.as_tensor(img_goal01, device=dev),
            },
            use_ddim=True, generator=gen,
        )
        return out["action"][0].float().cpu().numpy()

    def video_fn(img01, task):
        # uint8 on the device: 4x less readback
        return np.asarray(trainer.video_model.sample_u8(gen, img01[None], [task])[0])

    stamp = datetime.now().strftime("%y%m%d-%H%M%S")
    save_path = os.path.join(
        workdir, "plans", f"{stamp}-nm{eval_cfg.n_seeds}-evSd{eval_seed}"
    )
    n_workers = int(args.get("--workers", 0))
    if n_workers > 1:
        # parallel protocol: N episodes in lock-step, batched card calls
        from v2a_tpu_torch.envs.subproc import EnvWorkerPool
        from v2a_tpu_torch.eval.parallel import ParallelEvaluator

        def policy_fn_batch(obs01, goal01):
            out = trainer.ema_policy.predict_action(
                {
                    "img_obs_1": torch.as_tensor(obs01, device=dev),
                    "img_goal_1": torch.as_tensor(goal01, device=dev),
                },
                use_ddim=True, generator=gen,
            )
            return out["action"].float().cpu().numpy()

        def video_fn_batch(imgs01, tasks):
            return np.asarray(trainer.video_model.sample_u8(gen, imgs01, list(tasks)))

        with EnvWorkerPool(cfg.dataset, n_workers=n_workers) as pool:
            results = ParallelEvaluator(
                pool, policy_fn_batch, video_fn_batch,
                video_horizon=cfg.video.video_future_horizon,
                config=eval_cfg,
            ).run_evals(save_path=save_path)
    else:
        evaluator = Evaluator(
            env_list,
            policy_fn,
            video_fn,
            video_horizon=cfg.video.video_future_horizon,
            config=eval_cfg,
            save_path=save_path,
        )
        results = evaluator.run_evals()
    path = save_result_json(
        results, save_path, epoch=epoch,
        dp_ds=cfg.policy.num_inference_steps_ddim,
        vid_ds=cfg.video.sampling_timesteps,
        num_vid_pred_per_ep=eval_cfg.num_vid_pred_per_ep,
        use_vid_first_n_frames=eval_cfg.use_vid_first_n_frames,
        eval_seed=eval_seed,
        # metadata fields of the reference result JSON (`plan_lb.py:113-121`)
        extra={
            "vid_var_temp": cfg.video.var_temp,
            "dp_var_temp": cfg.policy.ddpm_var_temp,
            "vid_diffusion": cfg.video_ckpt_dir,
            "eval_n_preds_betw_vframes": eval_cfg.eval_n_preds_betw_vframes,
            "eval_seed": eval_seed,
        },
    )
    print(f"[eval] suc_rate={results['suc_rate']:.3f} -> {path}")
    return path


if __name__ == "__main__":
    main()
