"""Day-1 real-asset bring-up: one command from a reference checkpoint to a
verified eval episode, with a fail-fast PASS/FAIL manifest at every step.

Real assets (the release checkpoint + a local HF CLIP checkout):

    python -m v2a_tpu_torch.scripts.bringup \\
        --pt ckpts/libero/libero_ep20_bs12_aug/model-180000.pt \\
        --clip /path/to/clip-vit-base-patch32 \\
        --out-dir bringup_out

Synthetic stand-ins (a reference-format torch checkpoint from the port's
writer plus a real-BPE synthetic CLIP, then the identical pipeline):

    python -m v2a_tpu_torch.scripts.bringup --synthetic --out-dir bringup_out
    python -m v2a_tpu_torch.scripts.bringup --torch-oracle   # the release schema

Counterpart of `scripts/bringup.py`, with its flags plus `--device`: the
card unless `--device cpu` (or `--cpu`); `--synthetic` does not force the
CPU. The reference tree the JAX script builds its synthetic checkpoint from
is not in the repository, so the checkpoint comes from the port's writer
(`convert/torch_import.py::synthetic_video_checkpoint`: the reference's key
names and shapes, `SMALL` or under `--torch-oracle` the release schema
`REAL`, weights from a numpy generator), the CLIP text tower from
`transformers.CLIPTextModel` (without `transformers` the assets step fails
with its `ImportError`) and the tokenizer from `write_synthetic_tokenizer`.

Steps (reference behaviours being brought up):
  1. assets    - checkpoint + CLIP weights + tokenizer files exist
  2. convert   - torch .pt -> the port's converted file (+ tokenizer bundle)
                 (`diffuser/models/video_model.py:38-46` EMA extraction)
  3. load      - `VideoPredModel.load_converted` incl. the real-tokenizer
                 fail-fast gate
  4. tokenizer - real-BPE fidelity probe (ids must differ from the hash
                 fallback; under the vocab size)
  5. parity    - (synthetic only) the loaded model's forward against a
                 U-Net given the writer's tensors in memory through the
                 converter's stages, max abs err < 2e-3 (the file round
                 trip, the load's key map and the config's network; the
                 converter itself is held against the JAX package's in
                 `tests/test_torch_bringup.py`)
  6. sample    - one video sampled end-to-end (`plan_lb.py:26-156` uses
                 exactly this surface before eval)
  7. eval      - one eval episode through `Evaluator.eval_1_env` with the
                 freshly loaded video model driving goal frames

Exit code 0 only if every step passes; the JSON manifest is printed and
written to <out-dir>/bringup_manifest.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from v2a_tpu_torch.device import resolve_device
from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel

SMALL = dict(
    model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
    attention_resolutions=(2,), num_head_channels=32,
)
# The RELEASE model's parameter schema (`lb_video_model_utils.py:33-39`: 128
# base channels, mult 1-5, 2 res blocks, attention at ds 8/16, 32-wide
# heads, 512-dim CLIP conditioning): the torch-oracle mode writes a
# random-weight checkpoint with exactly the real `model-180000.pt` key names
# and tensor shapes (the model is fully convolutional, so the parameter tree
# does not depend on image size or frame count, kept small for time).
REAL = dict(
    model_channels=128, num_res_blocks=2, channel_mult=(1, 2, 3, 4, 5),
    attention_resolutions=(8, 16), num_head_channels=32,
)
REAL_TEXT_DIM = 512
SMALL_TEXT_DIM = 64
PROBE = ["put the red mug on the plate"]
VOCAB = 49408


def small_config(real_shape: bool = False) -> VideoModelConfig:
    """The synthetic mode's config (32^2; `fused=False`, as in JAX)."""
    if real_shape:
        return VideoModelConfig(
            image_size=(32, 32), sample_per_seq=3, timesteps=100,
            sampling_timesteps=3, text_dim=REAL_TEXT_DIM, fused=False,
            **REAL,
        )
    return VideoModelConfig(
        image_size=(32, 32), sample_per_seq=4, timesteps=10,
        sampling_timesteps=10, text_dim=SMALL_TEXT_DIM, fused=False, **SMALL,
    )


def make_synthetic_assets(out_dir: str, cfg: VideoModelConfig):
    """(pt_path, clip_dir, checkpoint): a reference-format video checkpoint
    of `cfg` from the port's writer, and a synthetic CLIP text tower of
    `cfg.text_dim` with real byte-level-BPE tokenizer assets (characters
    only, no merges)."""
    import transformers

    from v2a_tpu_torch.convert.torch_import import (
        synthetic_video_checkpoint, write_synthetic_tokenizer,
    )

    ckpt = synthetic_video_checkpoint(cfg, seed=0)
    pt_path = os.path.join(out_dir, "synthetic-model-180000.pt")
    torch.save(ckpt, pt_path)

    # synthetic CLIP: the ClipTextEncoder's module shape at the config's width
    clip_dir = os.path.join(out_dir, "synthetic-clip")
    os.makedirs(clip_dir, exist_ok=True)
    ccfg = transformers.CLIPTextConfig(
        vocab_size=VOCAB, hidden_size=cfg.text_dim, num_hidden_layers=12,
        num_attention_heads=8, intermediate_size=cfg.text_dim * 4,
        max_position_embeddings=77,
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        clip = transformers.CLIPTextModel(ccfg).eval()
    torch.save(clip.state_dict(), os.path.join(clip_dir, "pytorch_model.bin"))
    write_synthetic_tokenizer(clip_dir)
    return pt_path, clip_dir, ckpt


# -- the pipeline -----------------------------------------------------------

class Manifest:
    def __init__(self):
        self.steps = []
        self.ok = True

    def run(self, name, fn):
        t0 = time.time()
        entry = {"step": name}
        try:
            info = fn() or {}
            entry.update({"status": "PASS", **info})
        except Exception as e:  # noqa: BLE001 - the manifest records every failure
            self.ok = False
            entry.update({"status": "FAIL", "error": f"{type(e).__name__}: {e}"})
            traceback.print_exc()
        entry["seconds"] = round(time.time() - t0, 2)
        self.steps.append(entry)
        print(f"[{entry['status']}] {name} ({entry['seconds']}s)"
              + (f" - {entry.get('error')}" if "error" in entry else ""),
              flush=True)
        return entry["status"] == "PASS"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pt", default=None, help="reference model-*.pt")
    ap.add_argument("--clip", default=None, help="local HF CLIP dir")
    ap.add_argument("--out-dir", default="bringup_out")
    ap.add_argument("--synthetic", action="store_true",
                    help="build small synthetic stand-ins")
    ap.add_argument("--torch-oracle", action="store_true",
                    help="synthetic mode at the RELEASE parameter schema: a "
                         "random-weight EMA checkpoint with the exact "
                         "model-180000.pt key layout is written, converted, "
                         "and forward-parity-checked (catches converter "
                         "layout drift before real assets arrive)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args = ap.parse_args(argv)
    if args.torch_oracle:
        args.synthetic = True
    device = resolve_device("cpu" if args.cpu else args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    man = Manifest()
    state = {}

    # 1. assets
    def step_assets():
        if args.synthetic:
            state["cfg"] = small_config(real_shape=args.torch_oracle)
            state["pt"], state["clip"], state["ckpt"] = make_synthetic_assets(
                args.out_dir, state["cfg"])
        else:
            if not args.pt:
                raise ValueError("--pt required (or --synthetic)")
            state["pt"], state["clip"] = args.pt, args.clip
            state["cfg"] = VideoModelConfig()
        if not os.path.isfile(state["pt"]):
            raise FileNotFoundError(f"checkpoint missing: {state['pt']}")
        if state["clip"]:
            for req in ("pytorch_model.bin", "vocab.json", "merges.txt"):
                p = os.path.join(state["clip"], req)
                if not os.path.isfile(p):
                    raise FileNotFoundError(f"CLIP asset missing: {p}")
        return {"pt": state["pt"], "clip": state["clip"]}

    if not man.run("assets", step_assets):
        return finish(man, args)

    # 2. convert
    def step_convert():
        from v2a_tpu_torch.convert.torch_import import convert_video_checkpoint

        out = os.path.join(args.out_dir, "torch-video-model.pt")
        params = convert_video_checkpoint(
            state["pt"], out, config=state["cfg"], clip_path=state["clip"]
        )
        state["converted"] = out
        n = sum(int(v.numel()) for sd in params.values() for v in sd.values())
        if n == 0:
            raise ValueError("conversion produced zero parameters")
        return {"params": n, "out": out, "has_text": "text" in params}

    if not man.run("convert", step_convert):
        return finish(man, args)

    # 3. load (exercises the real-tokenizer fail-fast gate)
    def step_load():
        model = VideoPredModel(state["cfg"], device=device)
        tok_dir = os.path.join(args.out_dir, "tokenizer")
        model.load_converted(
            state["converted"],
            tokenizer_dir=tok_dir if os.path.isdir(tok_dir) else None,
        )
        state["model"] = model
        return {"tokenizer_real": model.tokenizer.is_real, "device": str(device)}

    if not man.run("load", step_load):
        return finish(man, args)

    # 4. tokenizer fidelity
    def step_tokenizer():
        model = state["model"]
        ids, mask = model.tokenizer(PROBE)
        info = {"is_real": model.tokenizer.is_real,
                "probe_len": int(mask.sum())}
        if state["clip"]:
            if not model.tokenizer.is_real:
                raise RuntimeError("CLIP weights present but tokenizer is "
                                   "the hash fallback")
            from v2a_tpu_torch.models.clip_text import HashTokenizer

            hids, _ = HashTokenizer()(PROBE)
            if np.array_equal(ids, hids):
                raise RuntimeError("real tokenizer produced the hash "
                                   "fallback's ids - assets are wrong")
            if int(ids.max()) >= VOCAB:
                raise RuntimeError(f"token id {int(ids.max())} out of vocab")
        return info

    if not man.run("tokenizer", step_tokenizer):
        return finish(man, args)

    # 5. parity (synthetic only: the writer's tensors are in memory)
    def step_parity():
        if "ckpt" not in state:
            return {"skipped": "real-asset mode; parity is covered by "
                               "tests/test_torch_convert.py on the small model"}
        from v2a_tpu_torch.convert.from_jax import video_tree
        from v2a_tpu_torch.convert.torch_import import convert_video_unet, extract_unet_state

        cfg, model = state["cfg"], state["model"]
        with torch.device(device):
            ref = model.build_unet(fused=False).eval()
        ref.load_state_dict(video_tree(convert_video_unet(
            extract_unet_state(state["ckpt"]), channel_mult=tuple(cfg.channel_mult),
            num_res_blocks=cfg.num_res_blocks,
            attention_resolutions=tuple(cfg.attention_resolutions))))
        rs = np.random.RandomState(0)
        b, f, hw = 1, cfg.video_future_horizon, 32
        x = rs.randn(b, 6, f, hw, hw).astype(np.float32).transpose(0, 2, 3, 4, 1)
        t = np.array([3])
        tokens = rs.randn(b, 5, cfg.text_dim).astype(np.float32)
        args_ = (torch.as_tensor(x, device=device), torch.as_tensor(t, device=device),
                 torch.as_tensor(tokens, device=device))
        with torch.no_grad():
            out_ref = ref(*args_).float().cpu().numpy()
            out = model.unet(*args_).float().cpu().numpy()
        err = float(np.abs(out - out_ref).max())
        if not np.isfinite(out).all() or err > 2e-3:
            raise AssertionError(f"forward parity max err {err}")
        return {"max_abs_err": err}

    if not man.run("parity", step_parity):
        return finish(man, args)

    # 6. sample one video
    def step_sample():
        model = state["model"]
        h, w = state["cfg"].image_size
        img01 = np.clip(
            np.random.RandomState(1).rand(1, h, w, 3).astype(np.float32), 0, 1
        )
        v = model.sample_u8(img01, PROBE,
                            torch.Generator(device=device).manual_seed(0)).cpu().numpy()
        want = (1, state["cfg"].video_future_horizon, h, w, 3)
        if v.shape != want:
            raise AssertionError(f"video shape {v.shape} != {want}")
        if v.dtype != np.uint8:
            raise AssertionError(f"video dtype {v.dtype} != uint8")
        np.save(os.path.join(args.out_dir, "bringup_video.npy"), v)
        return {"shape": list(v.shape),
                "mean": round(float(v.mean()), 2)}

    if not man.run("sample", step_sample):
        return finish(man, args)

    # 7. one eval episode (fake env backend; the LIBERO backend slots into
    # the same `Evaluator` surface)
    def step_eval():
        from v2a_tpu_torch.envs.fake import FakeEnvList
        from v2a_tpu_torch.eval.harness import EvalConfig, Evaluator

        model = state["model"]
        cfg = state["cfg"]
        h, w = cfg.image_size
        envs = FakeEnvList(num_tasks=1, img_hw=(h, w))

        def policy_fn(img_obs01, img_goal01):
            return np.zeros((4, 7), np.float32)

        gen = torch.Generator(device=device).manual_seed(7)

        def video_fn(img01, task):
            return model.sample_u8(img01[None], [task], gen)[0].cpu().numpy()

        ecfg = EvalConfig(
            n_seeds=1, eval_n_preds_betw_vframes=2, num_vid_pred_per_ep=1,
            use_vid_first_n_frames=2, n_acts_per_pred=4, vis=False,
        )
        ev = Evaluator(
            envs, policy_fn, video_fn,
            video_horizon=cfg.video_future_horizon, config=ecfg,
        )
        task = envs.task_list[0]
        env_idx = envs.seed_sets[task][0]
        envs.init_1_given_env(task, env_idx, e_seed=0)
        res = ev.eval_1_env(task, "agent", env_idx)
        envs.close_1_given_env(task, env_idx)
        if len(res.imgs) < 2:
            raise AssertionError("episode produced no rollout frames")
        return {"episode_frames": len(res.imgs),
                "videos_predicted": len(res.pred_videos)}

    man.run("eval", step_eval)
    return finish(man, args)


def finish(man: Manifest, args) -> int:
    manifest = {"pass": man.ok, "steps": man.steps}
    path = os.path.join(args.out_dir, "bringup_manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps(manifest))
    print(f"[bringup] {'PASS' if man.ok else 'FAIL'} - manifest at {path}")
    return 0 if man.ok else 1


if __name__ == "__main__":
    sys.exit(main())
