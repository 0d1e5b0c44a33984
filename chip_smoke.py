#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (`v2a_tpu_torch`) through its serving path,
its train steps and its online training loop on one NVIDIA card and holds
its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit, torch and CUDA versions;
  2. builds every kernel in `v2a_tpu_torch/csrc/` with nvcc (sm_90a), one
     nvcc per source, all started together;
  3. every kernel against its plain version in bf16 at every shape the
     release-width U-Net forward (B=8) gives it, under eight routings,
     recorded from one forward of each: the shipped padded-stream routing
     (K1, K2, K3, K4a, K4b, K5), the unpadded one (K1, K2), `padded_k8_k9`
     (the padded routing with K8 at the downsamples into a padded level and
     K9 in every attention block), `padded_k8_k9_wide` (the same with
     attention also at ds 4 and 64-channel heads: K9 at 32^2 with 1,024
     tokens too), `plain_k7` (the non-fused forward with K7 in its
     GroupNorms), `spatial_k10_k11` (the K1 gate off: K10 at the 3x3 convs,
     K11 at the temporal convs) and `padded_k12` (the padded routing with K12
     in its convs without a skip fold), `padded_mega_off` (the shipped
     routing with `mega_kernel=False`: K4a -> K4b where K3 runs),
     `spatial2_deep` (`spatial2_max_s=512`: K1 at 16^2 and 8^2 only, no
     padded level), `padded_upconv_off` (`upconv=False`: the upsample convs
     into a padded level through K3 or K4a -> K4b where K5 runs) and
     `padded_entry_pad` (`entry_pad=True`: the 6-channel entry conv through
     K3, its channels zero-extended to 32 by the wrapper). Every shape on three input sets,
     each seeded by a stable hash of the shape's signature (`seed_of`), the
     worst case kept. Gates derived from the arithmetic: outputs within one
     bf16 ulp (K3, K12: plus the carried conv-output difference; K9: plus
     the carried head-output difference), statistics by `stats_ok`.
     Padded-stream inputs carry NaN in their pad rows and outputs must have
     exactly zero pad cols (K9's: every pad position); K3 and K12 one
     rounding at a time against their own conv half (`conv_out`: one ulp of
     the plain conv; the output one ulp of the plain temporal conv of it and
     of K4b of it), and against K4a -> K4b within one ulp plus the carried
     conv-half difference; K1-K12 two launches bit-equal; K4a with one part
     bit-equal to K1 on the interior (it runs K1's body), K10 bit-equal to
     K1 without an affine (K1's entry in mode 0), K8's interior bit-equal
     to K1 on its input's interior at even pixels (K1's body at stride 2),
     K5's four parity planes each bit-equal to K1 on its input's interior
     with that parity's collapsed weights at their four taps (K1's body
     with the parity tap sets), K4b with no skip part, on a padded copy of
     K2's input, bit-equal to K2 at every K2 signature (it runs K2's body),
     and K11's output and statistics bit-equal to K2's on the same tensor
     (K2's launch on x's own memory); each K3 / K12 row logs its tile
     plan (pixels, cluster along D, grid), each K1, K4a, K10, K8 and K5 row
     its `affine_conv_plan` (K8's at stride 2, K5's with its parities),
     each K2, K4b and K11 row its `temporal_conv_plan` (the C side's plan
     must be the same), each K9
     row its `attention_plan`, each K7 row its `group_norm_plan` (threads,
     lanes, rows and CTAs per sample, grid, shared memory), and a B=1 grid
     of K12, K4a, K8, K9, K10, K5, K2, K4b, K11 or K7 below one CTA per SM
     fails (K2 / K4b / K11: where a tile larger than 16 pixels was taken).
     Each shape is
     timed on its first input set: kernel, plain version and PyTorch
     yardstick (`library_ms`); at K3's and K12's shapes also the same work
     as K4a -> K4b;
  4. one release-width U-Net forward (B=8, F=7, 128^2, bf16) per routing:
     launch counts per kernel (the JAX package's with the flags set), each
     against the port's bf16 plain path and a float32 plain reference, and
     the eleven routings' and the plain path's times in turns (padded
     against padded_mega_off: K3 against the split end to end);
  5. serves requests through the shipped routing: `VideoPredModel.sample`
     (100-step ancestral chain) per task, then `DiffusionPolicy.
     predict_action` (DDIM-8) on (current frame, first goal frame); then one
     goal-video request through each of `padded_k8_k9`, `plain_k7`,
     `spatial_k10_k11` and `padded_k12` (`VideoModelConfig(downconv=True,
     attn_kernel=True)`, `VideoModelConfig(fused=False,
     use_pallas_gn=True)`, `VideoModelConfig(spatial2_min_ch=0,
     pallas_spatial=True, tconv_hw=True)`,
     `VideoModelConfig(stream_kernel=True)`); checks shapes, range,
     finiteness and each run's launch counts, then holds every kernel
     against its plain version at the shapes these serving runs gave it;
  6. trains: a release-width bf16 `VideoModelTrainer` at B=4 on synthetic
     uint8 clips, through `train()`, in three routings: train_fused with K6
     as the wgrad (K1 forward, K1 dgrad, K6), train_fused with the library
     wgrad (the JAX default), and the plain path. Per routing: one
     gradient on a fixed batch and noise, held against a float32 plain
     step (each routing's relative error, whole vector and worst leaf, at
     most twice the bf16 plain path's), then a warm-up and timed steps (ms
     per step by CUDA events, launches per step, finite loss and weights).
     Then K1 and K6 against their plain versions at every shape one train
     step gave them, and K6 at six small and edge shapes (`K6_SMALL`); both
     two launches bit-equal;
     each K6 row logs its `wgrad_plan` (pixel tile, chunks, grid) and its
     time beside `conv2d_weight`'s and its bound, each K1 row its
     `affine_conv_plan` (pixels, output channels per CTA, grid) and its
     forward and dgrad calls apart;
  7. trains the policy: `make_train_step(policy.loss, fused_clip_adamw,
     EMAConfig())` at the release batch (64), bf16 compute, one warm-up and
     three timed steps, the peak memory, finite loss and weights;
  8. the online loop: `train/build.py::build_experiment` from the port's
     copy of the release config (`config/libero/lb_tk8_65to72.py`, full
     widths) with the cuts of `ONLINE_OVERRIDES` (the fake env's 8 tasks at
     128^2, live random episodes, one guided cycle in 8 train steps, smaller
     replay stores), then `OnlineTrainer.train()`: the cycle's B=8 goal
     videos through the padded routing (its launches exactly 100 release
     forwards', nothing launched outside it), the EMA policy's DDIM-8
     predictions in the rollouts, B=64 train steps from the native store
     through the prefetcher; the video buffer's episodes, finite losses,
     `save` and `load` into a fresh trainer bit-equal, the native store's
     hindsight batch equal to the Python backend's; then the eval entry
     point (`scripts/eval.py` on the run's workdir: the snapshot's one seed
     per task and one goal video per episode). Then the concurrency, each
     run's counts zeroed just before it and read just after: the eval entry
     point with `--workers 8` on the same workdir (8 spawned env workers,
     8 episodes in lock-step, launches exactly one B=8 chain's); a pool
     cycle (`n_env_workers=8` through `build_experiment`: one B=8 chain,
     then lock-step rounds of one B=8 DDIM-8 prediction each; launches
     exactly 100 B=8 forwards', 8 valid episodes, one B=8 call a round); a
     pipelined and overlapped `train()` over two guided cycles (`PIPELINED_
     OVERRIDES`: the cycles on a worker thread, each cycle's goal videos a
     stream started in the cycle before and pumped behind its policy calls;
     16 episodes, no explore thread or open env left, finite losses, and
     after the last stream is pumped out exactly 300 B=8 forwards'); and
     the stream gate (`sample_u8_stream` bit-equal to `sample_u8` on the
     release U-Net, B=2, a 10-step ancestral chain); the kernels at any
     signature these runs gave them that phase 3 did not hold. Logged with
     the card's name and power limit: s per cycle and per goal-video call,
     predictions and ms each, env steps and host ms each, ms per train step
     and per hindsight batch, peak memory, eval s per episode; the pool
     cycle's rounds and ms per B=8 prediction beside the serial cycle's, the
     pipelined cycles' s, join waits and train steps, the parallel eval's
     wall s beside the serial one's;
  9. the video entry points: `scripts/train_video.py` (`run`, the
     release width at B=4 on the card, on synthetic clips: the card
     machine has no h5py) for 2 steps (K1's launches per step phase 6's
     train_fused step's, finite losses), then `--resume --sample-after` in a
     fresh call (step, weights, EMA and optimizer state bit-equal; the
     validation sample on 2 tasks exactly 100 padded B=2 forwards'
     launches), then `scripts/sample_video.py --smoke 1` (`videos.npy` and
     the PNG strips); each part's wall time on its own line, and one line
     saying that the H5 modules are not run here;
  10. the reference checkpoints: a release-schema reference video
     checkpoint (U-Net only, float32, the trainer layout) from the port's
     writer, `scripts/convert_ckpt.py --kind video`, `train/build.py::
     make_video_model` on the release config pointed at the output (the
     parameters bit-equal to a model given the same f32 values in memory,
     the load's peak card memory logged and gated), `scripts/sample_video.py
     --ckpt` (B=1, the 100-step ancestral chain, the shipped padded routing:
     bit-equal to that model's video with the same generator, its launches
     exactly 100 padded forwards'), a converted file with CLIP text weights
     refused without the real tokenizer (and where `transformers` is
     installed, loaded with it), and a release reference policy checkpoint
     through `convert_ckpt --kind policy` (one B=1 DDIM-8 `predict_action`
     equal to the source policy's); each part's seconds beside the card's name and
     power limit;
  11. the model families: Thor, Bridge and MW-flow (`models/
     env_variants.py`) at their presets' widths, bf16: a B=8 forward through
     the shipped routing, `padded_k8_k9`, `plain_k7`, `spatial_k10_k11`,
     `padded_k12` and the plain path, gated against float32 as phase 4
     gates the release forward, with `VARIANT_FORWARD`'s launches; one B=1
     request through `VideoPredModel.sample` (`FAMILY_TIMESTEPS` steps,
     exactly that many forwards' launches); for Thor and Bridge a B=4 train step through train_fused
     with K6 against float32 (`VARIANT_TRAIN_STEP`'s launches); every kernel
     signature these runs gave that no earlier phase held, against its
     plain version on three input sets with its plan; the xattn backbone at
     the release widths (a B=8 forward against float32, a B=1 chain,
     `scripts/train_video.py --backbone xattn` for 2 steps at B=3 and
     `--resume --sample-after` bit-equal; both chains `FAMILY_TIMESTEPS`
     steps); the transformer denoiser (B=1 and B=64
     forwards against float32, a backward and an AdamW step); its wall time
     on its own line (libero, mw and thor_luo are the release config);
  12. the guided image family (`v2a_tpu_torch/guided/`, its seven CLIs in
     `v2a_tpu_torch/scripts/guided/`), bf16, at the published widths of
     openai/guided-diffusion's README (the 64x64 model, its classifier, the
     64 -> 256 upsampler; weights from a seed): the 64x64 model's B=16
     forward with every parameter drawn against float32 (max error over
     the float32 output's std under 0.1), then through `main(argv)`:
     `image_train` (3 steps at B=8, resumed for 1, the restored weights
     bit-equal to the snapshot), `image_sample` (B=16, 25 respaced steps,
     ancestral and DDIM), `classifier_train` (2 steps at B=8) and
     `classifier_sample` (B=8; the first guidance gradient finite and
     non-zero), `super_res_train` (2 steps at B=4 or the largest that fits,
     then a step with `--use_checkpoint True`: the same loss, a lower peak),
     `super_res_sample` on the samples (6 at B=4, 256^2), `image_nll` (4
     images); finite losses, the npz files' shapes and dtypes, and no
     kernel of the port launched (the JAX nets reach no Pallas kernel); ms
     per forward and per step, s per sample batch, peak memory, the
     phase's wall time;
  13. the lab kernels: the port's perf lab (`python -m
     v2a_tpu_torch.scripts.perf_lab winobench2 tconvbench2`), the path that
     launches K14 and K15; K13 against K3 at every K3 signature of the
     padded forward, bit for bit (K3's mainloop, its copies by TMA); then
     K13 (bit-equal to K3, K3's gates through K3's conv half, two launches
     bit-equal, timed in turns with K3, and against K4a -> K4b, its copy
     route logged), K14 at every K10 signature of `spatial_k10_k11` and
     the lab's (one ulp of its plain version; its difference from K10
     reported), K15 at the lab's three shapes (bit-equal to K2 with a zero
     bias: K2's launch) and K9 at head widths 8, 40, 80 and 160 (C 640),
     each on three input sets; then the perf lab's paths at release width
     (`LAB_FORWARDS`: the five ablations and four fused routings, each
     forward's launches against `LAB_PER_FORWARD`, outputs finite;
     `trace_chain` at `LAB_CHAIN_STEPS` DDIM steps and
     `trace_vtrain:4:tfused`, each naming every hand kernel its routing
     launches (`LAB_TRACE_KERNELS`) by its C entry with a nonzero device
     time, 0 < busy <= wall; `affconvbench`, `megabench:L1`,
     `tconvbench`);
  15. (run before 14's lines) the mesh on `torch.distributed` and
     rematerialisation (`mesh_and_remat`): on a one-rank NCCL group, a B=4
     train_fused step on a (dp=1, tp=1) mesh bit-equal to the step without
     a mesh, `shard_for_mesh` + a B=2 chain bit-equal to the chain without
     (100 padded forwards' launches), one guided cycle through
     `build_experiment` with `mesh_axes=("auto_dp",)` on phase 8's cut
     config (100 B=8 forwards', the buffer digest check passed); with more
     than one card a dp step over 4 (or 2) of them against the single-card
     step (one line saying it did not run otherwise); the B=4 step under
     no remat, "blocks", "levels", "mxu" and "blocks" with train_fused (the
     loss bit-equal, the gradient within `REMAT_GRAD_BOUND`, K1's launches
     the step's plus the recomputed ResBlock forwards', ms and peak GiB,
     "blocks" and "levels" below the peak without remat), and
     `scripts/train_video.py --backbone xattn --use-checkpoint` at B=4;
  16. (run before 14's lines) the last modules (`last_modules`): (a)
     `python -m v2a_tpu_torch.scripts.evaluate_samples` on phase 12's
     ancestral `image_sample` batch against its 64 synthetic images, with
     `--inception` on a synthetic `inception_v3` state dict (an fc head
     added) and with the random conv trunk, both processes at once (the JAX
     CLI's keys, finite metrics), the card's Inception features of 8 images
     within 1e-3 of their std of the CPU forward (TF32 off), ms per B=64
     float32 Inception forward; (b) the trunk's pools at the release
     policy's pool input (the packed forward bit-equal to `F.max_pool2d`,
     its gradient within one bf16 ulp; `mask_bwd` reaching every tied
     position) and a B=64 policy step per `pool`; (c) the release U-Net
     with `use_scale_shift_norm` (its own weights): B=8 forwards, unpadded
     fused (K1 73, K2 63) and plain, within twice the bf16 plain path's
     error of float32, in turns; the padded routing refuses it; (d) B=4
     `VideoModelTrainer` steps with K6 at `wgrad_min_s` 0 and 4096, with
     `train_dgrad_kernel=False` and with `train_tconv_dot=True` (and the
     plain step): launches per step, gradients through phase 6's gate, ms
     per step; every kernel signature of (c) and (d) not held before,
     against its plain version; the phase's wall time (budget 75 s);
  17. (run after 16, before 14's lines) the last entry points
     (`last_entry_points`): (a) `python -m
     v2a_tpu_torch.scripts.verify_onchip`'s three gates through its
     functions: the release U-Net with N(0, 0.02) weights under its four
     routings (`unfused`, `fused_nopad`, `default`, `pallas_attn`), a B=8
     forward each (launches `VERIFY_PER_FORWARD`) and a 100-step ancestral
     chain each at B=2 (`ENTRY_CHAIN_B`, not the CLI's 8: the script's time
     limit; exactly 100 forwards' launches), through the JAX script's gates;
     `--train` (the release policy's gradients at B=16, three clip + AdamW
     updates: `fused_clip_adamw` against `torch.optim` and host float64);
     `--train-fused` with the library wgrad and with K6 (launches
     `VERIFY_TRAIN_FUSED`); every kernel signature these runs gave that no
     earlier phase held, against its plain version on three input sets;
     (b) `python -m v2a_tpu_torch.scripts.bringup --synthetic
     --torch-oracle` (the release parameter schema) in this process, every
     step PASS and no kernel launched, then `--pt <missing>`: one step,
     `assets` FAIL naming the path; (c) one line saying that the LIBERO
     backend is not run, with its import error; the phase's wall time
     (budget 60 s);
  14. prints the `kernels` JSON line, then the device line last.

Weights are random from a seed (phase 10: the writer's reference
checkpoints, from the same seed); text goes through the offline
HashTokenizer.
The env workers start by `spawn` with the main module hidden, so they do
not import this file; its top level does no CUDA work all the same, and
everything runs from `main()`.
Per-shape results go to `chiprun_out/chip_smoke_shapes.json`; the trainers
write their checkpoints under `logs/chip_smoke_train/`,
`logs/chip_smoke_online/` and `logs/chip_smoke_video/`, phase 10 its
reference and converted checkpoints under `logs/chip_smoke_ckpt/`, phase 11
its trainers' under `logs/chip_smoke_family/`, phase 12 its images,
snapshots and samples under `logs/chip_smoke_guided/` (its ancestral sample
batch to `logs/chip_smoke_eval/` for phase 16), phase 17 its bring-up
assets under `logs/chip_smoke_bringup/`, and the script removes them.
"""

import contextlib
import dataclasses
import gc
import inspect
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
N_REQUESTS = 2
TASKS = [
    "put both the alphabet soup and the tomato sauce in the basket",
    "open the top drawer and put the bowl inside",
]
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PEAK_F32 = 67e12  # H100 SXM float32 rate outside the tensor cores (K7's operations)
# the U-Net routings of phases 3-5: VideoModelConfig arguments (`_routed_unet`)
ROUTINGS = {
    "padded": dict(fused=True),
    "unpadded": dict(fused=True, padded_stream=False),
    "padded_k8_k9": dict(fused=True, downconv=True, attn_kernel=True),
    "plain_k7": dict(fused=False, use_pallas_gn=True),
    "spatial_k10_k11": dict(fused=True, spatial2_min_ch=0, pallas_spatial=True, tconv_hw=True),
    "padded_k12": dict(fused=True, stream_kernel=True),
    # padded_k8_k9 with attention also at ds 4 and 64-channel heads: K9 at the
    # padded 32^2 level (1,024 tokens, C 384, 6 heads), 16^2 (C 512, 8 heads)
    # and 8^2 (C 640, 10 heads); its own weights (more attention blocks)
    "padded_k8_k9_wide": dict(fused=True, downconv=True, attn_kernel=True,
                              attention_resolutions=(4, 8, 16), num_head_channels=64),
    # the shipped routing with the mega-kernel switch off (V2A_MEGA_KERNEL=0):
    # K4a -> K4b where K3 runs, the split against the fused kernel end to end
    "padded_mega_off": dict(fused=True, mega_kernel=False),
    # the K1 gate up to H*W 512 (V2A_SPATIAL2_MAX_S=512): K1 at 16^2 and 8^2
    # only, no padded level, the library's convs and K2 above
    "spatial2_deep": dict(fused=True, spatial2_max_s=512),
    # the upsample convs into a padded level without K5 (V2A_UPCONV=0):
    # nearest-2x, pad, then K3 or K4a -> K4b
    "padded_upconv_off": dict(fused=True, upconv=False),
    # the 6-channel entry conv on the padded stream (V2A_ENTRY_PAD=1): K3 at
    # C=6, its channels zero-extended to 32 by the wrapper
    "padded_entry_pad": dict(fused=True, entry_pad=True),
}
# the routing arguments that change the U-Net's parameters
ARCH = ("attention_resolutions", "num_head_channels")
# launches per release forward of each routing (tests/test_torch_padded.py
# traces the same counts on the meta device, tests/test_torch_serving_routes.py
# the JAX package's)
EXPECTED_PER_FORWARD = {
    "padded": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30,
               "fused_conv_tconv_padded": 16, "fused_affine_conv3x3_padded": 14,
               "temporal_conv_padded": 17, "fused_upconv3x3_padded": 3},
    "unpadded": {"fused_affine_conv3x3": 73, "temporal_conv_fused": 63},
    "padded_k8_k9": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 28,
                     "fused_conv_tconv_padded": 16, "fused_affine_conv3x3_padded": 14,
                     "temporal_conv_padded": 19, "fused_upconv3x3_padded": 3,
                     "fused_downconv3x3_padded": 2, "fused_spatial_attention_padded": 11},
    "plain_k7": {"fused_group_norm_silu": 66},
    "spatial_k10_k11": {"spatial_conv3x3": 73, "temporal_conv_fused_hw": 63},
    "padded_k12": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30,
                   "fused_conv_tconv_stream": 19, "fused_conv_tconv_padded": 5,
                   "fused_affine_conv3x3_padded": 6, "temporal_conv_padded": 9,
                   "fused_upconv3x3_padded": 3},
    "padded_k8_k9_wide": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 28,
                          "fused_conv_tconv_padded": 16, "fused_affine_conv3x3_padded": 14,
                          "temporal_conv_padded": 19, "fused_upconv3x3_padded": 3,
                          "fused_downconv3x3_padded": 2, "fused_spatial_attention_padded": 16},
    "padded_mega_off": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30,
                        "fused_affine_conv3x3_padded": 30, "temporal_conv_padded": 33,
                        "fused_upconv3x3_padded": 3},
    "spatial2_deep": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 63},
    "padded_upconv_off": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30,
                          "fused_conv_tconv_padded": 17, "fused_affine_conv3x3_padded": 16,
                          "temporal_conv_padded": 16},
    "padded_entry_pad": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 29,
                         "fused_conv_tconv_padded": 17, "fused_affine_conv3x3_padded": 14,
                         "temporal_conv_padded": 17, "fused_upconv3x3_padded": 3},
}
# the routings served one goal-video request each in phase 5, beside the
# shipped one
NEW_SERVED = ("padded_k8_k9", "plain_k7", "spatial_k10_k11", "padded_k12")
TRAIN_B, TRAIN_STEPS = 4, 3  # timed steps after one warm-up step
TRAIN_ROUTINGS = {
    "k6": dict(train_fused=True, wgrad_kernel=True),
    "library_wgrad": dict(train_fused=True, wgrad_kernel=False),
    "plain": dict(train_fused=False),
}
# launches per B=4 release train step: 58 convs take the train_fused routing
# (tests/test_torch_train.py traces the same counts on the meta device)
EXPECTED_PER_TRAIN_STEP = {
    "k6": {"fused_affine_conv3x3": 116, "wgrad_conv3x3": 58},
    "library_wgrad": {"fused_affine_conv3x3": 116},
    "plain": {},
}
# K9's head widths off the release routings, held in the lab phase
K9_WIDTHS = (8, 40, 80, 160)
# phase 13, the perf lab's paths (`v2a_tpu_torch/scripts/perf_lab.py`) at
# release width: its forward names, their launches per forward (traced on
# the meta device by tests/test_torch_perf_lab.py), its traces with the hand
# kernels each routing launches, its benches
LAB_FORWARDS = ("base", "no_attn", "no_temporal", "no_gn", "conv_only", "fused",
                "fused_default", "fused_attn", "fused_upconv")
LAB_PER_FORWARD = dict(
    {name: {} for name in LAB_FORWARDS[:5]},
    fused={"temporal_conv_fused": 63},
    fused_default=EXPECTED_PER_FORWARD["padded"],
    fused_attn=dict(EXPECTED_PER_FORWARD["padded"], fused_spatial_attention_padded=11),
    fused_upconv=EXPECTED_PER_FORWARD["padded"])
LAB_ITERS = 3  # timed forwards after one warm forward
LAB_CHAIN_STEPS = 4  # DDIM steps of trace_chain
LAB_TRACE_KERNELS = {
    "trace_chain": tuple(EXPECTED_PER_FORWARD["padded"]),
    "trace_vtrain:4:tfused": ("fused_affine_conv3x3", "wgrad_conv3x3"),
}
LAB_BENCHES = ("affconvbench", "megabench:L1", "tconvbench")
# K6 also at small shapes, where a lost pixel or a wrong border tap shows
# above its gate, and at the edges of its tiling and plan: W below the 8x8
# tile, H and W not multiples of it, chunk boundaries mid-sample and a
# ragged last chunk (with 128- and 64-wide output blocks):
# (N, H, W, C), D, affine, silu
K6_SMALL = [((2, 8, 8, 128), 128, False, False), ((2, 8, 8, 128), 128, True, True),
            ((2, 4, 5, 64), 64, True, True), ((3, 5, 7, 64), 192, False, False),
            ((5, 48, 40, 128), 128, True, True), ((4, 40, 48, 128), 192, True, True)]
# the policy train step: the release batch (`buf_sample_batch_size`) and the
# timed steps after one warm-up step
POLICY_B, POLICY_STEPS = 64, 3
# the online loop (phase 8): the port's copy of the release config with
# these cuts, each logged with its reason; one guided cycle (step 4) in
# ONLINE_STEPS train steps
ONLINE_STEPS = 8
ONLINE_OVERRIDES = {
    "dataset": "fake-8tk-v0",
    "env_backend": "fake",
    "trainer.rand_explo_type": "live",
    "trainer.randsam_path": "",
    "trainer.num_init_rand_ep_per_tk": 2,
    "explore.act_down_val": -0.1,
    "trainer.init_rand_steps": 3,
    "trainer.video_explo_freq": 4,
    "trainer.rand_explo_freq": 10 ** 9,
    "trainer.n_train_steps": ONLINE_STEPS,
    "trainer.save_freq": ONLINE_STEPS,
    "trainer.log_freq": 1,
    "trainer.max_episodes_rand": 16,
    "trainer.max_episodes_vid": 16,
    "trainer.checkpoint_buffers": True,
    "eval.n_seeds": 1,
    "eval.num_vid_pred_per_ep": 1,
    "eval.eval_n_preds_betw_vframes": 1,
}
ONLINE_WHY = {
    "dataset": "FakeEnvList, 8 tasks at 128^2: LIBERO is not installed",
    "env_backend": "the fake world",
    "trainer.rand_explo_type": "live random episodes: no H5 file in the repository",
    "trainer.randsam_path": "no H5 file",
    "trainer.num_init_rand_ep_per_tk": "one live episode per task before the loop",
    "explore.act_down_val": "a fixed descent, as in fake_smoke: the per-task table is "
                            "LIBERO's tuning",
    "trainer.init_rand_steps": "schedule: the cycle at step 4",
    "trainer.video_explo_freq": "schedule: one cycle",
    "trainer.rand_explo_freq": "schedule: no further random round",
    "trainer.n_train_steps": "8 train steps",
    "trainer.save_freq": "a checkpoint at steps 1 and 8",
    "trainer.log_freq": "every step",
    "trainer.max_episodes_rand": "the native store preallocates max_episodes x 700 "
                                 "frames (1,200 x 700 x 128^2 x 3 B = 41 GB at release)",
    "trainer.max_episodes_vid": "likewise (600: 21 GB)",
    "trainer.checkpoint_buffers": "the buffers go into the checkpoint, for the resume gate",
    "eval.n_seeds": "the eval: one seed per task",
    "eval.num_vid_pred_per_ep": "the eval: one goal video per episode",
    "eval.eval_n_preds_betw_vframes": "the eval: 1 prediction per goal frame (5 in the "
                                      "release; cut to hold the script's time)",
}
ONLINE_BATCH_REPS = 20  # hindsight batches timed per backend
# phase 8's concurrency runs, on the same cut config: a pool cycle on
# POOL_WORKERS spawned env workers (one per task), a pipelined and
# overlapped train() over PIPELINED_CYCLES guided cycles (steps 4 and 8),
# the eval entry point with --workers POOL_WORKERS, and the stream gate: the
# release U-Net's chain of STREAM_STEPS ancestral steps at B=STREAM_B as a
# stream against sample_u8 (a 10-step chain keeps the gate cheap)
POOL_WORKERS = 8
PIPELINED_CYCLES = 2
# phase 9, the video entry points: `scripts/train_video.py` at release width
# and B=4 on synthetic clips (the card machine has no h5py), this many steps,
# then resumed with a validation sample per task; `scripts/sample_video.py
# --smoke 1`
VIDEO_STEPS = 2
PIPELINED_OVERRIDES = {
    "n_env_workers": POOL_WORKERS,
    "trainer.pipeline_explore": True,
    "trainer.overlap_explore": True,
    "trainer.n_train_steps": 4 * PIPELINED_CYCLES + 1,
    "trainer.save_freq": 10 ** 9,
}
PIPELINED_WHY = {
    "n_env_workers": "8 spawned env workers, one per task",
    "trainer.pipeline_explore": "the next cycle's goal videos as a stream pumped behind the "
                                "policy calls",
    "trainer.overlap_explore": "the cycles on a worker thread beside the train steps",
    "trainer.n_train_steps": "two guided cycles, spawned at steps 4 and 8",
    "trainer.save_freq": "no checkpoint but step 1's: a save joins the cycle in flight",
}
STREAM_STEPS, STREAM_B, STREAM_CHUNKS = 10, 2, 4
ROOT = os.path.dirname(os.path.abspath(__file__))
ONLINE_LOGS = os.path.join(ROOT, "logs", "chip_smoke_online")
VIDEO_LOGS = os.path.join(ROOT, "logs", "chip_smoke_video")
# phase 10, the reference checkpoints: written, converted and loaded here
CKPT_LOGS = os.path.join(ROOT, "logs", "chip_smoke_ckpt")
CKPT_MILESTONE = 180000
# the load's peak card memory over the parameters' bytes: a second copy of
# the weights on the card would make it 2
CKPT_PEAK_SLACK = 1.25
# phase 11, the model families: the environment variants whose presets are
# not the release config (`models/env_variants.py`; libero, mw and thor_luo
# are, and phases 4-5 run them) under these routings of phase 3, B=8
# forwards, a B=1 chain, and a B=4 train step for the trained ones; the
# cross-attention backbone at the release widths; the transformer denoiser
FAMILY_VARIANTS = ("thor", "bridge", "mw_flow")
FAMILY_ROUTINGS = ("padded", "padded_k8_k9", "plain_k7", "spatial_k10_k11", "padded_k12")
FAMILY_B = 8
FAMILY_LOGS = os.path.join(ROOT, "logs", "chip_smoke_family")
# launches per forward of each variant and routing (tests/test_torch_variants.py
# pins the same counts on the meta device and against the JAX package's)
VARIANT_FORWARD = {
    "thor": {
        "padded": {"fused_affine_conv3x3": 22, "temporal_conv_fused": 21,
                   "fused_conv_tconv_padded": 21, "fused_affine_conv3x3_padded": 7,
                   "temporal_conv_padded": 9, "fused_upconv3x3_padded": 2},
        "padded_k8_k9": {"fused_affine_conv3x3": 22, "temporal_conv_fused": 20,
                         "fused_conv_tconv_padded": 21, "fused_affine_conv3x3_padded": 7,
                         "temporal_conv_padded": 10, "fused_upconv3x3_padded": 2,
                         "fused_downconv3x3_padded": 1, "fused_spatial_attention_padded": 8},
        "plain_k7": {"fused_group_norm_silu": 55},
        "spatial_k10_k11": {"spatial_conv3x3": 60, "temporal_conv_fused_hw": 51},
        "padded_k12": {"fused_affine_conv3x3": 22, "temporal_conv_fused": 21,
                       "fused_conv_tconv_stream": 19, "fused_conv_tconv_padded": 5,
                       "fused_affine_conv3x3_padded": 4, "temporal_conv_padded": 6,
                       "fused_upconv3x3_padded": 2},
    },
    "bridge": {
        "padded": {"fused_affine_conv3x3": 19, "temporal_conv_fused": 18,
                   "fused_affine_conv3x3_padded": 8, "temporal_conv_padded": 9,
                   "fused_upconv3x3_padded": 1},
        "padded_k8_k9": {"fused_affine_conv3x3": 19, "temporal_conv_fused": 18,
                         "fused_affine_conv3x3_padded": 8, "temporal_conv_padded": 9,
                         "fused_upconv3x3_padded": 1, "fused_spatial_attention_padded": 8},
        "plain_k7": {"fused_group_norm_silu": 55},
        "spatial_k10_k11": {"spatial_conv3x3": 20, "temporal_conv_fused_hw": 19},
        "padded_k12": {"fused_affine_conv3x3": 19, "temporal_conv_fused": 18,
                       "fused_conv_tconv_stream": 4, "fused_affine_conv3x3_padded": 4,
                       "temporal_conv_padded": 5, "fused_upconv3x3_padded": 1},
    },
    # the release U-Net's counts: neither the 5-channel entry conv nor the
    # 2-channel output conv takes a kernel
    "mw_flow": {r: EXPECTED_PER_FORWARD[r] for r in FAMILY_ROUTINGS},
}
# launches per B=4 train step through train_fused with K6 (K1's forwards and
# dgrads together), for the variants phase 11 trains
VARIANT_TRAIN_STEP = {"thor": {"fused_affine_conv3x3": 96, "wgrad_conv3x3": 48},
                      "bridge": {"fused_affine_conv3x3": 30, "wgrad_conv3x3": 15}}
# the xattn backbone's and the transformer's bf16 forward: max |bf16 - f32|
# over the float32 output's std at most this (the release forward's plain
# bf16 path strays about 6e-2, PERF.md section 7)
FAMILY_ERR_BOUND = 0.1
# less by one while a step does not fit the card: B=4 runs out of memory
# without remat, so the run starts at 3; phase 15 trains B=4 with
# --use-checkpoint
XATTN_TRAIN_B = 3
# the depth of phase 11's chains (each family's request, xattn's request and
# --sample-after): 25 steps of a 25-step schedule, cut from the release's 100
# to hold the script's time
FAMILY_TIMESTEPS = 25
TFD_BATCHES = (1, 64)


def _rk():
    """The port's kernel registry and launch counts, K1-K9 (imported once
    main() has checked for the card and the checkout)."""
    from v2a_tpu_torch.ops import resblock_kernels as rk
    return rk


def launch_counts():
    return dict(_rk().launches)


def zero_launches():
    counts = _rk().launches
    for name in counts:
        counts[name] = 0


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps=10, warm=2):
    """Mean ms per call over `reps` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def within_one_ulp(got, want, extra=0.0):
    """bf16: kernel and plain version sum the same rounded products in float32
    in another order, so the final rounding may differ by one unit in the
    last place (2^-7 of the value at most); near zero an absolute 1e-3 of
    the output's std absorbs the float32 summation noise. `extra`: a further
    per-element allowance (K3's, see `check_k3`). Returns (ok, max|err|,
    max|err|/std, elements beyond the strict one-ulp gate)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    std = want.std()
    tol = want.abs() * 2.0 ** -7 + 1e-3 * std
    bad = int((err > tol + extra).sum())
    if bad:
        log(f"[kernels] {bad} of {want.numel()} elements beyond the gate")
    return bad == 0, float(err.max()), float(err.max() / std), int((err > tol).sum())


def check_stream(got, want, hw, extra=0.0):
    """A padded-stream output: pad cols of the interior rows exactly zero,
    the interior within one ulp of the plain version (whose pad rows hold
    NaN)."""
    h, w = hw
    rows = got[..., 1:h + 1, :, :]
    if bool(rows[..., 0, :].any()) or bool(rows[..., w + 1:, :].any()):
        log("[kernels] nonzero pad cols")
        return False, float("nan"), float("nan"), -1
    return within_one_ulp(rows[..., 1:w + 1, :], want[..., 1:h + 1, 1:w + 1, :], extra)


def stats_rel_err(got, want):
    """Sum and sum of squares (the second last axis), each relative to its
    largest magnitude."""
    return max(float((got[..., i, :] - want[..., i, :]).abs().max()
                     / want[..., i, :].abs().max()) for i in range(2))


def stats_ok(got, want, y_got, y_want, rounded=True):
    """Statistics (B, F, 2, C) (or (N, 2, C)) that a kernel takes of its own
    output y_got, against those its plain version takes of y_want. Only the
    order of float32 sums and the accepted output differences separate them,
    so the gate is derived from those: within 1e-4 of the largest float32
    sum of the kernel's own output (only the summation order differs), and
    within 1e-3 of the plain statistics' largest magnitude plus what the
    output differences move the sums by (sum_s |y_k - y_p| and
    sum_s |y_k^2 - y_p^2|). At S = 64 a few one-ulp roundings of the output
    move a sum by more than 1e-3 of its largest value (1.3e-3 seen for K11
    at 64x8x7x640 with a residual, 1.1e-3 for K2 at the same shape).
    `rounded=False` (K9): the statistics are of the float32 output before
    its one rounding, each element within half an ulp (2^-8 |y|) of the
    rounded one, so both bounds also take those half-ulps. Returns (ok,
    relative error against the plain statistics)."""
    lead = got.shape[:-2]
    yk = y_got.float().reshape(*lead, -1, got.shape[-1])
    yp = y_want.float().reshape(yk.shape)
    s_ax = yk.dim() - 2
    own = torch.stack([yk.sum(s_ax), (yk * yk).sum(s_ax)], -2)
    slack = torch.stack([(yk - yp).abs().sum(s_ax), (yk * yk - yp * yp).abs().sum(s_ax)], -2)
    own_slack = torch.zeros_like(own)
    if not rounded:
        half = yk.abs() * 2.0 ** -8
        own_slack = torch.stack([half.sum(s_ax), (2 * yk.abs() * half + half * half).sum(s_ax)],
                                -2)
        slack = slack + 2 * own_slack
    ok = True
    for i in range(2):
        g, w, o = got[..., i, :], want[..., i, :], own[..., i, :]
        ok = ok and bool(((g - w).abs() <= 1e-3 * w.abs().max() + slack[..., i, :]).all())
        ok = ok and bool(((g - o).abs() <= 1e-4 * o.abs().max() + own_slack[..., i, :]).all())
    return ok, stats_rel_err(got, want)


class Inputs:
    """Random inputs on the card from one generator."""

    def __init__(self, rk, gen, dev):
        self.rk, self.gen, self.dev = rk, gen, dev

    def randn(self, *shape, scale=1.0):
        return torch.randn(*shape, generator=self.gen, device=self.dev) * scale

    def stream(self, lead, hw, c):
        """A bf16 padded stream: random interior, zero pad cols, NaN pad rows."""
        return self.rk._place(self.randn(*lead, *hw, c), *self.rk.padded_hw(*hw)).bfloat16()

    def conv_parts(self, lead, hw, cins, d):
        rows = lead[0] * (lead[1] if len(lead) > 1 else 1)
        return [(self.stream(lead, hw, c), self.randn(3, 3, c, d, scale=(9 * sum(cins)) ** -0.5),
                 1 + self.randn(rows, c, scale=0.1), self.randn(rows, c, scale=0.1))
                for c in cins]

    def tconv_extras(self, b, f, hw, d, emb, res, skip_cins):
        """(emb, residual, skip parts, skip bias) as the path passes them."""
        e = self.randn(b, d).bfloat16() if emb else None
        r = self.stream((b, f), hw, d) if res else None
        skips = [(self.stream((b, f), hw, c), self.randn(c, d, scale=c ** -0.5))
                 for c in skip_cins]
        sb = self.randn(d, scale=0.1) if skip_cins else None
        return e, r, skips or None, sb


def _activated(rk, parts, hw, silu):
    """Yardstick input: the activated interiors, concatenated, as an NCHW view
    of channels_last data."""
    xs = [rk._interior(x, hw) for x, _, _, _ in parts]
    xa = torch.cat([rk._act(x.reshape(-1, *x.shape[-3:]), a, b, silu)
                    for x, (_, _, a, b) in zip(xs, parts)], -1)
    return xa.permute(0, 3, 1, 2)


def _cl_weight(kernels):
    return torch.cat(kernels, 2).bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def _stacked(y, b, f, c):
    """(B*F*S, 3C) frame-stacked operand of the temporal taps."""
    yp = F.pad(y.reshape(b, f, -1, c), (0, 0, 0, 0, 1, 1))
    return torch.cat([yp[:, :f], yp[:, 1:f + 1], yp[:, 2:]], -1).reshape(-1, 3 * c)


def _skip_yardstick(rk, skips, hw):
    if not skips:
        return None, None
    sx = torch.cat([rk._interior(x, hw) for x, _ in skips], -1)
    return sx.reshape(-1, sx.shape[-1]), torch.cat([k for _, k in skips], 0).bfloat16()


def check_k1(rk, key, inp, timed):
    """K1 at one recorded signature, within one ulp of its plain version and
    two launches bit-equal: (ok, max|err|, max|err|/std, None, times or
    None, flops, bytes, label)."""
    _, (n, h, w, c), d, affine, silu = key
    x = inp.randn(n, h, w, c).bfloat16()
    kern = inp.randn(3, 3, c, d, scale=(9 * c) ** -0.5)
    bias = inp.randn(d, scale=0.1)
    a = b = None
    if affine:
        a = 1 + inp.randn(n, c, scale=0.1)
        b = inp.randn(n, c, scale=0.1)
    got = rk.fused_affine_conv3x3(x, kern, bias, a, b, silu)
    same = torch.equal(got, rk.fused_affine_conv3x3(x, kern, bias, a, b, silu))
    want = rk.fused_affine_conv3x3_plain(x, kern, bias, a, b, silu)
    ok, abs_err, rel, _ = within_one_ulp(got, want)
    if not same:
        log(f"[kernels] K1 {n}x{h}x{w}x{c}->{d}: two launches differ")
    ok = ok and same
    times = None
    if timed:
        times = dict(
            ms=time_ms(lambda: rk.fused_affine_conv3x3(x, kern, bias, a, b, silu)),
            plain_ms=time_ms(lambda: rk.fused_affine_conv3x3_plain(x, kern, bias, a, b, silu),
                             3, 1),
        )
        # yardstick: cuDNN on the pre-activated input, channels_last bf16
        xa = rk._act(x, a, b, silu).permute(0, 3, 1, 2)  # NCHW view of channels_last data
        wl, bl = _cl_weight([kern]), bias.bfloat16()
        times["library_ms"] = time_ms(lambda: F.conv2d(xa, wl, bl, padding=1))
    # only taps inside the frame: the zero halo needs no products
    flops = 2.0 * n * (3 * h - 2) * (3 * w - 2) * c * d
    nbytes = 2 * (n * h * w * (c + d) + 9 * c * d) + 4 * d + (8 * n * c if affine else 0)
    mode = "affine+silu" if silu else "affine" if affine else "plain-conv"
    return ok, abs_err, rel, None, times, flops, nbytes, f"K1 {n}x{h}x{w}x{c}->{d} {mode}"


def _tconv_plan_ok(rk, tag, label, b, f, s, c):
    """The C side's plan (`v2a_temporal_conv_plan`) is the one the wrapper
    sizes the statistics by and the row logs."""
    same = rk.temporal_conv_plan_of_kernel(b, f, s, c) == rk.temporal_conv_plan(b, f, s, c)
    if not same:
        log(f"[kernels] {tag} {label}: the kernel's plan is not temporal_conv_plan's")
    return same


def check_k2(rk, key, inp, timed):
    """K2 at one recorded signature, as `check_k1`; also K4b on a padded copy
    of the input (NaN pad rows; the residual padded too), bit-equal to K2 on
    the interior and in the statistics (K4b runs K2's body with K2's plan:
    the same products in the same order)."""
    _, shape, has_emb, has_res, stats = key
    b, f, c = shape[0], shape[1], shape[-1]
    s = 1
    for dim in shape[2:-1]:
        s *= dim
    x = inp.randn(*shape).bfloat16()
    kern = inp.randn(3, c, c, scale=(3 * c) ** -0.5)
    bias = inp.randn(c, scale=0.1)
    emb = inp.randn(b, c).bfloat16() if has_emb else None
    res = inp.randn(*shape).bfloat16() if has_res else None
    got = rk.temporal_conv_fused(x, kern, bias, emb, res, stats)
    again = rk.temporal_conv_fused(x, kern, bias, emb, res, stats)
    want = rk.temporal_conv_fused_plain(x, kern, bias, emb, res, stats)
    hw = tuple(shape[2:4])
    hp, wp = rk.padded_hw(*hw)
    k4b = rk.temporal_conv_padded(rk._place(x, hp, wp), kern, bias, hw, emb,
                                  None if res is None else rk._place(res, hp, wp),
                                  want_stats=stats)
    st_ok, st_err = True, None
    if stats:
        (got, gst), (again, ast), (want, wst), (k4b, kst) = got, again, want, k4b
        st_ok, st_err = stats_ok(gst, wst, got, want)
        st_ok = st_ok and torch.equal(gst, ast) and torch.equal(gst, kst)
    same, vs_k4b = torch.equal(got, again), torch.equal(rk._interior(k4b, hw), got)
    log(f"[kernels] K2 {'x'.join(map(str, shape))}: two launches bit-equal: {same}; K4b on its "
        f"padded copy bit-equal: {vs_k4b}")
    ok, abs_err, rel, _ = within_one_ulp(got, want)
    ok = (ok and st_ok and same and vs_k4b
          and _tconv_plan_ok(rk, "K2", "x".join(map(str, shape)), b, f, s, c))
    times = None
    if timed:
        times = dict(
            ms=time_ms(lambda: rk.temporal_conv_fused(x, kern, bias, emb, res, stats)),
            plain_ms=time_ms(lambda: rk.temporal_conv_fused_plain(x, kern, bias, emb, res,
                                                                  stats), 3, 1),
        )
        # yardstick: one matmul of the frame-stacked (B*F*S, 3C) x (3C, C) form
        stacked, w2d = _stacked(x, b, f, c), kern.bfloat16().reshape(3 * c, c)
        times["library_ms"] = time_ms(lambda: torch.matmul(stacked, w2d))
    x_numel = b * f * s * c
    flops = 2.0 * b * s * c * c * (3 * f - 2)  # the padded frame taps multiply zeros
    nbytes = (2 * x_numel * (2 + has_res) + 2 * 3 * c * c + 4 * c
              + (4 * b * c if has_emb else 0) + (8 * b * f * c if stats else 0))
    label = f"K2 {b}x{f}x{s}x{c} emb={int(has_emb)} res={int(has_res)} stats={int(stats)}"
    return ok, abs_err, rel, st_err, times, flops, nbytes, label


def _conv_cost(n, h, w, wp, cins, d):
    """(flops, bytes) of K4a: in-frame taps only; interior in, interior and
    pad cols out."""
    flops = sum(2.0 * n * (3 * h - 2) * (3 * w - 2) * c * d for c in cins)
    nbytes = sum(2 * n * h * w * c + 18 * c * d + 8 * n * c for c in cins) + 2 * n * h * wp * d
    return flops, nbytes + 4 * d


def _tconv_cost(b, f, h, w, wp, c, emb, res, skip_cins, stats):
    """(flops, bytes) of K4b, as `_conv_cost`."""
    s = h * w
    flops = 2.0 * b * s * c * c * (3 * f - 2) + sum(2.0 * b * f * s * cs * c for cs in skip_cins)
    nbytes = (2 * b * f * s * c * (1 + res) + 2 * b * f * h * wp * c + 6 * c * c + 4 * c
              + sum(2 * b * f * s * cs + 2 * cs * c for cs in skip_cins)
              + (4 * c if skip_cins else 0) + (4 * b * c if emb else 0)
              + (8 * b * f * c if stats else 0))
    return flops, nbytes


def check_k4a(rk, key, inp, timed):
    """K4a at one recorded signature: NaN pad rows in, zero pad cols out,
    the interior within one ulp of its plain version, two launches
    bit-equal; with one part, bit-equal to K1 on the interior (K4a runs
    K1's body: the same chunks in the same order)."""
    _, n, hw, cins, d, silu = key
    h, w = hw
    parts = inp.conv_parts((n,), hw, cins, d)
    bias = inp.randn(d, scale=0.1)
    got = rk.fused_affine_conv3x3_padded(parts, bias, hw, silu)
    again = rk.fused_affine_conv3x3_padded(parts, bias, hw, silu)
    want = rk.fused_affine_conv3x3_padded_plain(parts, bias, hw, silu)
    ok, abs_err, rel, _ = check_stream(got, want, hw)
    same = torch.equal(got[:, 1:h + 1], again[:, 1:h + 1])  # pad rows are not written
    vs_k1 = None
    if len(cins) == 1:  # K1 on the channels K4a computes on (`rk.widen_channels`)
        x, k, a, b = rk.widen_channels(*parts[0])
        k1 = rk.fused_affine_conv3x3(rk._interior(x, hw).contiguous(), k, bias, a, b, silu)
        vs_k1 = torch.equal(rk._interior(got, hw), k1)
    log(f"[kernels] K4a {n}x{h}x{w}x{'+'.join(map(str, cins))}->{d}: two launches bit-equal: "
        f"{same}" + ("" if vs_k1 is None else f"; bit-equal to K1: {vs_k1}"))
    ok = ok and same and vs_k1 is not False
    times = None
    if timed:
        times = dict(ms=time_ms(lambda: rk.fused_affine_conv3x3_padded(parts, bias, hw, silu)),
                     plain_ms=time_ms(lambda: rk.fused_affine_conv3x3_padded_plain(
                         parts, bias, hw, silu), 3, 1))
        xa, wl, bl = _activated(rk, parts, hw, silu), _cl_weight([p[1] for p in parts]), \
            bias.bfloat16()
        times["library_ms"] = time_ms(lambda: F.conv2d(xa, wl, bl, padding=1))
    flops, nbytes = _conv_cost(n, h, w, rk.padded_hw(h, w)[1], cins, d)
    label = f"K4a {n}x{h}x{w}x{'+'.join(map(str, cins))}->{d} silu={int(silu)}"
    return ok, abs_err, rel, None, times, flops, nbytes, label


def check_k4b(rk, key, inp, timed):
    _, (b, f), hw, c, emb, res, skip_cins, stats = key
    h, w = hw
    x = inp.stream((b, f), hw, c)
    kern = inp.randn(3, c, c, scale=(3 * c) ** -0.5)
    bias = inp.randn(c, scale=0.1)
    e, r, skips, sb = inp.tconv_extras(b, f, hw, c, emb, res, skip_cins)
    args = (x, kern, bias, hw, e, r, skips, sb, stats)
    got, want = rk.temporal_conv_padded(*args), rk.temporal_conv_padded_plain(*args)
    again = rk.temporal_conv_padded(*args)
    st_ok, st_err = True, None
    if stats:
        (got, gst), (want, wst), (again, ast) = got, want, again
        st_ok, st_err = stats_ok(gst, wst, rk._interior(got, hw), rk._interior(want, hw))
        st_ok = st_ok and torch.equal(gst, ast)
    same = torch.equal(got[:, :, 1:h + 1], again[:, :, 1:h + 1])  # pad rows are not written
    if not same:
        log(f"[kernels] K4b {b}x{f}x{h}x{w}x{c}: two launches differ")
    ok, abs_err, rel, _ = check_stream(got, want, hw)
    ok = ok and st_ok and same and _tconv_plan_ok(rk, "K4b", f"{b}x{f}x{h}x{w}x{c}", b, f,
                                                  h * w, c)
    times = None
    if timed:
        times = dict(ms=time_ms(lambda: rk.temporal_conv_padded(*args)),
                     plain_ms=time_ms(lambda: rk.temporal_conv_padded_plain(*args), 3, 1))
        stacked = _stacked(rk._interior(x, hw), b, f, c)
        w2d = kern.bfloat16().reshape(3 * c, c)
        sx, sk = _skip_yardstick(rk, skips, hw)
        times["library_ms"] = time_ms(
            lambda: (torch.matmul(stacked, w2d), sk is not None and torch.matmul(sx, sk)))
    flops, nbytes = _tconv_cost(b, f, h, w, rk.padded_hw(h, w)[1], c, emb, res, skip_cins, stats)
    label = (f"K4b {b}x{f}x{h}x{w}x{c} emb={int(emb)} res={int(res)} "
             f"skip={'+'.join(map(str, skip_cins)) or 0} stats={int(stats)}")
    return ok, abs_err, rel, st_err, times, flops, nbytes, label


def _k3_args(key, inp):
    """K3's arguments at one recorded signature (K13 takes the same)."""
    _, (b, f), hw, cins, d, emb, res, skip_cins, silu, stats = key
    parts = inp.conv_parts((b, f), hw, cins, d)
    kbias, tbias = inp.randn(d, scale=0.1), inp.randn(d, scale=0.1)
    tk = inp.randn(3, d, d, scale=(3 * d) ** -0.5)
    e, r, skips, sb = inp.tconv_extras(b, f, hw, d, emb, res, skip_cins)
    return (parts, kbias, tk, tbias, hw, e, r, skips, sb, silu, stats)


def _k3_case(rk, key, inp):
    """K3's arguments, the flat parts, K4a's conv output and the plain one."""
    _, (b, f), hw, cins, d, emb, res, skip_cins, silu, stats = key
    hp, wp = rk.padded_hw(*hw)
    args = _k3_args(key, inp)
    parts, kbias = args[:2]
    flat = [(x.reshape(b * f, hp, wp, -1), k, a, bb) for x, k, a, bb in parts]
    yk = rk.fused_affine_conv3x3_padded(flat, kbias, hw, silu).reshape(b, f, hp, wp, d)
    yp = rk.fused_affine_conv3x3_padded_plain(flat, kbias, hw, silu).reshape(b, f, hp, wp, d)
    return args, flat, yk, yp


def _conv_half(rk, kernel, args):
    """One launch of K3 or K12 (`kernel`) that also stores its own rounded
    conv half (`conv_out`): (output, conv half)."""
    parts, tk = args[0], args[2]
    conv = torch.zeros(parts[0][0].shape[:4] + (tk.shape[-1],), dtype=parts[0][0].dtype,
                       device=parts[0][0].device)
    return kernel(*args, conv_out=conv), conv


def _carried(rk, dy, tk, hw):
    """sum_t |W_t| |dY(f + t - 1)|: how far the temporal taps carry a
    difference dY of the conv half (interiors, B, F, H, W, D)."""
    b, f, h, w, d = dy.shape
    return (_stacked(dy.float().abs(), b, f, d) @ tk.bfloat16().float().abs().reshape(3 * d, d)
            ).reshape(b, f, h, w, d)


def _k3_gates(rk, key, args, got, conv, yk, yp):
    """K3's, K12's and K13's gates, one rounding at a time against the
    kernel's own conv half `conv` (K3, K12: its `conv_out`; K13: K3's, which
    its products equal bit for bit): the conv half within one ulp of
    the plain conv; the output within one ulp of the plain temporal conv of
    that conv half and of K4b of it; against K4a -> K4b within one ulp plus
    the carried difference of the two conv halves, sum_t |W_t| |dY(f+t-1)|
    with dY = conv - K4a's (their float32 conv sums run in other orders, so a
    conv output may round to the neighbouring bf16 value); against the plain
    chain (K4a's plain, then K4b's) within one ulp plus the carried
    conv - plain conv difference. Statistics by `stats_ok` against the plain
    chain and against K4a -> K4b. Returns (ok, max|err|, max|err|/std,
    stats error, |err| against K4a -> K4b, elements beyond one ulp of the
    plain chain). K12's key has no skip widths."""
    if key[0] == "k12":
        _, (b, f), hw, cins, d, emb, res, silu, stats = key
    else:
        _, (b, f), hw, cins, d, emb, res, skip_cins, silu, stats = key
    h, w = hw
    tk, tbias, _, e, r = args[2:7]
    skips, sb = (args[7], args[8]) if key[0] != "k12" else (None, None)
    ext = (tk, tbias, hw, e, r, skips, sb, stats)
    want = rk.fused_conv_tconv_padded_plain(*args) if key[0] != "k12" else \
        rk.fused_conv_tconv_stream_plain(*args)
    half = rk.temporal_conv_padded_plain(conv, *ext)
    own = rk.temporal_conv_padded(conv, *ext)
    two = rk.temporal_conv_padded(yk, *ext)
    st_ok, st_err = True, None
    if stats:
        (got, gst), (want, wst), (half, hst), (own, ost), (two, tst) = got, want, half, own, two
        yg = rk._interior(got, hw)
        st_ok, st_err = stats_ok(gst, wst, yg, rk._interior(want, hw))
        for st, y in ((hst, half), (ost, own), (tst, two)):
            st_ok = st_ok and stats_ok(gst, st, yg, rk._interior(y, hw))[0]
    ci = rk._interior(conv, hw).float()
    ok_conv = check_stream(conv, yp, hw)[0]
    ok_half = check_stream(got, half, hw)[0] and check_stream(got, own, hw)[0]
    carried = _carried(rk, ci - rk._interior(yk, hw).float(), tk, hw)
    ok_two, two_err, _, _ = check_stream(got, two, hw, carried)
    carried = _carried(rk, ci - rk._interior(yp, hw).float(), tk, hw)
    ok, abs_err, rel, strict = check_stream(got, want, hw, carried)
    ok = ok and ok_conv and ok_half and ok_two and st_ok
    return ok, abs_err, rel, st_err, two_err, strict


def _k3_times(rk, key, args, flat, kernel):
    """`kernel` timed at one K3 signature, with the plain chain, the same
    work as K4a -> K4b and the PyTorch yardstick (cuDNN's conv, then the
    temporal and skip matmuls)."""
    _, (b, f), hw, cins, d, emb, res, skip_cins, silu, stats = key
    hp, wp = rk.padded_hw(*hw)
    parts, kbias, tk, tbias, _, e, r, skips, sb, _, _ = args
    times = dict(ms=time_ms(lambda: kernel(*args)),
                 plain_ms=time_ms(lambda: rk.fused_conv_tconv_padded_plain(*args), 3, 1))
    times["k4a_k4b_ms"] = time_ms(lambda: rk.temporal_conv_padded(
        rk.fused_affine_conv3x3_padded(flat, kbias, hw, silu).reshape(b, f, hp, wp, d),
        tk, tbias, hw, e, r, skips, sb, stats))
    xa, wl = _activated(rk, parts, hw, silu), _cl_weight([p[1] for p in parts])
    kb = kbias.bfloat16()
    stacked = _stacked(F.conv2d(xa, wl, kb, padding=1).permute(0, 2, 3, 1), b, f, d)
    w2d = tk.bfloat16().reshape(3 * d, d)
    sx, sk = _skip_yardstick(rk, skips, hw)
    times["library_ms"] = time_ms(lambda: (
        F.conv2d(xa, wl, kb, padding=1), torch.matmul(stacked, w2d),
        sk is not None and torch.matmul(sx, sk)))
    return times


def _k3_cost(rk, key):
    _, (b, f), (h, w), cins, d, emb, res, skip_cins, silu, stats = key
    wp = rk.padded_hw(h, w)[1]
    f1, b1 = _conv_cost(b * f, h, w, wp, cins, d)
    f2, b2 = _tconv_cost(b, f, h, w, wp, d, emb, res, skip_cins, stats)
    # the conv output stays on chip: neither its write nor its read counts
    return f1 + f2, b1 + b2 - 2 * b * f * h * wp * d - 2 * b * f * h * w * d


def _k3_label(key):
    _, (b, f), (h, w), cins, d, emb, res, skip_cins, _, _ = key
    return (f"{b}x{f}x{h}x{w}x{'+'.join(map(str, cins))}->{d} emb={int(emb)} res={int(res)} "
            f"skip={'+'.join(map(str, skip_cins)) or 0}")


def _same(got, again, key):
    """Two launches' outputs bit-equal: the interior rows (pad rows are
    unwritten) and the statistics."""
    h = key[2][0]
    if key[-1]:
        (got, gst), (again, ast) = got, again
        if not torch.equal(gst, ast):
            return False
    return torch.equal(got[:, :, 1:h + 1], again[:, :, 1:h + 1])


def check_k3(rk, key, inp, timed):
    """K3 at one recorded signature (`_k3_gates`, against its own conv half);
    the model's launch (no `conv_out`) bit-equal to the one that stores it."""
    args, flat, yk, yp = _k3_case(rk, key, inp)
    got, conv = _conv_half(rk, rk.fused_conv_tconv_padded, args)
    same = _same(got, rk.fused_conv_tconv_padded(*args), key)
    ok, abs_err, rel, st_err, two_err, strict = _k3_gates(rk, key, args, got, conv, yk, yp)
    log(f"[kernels] K3 vs K4a->K4b max|err| {two_err:.3g}; vs its plain chain: {strict} "
        f"elements beyond one ulp, all within the carried conv-output difference: {ok}; "
        f"two launches bit-equal: {same}")
    times = _k3_times(rk, key, args, flat, rk.fused_conv_tconv_padded) if timed else None
    flops, nbytes = _k3_cost(rk, key)
    return ok and same, abs_err, rel, st_err, times, flops, nbytes, "K3 " + _k3_label(key)


# how K13 (`csrc/conv_tconv_dma.cu`) issues its window and weight-slab copies
K13_COPIES = "tma"


def _k13_vs_k3(rk, key, args, got):
    """K13 against K3, which the JAX package's test relates it to
    (`tests/test_pallas_kernels.py:712-760`): K13 is K3's mainloop with its
    copies issued by TMA, the same products in the same order, so its
    output's interior rows and its statistics are bit-equal to K3's.
    Returns (bit-equal, K3's output, K3's rounded conv half)."""
    y3, conv = _conv_half(rk, rk.fused_conv_tconv_padded, args)
    return _same(got, y3, key), y3, conv


def check_k13(rk, key, inp, timed):
    """K13 at a K3 signature, on K3's inputs: bit-equal to K3
    (`_k13_vs_k3`), then K3's gates (`_k3_gates`) through K3's conv half,
    which K13's products equal; two launches bit-equal; timed against K3 and
    K4a -> K4b."""
    args, flat, yk, yp = _k3_case(rk, key, inp)
    got = rk.fused_conv_tconv_dma(*args)
    same = _same(got, rk.fused_conv_tconv_dma(*args), key)
    vs_k3, _, conv = _k13_vs_k3(rk, key, args, got)
    ok, abs_err, rel, st_err, two_err, strict = _k3_gates(rk, key, args, got, conv, yk, yp)
    log(f"[lab] K13 ({K13_COPIES} copies) two launches bit-equal: {same}; bit-equal to K3: "
        f"{vs_k3}; vs its plain chain: {strict} elements beyond one ulp, all within the carried "
        f"conv-output difference: {ok}")
    times = None
    if timed:
        times = _k3_times(rk, key, args, flat, rk.fused_conv_tconv_dma)
        times["k3_ms"] = time_ms(lambda: rk.fused_conv_tconv_padded(*args))
        times["ms"] = (times["ms"] + time_ms(lambda: rk.fused_conv_tconv_dma(*args))) / 2
    flops, nbytes = _k3_cost(rk, key)
    return ok and same and vs_k3, abs_err, rel, st_err, times, flops, nbytes, "K13 " + _k3_label(key)


def _parity_kernel(rk, kern, p, pp, dt):
    """K_pp': `upconv_weights(kern)` in the input's dtype at output parity
    (p, p'), placed at the 3x3 taps (p + a, p' + b), zeros at the other five."""
    w16 = rk.upconv_weights(kern).to(dt)
    kk = torch.zeros(3, 3, *kern.shape[2:], dtype=dt, device=kern.device)
    for a in range(2):
        for b in range(2):
            kk[p + a, pp + b] = w16[p, pp, a, b]
    return kk


def check_k5(rk, key, inp, timed):
    """K5 at one recorded signature: NaN pad rows in, exactly zero pad cols
    out, the interior within one ulp; two launches bit-equal; each parity
    plane (p, p') of the interior bit-equal to K1 on the input's interior
    with the 3x3 kernel K_pp' (K5 runs K1's body with the parity tap sets:
    the same products in the same order, K1's five zero taps adding exact
    zeros)."""
    _, n, hw, c, d, affine, silu = key
    h, w = hw
    x = inp.stream((n,), hw, c)
    kern = inp.randn(3, 3, c, d, scale=(9 * c) ** -0.5)
    bias = inp.randn(d, scale=0.1)
    a = b = None
    if affine:
        a, b = 1 + inp.randn(n, c, scale=0.1), inp.randn(n, c, scale=0.1)
    args = (x, kern, bias, hw, a, b, silu)
    got, again = rk.fused_upconv3x3_padded(*args), rk.fused_upconv3x3_padded(*args)
    want = rk.fused_upconv3x3_padded_plain(*args)
    ok, abs_err, rel, _ = check_stream(got, want, (2 * h, 2 * w))
    same = torch.equal(got[:, 1:2 * h + 1], again[:, 1:2 * h + 1])  # pad rows are not written
    xi, yi = rk._interior(x, hw).contiguous(), rk._interior(got, (2 * h, 2 * w))
    vs_k1 = [torch.equal(yi[:, p::2, pp::2],
                         rk.fused_affine_conv3x3(xi, _parity_kernel(rk, kern, p, pp, x.dtype),
                                                 bias, a, b, silu))
             for p in range(2) for pp in range(2)]
    log(f"[kernels] K5 {n}x{h}x{w}x{c}->{d}: two launches bit-equal: {same}; parity planes "
        f"bit-equal to K1 with their collapsed taps: {vs_k1}")
    ok = ok and same and all(vs_k1)
    times = None
    if timed:
        times = dict(ms=time_ms(lambda: rk.fused_upconv3x3_padded(*args)),
                     plain_ms=time_ms(lambda: rk.fused_upconv3x3_padded_plain(*args), 3, 1))
        # yardstick: cuDNN on the upsampled (activated) interior, channels_last bf16
        xu = rk._act(rk._interior(x, hw), a, b, silu)
        xu = xu.repeat_interleave(2, 1).repeat_interleave(2, 2).permute(0, 3, 1, 2)
        wl, bl = _cl_weight([kern]), bias.bfloat16()
        times["library_ms"] = time_ms(lambda: F.conv2d(xu, wl, bl, padding=1))
    # the collapsed taps that land inside the low-res frame
    flops = 2.0 * n * (4 * h - 2) * (4 * w - 2) * c * d
    nbytes = (2 * n * h * w * c + 32 * c * d + 4 * d + (8 * n * c if affine else 0)
              + 2 * n * 2 * h * rk.padded_hw(2 * h, 2 * w)[1] * d)
    label = f"K5 {n}x{h}x{w}x{c}->{d} up2x affine={int(affine)}"
    return ok, abs_err, rel, None, times, flops, nbytes, label


def check_k6(rk, key, inp, timed):
    """K6 at one recorded signature. Gate, per element: |err| <= 1e-4 *
    (|s|^T |g|), the float32 sum of absolute products, which bounds what any
    summation order (tensor-core accumulation included) can change; and two
    launches bit-equal. Returns as `check_k1`, the error over std."""
    _, (n, h, w, c), d, affine, silu = key
    x = inp.randn(n, h, w, c).bfloat16()
    g = inp.randn(n, h, w, d).bfloat16()
    a = b = None
    if affine:
        a = 1 + inp.randn(n, c, scale=0.1)
        b = inp.randn(n, c, scale=0.1)
    got = rk.wgrad_conv3x3(x, g, a, b, silu)
    again = rk.wgrad_conv3x3(x, g, a, b, silu)
    want = rk.wgrad_conv3x3_plain(x, g, a, b, silu)
    s = rk._act(x, a, b, silu)
    gate = 1e-4 * rk.wgrad_conv3x3_plain(s.abs(), g.abs())
    err = (got - want).abs()
    bit_equal = torch.equal(got, again)
    ratio = float((err / gate.clamp_min(1e-30)).max())
    ok = bool((err <= gate).all()) and bit_equal
    log(f"[kernels] K6 {n}x{h}x{w}x{c}->{d}: max |err| / gate {ratio:.3g}, "
        f"two launches bit-equal: {bit_equal}")
    times = None
    if timed:
        times = dict(ms=time_ms(lambda: rk.wgrad_conv3x3(x, g, a, b, silu)),
                     plain_ms=time_ms(lambda: rk.wgrad_conv3x3_plain(x, g, a, b, silu), 3, 1))
        # yardstick: the library's conv weight gradient on the materialised
        # activation, NCHW views of channels_last bf16 data
        sl, gl = s.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        times["library_ms"] = time_ms(
            lambda: torch.nn.grad.conv2d_weight(sl, (d, c, 3, 3), gl, padding=1))
    # only taps inside the frame, as K1
    flops = 2.0 * n * (3 * h - 2) * (3 * w - 2) * c * d
    nbytes = 2 * n * h * w * (c + d) + 4 * 9 * c * d + (8 * n * c if affine else 0)
    mode = "affine+silu" if silu else "affine" if affine else "plain-conv"
    return (ok, float(err.max()), float(err.max() / want.std()), None, times, flops, nbytes,
            f"K6 {n}x{h}x{w}x{c}->{d} {mode}")


def check_k7(rk, key, inp, timed):
    """K7 at one recorded signature: within one ulp of its plain version,
    two launches bit-equal (fixed-order statistics; the second launch also
    finds the scratch's arrival counters the first left)."""
    from v2a_tpu_torch.ops import group_norm as gn

    _, shape, groups, silu = key
    c = shape[-1]
    x = (inp.randn(*shape) * 2 + 0.5).bfloat16()
    scale, bias = 1 + inp.randn(c, scale=0.2), inp.randn(c, scale=0.2)
    got = gn.fused_group_norm_silu(x, scale, bias, groups, with_silu=silu)
    again = gn.fused_group_norm_silu(x, scale, bias, groups, with_silu=silu)
    want = gn.fused_group_norm_silu_plain(x, scale, bias, groups, with_silu=silu)
    ok, abs_err, rel, _ = within_one_ulp(got, want)
    ok = ok and torch.equal(got, again)
    times = None
    if timed:
        times = dict(ms=time_ms(lambda: gn.fused_group_norm_silu(x, scale, bias, groups,
                                                                 with_silu=silu)),
                     plain_ms=time_ms(lambda: gn.fused_group_norm_silu_plain(
                         x, scale, bias, groups, with_silu=silu), 3, 1))
        # yardstick: F.group_norm on the channels-first view, then F.silu
        xc = x.reshape(shape[0], -1, c).transpose(1, 2)
        sb, bb = scale.bfloat16(), bias.bfloat16()
        times["library_ms"] = time_ms(
            lambda: (F.silu if silu else (lambda v: v))(F.group_norm(xc, groups, sb, bb, 1e-5)))
    numel = x.numel()
    # float32 operations outside the tensor cores: 3 per element for the
    # statistics, 4 for the affine, 5 for the SiLU
    flops = numel * (7 + 5 * silu)
    nbytes = 2 * 2 * numel + 8 * c
    label = f"K7 {'x'.join(map(str, shape))} silu={int(silu)}"
    return ok, abs_err, rel, None, times, flops, nbytes, label


def check_k8(rk, key, inp, timed):
    """K8 at one recorded signature: NaN pad rows in, exactly zero pad cols
    out, the interior within one ulp; two launches bit-equal; the interior
    bit-equal to K1 on the input's interior at even pixels (K8 runs K1's
    body at stride 2: the same products in the same order)."""
    _, n, hw, c, d, affine, silu = key
    h, w = hw
    x = inp.stream((n,), hw, c)
    kern = inp.randn(3, 3, c, d, scale=(9 * c) ** -0.5)
    bias = inp.randn(d, scale=0.1)
    a = b = None
    if affine:
        a, b = 1 + inp.randn(n, c, scale=0.1), inp.randn(n, c, scale=0.1)
    args = (x, kern, bias, hw, a, b, silu)
    got, again = rk.fused_downconv3x3_padded(*args), rk.fused_downconv3x3_padded(*args)
    ok, abs_err, rel, _ = check_stream(got, rk.fused_downconv3x3_padded_plain(*args),
                                       (h // 2, w // 2))
    same = torch.equal(got[:, 1:-1], again[:, 1:-1])  # pad rows are not written
    k1 = rk.fused_affine_conv3x3(rk._interior(x, hw).contiguous(), kern, bias, a, b, silu)
    vs_k1 = torch.equal(rk._interior(got, (h // 2, w // 2)), k1[:, ::2, ::2])
    log(f"[kernels] K8 {n}x{h}x{w}x{c}->{d}: two launches bit-equal: {same}; bit-equal to K1 "
        f"at even pixels: {vs_k1}")
    ok = ok and same and vs_k1
    times = None
    if timed:
        times = dict(ms=time_ms(lambda: rk.fused_downconv3x3_padded(*args)),
                     plain_ms=time_ms(lambda: rk.fused_downconv3x3_padded_plain(*args), 3, 1))
        # yardstick: cuDNN's stride-2 conv on the (activated) interior,
        # channels_last bf16
        xa = rk._act(rk._interior(x, hw), a, b, silu).contiguous().permute(0, 3, 1, 2)
        wl, bl = _cl_weight([kern]), bias.bfloat16()
        times["library_ms"] = time_ms(lambda: F.conv2d(xa, wl, bl, stride=2, padding=1))
    h2, w2 = h // 2, w // 2
    # only taps inside the frame: 3 H/2 - 1 rows and 3 W/2 - 1 cols of them
    flops = 2.0 * n * (3 * h2 - 1) * (3 * w2 - 1) * c * d
    nbytes = (2 * n * h * w * c + 18 * c * d + 4 * d + (8 * n * c if affine else 0)
              + 2 * n * h2 * rk.padded_hw(h2, w2)[1] * d)
    mode = "affine+silu" if silu else "affine" if affine else "bare"
    return ok, abs_err, rel, None, times, flops, nbytes, f"K8 {n}x{h}x{w}x{c}->{d} {mode}"


def check_k9(rk, key, inp, timed):
    """K9 at one recorded signature: NaN pad rows in, EVERY pad position of
    the output exactly zero, two launches bit-equal. The interior within
    one ulp of the plain version plus the carried difference of the heads'
    outputs: kernel and plain version round each head output (the
    projection's input) from float32 sums taken in other orders, so it may
    differ by one ulp (2^-7 |att|), which the projection carries into the
    output by |Wproj|: (|att| 2^-7) @ |Wproj|. Statistics (of the float32
    output before its rounding) by `stats_ok`."""
    _, n, hw, c, ch, stats = key
    h, w = hw
    x = inp.stream((n,), hw, c)
    a, b = 1 + inp.randn(n, c, scale=0.1), inp.randn(n, c, scale=0.1)
    wts = (inp.randn(c, 3 * c, scale=c ** -0.5), inp.randn(3 * c, scale=0.1),
           inp.randn(c, c, scale=c ** -0.5), inp.randn(c, scale=0.1))
    args = (x, hw, a, b, *wts, ch)
    got, gst = rk.fused_spatial_attention_padded(*args, want_stats=True)
    again = rk.fused_spatial_attention_padded(*args, want_stats=stats)
    want, wst = rk.fused_spatial_attention_padded_plain(*args, want_stats=True)
    again = again[0] if stats else again
    pads = got.clone()
    pads[:, 1:h + 1, 1:w + 1] = 0
    ok_pads = not bool(pads.any())
    _, att = rk.spatial_attention_heads_plain(x, hw, a, b, wts[0], wts[1], ch)
    carried = (att.float().abs() * 2.0 ** -7) @ wts[2].bfloat16().float().abs()
    gi, wi = rk._interior(got, hw), rk._interior(want, hw)
    st_ok, st_err = stats_ok(gst, wst, gi, wi, rounded=False)
    ok, abs_err, rel, strict = within_one_ulp(gi, wi, rk._interior(carried.reshape(got.shape), hw))
    bit_equal = torch.equal(got, again)
    log(f"[kernels] K9 {n}x{h}x{w}x{c} head {ch}: {strict} elements beyond one ulp, all within "
        f"the carried head-output difference: {ok}; pads zero: {ok_pads}; two launches "
        f"bit-equal: {bit_equal}")
    ok = ok and ok_pads and bit_equal and st_ok
    times = None
    if timed:
        times = dict(ms=time_ms(lambda: rk.fused_spatial_attention_padded(*args,
                                                                          want_stats=stats)),
                     plain_ms=time_ms(lambda: rk.fused_spatial_attention_padded_plain(
                         *args, want_stats=stats), 3, 1))
        # yardstick: the QKV and projection matmuls around
        # F.scaled_dot_product_attention, on the normed interior tokens (its
        # scale 1/sqrt(ch) is the block's ch^-1/4 on q and on k)
        s, heads = h * w, c // ch
        xn = rk._act(rk._interior(x, hw).reshape(n, s, c), a, b, False).reshape(n * s, c)
        wq, wo = wts[0].bfloat16(), wts[2].bfloat16()
        bq, bo = wts[1].bfloat16(), wts[3].bfloat16()

        def library():
            qkv = torch.matmul(xn, wq) + bq
            q, k, v = qkv.view(n, s, heads, 3, ch).permute(3, 0, 2, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v)
            return torch.matmul(o.transpose(1, 2).reshape(n * s, c), wo) + bo

        times["library_ms"] = time_ms(library)
    s = h * w
    flops = 2.0 * n * s * c * 4 * c + 4.0 * n * s * s * c
    hp, wp = rk.padded_hw(h, w)
    nbytes = 2 * n * s * c + 2 * n * hp * wp * c + 8 * c * c + 16 * c + 8 * n * c * (1 + stats)
    label = f"K9 {n}x{h}x{w}x{c} heads={c // ch}x{ch} stats={int(stats)}"
    return ok, abs_err, rel, st_err, times, flops, nbytes, label


def check_k10(rk, key, inp, timed):
    """K10 at one recorded signature: within one ulp of its plain version,
    two launches bit-equal, bit-equal to K1 without an affine (K10 is K1's
    entry in mode 0)."""
    _, (n, h, w, c), d = key
    x = inp.randn(n, h, w, c).bfloat16()
    kern = inp.randn(3, 3, c, d, scale=(9 * c) ** -0.5)
    bias = inp.randn(d, scale=0.1)
    got, again = rk.spatial_conv3x3(x, kern, bias), rk.spatial_conv3x3(x, kern, bias)
    ok, abs_err, rel, _ = within_one_ulp(got, rk.spatial_conv3x3_plain(x, kern, bias))
    same, vs_k1 = torch.equal(got, again), torch.equal(got, rk.fused_affine_conv3x3(x, kern, bias))
    log(f"[kernels] K10 {n}x{h}x{w}x{c}->{d}: two launches bit-equal: {same}; bit-equal to K1 "
        f"mode 0: {vs_k1}")
    ok = ok and same and vs_k1
    times = None
    if timed:
        times = dict(ms=time_ms(lambda: rk.spatial_conv3x3(x, kern, bias)),
                     plain_ms=time_ms(lambda: rk.spatial_conv3x3_plain(x, kern, bias), 3, 1))
        # yardstick: cuDNN on the same input, channels_last bf16
        xl, wl, bl = x.permute(0, 3, 1, 2), _cl_weight([kern]), bias.bfloat16()
        times["library_ms"] = time_ms(lambda: F.conv2d(xl, wl, bl, padding=1))
    flops = 2.0 * n * (3 * h - 2) * (3 * w - 2) * c * d  # in-frame taps only
    nbytes = 2 * (n * h * w * (c + d) + 9 * c * d) + 4 * d
    return ok, abs_err, rel, None, times, flops, nbytes, f"K10 {n}x{h}x{w}x{c}->{d}"


def check_k11(rk, key, inp, timed):
    """K11 at one recorded signature, as `check_k2`; two launches bit-equal;
    y and its statistics bit-equal to K2's on the same tensor (K11 is K2's
    launch on x's own memory, the (S, B, F, C) view being only another
    address map over it); the C side's plan is `temporal_conv_plan`'s."""
    _, shape, has_emb, has_res, stats = key
    b, f, c = shape[0], shape[1], shape[-1]
    s = 1
    for dim in shape[2:-1]:
        s *= dim
    x = inp.randn(*shape).bfloat16()
    kern = inp.randn(3, c, c, scale=(3 * c) ** -0.5)
    bias = inp.randn(c, scale=0.1)
    emb = inp.randn(b, c).bfloat16() if has_emb else None
    res = inp.randn(*shape).bfloat16() if has_res else None
    args = (x, kern, bias, emb, res, stats)
    got, again = rk.temporal_conv_fused_hw(*args), rk.temporal_conv_fused_hw(*args)
    want, k2 = rk.temporal_conv_fused_hw_plain(*args), rk.temporal_conv_fused(*args)
    st_ok, st_err = True, None
    if stats:
        (got, gst), (again, ast), (want, wst), (k2, kst) = got, again, want, k2
        st_ok, st_err = stats_ok(gst, wst, got, want)
        st_ok = st_ok and torch.equal(gst, kst) and torch.equal(gst, ast)
    same, vs_k2 = torch.equal(got, again), torch.equal(got, k2)
    log(f"[kernels] K11 {'x'.join(map(str, shape))}: two launches bit-equal: {same}; "
        f"bit-equal to K2: {vs_k2}")
    ok, abs_err, rel, _ = within_one_ulp(got, want)
    label = f"{s}x{b}x{f}x{c}"
    ok = ok and same and vs_k2 and st_ok and _tconv_plan_ok(rk, "K11", label, b, f, s, c)
    times = None
    if timed:
        stacked, w2d = _stacked(x, b, f, c), kern.bfloat16().reshape(3 * c, c)
        times = dict(ms=time_ms(lambda: rk.temporal_conv_fused_hw(*args)),
                     plain_ms=time_ms(lambda: rk.temporal_conv_fused_hw_plain(*args), 3, 1),
                     # yardstick: one matmul of the frame-stacked (B*F*S, 3C)
                     # x (3C, C) form, K2's
                     library_ms=time_ms(lambda: torch.matmul(stacked, w2d)))
    flops = 2.0 * b * s * c * c * (3 * f - 2)  # the padded frame taps multiply zeros
    nbytes = (2 * b * f * s * c * (2 + has_res) + 2 * 3 * c * c + 4 * c
              + (4 * b * c if has_emb else 0) + (8 * b * f * c if stats else 0))
    label = f"K11 {label} emb={int(has_emb)} res={int(has_res)} stats={int(stats)}"
    return ok, abs_err, rel, st_err, times, flops, nbytes, label


def check_k12(rk, key, inp, timed):
    """K12 held as K3 (`_k3_gates`, against its own conv half), without the
    skip fold; the model's launch (no `conv_out`) bit-equal to the one that
    stores it."""
    _, (b, f), hw, cins, d, emb, res, silu, stats = key
    h, w = hw
    hp, wp = rk.padded_hw(h, w)
    parts = inp.conv_parts((b, f), hw, cins, d)
    kbias, tbias = inp.randn(d, scale=0.1), inp.randn(d, scale=0.1)
    tk = inp.randn(3, d, d, scale=(3 * d) ** -0.5)
    e, r, _, _ = inp.tconv_extras(b, f, hw, d, emb, res, ())
    args = (parts, kbias, tk, tbias, hw, e, r, silu, stats)
    got, conv = _conv_half(rk, rk.fused_conv_tconv_stream, args)
    bit_equal = _same(got, rk.fused_conv_tconv_stream(*args), key)
    flat = [(x.reshape(b * f, hp, wp, -1), k, a, bb) for x, k, a, bb in parts]
    yk = rk.fused_affine_conv3x3_padded(flat, kbias, hw, silu).reshape(b, f, hp, wp, d)
    yp = rk.fused_affine_conv3x3_padded_plain(flat, kbias, hw, silu).reshape(b, f, hp, wp, d)
    ok, abs_err, rel, st_err, two_err, strict = _k3_gates(rk, key, args, got, conv, yk, yp)
    log(f"[kernels] K12 vs K4a->K4b max|err| {two_err:.3g}; vs its plain chain: {strict} "
        f"elements beyond one ulp, all within the carried conv-output difference: {ok}; "
        f"two launches bit-equal: {bit_equal}")
    ok = ok and bit_equal
    times = None
    if timed:
        times = dict(ms=time_ms(lambda: rk.fused_conv_tconv_stream(*args)),
                     plain_ms=time_ms(lambda: rk.fused_conv_tconv_stream_plain(*args), 3, 1))
        times["k4a_k4b_ms"] = time_ms(lambda: rk.temporal_conv_padded(
            rk.fused_affine_conv3x3_padded(flat, kbias, hw, silu).reshape(b, f, hp, wp, d),
            tk, tbias, hw, e, r, want_stats=stats))
        xa, wl = _activated(rk, parts, hw, silu), _cl_weight([p[1] for p in parts])
        kb = kbias.bfloat16()
        stacked = _stacked(F.conv2d(xa, wl, kb, padding=1).permute(0, 2, 3, 1), b, f, d)
        w2d = tk.bfloat16().reshape(3 * d, d)
        times["library_ms"] = time_ms(lambda: (
            F.conv2d(xa, wl, kb, padding=1), torch.matmul(stacked, w2d)))
    f1, b1 = _conv_cost(b * f, h, w, wp, cins, d)
    f2, b2 = _tconv_cost(b, f, h, w, wp, d, emb, res, (), stats)
    # the conv output stays on chip: neither its write nor its read counts
    nbytes = b1 + b2 - 2 * b * f * h * wp * d - 2 * b * f * h * w * d
    label = (f"K12 {b}x{f}x{h}x{w}x{'+'.join(map(str, cins))}->{d} emb={int(emb)} "
             f"res={int(res)} silu={int(silu)}")
    return ok, abs_err, rel, st_err, times, f1 + f2, nbytes, label


def check_k14(rk, key, inp, timed):
    """K14 at a K10 signature, on K10's inputs: within one ulp of its plain
    version (which rounds as the Winograd body does), two launches
    bit-equal. Its difference from K10's output is reported, not gated:
    Winograd's transforms round at other places than a direct conv. Timed
    as it is called (`ms`, the weight transform included, as the JAX body
    makes it on every call); the transform alone, a part of `ms`, beside it
    (`weights_ms`)."""
    _, (n, h, w, c), d = key
    x = inp.randn(n, h, w, c).bfloat16()
    kern = inp.randn(3, 3, c, d, scale=(9 * c) ** -0.5)
    bias = inp.randn(d, scale=0.1)
    got = rk.winograd_conv3x3(x, kern, bias)
    again = rk.winograd_conv3x3(x, kern, bias)
    ok, abs_err, rel, _ = within_one_ulp(got, rk.winograd_conv3x3_plain(x, kern, bias))
    k10 = rk.spatial_conv3x3(x, kern, bias).float()
    vs_k10 = float((got.float() - k10).abs().max() / k10.std())
    log(f"[lab] K14 {n}x{h}x{w}x{c}->{d}: two launches bit-equal: {torch.equal(got, again)}; "
        f"max |K14 - K10| / std {vs_k10:.3e} (reported, not gated)")
    ok = ok and torch.equal(got, again)
    times = None
    if timed:
        xl, wl, bl = x.permute(0, 3, 1, 2), _cl_weight([kern]), bias.bfloat16()
        times = dict(ms=time_ms(lambda: rk.winograd_conv3x3(x, kern, bias)),
                     weights_ms=time_ms(lambda: rk.winograd_weights(kern).bfloat16()),
                     plain_ms=time_ms(lambda: rk.winograd_conv3x3_plain(x, kern, bias), 3, 1),
                     k10_ms=time_ms(lambda: rk.spatial_conv3x3(x, kern, bias)),
                     library_ms=time_ms(lambda: F.conv2d(xl, wl, bl, padding=1)),
                     err_vs_k10_over_std=vs_k10)
    patches = n * h * w // 4
    # the 16 transform-domain products on the tensor cores; the transforms in
    # float32 outside them: 3 adds per input component (16 per patch and
    # channel), 9 signed adds per output parity (4 per patch and channel)
    # and the bias
    flops = 2.0 * 16 * patches * c * d
    f32_ops = patches * (48.0 * c + 40.0 * d)
    # x and y in bf16, the (3, 3, C, D) kernel as it is passed, the bias
    nbytes = 2 * n * h * w * (c + d) + kern.element_size() * 9 * c * d + 4 * d
    return ok, abs_err, rel, None, times, (flops, f32_ops), nbytes, f"K14 {n}x{h}x{w}x{c}->{d}"


def check_k15(rk, key, inp, timed):
    """K15 at one perf-lab shape: within one ulp of its plain version, two
    launches bit-equal, and bit-equal to K2 with a zero bias on the same x
    and w (K15 is K2's launch); timed against one matmul of the
    frame-stacked (B*F*S, 3C) operand, K2's yardstick."""
    from v2a_tpu_torch.scripts import perf_lab

    _, (b, f, s, c) = key
    x = inp.randn(b, f, s, c).bfloat16()
    wt = inp.randn(3 * c, c, scale=(3 * c) ** -0.5)
    got, again = perf_lab.temporal_conv_taps(x, wt), perf_lab.temporal_conv_taps(x, wt)
    k2 = rk.temporal_conv_fused(x, wt.reshape(3, c, c), torch.zeros(c, device=x.device))
    ok, abs_err, rel, _ = within_one_ulp(got, perf_lab.temporal_conv_taps_plain(x, wt))
    same, vs_k2 = torch.equal(got, again), torch.equal(got, k2)
    log(f"[kernels] K15 {b}x{f}x{s}x{c}: two launches bit-equal: {same}; bit-equal to K2 with "
        f"a zero bias: {vs_k2}")
    ok = ok and same and vs_k2
    times = None
    if timed:
        stacked, w2d = _stacked(x, b, f, c), wt.bfloat16()
        times = dict(ms=time_ms(lambda: perf_lab.temporal_conv_taps(x, wt)),
                     plain_ms=time_ms(lambda: perf_lab.temporal_conv_taps_plain(x, wt), 3, 1),
                     library_ms=time_ms(lambda: torch.matmul(stacked, w2d)))
    flops = 2.0 * b * s * c * c * (3 * f - 2)  # the padded frame taps multiply zeros
    nbytes = 2 * 2 * b * f * s * c + 2 * 3 * c * c
    return ok, abs_err, rel, None, times, flops, nbytes, f"K15 {b}x{f}x{s}x{c}"


def _k3_signature(a):
    return (tuple(a["parts"][0][0].shape[:2]), tuple(a["hw"]),
            tuple(p[0].shape[-1] for p in a["parts"]), a["parts"][0][1].shape[-1],
            a["emb"] is not None, a["residual"] is not None,
            tuple(s[0].shape[-1] for s in a["skip_parts"] or ()), bool(a["silu"]),
            bool(a["want_stats"]))


# wrapper name -> (tag, signature from the bound call arguments, check)
KERNEL_CHECKS = {
    "fused_affine_conv3x3": ("k1", lambda a: (
        tuple(a["x"].shape), a["kernel"].shape[-1], a["a"] is not None, bool(a["silu"])),
        check_k1),
    "temporal_conv_fused": ("k2", lambda a: (
        tuple(a["x"].shape), a["emb"] is not None, a["residual"] is not None,
        bool(a["want_stats"])), check_k2),
    "fused_affine_conv3x3_padded": ("k4a", lambda a: (
        a["parts"][0][0].shape[0], tuple(a["hw"]), tuple(p[0].shape[-1] for p in a["parts"]),
        a["parts"][0][1].shape[-1], bool(a["silu"])), check_k4a),
    "temporal_conv_padded": ("k4b", lambda a: (
        tuple(a["x"].shape[:2]), tuple(a["hw"]), a["x"].shape[-1], a["emb"] is not None,
        a["residual"] is not None, tuple(s[0].shape[-1] for s in a["skip_parts"] or ()),
        bool(a["want_stats"])), check_k4b),
    "fused_conv_tconv_padded": ("k3", _k3_signature, check_k3),
    "fused_upconv3x3_padded": ("k5", lambda a: (
        a["x"].shape[0], tuple(a["hw_lo"]), a["x"].shape[-1], a["kernel"].shape[-1],
        a["a"] is not None, bool(a["silu"])), check_k5),
    "wgrad_conv3x3": ("k6", lambda a: (
        tuple(a["x"].shape), a["g"].shape[-1], a["a"] is not None, bool(a["silu"])), check_k6),
    "fused_downconv3x3_padded": ("k8", lambda a: (
        a["x"].shape[0], tuple(a["hw"]), a["x"].shape[-1], a["kernel"].shape[-1],
        a["a"] is not None, bool(a["silu"])), check_k8),
    "fused_spatial_attention_padded": ("k9", lambda a: (
        a["x"].shape[0], tuple(a["hw"]), a["x"].shape[-1], a["num_head_channels"],
        bool(a["want_stats"])), check_k9),
    "fused_group_norm_silu": ("k7", lambda a: (
        tuple(a["x"].shape), a["groups"], bool(a["with_silu"])), check_k7),
    "spatial_conv3x3": ("k10", lambda a: (tuple(a["x"].shape), a["kernel"].shape[-1]),
                        check_k10),
    "temporal_conv_fused_hw": ("k11", lambda a: (
        tuple(a["x"].shape), a["emb"] is not None, a["residual"] is not None,
        bool(a["want_stats"])), check_k11),
    "fused_conv_tconv_stream": ("k12", lambda a: (
        tuple(a["parts"][0][0].shape[:2]), tuple(a["hw"]),
        tuple(p[0].shape[-1] for p in a["parts"]), a["parts"][0][1].shape[-1],
        a["emb"] is not None, a["residual"] is not None, bool(a["silu"]),
        bool(a["want_stats"])), check_k12),
    # the lab kernels: K13 at K3's signatures, K14 at K10's, K15 at the perf
    # lab's shapes (`lab_kernels`)
    "fused_conv_tconv_dma": ("k13", _k3_signature, check_k13),
    "winograd_conv3x3": ("k14", lambda a: (tuple(a["x"].shape), a["kernel"].shape[-1]),
                         check_k14),
    "temporal_conv_taps": ("k15", lambda a: (tuple(a["x"].shape),), check_k15),
}
TAG_NAME = {tag: name for name, (tag, _, _) in KERNEL_CHECKS.items()}
# K13 and K14 take the inputs of the kernel whose signatures they are held at
SEED_AS = {"k13": "k3", "k14": "k10"}
SEEDS = 3  # inputs per gated shape; the first is timed


def seed_of(key, i):
    """The seed of input set i at one signature: a stable hash of the
    signature (never its position in a list, so adding shapes changes no
    other shape's inputs)."""
    return zlib.crc32(repr((SEED_AS.get(key[0], key[0]),) + key[1:] + (i,)).encode())


@contextlib.contextmanager
def dgrad_calls():
    """Yields {K1 signature: calls} of the K1 launches that `ops/conv_vjp.py`
    makes as dgrads (plain-conv mode on the cotangent, the flipped and
    transposed kernel) inside the block."""
    from v2a_tpu_torch.ops import conv_vjp

    calls, inner = {}, conv_vjp._dgrad_kernel

    def recorded(g, kernel):
        key = ("k1", tuple(g.shape), kernel.shape[2], False, False)
        calls[key] = calls.get(key, 0) + 1
        return inner(g, kernel)

    conv_vjp._dgrad_kernel = recorded
    try:
        yield calls
    finally:
        conv_vjp._dgrad_kernel = inner


@contextlib.contextmanager
def recording():
    """Yields {signature: calls} of every kernel wrapper called inside the
    block. The shims only record and pass on; the wrappers still count their
    launches."""
    calls = {}
    modules = {name: _rk().wrapper_module(name) for name in KERNEL_CHECKS}
    originals = {name: getattr(modules[name], name) for name in KERNEL_CHECKS}

    def shim(name):
        tag, signature, _ = KERNEL_CHECKS[name]
        fn = originals[name]
        sig = inspect.signature(fn)

        def recorded(*a, **k):
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            key = (tag,) + signature(bound.arguments)
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        return recorded

    for name in KERNEL_CHECKS:
        setattr(modules[name], name, shim(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(modules[name], name, fn)


def _plan_row(rk, key):
    """The plan of a launch at this signature: K3 / K12 / K13's tile plan
    (pixels per tile, CTAs per cluster along D, CTAs in the grid, shared
    memory per CTA; K13 takes K3's, and its copy route), K6's `wgrad_plan`
    (pixel tile, chunks of tiles, tiles per chunk, grid, shared memory),
    K1's, K10's, K4a's, K8's and K5's `affine_conv_plan` (pixels per tile,
    output channels per CTA, grid, shared memory; K4a over its parts' summed
    C, K8 at stride 2, K5 with its parities), K2's, K4b's and K11's
    `temporal_conv_plan`, K9's `attention_plan` (per phase: token tile x
    columns, warps, grid, shared memory; the attention's queries a CTA and
    lane slices; `grid` the smallest phase's) and K14's `winograd_plan` (patches per tile, output
    channels per CTA, window resident or streamed, grid, shared memory); {}
    for the other kernels."""
    if key[0] == "k6":
        plan = rk.wgrad_plan(*key[1], key[2])
        return dict(tile=f"{plan.tile_h}x{plan.tile_w}", chunks=plan.chunks,
                    per_chunk=plan.per_chunk, grid=plan.grid, smem=plan.smem)
    if key[0] in ("k1", "k10"):
        plan = rk.affine_conv_plan(*key[1], key[2])
        return dict(pixels=plan.pixels, nc=plan.nc, grid=plan.grid, smem=plan.smem)
    if key[0] in ("k8", "k5"):
        _, n, (h, w), c, d, _, _ = key
        plan = (rk.affine_conv_plan(n, h, w, c, d, stride=2) if key[0] == "k8"
                else rk.affine_conv_plan(n, h, w, c, d, up=True))
        return dict(pixels=plan.pixels, nc=plan.nc, grid=plan.grid, smem=plan.smem)
    if key[0] == "k4a":
        _, n, (h, w), cins, d, _ = key
        plan = rk.affine_conv_plan(n, h, w, sum(rk.widened(c) for c in cins), d)
        return dict(pixels=plan.pixels, nc=plan.nc, grid=plan.grid, smem=plan.smem)
    if key[0] in ("k2", "k4b", "k11"):
        if key[0] in ("k2", "k11"):
            shape = key[1]
            b, f, s, c = shape[0], shape[1], int(np.prod(shape[2:-1])), shape[-1]
        else:
            (b, f), s, c = key[1], key[2][0] * key[2][1], key[3]
        plan = rk.temporal_conv_plan(b, f, s, c)
        return dict(pixels=plan.pixels, frames=plan.frames, nc=plan.nc, tiles=plan.tiles,
                    grid=plan.grid, smem=plan.smem)
    if key[0] == "k9":
        _, n, (h, w), c, ch, _ = key
        plan = rk.attention_plan(n, h, w, c, ch)
        q, p = plan.qkv, plan.proj
        return dict(qkv=f"{q.tokens}x{q.nc} w{q.warps} grid {q.grid} smem {q.smem}",
                    attention=f"{plan.queries}q x {plan.slices}x{plan.slice} lanes w{plan.warps} "
                              f"grid {plan.grid} smem {plan.smem}",
                    proj=f"{p.tokens}x{p.nc} w{p.warps} grid {p.grid} smem {p.smem}",
                    grid=min(q.grid, plan.grid, p.grid))
    if key[0] == "k14":
        plan = rk.winograd_plan(*key[1], key[2])
        return dict(patches=f"{plan.patches} ({plan.tile_h}x{plan.tile_w})", nc=plan.nc,
                    window="resident" if plan.resident else "streamed", grid=plan.grid,
                    smem=plan.smem)
    if key[0] == "k7":
        from v2a_tpu_torch.ops import group_norm as gn

        shape = key[1]
        plan = gn.group_norm_plan(shape[0], int(np.prod(shape[1:-1])), shape[-1], key[2])
        return dict(threads=plan.threads, lanes=plan.lanes, rows=plan.rows, ctas=plan.ctas,
                    grid=shape[0] * plan.ctas, smem=plan.smem)
    if key[0] not in ("k3", "k12", "k13"):
        return {}
    (b, f), (h, w), d = key[1], key[2], key[4]
    plan = rk.conv_tconv_plan(b, f, h, w, d, ring=key[0] == "k12", tma=key[0] == "k13")
    row = dict(pixels=plan.pixels, cluster=plan.cluster, grid=plan.grid, smem=plan.smem)
    return dict(row, copies=K13_COPIES) if key[0] == "k13" else row


def check_kernels(rk, routing_calls, dev, timed, tag, roles=None):
    """Each recorded signature against the plain version, on `SEEDS` input
    sets seeded by the signature (`seed_of`); the worst case per shape is
    kept. `routing_calls`: {routing: {signature: calls}}. With `timed`, K2
    without statistics (which the path never asks for) is added, each shape
    is timed on its first input set, and per routing the per-kernel sums
    weight each shape by its calls in that routing. `roles`: {signature:
    {role: calls}} added to a shape's row and log line (K1's forwards and
    dgrads in the train step)."""
    roles = roles or {}
    keys = sorted({k for calls in routing_calls.values() for k in calls}, key=str)
    no_stats = [k for k in keys if k[0] == "k2" and not k[2] and not k[3]]
    if timed and no_stats:
        keys.append(("k2", no_stats[0][1], False, False, False))
    rows, failed = [], []
    agg = {r: {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_s=0.0,
                          bytes_s=0.0, max_abs_err=0.0, k4a_k4b_ms=0.0,
                          k3_ms=0.0, k10_ms=0.0, weights_ms=0.0)
               for name in rk.KERNELS}
           for r in routing_calls}
    with torch.no_grad():
        for key in keys:
            counts = {r: calls.get(key, 0) for r, calls in routing_calls.items()}
            check = KERNEL_CHECKS[TAG_NAME[key[0]]][2]
            ok, abs_err, rel, st_err, times = True, 0.0, 0.0, None, None
            for i in range(SEEDS):
                inp = Inputs(rk, torch.Generator(device=dev).manual_seed(seed_of(key, i)), dev)
                res = check(rk, key, inp, timed and i == 0)
                ok, abs_err, rel = ok and res[0], max(abs_err, res[1]), max(rel, res[2])
                if res[3] is not None:
                    st_err = max(st_err or 0.0, res[3])
                times = times or res[4]
                flops, nbytes, label = res[5:]
                if not res[0]:
                    log(f"[{tag}] {label}: input set {i} (seed {seed_of(key, i)}) fails its gate")
            tensor_ops, f32_ops = flops if isinstance(flops, tuple) else (
                (0.0, flops) if key[0] == "k7" else (flops, 0.0))
            ops_s = tensor_ops / PEAK_FLOPS + f32_ops / PEAK_F32
            bytes_s = nbytes / PEAK_BYTES
            bound_ms = max(ops_s, bytes_s) * 1e3
            plan = _plan_row(rk, key)
            served_b1 = (key[1][0] == 1 if key[0] in ("k12", "k2", "k4b", "k11")
                         else key[1][0] == 7 if key[0] == "k10"
                         else key[1][0] in (1, 7) if key[0] == "k7" else key[1] == 7)
            # K2 / K4b / K11: where a 16-pixel tile gives a CTA per SM (not 8^2 x 512 at B=1)
            short = plan.get("pixels", 0) > 16 if key[0] in ("k2", "k4b", "k11") else True
            if (key[0] in ("k12", "k4a", "k8", "k9", "k10", "k5", "k2", "k4b", "k11", "k7")
                    and served_b1
                    and short
                    and plan["grid"] < rk.HOPPER_SMS):
                log(f"[{tag}] {label}: a B=1 grid of {plan['grid']} CTAs leaves SMs idle")
                ok = False
            rows.append(dict(shape=label, calls=counts, ok=ok, seeds=SEEDS, max_abs_err=abs_err,
                             max_err_over_std=rel, stats_rel_err=st_err, bound_ms=bound_ms,
                             bound_by="operations" if ops_s >= bytes_s else "bytes",
                             **roles.get(key, {}), **plan, **(times or {})))
            extra = {k: v for k, v in (times or {}).items()
                     if k in ("k4a_k4b_ms", "k3_ms", "k10_ms", "weights_ms")}
            log(f"[{tag}] {label:56s} x{list(counts.values())} ok={ok} (worst of {SEEDS}) "
                f"err/std={rel:.2e} " + (f"stats_rel={st_err:.1e} " if st_err is not None else "")
                + (f"ms={times['ms']:.3f} plain={times['plain_ms']:.3f} "
                   f"lib={times['library_ms']:.3f} " if times else "")
                + "".join(f"{k[:-3]}={v:.3f} " for k, v in extra.items())
                + f"bound={bound_ms:.3f}"
                + "".join(f" {k}={v}" for k, v in dict(roles.get(key, {}), **plan).items()))
            if not ok:
                failed.append(label)
            for r, count in counts.items():
                a = agg[r][TAG_NAME[key[0]]]
                a["max_abs_err"] = max(a["max_abs_err"], abs_err if count else 0.0)
                for k, v in dict(times or {}, bound_ms=bound_ms, ops_s=ops_s,
                                 bytes_s=bytes_s).items():
                    if k in a:
                        a[k] += count * v
            torch.cuda.empty_cache()
    if failed:
        fail(f"{len(failed)} shapes disagree with their plain versions: {failed}")
    return rows, agg


def _unet_kw(vcfg):
    return dict(in_channels=vcfg.channels + vcfg.cond_ch, out_channels=vcfg.channels,
                model_channels=vcfg.model_channels, channel_mult=vcfg.channel_mult,
                num_res_blocks=vcfg.num_res_blocks,
                attention_resolutions=vcfg.attention_resolutions,
                num_head_channels=vcfg.num_head_channels, task_token_dim=vcfg.text_dim)


def _arch(routing):
    """The U-Net arguments of a routing that change its parameters."""
    return {k: v for k, v in ROUTINGS[routing].items() if k in ARCH}


def _routed_unet(vcfg, routing):
    """A bf16 `VideoUNet` of `vcfg` with `ROUTINGS[routing]` (its `fused`,
    its `ConvRouting` from the config, its architecture), uninitialized."""
    from v2a_tpu_torch.models.video_unet import VideoUNet

    cfg = dataclasses.replace(vcfg, **ROUTINGS[routing])
    return VideoUNet(dtype=torch.bfloat16, fused=cfg.fused, routing=cfg.conv_routing(),
                     **_unet_kw(cfg))


def check_forward(rk, nets, inputs, vcfg, dev, expected=EXPECTED_PER_FORWARD, tag="forward"):
    """Phase 4 (and phase 11 for each variant, its counts `expected`):
    launch counts, each routing vs plain vs float32, times in turns. `nets`:
    {routing: U-Net}, "padded" among them. A routing with its own
    architecture (`padded_k8_k9_wide`) is held against plain paths of that
    architecture with its own weights."""
    from v2a_tpu_torch.models.video_unet import VideoUNet

    def fwd(net):
        with torch.no_grad():
            return net(*inputs)

    outs = {}
    for routing, net in nets.items():
        zero_launches()
        outs[routing] = fwd(net)
        torch.cuda.synchronize()
        per_fwd = {k: v for k, v in launch_counts().items() if v}
        log(f"[{tag}] {routing} routing, launches per forward: {per_fwd}")
        if per_fwd != expected[routing]:
            fail(f"{tag}: {routing} launch counts {per_fwd} != {expected[routing]}")
    # the plain bf16 path and the float32 reference of each architecture
    refs, plain16 = {}, None
    for routing in [r for r in ("padded", "padded_k8_k9_wide") if r in nets]:
        kw = dict(_unet_kw(vcfg), **_arch(routing))
        state = nets[routing].state_dict()
        p16 = VideoUNet(dtype=torch.bfloat16, **kw).to(dev).eval()
        p16.load_state_dict(state)
        r32 = VideoUNet(dtype=torch.float32, **kw).to(dev).eval()
        r32.load_state_dict(state)
        refs[routing] = (fwd(p16), fwd(r32))
        plain16 = plain16 or p16
        del r32
    outs["plain_bf16"] = refs["padded"][0]
    for o in list(outs.values()) + [r for pair in refs.values() for r in pair]:
        if o.shape != inputs[0].shape[:-1] + (vcfg.channels,) or not bool(torch.isfinite(o).all()):
            fail("forward output has the wrong shape or non-finite values")

    def ref_of(routing):
        return refs["padded_k8_k9_wide" if _arch(routing) else "padded"]

    def err(o, ref):
        d = (o - ref).abs()
        std = float(ref.std())
        return float(d.max()) / std, float(d.mean()) / std

    errs = {name: err(o, ref_of(name)[1]) for name, o in outs.items() if name in nets}
    errs["plain_bf16"] = err(refs["padded"][0], refs["padded"][1])
    if "padded_k8_k9_wide" in refs:
        errs["plain_bf16_wide"] = err(*refs["padded_k8_k9_wide"])
    errs.update({f"{r}_vs_plain_bf16": err(outs[r], ref_of(r)[0]) for r in nets})
    log(f"[{tag}] err/std (max, mean) vs the float32 plain reference of the routing's "
        "architecture: " + "; ".join(f"{k} {v[0]:.3e} {v[1]:.3e}" for k, v in errs.items()))
    # the fused routings round at other places than the plain bf16 path, but
    # in the same class: each may stray from float32 at most twice as far
    for r in nets:
        e_plain = errs["plain_bf16_wide" if _arch(r) else "plain_bf16"]
        if errs[r][0] > 2 * e_plain[0] or errs[r][1] > 2 * e_plain[1]:
            fail(f"{tag}: {r} forward strays further from the float32 reference than the bf16 "
                 "plain path")
    fwd_ms = {name: [] for name in list(nets) + ["plain_bf16"]}
    turns = list(nets.items()) + [("plain_bf16", plain16)]
    for label, net in turns + turns[::-1]:
        fwd_ms[label].append(time_ms(lambda: fwd(net), 2, 1))
    b, f, h, w = inputs[0].shape[:4]
    log(f"[{tag}] B={b} F={f} {h}x{w} ms (in turns): {fwd_ms}")
    return dict(forward_ms=fwd_ms, forward_err=errs)


def serve(rk, model, vcfg, dev):
    """Phase 5, the main path: goal video, then actions, per request; the
    launch counts are read from this run only. Returns the launches, the
    request times and the kernels' {signature: calls} on this path."""
    from v2a_tpu_torch.models.policy import DiffusionPolicy, PolicyConfig

    policy = DiffusionPolicy.create(PolicyConfig(dtype="bfloat16"), device=dev).init(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    h, w = vcfg.image_size
    frames = torch.rand(N_REQUESTS, h, w, 3, generator=gen, device=dev)
    zero_launches()
    with recording() as calls:
        req = _requests(model, policy, frames, vcfg, gen)
    launches = launch_counts()
    n_fwd = N_REQUESTS * vcfg.sampling_timesteps
    log(f"[serve] {N_REQUESTS} requests (reduced from the 8 release tasks to keep the run "
        f"short; width and step count unchanged): launches {launches} over {n_fwd} forwards")
    for name, (tag, _, _) in KERNEL_CHECKS.items():
        want = n_fwd * EXPECTED_PER_FORWARD["padded"].get(name, 0)
        made = sum(v for key, v in calls.items() if key[0] == tag)
        if launches[name] != want or made != want:
            fail(f"{name}: {made} calls and {launches[name]} launches on the serving path, "
                 f"expected {want}")
    return launches, req, calls


def serve_routing(routing, model, vcfg, dev):
    """Phase 5, a further routing's main path: one goal-video request
    (`VideoPredModel.sample`, B=1, the 100-step chain) through a model of
    that `VideoModelConfig` holding the shipped model's weights; the launch
    counts are read from this run only. Returns the launches, the request's
    seconds and the kernels' {signature: calls} on this path."""
    from v2a_tpu_torch.models.video_model import VideoPredModel

    vm = VideoPredModel(dataclasses.replace(vcfg, **ROUTINGS[routing]), device=dev)
    vm.nets.load_state_dict(model.nets.state_dict())
    if vm.unet.fused != ROUTINGS[routing]["fused"]:
        fail(f"{routing}: the model resolved fused={vm.unet.fused}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    h, w = vcfg.image_size
    frame = torch.rand(1, h, w, 3, generator=gen, device=dev)
    zero_launches()
    with recording() as calls:
        t0 = time.perf_counter()
        video = vm.sample(frame, [TASKS[0]], generator=gen)
        torch.cuda.synchronize()
        t_video = time.perf_counter() - t0
    launches = launch_counts()
    if video.shape != (1, vcfg.video_future_horizon, h, w, 3):
        fail(f"{routing}: sampled video has shape {tuple(video.shape)}")
    if not bool(torch.isfinite(video).all()) or video.min() < 0 or video.max() > 1:
        fail(f"{routing}: sampled video is not finite in [0, 1]")
    n_fwd = vcfg.sampling_timesteps
    for name, (tag, _, _) in KERNEL_CHECKS.items():
        want = n_fwd * EXPECTED_PER_FORWARD[routing].get(name, 0)
        made = sum(v for key, v in calls.items() if key[0] == tag)
        if launches[name] != want or made != want:
            fail(f"{routing}: {name}: {made} calls and {launches[name]} launches on the "
                 f"serving path, expected {want}")
    log(f"[serve] {routing}: one request, video {t_video:.2f} s (100-step ancestral, B=1), "
        f"video mean {float(video.mean()):.4f}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    del vm
    torch.cuda.empty_cache()
    return launches, t_video, calls


def _requests(model, policy, frames, vcfg, gen):
    h, w = vcfg.image_size
    req = []
    for i in range(N_REQUESTS):
        t0 = time.perf_counter()
        video = model.sample(frames[i:i + 1], [TASKS[i]], generator=gen)
        torch.cuda.synchronize()
        t_video = time.perf_counter() - t0
        t0 = time.perf_counter()
        act = policy.predict_action({"img_obs_1": frames[i:i + 1], "img_goal_1": video[:, 0]},
                                    generator=gen)["action"]
        torch.cuda.synchronize()
        t_policy = time.perf_counter() - t0
        if video.shape != (1, vcfg.video_future_horizon, h, w, 3):
            fail(f"sampled video has shape {tuple(video.shape)}")
        if not bool(torch.isfinite(video).all()) or video.min() < 0 or video.max() > 1:
            fail("sampled video is not finite in [0, 1]")
        if act.shape != (1, 8, 7) or not bool(torch.isfinite(act).all()) or act.abs().max() > 1:
            fail("predicted actions have the wrong shape or leave the action bounds")
        req.append((t_video, t_policy))
        log(f"[serve] request {i}: video {t_video:.2f} s (100-step ancestral, B=1), "
            f"actions {t_policy:.3f} s (DDIM-8), video mean {float(video.mean()):.4f}, "
            f"action[0] {[round(v, 3) for v in act[0, 0].tolist()]}")
    return req


class SyntheticClips:
    """`VideoClipDataset.sample_batch`'s interface on uint8 episodes made from
    the seed: the LIBERO clips are not in the repository and the card
    machine has no h5py. A random episode, a random start, the next F frames
    at stride 4, frames / 255."""

    def __init__(self, frames, hw, seed, episodes=2, stride=4):
        rng = np.random.default_rng(seed)
        length = frames * stride + 9
        self.frames, self.stride = frames, stride
        self.episodes = rng.integers(0, 256, size=(episodes, length) + tuple(hw) + (3,),
                                     dtype=np.uint8)

    def __len__(self):
        return len(self.episodes)

    def sample_batch(self, batch, rng):
        f, s = self.frames, self.stride
        conds, vids, tasks = [], [], []
        for _ in range(batch):
            e = int(rng.integers(len(self.episodes)))
            imgs = self.episodes[e]
            start = int(rng.integers(0, len(imgs) - f * s))
            conds.append(imgs[start])
            vids.append(imgs[start + s:start + s * (f + 1):s][:f])
            tasks.append(TASKS[e % len(TASKS)])
        return (np.stack(conds).astype(np.float32) / 255.0,
                np.stack(vids).astype(np.float32) / 255.0, tasks)


def _grad_rel(grads, ref):
    """(whole gradient vector, worst leaf) relative L2 error against `ref`."""
    num = den = worst = 0.0
    for k, r in ref.items():
        d = float((grads[k].float() - r.float()).square().sum())
        n = float(r.float().square().sum())
        num, den = num + d, den + n
        worst = max(worst, (d / n) ** 0.5 if n > 0 else (0.0 if d == 0 else float("inf")))
    return (num / den) ** 0.5, worst


def _train_problem(model, vcfg, dev):
    """A train step's fixed problem: synthetic clips, the U-Net's initial
    weights, one B=`TRAIN_B` batch and noise draw, and the float32 plain
    step's loss and gradients on them (the reference of every routing's
    gradient)."""
    from v2a_tpu_torch.models.video_unet import VideoUNet

    clips = SyntheticClips(vcfg.video_future_horizon, vcfg.image_size, SEED + 2)
    init = {k: v.clone() for k, v in model.unet.state_dict().items()}
    rng = np.random.default_rng(SEED + 3)
    x_cond, video, tasks = clips.sample_batch(TRAIN_B, rng)
    batch = (torch.as_tensor(video, device=dev),
             (torch.as_tensor(x_cond, device=dev) * 2.0 - 1.0)[:, None],
             model.encode_batch_text(tasks),
             torch.as_tensor(rng.integers(0, vcfg.timesteps, TRAIN_B), device=dev),
             torch.ones(TRAIN_B, device=dev))
    noise = torch.randn(batch[0].shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 4))
    ref = VideoUNet(dtype=torch.float32, **_unet_kw(vcfg)).to(dev)
    ref.load_state_dict(init)
    loss32 = model.diffusion.p_losses(ref, *batch[:3], t=batch[3], sample_weights=batch[4],
                                      noise=noise)
    loss32.backward()
    grads32 = {k: p.grad for k, p in ref.named_parameters()}
    return clips, init, batch, noise, loss32.item(), grads32


def train(rk, model, vcfg, dev):
    """Phase 6: the video-model train step through `VideoModelTrainer.train`
    in each routing. Returns the report, the kernels' {signature: calls} of
    one K6-routing gradient step, the launches of the K6 routing's run, and
    {K1 signature: its forward and dgrad calls} of that step."""
    from v2a_tpu_torch.train import checkpoint as ckpt
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    torch.cuda.reset_peak_memory_stats()
    clips, init, batch, noise, loss32, grads32 = _train_problem(model, vcfg, dev)
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] float32 plain step at B={TRAIN_B}: loss {loss32:.6f}, "
        f"peak memory {peak32:.1f} GiB")
    torch.cuda.empty_cache()

    report = dict(batch=TRAIN_B, steps_timed=TRAIN_STEPS, float32_peak_gib=peak32,
                  ms_per_step={}, wall_s={}, launches_per_step={}, grad_rel_err={},
                  loss={}, peak_gib={})
    grads, calls, k6_launches, roles = {}, {}, {}, {}
    for name, flags in TRAIN_ROUTINGS.items():
        model.unet.load_state_dict(init)
        workdir = os.path.join(ROOT, "logs", "chip_smoke_train", name)
        cfg = VideoTrainerConfig(batch_size=TRAIN_B, n_train_steps=1 + TRAIN_STEPS,
                                 save_freq=10 ** 9, log_freq=1, **flags)
        torch.cuda.reset_peak_memory_stats()
        trainer = VideoModelTrainer(model, clips, cfg, workdir=workdir, seed=SEED)
        if trainer.train_unet.train_fused != flags["train_fused"]:
            fail(f"{name}: the trainer resolved train_fused={trainer.train_unet.train_fused}")
        with recording() as step_calls, dgrad_calls() as dgrads:
            trainer.loss_and_grads(*batch, noise=noise)
        if name == "k6":
            calls = step_calls
            roles = {key: dict(forward_calls=n - dgrads.get(key, 0), dgrad_calls=dgrads.get(key, 0))
                     for key, n in step_calls.items() if key[0] == "k1"}
        grads[name] = {k: p.grad.detach().clone()
                       for k, p in trainer.train_unet.named_parameters()}
        trainer.state.optimizer.zero_grad(set_to_none=True)
        # the user's entry point; a shim on train_step times each step by CUDA
        # events and takes the launches each step made
        steps, inner = [], trainer.train_step

        def timed_step(*a, **k):
            before = launch_counts()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner(*a, **k)
            e1.record()
            steps.append((e0, e1, {n: v - before[n] for n, v in launch_counts().items()
                                   if v != before[n]}, out[0]))
            return out

        trainer.train_step = timed_step
        zero_launches()
        t0 = time.perf_counter()
        trainer.train(1 + TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        if name == "k6":
            k6_launches = launch_counts()
        want = EXPECTED_PER_TRAIN_STEP[name]
        per_step = [st[2] for st in steps]
        if len(steps) != 1 + TRAIN_STEPS or any(ps != want for ps in per_step):
            fail(f"{name}: launches per train step {per_step}, expected {want}")
        if launches != {k: (1 + TRAIN_STEPS) * v for k, v in want.items()}:
            fail(f"{name}: launches over the run {launches}")
        losses = [float(st[3]) for st in steps]
        if not all(np.isfinite(losses)):
            fail(f"{name}: non-finite loss {losses}")
        if not all(bool(torch.isfinite(p).all()) for p in trainer.train_unet.parameters()):
            fail(f"{name}: non-finite parameters after training")
        if not all(bool(torch.isfinite(p).all()) for p in model.unet.parameters()):
            fail(f"{name}: non-finite EMA weights published into the model")
        if ckpt.latest_label(workdir) is None:
            fail(f"{name}: train() saved no checkpoint")
        ms = [st[0].elapsed_time(st[1]) for st in steps]
        report["ms_per_step"][name] = ms[1:]
        report["wall_s"][name] = wall
        report["launches_per_step"][name] = want
        report["loss"][name] = losses
        report["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[train] {name}: ms per B={TRAIN_B} step {[round(v, 1) for v in ms[1:]]} "
            f"(warm-up {ms[0]:.1f}), launches per step {want or 'none'}, losses "
            f"{[round(v, 4) for v in losses]}, train({1 + TRAIN_STEPS}) {wall:.1f} s incl. "
            f"its checkpoint, peak {report['peak_gib'][name]:.1f} GiB")
        trainer.close()
        del trainer, inner, steps
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(ROOT, "logs", "chip_smoke_train"), ignore_errors=True)
    rel = {name: _grad_rel(g, grads32) for name, g in grads.items()}
    report["grad_rel_err"] = rel
    log("[train] gradient rel. error vs the float32 plain step (whole vector, worst leaf): "
        + "; ".join(f"{k} {v[0]:.3e} {v[1]:.3e}" for k, v in rel.items()))
    for name, (whole, worst) in rel.items():
        if whole > 2 * rel["plain"][0] or worst > 2 * rel["plain"][1]:
            fail(f"{name} gradient strays further from float32 than twice the bf16 plain path")
    model.unet.load_state_dict(init)
    for key in K6_SMALL:
        calls.setdefault(("k6",) + key, 0)
    return report, calls, k6_launches, roles


def train_policy(dev, pool="max", steps=POLICY_STEPS):
    """Phase 7 (phase 16 (b): each trunk `pool`, `steps` timed steps): the
    policy train step at the release batch,
    `make_train_step(policy.loss, fused_clip_adamw(cfg), EMAConfig())` on a
    bf16-compute policy with float32 parameters and moments (the release
    recipe: AdamW lr 1e-4, betas (0.95, 0.999), eps 1e-8, wd 1e-6, clip 1.0,
    EMA power 0.75 every step), on a synthetic batch from the seed: one
    warm-up step, then `steps` steps timed by CUDA events; the peak
    memory; finite loss, gradient norm, weights and EMA. It runs no kernel
    of the port (plain PyTorch, as the JAX step runs plain XLA)."""
    from v2a_tpu_torch.models.policy import DiffusionPolicy, PolicyConfig
    from v2a_tpu_torch.train.train_state import (
        EMAConfig, OptimizerConfig, PolicyTrainState, fused_clip_adamw, make_train_step)

    policy = DiffusionPolicy.create(PolicyConfig(dtype="bfloat16", vision_pool=pool),
                                    device=dev).init(SEED)
    policy.nets.requires_grad_(True)
    cfg = policy.config
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    h, w = cfg.image_size
    batch = {"obs": {k: torch.rand(POLICY_B, h, w, 3, generator=gen, device=dev)
                     for k in cfg.obs_keys},
             "action": policy.action_norm.unnormalize(
                 torch.rand(POLICY_B, cfg.horizon, cfg.action_dim, generator=gen, device=dev)
                 * 2 - 1)}
    torch.cuda.reset_peak_memory_stats()
    tx = fused_clip_adamw(OptimizerConfig())
    state = PolicyTrainState(policy.nets, tx)
    step = make_train_step(policy.loss, tx, EMAConfig())
    zero_launches()
    events, outs = [], []
    for _ in range(1 + steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        outs.append(step(state, batch, gen))
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    ms = [e0.elapsed_time(e1) for e0, e1 in events]
    losses = [float(o.loss) for o in outs]
    norms = [float(o.grad_norm) for o in outs]
    launches = {k: v for k, v in launch_counts().items() if v}
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(norms))):
        fail(f"policy train step: non-finite loss {losses} or gradient norm {norms}")
    if not all(bool(torch.isfinite(p).all()) for p in state.params + state.ema_params):
        fail("policy train step: non-finite weights or EMA")
    if state.step != 1 + steps or launches:
        fail(f"policy train step: {state.step} steps, kernel launches {launches}")
    report = dict(pool=pool, batch=POLICY_B, steps_timed=steps, ms_per_step=ms[1:],
                  warmup_ms=ms[0],
                  loss=losses, grad_norm=norms,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  params_m=sum(p.numel() for p in state.params) / 1e6)
    log(f"[policy-train] B={POLICY_B}, {report['params_m']:.1f} M params, bf16 compute, pool "
        f"{pool!r}: ms per "
        f"step {[round(v, 2) for v in ms[1:]]} (warm-up {ms[0]:.1f}), losses "
        f"{[round(v, 4) for v in losses]}, gradient norms {[round(v, 3) for v in norms]}, "
        f"peak {report['peak_gib']:.2f} GiB")
    del policy, state, step, batch, outs
    torch.cuda.empty_cache()
    return report


def _timed(log_to, fn, sync=True):
    """`fn` with each call's seconds appended to `log_to` (after a
    synchronize, so the card's work is inside)."""
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if sync:
            torch.cuda.synchronize()
        log_to.append(time.perf_counter() - t0)
        return out
    return wrapped


def online_loop(rk, routing_calls, dev, smi):
    """Phase 8, the online loop: `build_experiment` from the port's copy of
    the release config with the cuts of `ONLINE_OVERRIDES`, then
    `OnlineTrainer.train()` (live random episodes, one video-guided cycle:
    one B=8 goal-video call on the padded routing, then the rollouts with
    the EMA policy's DDIM-8 predictions; the train steps from the native
    replay buffers through the prefetcher), `save` and `load` into a fresh
    trainer, then the eval entry point on the run's workdir (`scripts/eval.py`:
    the loaded EMA policy, one seed per task, one goal video per episode, from
    the snapshot). The counts are zeroed just before
    `train()` and read just after. Returns the report, the launches and the
    per-kernel errors and the keys of any cycle signature phase 3 did not
    hold."""
    from v2a_tpu_torch.config import apply_overrides, load_config_module
    from v2a_tpu_torch.data.replay_buffer import ReplayBuffer
    from v2a_tpu_torch.scripts import eval as eval_script
    from v2a_tpu_torch.train.build import build_experiment

    cfg = load_config_module(os.path.join(ROOT, "v2a_tpu_torch", "config", "libero",
                                          "lb_tk8_65to72.py"))
    cfg = apply_overrides(cfg, dict(ONLINE_OVERRIDES, logbase=ONLINE_LOGS, exp_name="run"))
    workdir = cfg.savepath()
    shutil.rmtree(ONLINE_LOGS, ignore_errors=True)
    log("[online] cuts of the release config: " + "; ".join(
        f"{k}={v} ({ONLINE_WHY[k]})" for k, v in ONLINE_OVERRIDES.items()))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, policy, env_list, video_model = build_experiment(cfg)
    build_s = time.perf_counter() - t0
    if not (video_model.unet.fused and video_model.unet.routing.padded_stream):
        fail("online: the video model did not resolve to the padded routing on cuda")
    if trainer.envBuf_vid.backend != "native" or trainer.cfg.prefetch_depth != 2:
        fail("online: expected the native replay store and prefetch depth 2")
    n_tasks = len(env_list.task_list)

    # instrumentation: the cycle, its video call, its predictions and env
    # steps, the train steps (CUDA events)
    cycle_s, video_s, predict_s, env_s, steps = [], [], [], [], []
    in_cycle = {"on": False}
    sampler = trainer.video_model
    sampler.sample_u8 = _timed(video_s, sampler.sample_u8)
    trainer.executor.policy_fn = _timed(predict_s, trainer.executor.policy_fn, sync=False)
    env_step = env_list.step_an_env

    def timed_env_step(*a, **k):
        if not in_cycle["on"]:
            return env_step(*a, **k)
        t = time.perf_counter()
        out = env_step(*a, **k)
        env_s.append(time.perf_counter() - t)
        return out

    env_list.step_an_env = timed_env_step
    explore = trainer.video_guided_explore
    cycle_calls, cycle_launches = {}, {}

    def cycle():
        in_cycle["on"] = True
        before = launch_counts()
        t = time.perf_counter()
        try:
            with recording() as calls:
                explore()
            torch.cuda.synchronize()
        finally:
            in_cycle["on"] = False
        cycle_s.append(time.perf_counter() - t)
        cycle_calls.update(calls)
        cycle_launches.update({n: v - before[n] for n, v in launch_counts().items()})

    trainer.video_guided_explore = cycle
    inner = trainer._train_step

    def timed_step(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(*a, **k)
        e1.record()
        steps.append((e0, e1, out.loss))
        return out

    trainer._train_step = timed_step
    zero_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()

    # gates: one cycle, its launches exactly 100 B=8 release forwards of
    # the padded routing, none outside it; the buffer; finite losses
    n_fwd = cfg.video.sampling_timesteps
    want = {name: n_fwd * EXPECTED_PER_FORWARD["padded"].get(name, 0) for name in launches}
    if len(cycle_s) != 1 or trainer.step != ONLINE_STEPS:
        fail(f"online: {len(cycle_s)} guided cycles over {trainer.step} steps, expected 1 "
             f"over {ONLINE_STEPS}")
    if cycle_launches != want or launches != want:
        fail(f"online: launches {launches} (in the cycle {cycle_launches}), expected {want}")
    made = {}
    for key, n in cycle_calls.items():
        made[key[0]] = made.get(key[0], 0) + n
    if any(made.get(tag, 0) != want[name] for name, (tag, _, _) in KERNEL_CHECKS.items()):
        fail(f"online: wrapper calls {made} do not match the launches {want}")
    lo, hi = trainer.explore_cfg.act_min, trainer.explore_cfg.act_max
    eps = trainer.envBuf_vid.export_episodes()
    h, w = cfg.video.image_size
    if len(eps) != n_tasks or trainer.cnt_vid_rollouts != n_tasks:
        fail(f"online: {len(eps)} episodes in the video buffer, expected {n_tasks}")
    for ep in eps:
        imgs, acts = ep["imgs"], ep["acts"]
        if (imgs.dtype != np.uint8 or imgs.shape[1:] != (h, w, 3)
                or len(imgs) != len(acts) + 1 or acts.min() < lo or acts.max() > hi):
            fail(f"online: a guided episode of {imgs.shape} {imgs.dtype} and "
                 f"{acts.shape} actions in [{acts.min()}, {acts.max()}]")
    losses = [float(s[2]) for s in steps]
    if len(losses) != ONLINE_STEPS or not np.all(np.isfinite(losses)):
        fail(f"online: losses {losses}")
    step_ms = [e0.elapsed_time(e1) for e0, e1, _ in steps]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # save, then load into a fresh trainer: bit-equal state and counters
    t0 = time.perf_counter()
    trainer.save()
    save_s = time.perf_counter() - t0
    fresh, *_ = build_experiment(cfg, workdir, with_video_model=False, snapshot=False)
    t0 = time.perf_counter()
    fresh.load()
    load_s = time.perf_counter() - t0
    a, b = trainer.state_dict(), fresh.state_dict()
    same = (a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
            and all(torch.equal(a[p][k], b[p][k]) for p in ("params", "ema_params")
                    for k in a[p])
            and all(torch.equal(x, y) for p in ("mu", "nu")
                    for x, y in zip(a["opt_state"][p], b["opt_state"][p]))
            and fresh._counters() == trainer._counters())
    for name in ("envBuf_rand", "envBuf_vid"):
        x, y = getattr(trainer, name), getattr(fresh, name)
        same = same and len(x) == len(y) and (
            x.cnt_all_history_episodes == y.cnt_all_history_episodes)
        for ea, eb in zip(x.export_episodes(), y.export_episodes()):
            same = same and all(np.array_equal(ea[k], eb[k]) for k in ("imgs", "acts"))
    if not same:
        fail("online: the loaded trainer differs from the saved one")

    # the hindsight batch: the native store against the Python backend on
    # the same episodes and generator
    py = ReplayBuffer(trainer.cfg.max_episodes_vid, trainer.cfg.max_len_uB,
                      trainer.cfg.min_len_uB, trainer.cfg.model_act_horizon, backend="python")
    for ep in eps:
        py.add_episode(ep["task"], ep["cam"], ep["env_idx"], ep["imgs"], ep["acts"],
                       is_success=ep["is_success"])
    bs = trainer.cfg.buf_sample_batch_size
    nat_b = trainer.envBuf_vid.sample_batch(bs, np.random.default_rng(SEED + 7))
    py_b = py.sample_batch(bs, np.random.default_rng(SEED + 7))
    if not all(np.array_equal(np.asarray(nat_b[k]), np.asarray(py_b[k])) for k in nat_b):
        fail("online: the native store's hindsight batch differs from the Python backend's")
    batch_ms = {}
    for name, buf in (("native", trainer.envBuf_vid), ("python", py)):
        rng = np.random.default_rng(SEED)
        t0 = time.perf_counter()
        for _ in range(ONLINE_BATCH_REPS):
            buf.sample_batch(bs, rng)
        batch_ms[name] = (time.perf_counter() - t0) / ONLINE_BATCH_REPS * 1e3
    del py

    # the eval entry point on the run's workdir, with the card's memory of
    # the loop given back first
    del trainer, fresh, policy, video_model, sampler, explore, inner
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with open(eval_script.main(["--workdir", workdir, "--vis", "0"])) as fh:
        result = json.load(fh)
    eval_s = time.perf_counter() - t0
    if (result["num_evals"] != n_tasks or len(result["run_times_all"]) != n_tasks
            or result["epoch"] != ONLINE_STEPS):
        fail(f"online: eval ran {result['num_evals']} episodes at step {result['epoch']}, "
             f"expected {n_tasks} at {ONLINE_STEPS}")
    eval_s_per_episode = float(np.mean(result["run_times_all"]))

    env_steps = sum(int(len(ep["acts"])) for ep in eps)
    report = dict(
        card=smi, tasks=n_tasks, build_s=build_s, train_s=train_s, cycle_s=cycle_s[0],
        video_call_s=video_s[0], predictions=len(predict_s),
        ms_per_prediction=float(np.mean(predict_s)) * 1e3,
        env_steps_in_cycle=len(env_s), env_steps_in_episodes=env_steps,
        host_ms_per_env_step=float(np.mean(env_s)) * 1e3,
        train_step_ms=step_ms, losses=losses, hindsight_batch_ms=batch_ms, batch=bs,
        peak_gib=peak, save_s=save_s, load_s=load_s,
        eval_s=eval_s, eval_s_per_episode=eval_s_per_episode,
        eval_run_times=result["run_times_all"], eval_suc_rate=result["suc_rate"],
        launches=cycle_launches)
    log(f"[online] {smi}: train({ONLINE_STEPS}) {train_s:.1f} s; one guided cycle "
        f"{cycle_s[0]:.2f} s, its goal-video call {video_s[0]:.2f} s (B={n_tasks}, {n_fwd}-step "
        f"chain), launches {{K1 {want['fused_affine_conv3x3']}, K2 "
        f"{want['temporal_conv_fused']}, K3 {want['fused_conv_tconv_padded']}, K4a "
        f"{want['fused_affine_conv3x3_padded']}, K4b {want['temporal_conv_padded']}, K5 "
        f"{want['fused_upconv3x3_padded']}}}")
    log(f"[online] {smi}: {len(predict_s)} policy predictions in the cycle (B=1 DDIM-"
        f"{cfg.policy.num_inference_steps_ddim}, {cfg.policy.dtype}), "
        f"{report['ms_per_prediction']:.1f} ms each; {len(env_s)} env steps, host "
        f"{report['host_ms_per_env_step']:.3f} ms each")
    log(f"[online] {smi}: ms per B={bs} train step {[round(v, 1) for v in step_ms]}, losses "
        f"{[round(v, 4) for v in losses]}; ms per hindsight batch of {bs}: native "
        f"{batch_ms['native']:.2f}, python {batch_ms['python']:.2f} (equal batches); peak "
        f"{peak:.1f} GiB")
    log(f"[online] {smi}: save {save_s:.1f} s, load {load_s:.1f} s (bit-equal); "
        f"scripts/eval.py {eval_s:.1f} s in all, {n_tasks} episodes, "
        f"{eval_s_per_episode:.2f} s per episode, success rate {result['suc_rate']:.3f} "
        f"(random weights)")

    # the concurrency: the eval entry point on 8 workers, a pool cycle, the
    # pipelined and overlapped loop (each its counts zeroed just before and
    # read just after, added to the loop's), then the stream gate
    want = {name: n_fwd * EXPECTED_PER_FORWARD["padded"].get(name, 0) for name in launches}
    runs = [parallel_eval(workdir, n_tasks, want, smi, eval_s),
            pool_cycle(cfg, want, smi, report),
            pipelined_run(cfg, want, smi)]
    for name, run_report, run_launches, _ in runs:
        report[name] = run_report
        for k, v in run_launches.items():
            launches[k] += v
    report["stream"], stream_calls = stream_gate(cfg, smi)
    report["launches_with_concurrency"] = dict(launches)

    # the runs' kernel signatures: held in phase 3 unless new (the stream
    # gate's B=2 chain)
    seen = [cycle_calls, stream_calls] + [r[3] for r in runs]
    extra = {}
    for calls in seen:
        for k, v in calls.items():
            if k not in routing_calls["padded"]:
                extra[k] = extra.get(k, 0) + v
    extra_agg = {}
    if extra:
        _, extra_agg = check_kernels(rk, {"online": extra}, dev, timed=False,
                                     tag="online-shapes")
        extra_agg = extra_agg["online"]
    report["new_signatures"] = len(extra)
    gc.collect()
    shutil.rmtree(ONLINE_LOGS, ignore_errors=True)
    torch.cuda.empty_cache()
    return report, launches, extra_agg, set(extra)


def _gate_chains(tag, launches, calls, want):
    """Fail unless `launches` are exactly `want` and the recorded wrapper
    calls agree with them."""
    if launches != want:
        fail(f"{tag}: launches {launches}, expected {want}")
    made = {}
    for key, n in calls.items():
        made[key[0]] = made.get(key[0], 0) + n
    if any(made.get(tag_, 0) != want[name] for name, (tag_, _, _) in KERNEL_CHECKS.items()):
        fail(f"{tag}: wrapper calls {made} do not match the launches {want}")


def _gate_episodes(tag, eps, n, cfg, explore_cfg):
    """Fail unless there are `n` guided episodes of uint8 frames at the
    config's size, one frame more than actions, actions in range."""
    h, w = cfg.video.image_size
    if len(eps) != n:
        fail(f"{tag}: {len(eps)} episodes, expected {n}")
    for ep in eps:
        imgs, acts = ep["imgs"], ep["acts"]
        if (imgs.dtype != np.uint8 or imgs.shape[1:] != (h, w, 3)
                or len(imgs) != len(acts) + 1 or acts.min() < explore_cfg.act_min
                or acts.max() > explore_cfg.act_max):
            fail(f"{tag}: a guided episode of {imgs.shape} {imgs.dtype} and "
                 f"{acts.shape} actions in [{acts.min()}, {acts.max()}]")


def _rounds_of(pool, log_to):
    """Wraps `pool.map` so that each lock-step round's env stepping (the
    batched executor's `step_k` calls with done_mode 'last') appends its
    host seconds to `log_to`."""
    inner = pool.map

    def timed_map(calls, *a, **k):
        t = time.perf_counter()
        out = inner(calls, *a, **k)
        if calls and calls[0][1] == "step_k" and calls[0][3].get("done_mode") == "last":
            log_to.append(time.perf_counter() - t)
        return out

    pool.map = timed_map


def _workers_closed(tag, pool, env_list):
    """Fail if an env is open in a worker or in process, then close the
    pool and fail if a worker process outlives it."""
    try:
        pool.map([(i, "check_no_envs_exist", (), {}) for i in range(len(pool))])
        env_list.check_no_envs_exist()
    finally:
        pool.close()
    if any(w.alive for w in pool.workers):
        fail(f"{tag}: an env worker outlived the pool's close()")


def parallel_eval(workdir, n_tasks, want, smi, serial_s):
    """The eval entry point with `--workers 8` on the serial run's workdir:
    8 episodes (one per task) in lock-step, one B=8 goal-video call (one
    per episode), B=8 policy calls. Gates: 8 episodes at step 8, launches
    exactly one B=8 chain's."""
    from v2a_tpu_torch.scripts import eval as eval_script

    zero_launches()
    t0 = time.perf_counter()
    with recording() as calls:
        with open(eval_script.main(["--workdir", workdir, "--vis", "0",
                                    "--workers", str(POOL_WORKERS)])) as fh:
            result = json.load(fh)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    if result["num_evals"] != n_tasks or result["epoch"] != ONLINE_STEPS:
        fail(f"eval --workers: {result['num_evals']} episodes at step {result['epoch']}, "
             f"expected {n_tasks} at {ONLINE_STEPS}")
    _gate_chains("eval --workers", launches, calls, want)
    log(f"[online] {smi}: scripts/eval.py --workers {POOL_WORKERS} {wall_s:.1f} s in all for "
        f"{n_tasks} episodes (one B={POOL_WORKERS} goal-video call; serial: {serial_s:.1f} s)")
    return ("parallel_eval", dict(wall_s=wall_s, serial_wall_s=serial_s,
                                  run_times=result["run_times_all"],
                                  suc_rate=result["suc_rate"], launches=launches),
            launches, calls)


def pool_cycle(cfg, want, smi, serial):
    """One guided cycle on 8 spawned env workers (`n_env_workers=8`, built
    by `build_experiment`): one B=8 goal-video call, then lock-step rounds
    of one B=8 DDIM-8 prediction each. Gates: launches exactly 100 B=8
    forwards', none outside the cycle; 8 valid episodes; every policy call
    at B=8, one per round."""
    from v2a_tpu_torch.envs import subproc
    from v2a_tpu_torch.train.build import build_experiment

    starts = []

    class TimedPool(subproc.EnvWorkerPool):
        """The pool that `build_experiment` starts, timed until every
        worker answers (spawned with the main module hidden: numpy and the
        env registry only)."""

        def __init__(self, *a, **k):
            t = time.perf_counter()
            super().__init__(*a, **k)
            self.map([(i, "task_list", (), {}) for i in range(len(self))])
            starts.append(time.perf_counter() - t)

    pcfg = cfg.replace(n_env_workers=POOL_WORKERS, exp_name="pool")
    t0 = time.perf_counter()
    with mock.patch.object(subproc, "EnvWorkerPool", TimedPool):
        trainer, _, env_list, video_model = build_experiment(pcfg, pcfg.savepath(), snapshot=False)
    try:
        spawn_s, start_s = time.perf_counter() - t0, starts[0]
        if trainer._batched_executor is None or len(trainer.env_pool) != POOL_WORKERS:
            fail("pool: the trainer did not get a pool of 8 env workers")
        video_s, predict_s, batches, rounds = [], [], [], []
        sampler = trainer.video_model
        sampler.sample_u8 = _timed(video_s, sampler.sample_u8)
        policy_fn = trainer._batched_executor.policy_fn

        def predict(obs01, goal01):
            batches.append(len(obs01))
            return policy_fn(obs01, goal01)

        trainer._batched_executor.policy_fn = _timed(predict_s, predict, sync=False)
        _rounds_of(trainer.env_pool, rounds)
        zero_launches()
        t0 = time.perf_counter()
        with recording() as calls:
            trainer.video_guided_explore()
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        launches = launch_counts()
        eps = trainer.envBuf_vid.export_episodes()
        _workers_closed("pool", trainer.env_pool, env_list)
    finally:
        trainer.env_pool.close()
    _gate_chains("pool", launches, calls, want)
    _gate_episodes("pool", eps, POOL_WORKERS, pcfg, trainer.explore_cfg)
    if set(batches) != {POOL_WORKERS} or len(batches) != len(rounds) or len(video_s) != 1:
        fail(f"pool: policy calls at B={sorted(set(batches))}, {len(batches)} calls for "
             f"{len(rounds)} rounds, {len(video_s)} goal-video calls")
    ms_pred = float(np.mean(predict_s)) * 1e3
    rep = dict(pool_start_s=start_s, spawn_and_build_s=spawn_s, cycle_s=cycle_s, video_call_s=video_s[0],
               rounds=len(rounds), ms_per_prediction=ms_pred, predictions_s=float(sum(predict_s)),
               host_ms_per_round_of_env_steps=float(np.mean(rounds)) * 1e3,
               env_steps_in_episodes=sum(int(len(ep["acts"])) for ep in eps), launches=launches)
    log(f"[online] {smi}: pool cycle ({POOL_WORKERS} spawned workers) {cycle_s:.2f} s: its "
        f"goal-video call {video_s[0]:.2f} s, {len(rounds)} rounds x {ms_pred:.1f} ms per B="
        f"{POOL_WORKERS} DDIM-8 prediction, env steps {rep['host_ms_per_round_of_env_steps']:.1f}"
        f" ms per round; serial cycle {serial['cycle_s']:.2f} s: goal-video call "
        f"{serial['video_call_s']:.2f} s, {serial['predictions']} x "
        f"{serial['ms_per_prediction']:.1f} ms per B=1 prediction (a pool of "
        f"{POOL_WORKERS} up and answering {start_s:.1f} s; spawn + build {spawn_s:.1f} s)")
    del trainer, video_model, sampler
    gc.collect()
    torch.cuda.empty_cache()
    return "pool_cycle", rep, launches, calls


def pipelined_run(cfg, want, smi):
    """`train()` with 8 env workers, `pipeline_explore` and `overlap_explore`
    over two guided cycles (spawned at steps 4 and 8 on the worker thread,
    each cycle's goal videos a stream started in the cycle before and pumped
    behind its policy calls). Gates: 16 episodes committed, no explore
    thread left, no env open in a worker or in process, finite losses; after
    the last prefetched stream is pumped to its end, the launches are
    exactly (cycles + 1) x 100 B=8 forwards'."""
    from v2a_tpu_torch.config import apply_overrides
    from v2a_tpu_torch.train.build import build_experiment

    pcfg = apply_overrides(cfg, dict(PIPELINED_OVERRIDES, exp_name="pipelined"))
    log("[online] pipelined run: " + "; ".join(
        f"{k}={v} ({PIPELINED_WHY[k]})" for k, v in PIPELINED_OVERRIDES.items()))
    trainer, _, env_list, video_model = build_experiment(pcfg, pcfg.savepath(), snapshot=False)
    try:
        cycle_s, steps, batches, joins = [], [], [], []
        rollouts = trainer._explore_rollouts
        # the worker thread's wall per cycle (its reads back bound it)
        trainer._explore_rollouts = _timed(cycle_s, rollouts, sync=False)
        policy_fn = trainer._batched_executor.policy_fn
        trainer._batched_executor.policy_fn = lambda o, g: (batches.append(len(o)),
                                                            policy_fn(o, g))[1]
        join = trainer._join_explore

        def timed_join():
            t = time.perf_counter()
            busy = trainer._explore_thread is not None
            join()
            if busy:
                joins.append(time.perf_counter() - t)

        trainer._join_explore = timed_join
        inner = trainer._train_step

        def timed_step(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            e0.record()
            out = inner(*a, **k)
            e1.record()
            steps.append((e0, e1, out.loss, time.perf_counter() - t))
            return out

        trainer._train_step = timed_step
        zero_launches()
        t0 = time.perf_counter()
        with recording() as calls:
            trainer.train()
            stash = trainer._video_prefetch
            left = stash.videos.chunks_left if stash is not None else -1
            if stash is not None:
                stash.pump(10 ** 9)
            torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = launch_counts()
        threads = [t for t in threading.enumerate() if t.name == "v2a-explore"]
        thread_left = trainer._explore_thread is not None or bool(threads)
        eps = trainer.envBuf_vid.export_episodes()
        _workers_closed("pipelined", trainer.env_pool, env_list)
    finally:
        trainer.env_pool.close()
    n_cycles = PIPELINED_CYCLES
    if stash is None or thread_left or len(cycle_s) != n_cycles:
        fail(f"pipelined: {len(cycle_s)} cycles, stash {stash is not None}, explore thread "
             f"left {thread_left}")
    if trainer.cnt_vid_rollouts != n_cycles * POOL_WORKERS:
        fail(f"pipelined: {trainer.cnt_vid_rollouts} episodes committed, expected "
             f"{n_cycles * POOL_WORKERS}")
    _gate_episodes("pipelined", eps, n_cycles * POOL_WORKERS, pcfg, trainer.explore_cfg)
    _gate_chains("pipelined", launches, calls,
                 {k: (n_cycles + 1) * v for k, v in want.items()})
    losses = [float(st[2]) for st in steps]
    if len(losses) != pcfg.trainer.n_train_steps or not np.all(np.isfinite(losses)):
        fail(f"pipelined: losses {losses}")
    if set(batches) != {POOL_WORKERS}:
        fail(f"pipelined: policy calls at B={sorted(set(batches))}")
    step_ms = [e0.elapsed_time(e1) for e0, e1, _, _ in steps]
    rep = dict(train_s=train_s, cycle_s=cycle_s, join_wait_s=joins,
               train_step_ms=step_ms, train_step_host_ms=[st[3] * 1e3 for st in steps],
               losses=losses, predictions=len(batches), chunks_left_at_end=left,
               episodes=len(eps), launches=launches)
    log(f"[online] {smi}: pipelined + overlapped train({pcfg.trainer.n_train_steps}) "
        f"{train_s:.1f} s: {n_cycles} cycles of {[round(c, 2) for c in cycle_s]} s on the "
        f"worker thread, joins waited {[round(j, 2) for j in joins]} s, "
        f"{len(batches)} B={POOL_WORKERS} predictions, {left} chunks of the last stream "
        f"left at the end; ms per train step (CUDA events, the worker's launches "
        f"interleaved) {[round(v, 1) for v in step_ms]}")
    del trainer, video_model
    gc.collect()
    torch.cuda.empty_cache()
    return "pipelined", rep, launches, calls


def stream_gate(cfg, smi):
    """The release U-Net (bf16, padded routing, the online run's weights)
    on a chain of `STREAM_STEPS` ancestral steps at B=`STREAM_B`:
    `sample_u8_stream` pumped in `STREAM_CHUNKS` chunks equals `sample_u8`
    bit for bit on the card. Returns the report and the recorded calls."""
    from v2a_tpu_torch.models.video_model import VideoPredModel

    vcfg = dataclasses.replace(cfg.video, timesteps=STREAM_STEPS,
                               sampling_timesteps=STREAM_STEPS)
    model = VideoPredModel(vcfg, device=cfg.device).init(cfg.seed)
    if model.diffusion.is_ddim_sampling or not model.unet.routing.padded_stream:
        fail("stream gate: expected the ancestral sampler on the padded routing")
    x = np.random.default_rng(SEED).random((STREAM_B,) + tuple(vcfg.image_size) + (3,),
                                           np.float32)
    tasks = TASKS[:STREAM_B]
    with recording() as calls:
        t0 = time.perf_counter()
        ref = model.sample_u8(x, tasks, generator=torch.Generator(model.device).manual_seed(SEED))
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        stream = model.sample_u8_stream(x, tasks, torch.Generator(model.device).manual_seed(SEED),
                                        n_chunks=STREAM_CHUNKS)
        t0 = time.perf_counter()
        chunks = 0
        while stream.chunks_left:
            stream.pump(1)
            chunks += 1
        got = stream.result_u8()
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    if chunks != STREAM_CHUNKS or not torch.equal(got, ref):
        fail(f"stream gate: {chunks} chunks; sample_u8_stream differs from sample_u8 in "
             f"{int((got != ref).sum())} of {ref.numel()} values")
    log(f"[online] {smi}: sample_u8_stream == sample_u8 bit for bit (B={STREAM_B}, "
        f"{STREAM_STEPS}-step ancestral chain in {STREAM_CHUNKS} chunks, release U-Net "
        f"{vcfg.dtype}): "
        f"{stream_s:.2f} s against {ref_s:.2f} s")
    del model
    torch.cuda.empty_cache()
    return dict(equal=True, b=STREAM_B, steps=STREAM_STEPS, chunks=chunks, stream_s=stream_s,
                sample_u8_s=ref_s), calls


def _same_state(first, again, step):
    """Two `VideoModelTrainer`s at `step` with bit-equal weights, EMA and
    optimizer state."""
    a, b = first.state.state_dict(first.train_unet), again.state.state_dict(again.train_unet)
    return (a["step"] == b["step"] == step and all(
        torch.equal(a[part][k], b[part][k]) for part in ("params", "ema_params") for k in a[part])
        # Adam's `step` stays on the CPU in the trained run, the load puts
        # it on the card
        and all(torch.equal(x, b["opt_state"]["state"][i][k].to(x.device))
                for i, st in a["opt_state"]["state"].items() for k, x in st.items()
                if isinstance(x, torch.Tensor)))


def video_entry_points(rk, held, dev, smi):
    """Phase 9, the video entry points. `scripts/train_video.run` at release
    width (its flags' defaults), B=4, the device by default (the card), on
    `SyntheticClips` (`main` opens an H5 file, and the card machine has no
    h5py): `VIDEO_STEPS` steps through the train_fused routing, K1's
    launches exactly phase 6's per step and nothing else, finite losses;
    then `--resume --sample-after` in a fresh call: the step, weights, EMA
    and optimizer state bit-equal to the saved run's, the validation sample
    on the 2 tasks exactly 100 padded B=2 forwards' launches, the videos
    finite in [0, 1]; then `scripts/sample_video.py --smoke 1`: `videos.npy`
    uint8 (2, 7, 32, 32, 3) and the PNG strips. Each part's wall time on
    its own line. Returns the report, the launches of the train and sample
    runs, and the per-kernel errors of any signature not in `held`."""
    import importlib.util

    from v2a_tpu_torch.data import img_utils
    from v2a_tpu_torch.models.video_model import VideoPredModel
    from v2a_tpu_torch.scripts import sample_video, train_video

    why = ("h5py is not installed on this machine" if importlib.util.find_spec("h5py") is None
           else "this script reads no H5 file")
    log(f"[h5] NOT RUN on the card: data/h5_ingest.py, envs/offline.py, scripts/gen_randsam.py, "
        f"the trainer's from_h5 rounds and train_video's VideoClipDataset ({why}); "
        f"tests/test_torch_h5.py and tests/test_torch_video_cli.py hold them against the JAX "
        f"package on the CPU")
    shutil.rmtree(VIDEO_LOGS, ignore_errors=True)
    workdir = os.path.join(VIDEO_LOGS, "train")
    argv = ["--data", "(synthetic clips)", "--workdir", workdir, "--tasks", ",".join(TASKS),
            "--batch-size", str(TRAIN_B), "--n-steps", str(VIDEO_STEPS),
            "--save-freq", str(VIDEO_STEPS), "--log-freq", "1"]
    args = train_video.parse_args(argv)
    clips = SyntheticClips(args.frames, (args.image_size,) * 2, SEED + 7)
    report = {}
    zero_launches()
    t0 = time.perf_counter()
    first = train_video.run(args, clips, TASKS)
    torch.cuda.synchronize()
    report["train_s"] = time.perf_counter() - t0
    first.close()
    launches = launch_counts()
    want = {k: VIDEO_STEPS * EXPECTED_PER_TRAIN_STEP["library_wgrad"].get(k, 0) for k in launches}
    if launches != want:
        fail(f"video: train_video launches {launches}, expected {want}")
    with open(os.path.join(workdir, "metrics.jsonl")) as fh:
        losses = [r["video_train/loss"] for r in map(json.loads, fh) if "video_train/loss" in r]
    if len(losses) != VIDEO_STEPS or not np.all(np.isfinite(losses)) or first.step != VIDEO_STEPS:
        fail(f"video: train_video ran {first.step} steps, losses {losses}")
    log(f"[video] scripts/train_video.py, release width, B={TRAIN_B}, {VIDEO_STEPS} steps: "
        f"{report['train_s']:.1f} s (model build, steps, saves); losses "
        f"{[round(v, 4) for v in losses]}; K1 {launches['fused_affine_conv3x3']} launches")

    # --resume in a fresh call, with the validation sample on the 2 tasks
    sample_s = []
    sample = VideoPredModel.sample

    def timed_sample(self, *a, **k):
        t = time.perf_counter()
        out = sample(self, *a, **k)
        torch.cuda.synchronize()
        sample_s.append(time.perf_counter() - t)
        return out

    zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(VideoPredModel, "sample", timed_sample), recording() as calls:
        again = train_video.run(train_video.parse_args(argv + ["--resume", "--sample-after"]),
                                clips, TASKS)
    torch.cuda.synchronize()
    report["resume_s"] = time.perf_counter() - t0 - sum(sample_s)
    report["sample_after_s"] = sum(sample_s)
    again.close()
    sample_launches = launch_counts()
    if not _same_state(first, again, VIDEO_STEPS):
        fail("video: the resumed train_video state is not bit-equal to the saved run's")
    n_fwd = args.timesteps
    want = {k: n_fwd * EXPECTED_PER_FORWARD["padded"].get(k, 0) for k in sample_launches}
    _gate_chains("video: --sample-after", sample_launches, calls, want)
    vids = np.load(os.path.join(workdir, "validation_videos.npy"))
    if (vids.shape != (len(TASKS), args.frames, args.image_size, args.image_size, 3)
            or not np.isfinite(vids).all() or vids.min() < 0 or vids.max() > 1):
        fail(f"video: validation videos {vids.shape} not finite in [0, 1]")
    log(f"[video] --resume in a fresh call: {report['resume_s']:.1f} s (model build, load, "
        f"save), step {again.step}, weights, EMA and optimizer state bit-equal")
    log(f"[video] --sample-after, {len(TASKS)} tasks (B={len(TASKS)}, {n_fwd}-step ancestral "
        f"chain): {report['sample_after_s']:.2f} s, launches "
        f"{ {k: v for k, v in sample_launches.items() if v} } = {n_fwd} padded forwards'")
    del first, again
    gc.collect()
    torch.cuda.empty_cache()

    # sample_video --smoke 1 (a tiny model: no kernel takes its widths)
    out_dir = os.path.join(VIDEO_LOGS, "samples")
    t0 = time.perf_counter()
    sample_video.main(["--smoke", "1", "--n", "2", "--steps", "2", "--out", out_dir])
    report["sample_video_s"] = time.perf_counter() - t0
    vids = np.load(os.path.join(out_dir, "videos.npy"))
    if vids.dtype != np.uint8 or vids.shape != (2, 7, 32, 32, 3):
        fail(f"video: sample_video wrote {vids.dtype} {vids.shape}")
    pngs = all(os.path.exists(os.path.join(out_dir, f"video_{i}.png")) for i in range(2))
    if img_utils.imageio is not None and not pngs:
        fail("video: sample_video wrote no PNG strips")
    log(f"[video] scripts/sample_video.py --smoke 1: {report['sample_video_s']:.2f} s, "
        f"videos.npy uint8 {vids.shape}, PNG strips "
        + ("written" if pngs else "not written: imageio is not installed on this machine"))

    extra = {k: v for k, v in calls.items() if k not in held}
    extra_agg = {}
    if extra:
        _, extra_agg = check_kernels(rk, {"video": extra}, dev, timed=False, tag="video-shapes")
        extra_agg = extra_agg["video"]
    report["new_signatures"] = len(extra)
    log(f"[video] {smi}: {len(extra)} kernel signatures not held before")
    shutil.rmtree(VIDEO_LOGS, ignore_errors=True)
    for name, v in sample_launches.items():
        launches[name] += v
    return report, launches, extra_agg


def reference_checkpoints(rk, held, dev, smi):
    """Phase 10, the reference checkpoints into the port. The writer
    (`convert/torch_import.py::synthetic_video_checkpoint`, `SEED`) makes a
    release-schema reference video checkpoint (U-Net only, the trainer
    layout, float32); `scripts/convert_ckpt.py --kind video` converts it to
    `torch-model-{milestone}.pt`; `train/build.py::make_video_model` loads
    it into the release config's bf16 model (the parameters bit-equal, dtype
    included, to a model given the same f32 values in memory; the load's
    peak card memory within `CKPT_PEAK_SLACK` of the parameters' bytes: no
    second copy on the card); then `scripts/sample_video.py --ckpt` (B=1,
    the 100-step ancestral chain, the shipped padded routing) gives, bit for
    bit, the video the in-memory model samples with the same generator, its
    launches exactly 100 padded B=1 forwards'. A converted file with CLIP
    text weights is refused without a tokenizer (`RuntimeError`), and with
    the bundled tokenizer assets where `transformers` is missing
    (`ImportError`); where it is installed, that file loads with the real
    tokenizer and encodes the tasks. The policy: a release reference trainer
    checkpoint, `convert_ckpt --kind policy`, the converted `PolicyNets`
    bit-equal to the in-memory conversion, and one B=1 DDIM-8
    `predict_action` equal to the source policy's. Returns the report, the
    launches of the sample_video run and the per-kernel errors of any
    signature not in `held`."""
    import importlib.util

    from v2a_tpu_torch.config import load_config_module
    from v2a_tpu_torch.convert import from_jax
    from v2a_tpu_torch.convert import torch_import as ti
    from v2a_tpu_torch.models.policy import DiffusionPolicy
    from v2a_tpu_torch.models.video_model import VideoPredModel
    from v2a_tpu_torch.scripts import convert_ckpt, sample_video
    from v2a_tpu_torch.train.build import make_video_model

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_LOGS, ignore_errors=True)
    cfg = load_config_module(os.path.join(ROOT, "v2a_tpu_torch", "config", "libero",
                                          "lb_tk8_65to72.py"))
    cfg = cfg.replace(video_ckpt_dir=CKPT_LOGS, video_ckpt_milestone=CKPT_MILESTONE, seed=SEED)
    vcfg, pcfg = cfg.video, cfg.policy
    report = {}

    def timed(name, fn):
        seconds = []
        out = _timed(seconds, fn)()
        report[name] = seconds[0]
        return out

    # the video model: write, convert, load
    pt = os.path.join(CKPT_LOGS, f"model-{CKPT_MILESTONE}.pt")
    out = os.path.join(CKPT_LOGS, f"torch-model-{CKPT_MILESTONE}.pt")

    def write_video():
        ckpt = ti.synthetic_video_checkpoint(vcfg, SEED)
        os.makedirs(CKPT_LOGS)
        torch.save(ckpt, pt)
        return ckpt

    ckpt = timed("video_write_s", write_video)
    n_video = timed("video_convert_s",
                    lambda: convert_ckpt.main(["--kind", "video", "--pt", pt, "--out", out]))
    os.remove(pt)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = timed("video_load_s", lambda: make_video_model(cfg))
    param_bytes = sum(p.numel() * p.element_size() for p in model.nets.parameters())
    report["load_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    report["param_gib"] = param_bytes / 2 ** 30
    if not (model.unet.fused and model.unet.routing.padded_stream) or model.tokenizer.is_real:
        fail("checkpoints: the loaded model is not the padded routing with the hash tokenizer")
    if report["load_peak_gib"] > report["param_gib"] * CKPT_PEAK_SLACK:
        fail(f"checkpoints: the load peaked at {report['load_peak_gib']:.2f} GiB for "
             f"{report['param_gib']:.2f} GiB of parameters")
    # the same f32 values given in memory, the text tower of init(SEED)
    src = VideoPredModel(vcfg, device=dev).init(SEED)
    src.nets.unet.load_state_dict(from_jax.video_tree(ti.convert_video_unet(
        ti.extract_unet_state(ckpt), channel_mult=vcfg.channel_mult,
        num_res_blocks=vcfg.num_res_blocks, attention_resolutions=vcfg.attention_resolutions)))
    del ckpt
    got, want = model.nets.state_dict(), src.nets.state_dict()
    if got.keys() != want.keys() or not all(
            got[k].dtype == want[k].dtype == torch.float32 and torch.equal(got[k], want[k])
            for k in want):
        fail("checkpoints: the loaded parameters are not bit-equal to the source weights")
    log(f"[ckpt] {smi}: release-schema reference U-Net (U-Net only, f32) written in "
        f"{report['video_write_s']:.2f} s, converted by scripts/convert_ckpt.py "
        f"({n_video:,} params) in {report['video_convert_s']:.2f} s, loaded by "
        f"make_video_model in {report['video_load_s']:.2f} s (peak card memory "
        f"{report['load_peak_gib']:.3f} GiB for {report['param_gib']:.3f} GiB of parameters); "
        f"{len(want)} tensors bit-equal to the in-memory conversion, all float32")

    # sample_video --ckpt against the in-memory model's chain
    chain_s = []
    sample_dir = os.path.join(CKPT_LOGS, "samples")
    zero_launches()
    with mock.patch.object(VideoPredModel, "sample_u8", _timed(chain_s, VideoPredModel.sample_u8)
                           ), recording() as calls:
        videos = timed("sample_video_s", lambda: sample_video.main(
            ["--ckpt", out, "--n", "1", "--steps", str(vcfg.sampling_timesteps), "--seed",
             str(SEED), "--out", sample_dir]))
    launches = launch_counts()
    report["sample_chain_s"] = chain_s[0]
    n_fwd = vcfg.sampling_timesteps
    want_l = {k: n_fwd * EXPECTED_PER_FORWARD["padded"].get(k, 0) for k in launches}
    _gate_chains("checkpoints: sample_video --ckpt", launches, calls, want_l)
    h, w = vcfg.image_size
    frame = sample_video.synthetic_frame(h, w).astype(np.float32)[None] / 255.0
    ref = timed("source_chain_s", lambda: src.sample_u8(
        frame, ["a robot arm completes the task"],
        generator=torch.Generator(device=dev).manual_seed(SEED)).cpu().numpy())
    saved = np.load(os.path.join(sample_dir, "videos.npy"))
    if videos.shape != (1, vcfg.video_future_horizon, h, w, 3) or not (
            np.array_equal(saved, videos) and np.array_equal(videos, ref)):
        diff = (np.abs(videos.astype(np.int32) - ref.astype(np.int32)).max()
                if videos.shape == ref.shape else None)
        fail(f"checkpoints: sample_video --ckpt {videos.shape} is not bit-equal to the source "
             f"model's video (max |diff| {diff})")
    log(f"[ckpt] {smi}: scripts/sample_video.py --ckpt, B=1, {n_fwd}-step ancestral chain, "
        f"padded routing: {report['sample_video_s']:.2f} s (model build, load, chain), the "
        f"chain {report['sample_chain_s']:.2f} s; video bit-equal to the in-memory model's "
        f"with the same generator (its chain {report['source_chain_s']:.2f} s); launches {({k: v for k, v in launches.items() if v})} = "
        f"{n_fwd} padded forwards'")
    del model

    # a converted file with CLIP text weights: refused without the real tokenizer
    text_dir = os.path.join(CKPT_LOGS, "with_text")
    ti.save_video_params({"unet": ti.load_video_params(out)["unet"],
                          "text": {k: v.cpu() for k, v in src.nets.text.state_dict().items()}},
                         os.path.join(text_dir, f"torch-model-{CKPT_MILESTONE}.pt"))
    del src
    torch.cuda.empty_cache()
    try:
        VideoPredModel(vcfg, device=dev).load_converted(
            os.path.join(text_dir, f"torch-model-{CKPT_MILESTONE}.pt"))
        fail("checkpoints: text weights without a tokenizer were loaded")
    except RuntimeError as e:
        if "tokenizer" not in str(e):
            raise
    ti.write_synthetic_tokenizer(os.path.join(text_dir, "tokenizer"))
    has_hf = importlib.util.find_spec("transformers") is not None
    try:
        loaded = make_video_model(cfg.replace(video_ckpt_dir=text_dir))
        if not (has_hf and loaded.tokenizer.is_real):
            fail("checkpoints: text weights were loaded without the real tokenizer")
        import transformers

        emb = loaded.encode_batch_text(TASKS)
        if emb.shape[0] != len(TASKS) or not bool(torch.isfinite(emb).all()):
            fail("checkpoints: the real tokenizer's text embedding is not finite")
        text_gate = (f"loaded with the bundled tokenizer (transformers {transformers.__version__}"
                     f" is installed here), its text embedding of the {len(TASKS)} tasks "
                     f"{tuple(emb.shape)} finite")
        del loaded
    except ImportError as e:
        if has_hf:
            raise
        text_gate = f"refused: {type(e).__name__}: {e}"
    report["text_weights"] = text_gate
    log(f"[ckpt] a converted file with CLIP text weights: without a tokenizer refused "
        f"(RuntimeError); with the bundled tokenizer assets {text_gate}")
    shutil.rmtree(text_dir)
    torch.cuda.empty_cache()

    # the policy: write, convert, load, one DDIM-8 prediction
    ppt = os.path.join(CKPT_LOGS, "policy-model.pt")
    pout = os.path.join(CKPT_LOGS, "policy.pt")

    def write_policy():
        pckpt = ti.synthetic_policy_checkpoint(pcfg, SEED)
        torch.save(pckpt, ppt)
        return pckpt

    pckpt = timed("policy_write_s", write_policy)
    n_policy = timed("policy_convert_s",
                     lambda: convert_ckpt.main(["--kind", "policy", "--pt", ppt, "--out", pout]))
    policy = timed("policy_load_s", lambda: DiffusionPolicy.create(pcfg, device=dev).load_state_dict(
        torch.load(pout, map_location="cpu", weights_only=True)))
    source = DiffusionPolicy.create(pcfg, device=dev).load_state_dict(from_jax.policy_from_jax(
        ti.convert_policy(ti.extract_policy_state(pckpt), pcfg.obs_keys, pcfg.down_dims)))
    got, want = policy.nets.state_dict(), source.nets.state_dict()
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want):
        fail("checkpoints: the converted policy is not bit-equal to the in-memory conversion")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    h, w = pcfg.image_size
    obs = {k: torch.rand(1, h, w, 3, generator=gen, device=dev) for k in pcfg.obs_keys}
    preds = []
    for p in (policy, source):
        t = time.perf_counter()
        preds.append(p.predict_action(obs, generator=torch.Generator(device=dev).manual_seed(
            SEED))["action_pred"])
        torch.cuda.synchronize()
        report.setdefault("predict_s", time.perf_counter() - t)
    if not (torch.equal(preds[0], preds[1]) and bool(torch.isfinite(preds[0]).all())):
        fail("checkpoints: the converted policy's DDIM-8 prediction differs from the source's")
    log(f"[ckpt] {smi}: release reference policy checkpoint written in "
        f"{report['policy_write_s']:.2f} s, converted ({n_policy:,} params, the EMA) in "
        f"{report['policy_convert_s']:.2f} s, loaded in {report['policy_load_s']:.2f} s; "
        f"B=1 DDIM-8 predict_action {report['predict_s']:.3f} s, equal to the source "
        f"policy's")
    shutil.rmtree(CKPT_LOGS, ignore_errors=True)
    del policy, source
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase

    extra = {k: v for k, v in calls.items() if k not in held}
    extra_agg = {}
    if extra:
        _, extra_agg = check_kernels(rk, {"ckpt": extra}, dev, timed=False, tag="ckpt-shapes")
        extra_agg = extra_agg["ckpt"]
    report["new_signatures"] = len(extra)
    log(f"[ckpt] {smi}: {len(extra)} kernel signatures not held before; the phase "
        f"{report['phase_s']:.1f} s")
    return report, launches, extra_agg


def _family_variant(rk, name, dev):
    """Phase 11, one environment variant at its preset's widths, bf16: (a)
    a B=8 forward through each of `FAMILY_ROUTINGS` and the plain path,
    gated and timed as phase 4 gates the release forward, with
    `VARIANT_FORWARD`'s launches; (c) one B=1 request through
    `VideoPredModel.sample` (the ancestral chain of `FAMILY_TIMESTEPS` steps,
    the shipped routing), finite in [0, 1], exactly that many forwards'
    launches; (d) for the
    trained variants, a B=4 `VideoModelTrainer` gradient through the plain
    path and through train_fused with K6, each against a float32 plain
    gradient (the K6 routing at most twice as far as the plain bf16 path),
    then one timed step of each. Returns the report, the kernels'
    {signature: calls} of these runs and the launches of the chain and the
    K6 step."""
    from v2a_tpu_torch.models.env_variants import video_model_variant

    model = video_model_variant(name, device=dev, dtype="bfloat16", timesteps=FAMILY_TIMESTEPS,
                                sampling_timesteps=FAMILY_TIMESTEPS).init(SEED)
    vcfg = model.config
    if not (model.unet.fused and model.unet.routing.padded_stream):
        fail(f"{name}: the U-Net did not resolve to the padded-stream routing on cuda")
    nets = {"padded": model.unet}
    for routing in FAMILY_ROUTINGS[1:]:
        net = _routed_unet(vcfg, routing).to(dev).eval().requires_grad_(False)
        net.load_state_dict(model.unet.state_dict())
        nets[routing] = net
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f, (h, w) = vcfg.video_future_horizon, vcfg.image_size
    inputs = (torch.randn(FAMILY_B, f, h, w, vcfg.channels + vcfg.cond_ch, generator=gen,
                          device=dev),
              torch.randint(0, vcfg.timesteps, (FAMILY_B,), generator=gen, device=dev),
              model.encode_batch_text((TASKS * 4)[:FAMILY_B]))
    params = sum(p.numel() for p in model.unet.parameters())
    log(f"[family] {name}: {h}x{w}, channels {vcfg.channels} on a {vcfg.cond_ch}-channel "
        f"condition, mc {vcfg.model_channels}, mult {vcfg.channel_mult}, "
        f"{vcfg.num_res_blocks} res blocks, attention at ds {vcfg.attention_resolutions}; "
        f"U-Net {params / 1e6:.1f} M params, bf16")
    calls = {}
    for routing, net in nets.items():
        with recording() as c, torch.no_grad():
            net(*inputs)
        calls[routing] = c
    report = check_forward(rk, nets, inputs, vcfg, dev, expected=VARIANT_FORWARD[name],
                           tag=f"family {name}")
    report["params"] = params
    for routing in FAMILY_ROUTINGS[1:]:
        del nets[routing]
    torch.cuda.empty_cache()

    # (c) one request through the shipped routing
    frame = torch.rand(1, h, w, vcfg.cond_ch, generator=gen, device=dev)
    zero_launches()
    with recording() as chain_calls:
        t0 = time.perf_counter()
        video = model.sample(frame, [TASKS[0]], generator=gen)
        torch.cuda.synchronize()
        report["request_s"] = time.perf_counter() - t0
    chain = launch_counts()
    _gate_chains(f"{name}: request", chain, chain_calls,
                 {k: vcfg.sampling_timesteps * VARIANT_FORWARD[name]["padded"].get(k, 0)
                  for k in chain})
    if (video.shape != (1, f, h, w, vcfg.channels) or not bool(torch.isfinite(video).all())
            or video.min() < 0 or video.max() > 1):
        fail(f"{name}: sampled video {tuple(video.shape)} not finite in [0, 1]")
    log(f"[family] {name}: one request (B=1, {vcfg.sampling_timesteps}-step ancestral, padded "
        f"routing): {report['request_s']:.2f} s, launches "
        f"{ {k: v for k, v in chain.items() if v} }")
    calls["request"] = chain_calls
    if name in VARIANT_TRAIN_STEP:
        train_report, calls["train"], step_launches = _family_train(model, vcfg, dev, name)
        report["train"] = train_report
        for k, v in step_launches.items():
            chain[k] += v
    del model, nets
    gc.collect()
    torch.cuda.empty_cache()
    return report, calls, chain


def _family_train(model, vcfg, dev, name):
    """(d) of `_family_variant`: returns the report, the K6 routing's
    {signature: calls} and its step's launches."""
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    clips, init, batch, noise, _, grads32 = _train_problem(model, vcfg, dev)
    report = dict(batch=TRAIN_B, ms_per_step={}, peak_gib={}, grad_rel_err={})
    grads, k6_calls, k6_launches = {}, {}, {}
    for routing, flags in (("plain", dict(train_fused=False)),
                           ("k6", dict(train_fused=True, wgrad_kernel=True))):
        cfg = VideoTrainerConfig(batch_size=TRAIN_B, n_train_steps=2, save_freq=10 ** 9,
                                 log_freq=1, **flags)
        workdir = os.path.join(FAMILY_LOGS, f"{name}_{routing}")
        trainer = VideoModelTrainer(model, clips, cfg, workdir=workdir, seed=SEED)
        zero_launches()
        with recording() as step_calls:
            trainer.loss_and_grads(*batch, noise=noise)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        want = VARIANT_TRAIN_STEP[name] if routing == "k6" else {}
        if launches != want:
            fail(f"{name}: {routing} train-step launches {launches}, expected {want}")
        grads[routing] = {k: p.grad.detach().clone()
                          for k, p in trainer.train_unet.named_parameters()}
        if routing == "k6":
            k6_calls, k6_launches = step_calls, launch_counts()
        trainer.state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(2):  # a warm-up step, then the timed one
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            loss, _ = trainer.train_step(*batch)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            if not np.isfinite(float(loss)):
                fail(f"{name}: {routing} train step gave a non-finite loss")
        if not all(bool(torch.isfinite(p).all()) for p in trainer.train_unet.parameters()):
            fail(f"{name}: {routing} train step left non-finite parameters")
        report["ms_per_step"][routing] = ms
        report["peak_gib"][routing] = torch.cuda.max_memory_allocated() / 2 ** 30
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    shutil.rmtree(FAMILY_LOGS, ignore_errors=True)
    model.unet.load_state_dict(init)
    rel = {r: _grad_rel(g, grads32) for r, g in grads.items()}
    report["grad_rel_err"] = rel
    if rel["k6"][0] > 2 * rel["plain"][0] or rel["k6"][1] > 2 * rel["plain"][1]:
        fail(f"{name}: the K6 routing's gradient strays further from float32 than twice the "
             "bf16 plain path")
    log(f"[family] {name}: B={TRAIN_B} train step, ms (warm-up, timed) "
        + "; ".join(f"{r} {[round(v, 1) for v in m]} peak {report['peak_gib'][r]:.1f} GiB"
                    for r, m in report["ms_per_step"].items())
        + "; gradient rel. error vs float32 (whole, worst leaf) "
        + "; ".join(f"{r} {v[0]:.3e} {v[1]:.3e}" for r, v in rel.items())
        + f"; K6 routing launches per step {VARIANT_TRAIN_STEP[name]}")
    return report, k6_calls, k6_launches


def _family_xattn(dev):
    """Phase 11, the cross-attention backbone at the release widths
    (`VideoModelConfig(backbone="xattn", dtype="bfloat16")`: 128^2, F=7,
    block channels 128 x (1, 2, 3, 4, 5), 2 layers a block, 8 heads, text
    512): a B=8 forward against the float32 one (max error over the float32
    output's std under `FAMILY_ERR_BOUND`, finite), one B=1 chain of
    `FAMILY_TIMESTEPS` steps,
    then `scripts/train_video.py --backbone xattn` for 2 steps on synthetic
    clips at `XATTN_TRAIN_B`, or the largest batch below it that fits, and
    `--resume --sample-after` in a fresh call, bit-equal. It launches no
    kernel of the port (plain PyTorch: the JAX module is plain XLA)."""
    from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
    from v2a_tpu_torch.scripts import train_video

    vcfg = VideoModelConfig(backbone="xattn", dtype="bfloat16", timesteps=FAMILY_TIMESTEPS,
                            sampling_timesteps=FAMILY_TIMESTEPS)
    model = VideoPredModel(vcfg, device=dev).init(SEED)
    with torch.device(dev):
        ref = VideoPredModel(dataclasses.replace(vcfg, dtype="float32"), device=dev).build_unet()
    ref.load_state_dict(model.unet.state_dict())
    ref.eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    f, (h, w) = vcfg.video_future_horizon, vcfg.image_size
    inputs = (torch.randn(FAMILY_B, f, h, w, 6, generator=gen, device=dev),
              torch.randint(0, vcfg.timesteps, (FAMILY_B,), generator=gen, device=dev),
              model.encode_batch_text((TASKS * 4)[:FAMILY_B]))
    report = dict(params=model.param_count())
    zero_launches()
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        out16 = model.unet(*inputs)
        report["forward_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out32 = ref(*inputs)
        report["forward_ms"] = time_ms(lambda: model.unet(*inputs), 2, 1)
    if out16.shape != (FAMILY_B, f, h, w, 3) or not bool(torch.isfinite(out16).all()):
        fail("xattn: the bf16 forward is not finite of the expected shape")
    report["err_over_std"] = float((out16 - out32).abs().max()) / float(out32.std())
    if not report["err_over_std"] < FAMILY_ERR_BOUND:
        fail(f"xattn: bf16 forward max error / std {report['err_over_std']:.3e} against float32 "
             f"is not under {FAMILY_ERR_BOUND}")
    del ref, out16, out32
    torch.cuda.empty_cache()
    frame = torch.rand(1, h, w, 3, generator=gen, device=dev)
    t0 = time.perf_counter()
    video = model.sample(frame, [TASKS[0]], generator=gen)
    torch.cuda.synchronize()
    report["request_s"] = time.perf_counter() - t0
    if not bool(torch.isfinite(video).all()) or video.min() < 0 or video.max() > 1:
        fail("xattn: the sampled video is not finite in [0, 1]")
    if any(launch_counts().values()):
        fail(f"xattn: launched kernels {launch_counts()}")
    log(f"[family] xattn: {report['params'] / 1e6:.1f} M params (U-Net and text), bf16; B=8 "
        f"forward {report['forward_ms']:.1f} ms, peak "
        f"{report['forward_peak_gib']:.1f} GiB, max error / std vs float32 "
        f"{report['err_over_std']:.3e}; one request (B=1, {vcfg.sampling_timesteps}-step "
        f"ancestral) {report['request_s']:.2f} s")
    del model, video
    gc.collect()
    torch.cuda.empty_cache()

    shutil.rmtree(FAMILY_LOGS, ignore_errors=True)
    workdir = os.path.join(FAMILY_LOGS, "xattn")
    clips = SyntheticClips(f, (h, w), SEED + 9)
    b = XATTN_TRAIN_B
    while True:
        argv = ["--data", "(synthetic clips)", "--workdir", workdir, "--tasks", ",".join(TASKS),
                "--batch-size", str(b), "--n-steps", str(VIDEO_STEPS), "--save-freq",
                str(VIDEO_STEPS), "--log-freq", "1", "--backbone", "xattn",
                "--timesteps", str(FAMILY_TIMESTEPS)]
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            first = train_video.run(train_video.parse_args(argv), clips, TASKS)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if b == 1:
                raise
            log(f"[family] xattn: train_video at B={b} does not fit the card")
            b -= 1
            shutil.rmtree(workdir, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
    report["train_b"], report["train_s"] = b, time.perf_counter() - t0
    report["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    first.close()
    with open(os.path.join(workdir, "metrics.jsonl")) as fh:
        losses = [r["video_train/loss"] for r in map(json.loads, fh) if "video_train/loss" in r]
    if len(losses) != VIDEO_STEPS or not np.all(np.isfinite(losses)) or first.step != VIDEO_STEPS:
        fail(f"xattn: train_video ran {first.step} steps, losses {losses}")
    t0 = time.perf_counter()
    again = train_video.run(train_video.parse_args(argv + ["--resume", "--sample-after"]),
                            clips, TASKS)
    torch.cuda.synchronize()
    report["resume_sample_s"] = time.perf_counter() - t0
    again.close()
    if not _same_state(first, again, VIDEO_STEPS):
        fail("xattn: the resumed train_video state is not bit-equal to the saved run's")
    vids = np.load(os.path.join(workdir, "validation_videos.npy"))
    if vids.shape != (len(TASKS), f, h, w, 3) or not np.isfinite(vids).all():
        fail(f"xattn: validation videos {vids.shape} not finite")
    if any(launch_counts().values()):
        fail(f"xattn: launched kernels {launch_counts()}")
    log(f"[family] xattn: scripts/train_video.py --backbone xattn, B={b}, {VIDEO_STEPS} steps "
        f"{report['train_s']:.1f} s (build, steps, saves), peak {report['train_peak_gib']:.1f} "
        f"GiB, losses {[round(v, 4) for v in losses]}; --resume --sample-after (B={len(TASKS)}) "
        f"{report['resume_sample_s']:.1f} s, state bit-equal")
    del first, again
    shutil.rmtree(FAMILY_LOGS, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return report


def _family_transformer(dev):
    """Phase 11, `TransformerForDiffusion` at the JAX class's defaults (8
    layers, 4 heads, n_emb 256, horizon 16) with `causal_attn=True` and
    `cond_dim` the release policy's `global_cond_dim`: B=1 and B=64 bf16
    forwards against float32 (max error over the float32 output's std under
    `FAMILY_ERR_BOUND`), then one backward and one AdamW step (`make_train_step`
    with `fused_clip_adamw`, the release recipe) at B=64, finite; ms of
    each by CUDA events."""
    from v2a_tpu_torch.models.init import init_params
    from v2a_tpu_torch.models.policy import PolicyConfig
    from v2a_tpu_torch.models.transformer_policy import TransformerForDiffusion
    from v2a_tpu_torch.train.train_state import (
        EMAConfig, OptimizerConfig, PolicyTrainState, fused_clip_adamw, make_train_step)

    kw = dict(cond_dim=PolicyConfig().global_cond_dim, causal_attn=True)
    net = TransformerForDiffusion(dtype=torch.bfloat16, **kw).to(dev)
    init_params(net, torch.Generator(device=dev).manual_seed(SEED))
    ref = TransformerForDiffusion(dtype=torch.float32, **kw).to(dev)
    ref.load_state_dict(net.state_dict())
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def batch(b):
        return (torch.randn(b, 16, 7, generator=gen, device=dev),
                torch.randint(0, 100, (b,), generator=gen, device=dev),
                torch.randn(b, kw["cond_dim"], generator=gen, device=dev))

    report = dict(params=sum(p.numel() for p in net.parameters()), cond_dim=kw["cond_dim"],
                  forward_ms={}, err_over_std={})
    with torch.no_grad():
        for b in TFD_BATCHES:
            args = batch(b)
            out, want = net(*args), ref(*args)
            err = float((out - want).abs().max()) / float(want.std())
            if out.shape != (b, 16, 7) or not bool(torch.isfinite(out).all()) or not (
                    err < FAMILY_ERR_BOUND):
                fail(f"transformer: B={b} bf16 forward error / std {err:.3e} or shape "
                     f"{tuple(out.shape)}")
            report["err_over_std"][b] = err
            report["forward_ms"][b] = time_ms(lambda: net(*args))
    x, t, cond = batch(TFD_BATCHES[-1])
    target = torch.randn(x.shape, generator=gen, device=dev)
    tx = fused_clip_adamw(OptimizerConfig())
    state = PolicyTrainState(net, tx)
    step = make_train_step(lambda bt, g: (net(bt["x"], bt["t"], bt["cond"]) - bt["y"])
                           .square().mean(), tx, EMAConfig())
    ms = []
    for _ in range(2):  # a warm-up step, then the timed one
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(state, dict(x=x, t=t, cond=cond, y=target), gen)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        if not (np.isfinite(float(out.loss)) and np.isfinite(float(out.grad_norm))):
            fail("transformer: the train step gave a non-finite loss or gradient norm")
    if not all(bool(torch.isfinite(p).all()) for p in state.params + state.ema_params):
        fail("transformer: non-finite weights after the AdamW step")
    report["train_ms"] = ms
    log(f"[family] transformer: {report['params'] / 1e6:.2f} M params, causal, cond_dim "
        f"{kw['cond_dim']}; bf16 forward ms {report['forward_ms']} (B), error / std vs float32 "
        + ", ".join(f"B={b} {e:.3e}" for b, e in report["err_over_std"].items())
        + f"; B={TFD_BATCHES[-1]} backward + AdamW step ms (warm-up, timed) "
        f"{[round(v, 2) for v in ms]}")
    if any(launch_counts().values()):
        fail(f"transformer: launched kernels {launch_counts()}")
    return report


def model_families(rk, held, dev, smi):
    """Phase 11, the model families: each of `FAMILY_VARIANTS`
    (`_family_variant`), then (b) every kernel signature their runs gave
    that the earlier phases did not hold against its plain version on
    `SEEDS` input sets, with its plan; then the xattn backbone and the
    transformer denoiser (no kernel of the port: zero launches). Returns the
    report, the per-shape rows, the per-kernel errors and the launches of
    the main-path runs (the requests and the K6 train steps)."""
    t_phase = time.perf_counter()
    log("[family] libero, mw and thor_luo are presets equal to the release config, which "
        "phases 4-5 run; not repeated")
    report, calls, launches = {}, {}, dict.fromkeys(rk.launches, 0)
    for name in FAMILY_VARIANTS:
        report[name], variant_calls, variant_launches = _family_variant(rk, name, dev)
        for run, c in variant_calls.items():
            for key, n in c.items():
                calls[key] = calls.get(key, 0) + n
        for k, v in variant_launches.items():
            launches[k] += v
    extra = {k: v for k, v in calls.items() if k not in held}
    rows, agg = [], {}
    if extra:
        rows, agg = check_kernels(rk, {"family": extra}, dev, timed=False, tag="family-shapes")
        agg = agg["family"]
    report["new_signatures"] = len(extra)
    log(f"[family] {smi}: {len(extra)} kernel signatures not held before, each within its gate")
    zero_launches()
    report["xattn"] = _family_xattn(dev)
    report["transformer"] = _family_transformer(dev)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[family] phase 11 wall time {report['phase_s']:.1f} s ({smi})")
    return report, rows, agg, launches


# phase 12, the guided image family: the published flag sets of
# openai/guided-diffusion's README (its "64x64 model", "64x64 classifier" and
# "64x64 -> 256x256 upsampler"). `--dropout 0.1`, `--use_new_attention_order
# True` and `--num_heads 4` are left out: neither package has them (heads
# come from `--num_head_channels 64`)
GUIDED_MODEL_FLAGS = [
    "--attention_resolutions", "32,16,8", "--class_cond", "True", "--diffusion_steps", "1000",
    "--image_size", "64", "--learn_sigma", "True", "--noise_schedule", "cosine",
    "--num_channels", "192", "--num_head_channels", "64", "--num_res_blocks", "3",
    "--resblock_updown", "True", "--use_scale_shift_norm", "True"]
GUIDED_CLASSIFIER_FLAGS = [
    "--image_size", "64", "--classifier_attention_resolutions", "32,16,8",
    "--classifier_depth", "4", "--classifier_width", "128", "--classifier_pool", "attention",
    "--classifier_resblock_updown", "True", "--classifier_use_scale_shift_norm", "True"]
GUIDED_SR_FLAGS = [
    "--large_size", "256", "--small_size", "64", "--num_channels", "192",
    "--num_res_blocks", "2", "--attention_resolutions", "32,16,8", "--class_cond", "True",
    "--learn_sigma", "True", "--noise_schedule", "linear", "--resblock_updown", "True",
    "--use_scale_shift_norm", "True"]
# bf16 compute (the JAX package maps --use_fp16 to bf16), for the classifier too
GUIDED_FP16 = ["--use_fp16", "True", "--classifier_use_fp16", "True"]
GUIDED_IMAGES = (64, 64)  # synthetic class-prefixed .npy images, count and side
GUIDED_CLASSES = 8
GUIDED_RESPACING = "25"
# batches: the forward gate, image_train, image_sample, classifier_train and
# classifier_sample, super_res_train (less by one while it does not fit),
# super_res_sample, image_nll
GUIDED_B = dict(forward=16, train=8, sample=16, classifier=8, sr_train=4, sr_sample=4,
                sr_samples=6, nll=4)
GUIDED_TRAIN_STEPS = 3
GUIDED_LOGS = os.path.join(ROOT, "logs", "chip_smoke_guided")
GUIDED_BUDGET_S = 120


def _draw_every_parameter(net, seed):
    """Every parameter from `seed`: `init_params`, then the layers it keeps
    at zero drawn as their kind is (lecun-normal), and every vector (norm
    scales, biases) moved by 0.1 x a normal draw. A fresh image U-Net
    outputs exactly zero, which no gate can read."""
    from torch import nn

    from v2a_tpu_torch.models.init import init_params

    dev = next(net.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    init_params(net, gen)
    with torch.no_grad():
        for m in net.modules():
            if getattr(m, "zero_init", False):
                for p in m.parameters(recurse=False):
                    if p.ndim > 1:
                        fan_in = p.shape[1] if isinstance(m, nn.Linear) else p[..., 0].numel()
                        p.normal_(0.0, fan_in ** -0.5, generator=gen)
        for p in net.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=dev))
    return net


def _block_errors(net16, net32, args):
    """Max |bf16 - f32| / std(f32) at the output of every top-level block,
    in the order they run: where the bf16 error grows."""
    outs = {}

    def hook(tag, name):
        def fn(module, inputs, out):
            outs.setdefault(name, {})[tag] = out.float()
        return fn

    handles = [m.register_forward_hook(hook(tag, name))
               for tag, net in (("bf16", net16), ("f32", net32))
               for name, m in net.named_children()]
    with torch.no_grad():
        net16(*args)
        net32(*args)
    for h in handles:
        h.remove()
    return {name: float((o["bf16"] - o["f32"]).abs().max() / o["f32"].std())
            for name, o in outs.items() if len(o) == 2}


def _device_profile(fn, top=8):
    """One call of `fn` under `torch.profiler`, read by
    `utils/profiling.py::rollup`: the device's busy ms (the union of the
    kernel intervals), their summed ms, the host's wall ms around the call,
    the idle share against each, and the `top` host ops by the device time
    of the kernels they launch. Fails where the profiler saw no kernel."""
    from v2a_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profiling.trace(None) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    res = profiling.rollup(prof, topk=top, wall_ms=wall, out=None)
    if not res["n_events"] or not 0 < res["busy_ms"] <= wall:
        fail(f"torch.profiler: {res['n_events']} kernels, busy {res['busy_ms']} ms of "
             f"{wall} ms wall")
    return dict(busy_ms=res["busy_ms"], summed_ms=res["summed_ms"], wall_ms=wall,
                idle_share=res["idle_share"], idle_share_summed=1 - res["summed_ms"] / wall,
                categories=res["categories"],
                top=[dict(op=o["op"], ms=o["ms"], calls=o["calls"]) for o in res["ops"]])


@contextlib.contextmanager
def _timed_train_steps(log_to):
    """`GuidedTrainLoop.run_step` timed by CUDA events: (ms, loss) a step."""
    from v2a_tpu_torch.guided.train_loop import GuidedTrainLoop

    real = GuidedTrainLoop.run_step

    def run_step(self, x, kwargs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        loss = real(self, x, kwargs)
        e1.record()
        torch.cuda.synchronize()
        log_to.append((e0.elapsed_time(e1), loss))
        return loss

    with mock.patch.object(GuidedTrainLoop, "run_step", run_step):
        yield


def _npz_ok(path, n, side, labels):
    with np.load(path) as obj:
        arr = obj["arr_0"]
        lab = obj["arr_1"] if "arr_1" in obj.files else None
    ok = arr.dtype == np.uint8 and arr.shape == (n, side, side, 3)
    if labels:
        ok = ok and lab is not None and lab.shape == (n,)
    if not ok:
        fail(f"guided: {path} holds {arr.dtype} {arr.shape}, labels "
             f"{None if lab is None else lab.shape}")
    return arr


def _guided_train(main, argv, b, report, tag):
    """One train CLI at batch `b`, less by one while it does not fit: its
    loop; the batch, (ms, loss) per step, wall s and peak GiB in
    `report[tag]`."""
    while True:
        steps = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with _timed_train_steps(steps):
                loop = main(argv + ["--batch_size", str(b)])
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if b == 1:
                raise
            log(f"[guided] {tag} at B={b} does not fit the card")
            b -= 1
            gc.collect()
            torch.cuda.empty_cache()
    report[tag] = dict(b=b, ms=[s[0] for s in steps], loss=[s[1] for s in steps],
                       s=time.perf_counter() - t0,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if not steps or not np.all(np.isfinite([s[1] for s in steps])):
        fail(f"guided: {tag} losses {[s[1] for s in steps]}")
    log(f"[guided] {tag}: B={b}, {len(steps)} steps, ms per step (CUDA events) "
        f"{[round(s[0], 1) for s in steps]}, losses {[round(s[1], 4) for s in steps]}, peak "
        f"{report[tag]['peak_gib']:.2f} GiB, wall {report[tag]['s']:.1f} s (build, steps, saves)")
    return loop


def _guided_images():
    """The `GUIDED_IMAGES` synthetic uint8 images (N, side, side, 3)."""
    n, side = GUIDED_IMAGES
    rng = np.random.default_rng(SEED)
    return np.stack([rng.integers(0, 255, (side, side, 3), np.uint8) for _ in range(n)])


def _write_guided_images(d):
    """`GUIDED_IMAGES` uint8 .npy images, class-prefixed file names."""
    os.makedirs(d, exist_ok=True)
    for i, img in enumerate(_guided_images()):
        np.save(os.path.join(d, f"c{i % GUIDED_CLASSES:03d}_{i}.npy"), img)


def guided_family(dev, smi):
    """Phase 12, the guided image family through its CLIs (`main(argv)` of
    `v2a_tpu_torch/scripts/guided/`), bf16, weights from a seed, the README's
    flag sets: (a) the 64x64 model's B=16 forward with every parameter drawn,
    bf16 against float32 (max error over the float32 output's std under
    `FAMILY_ERR_BOUND`; else the error at every block is logged), ms by CUDA
    events; (b) `image_train` for `GUIDED_TRAIN_STEPS` steps at B=8, then
    `--resume_checkpoint` for 1 more (finite losses, the snapshot and EMA
    files, the restored weights bit-equal to the file); (c) `image_sample`
    from (b)'s snapshot, B=16, 25 respaced steps, ancestral and DDIM; (d)
    `classifier_train` 2 steps at B=8, then `classifier_sample` (scale 1.0,
    25 steps, B=8; the first `cond_fn` gradient finite and non-zero); (e)
    `super_res_train` 2 steps at B=4 (or the largest that fits), then one
    step with `--use_checkpoint True` (the same first loss, a lower peak);
    (f) `super_res_sample` on (c)'s samples, 6 at B=4 (the tail padded),
    (6, 256, 256, 3); (g) `image_nll` on 4 images, 25 steps; (h) no kernel of
    the port launched in the whole phase (the JAX nets reach no Pallas
    kernel). Returns the report."""
    from v2a_tpu_torch.guided import create_model_and_diffusion, model_and_diffusion_defaults
    from v2a_tpu_torch.guided.script_util import args_subset
    from v2a_tpu_torch.scripts.guided import (
        _common, classifier_sample, classifier_train, image_nll, image_sample, image_train,
        super_res_sample, super_res_train)

    t_phase = time.perf_counter()
    zero_launches()
    shutil.rmtree(GUIDED_LOGS, ignore_errors=True)
    imgs = os.path.join(GUIDED_LOGS, "images")
    _write_guided_images(imgs)
    side = GUIDED_IMAGES[1]
    cuda = ["--device", str(dev)]
    model_flags = GUIDED_MODEL_FLAGS + GUIDED_FP16[:2] + cuda
    report = {}

    # (a) the 64x64 model: bf16 against float32, every parameter drawn
    defaults = model_and_diffusion_defaults()
    args = _common.parse(model_flags, defaults)
    net16, _ = create_model_and_diffusion(**args_subset(args, defaults), device=dev)
    _draw_every_parameter(net16, SEED + 12)
    args.use_fp16 = False
    net32, _ = create_model_and_diffusion(**args_subset(args, defaults), device=dev)
    net32.load_state_dict(net16.state_dict())
    for net in (net16, net32):
        net.eval().requires_grad_(False)
    b = GUIDED_B["forward"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    fwd = (torch.randn(b, side, side, 3, generator=gen, device=dev),
           torch.randint(0, 1000, (b,), generator=gen, device=dev),
           torch.randint(0, 1000, (b,), generator=gen, device=dev))
    report["model_params"] = sum(p.numel() for p in net16.parameters())
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        out16 = net16(*fwd)
        report["forward_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out32 = net32(*fwd)
        report["forward_ms"] = time_ms(lambda: net16(*fwd), 5, 2)
        report["forward_f32_ms"] = time_ms(lambda: net32(*fwd), 3, 1)
        report["forward_profile"] = _device_profile(lambda: net16(*fwd))
    if out16.shape != (b, side, side, 6) or not bool(torch.isfinite(out16).all()):
        fail(f"guided: the bf16 forward gave {tuple(out16.shape)}, finite "
             f"{bool(torch.isfinite(out16).all())}")
    report["err_over_std"] = float((out16 - out32).abs().max()) / float(out32.std())
    log(f"[guided] {smi}: 64x64 model {report['model_params'] / 1e6:.1f} M params, B={b} bf16 "
        f"forward {report['forward_ms']:.2f} ms (float32 {report['forward_f32_ms']:.2f}), peak "
        f"{report['forward_peak_gib']:.2f} GiB, max error / std vs float32 "
        f"{report['err_over_std']:.3e}")
    prof = report["forward_profile"]
    log(f"[guided] B={b} bf16 forward under torch.profiler: device busy "
        f"{prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms wall, idle share "
        f"{prof['idle_share']:.3f} by the union of the kernel intervals "
        f"({prof['idle_share_summed']:.3f} by their sum, {prof['summed_ms']:.2f} ms); by op "
        f"(device ms, calls): " + ", ".join(
            f"{r['op']} {r['ms']:.2f} ({r['calls']:.0f})" for r in prof["top"]))
    if not report["err_over_std"] < FAMILY_ERR_BOUND:
        for name, err in _block_errors(net16, net32, fwd).items():
            log(f"[guided]   {name}: max error / std {err:.3e}")
        fail(f"guided: bf16 forward max error / std {report['err_over_std']:.3e} against "
             f"float32 is not under {FAMILY_ERR_BOUND}")
    del net16, net32, out16, out32
    gc.collect()
    torch.cuda.empty_cache()

    # (b) image_train, then a resumed step
    train_dir = os.path.join(GUIDED_LOGS, "train")
    train_argv = model_flags + ["--data_dir", imgs, "--out_dir", train_dir, "--log_interval", "1",
                                "--save_interval", "0", "--lr", "1e-4"]
    loop = _guided_train(image_train.main, train_argv + ["--max_steps", str(GUIDED_TRAIN_STEPS)],
                         GUIDED_B["train"], report, "image_train")
    n = GUIDED_TRAIN_STEPS
    snap = os.path.join(train_dir, f"model{n:06d}.pt")
    for path in (snap, os.path.join(train_dir, f"ema_0.9999_{n:06d}.pt")):
        if not os.path.exists(path):
            fail(f"guided: image_train wrote no {path}")
    del loop
    restored = []
    real_restore = image_train.init_or_restore

    def restore(model, path, *a, **k):
        out = real_restore(model, path, *a, **k)
        restored.append({n_: v.detach().cpu().clone() for n_, v in out.state_dict().items()})
        return out

    with mock.patch.object(image_train, "init_or_restore", restore):
        loop = _guided_train(image_train.main, train_argv + [
            "--max_steps", "1", "--resume_checkpoint", snap], GUIDED_B["train"], report,
            "image_train_resumed")
    saved = torch.load(snap, map_location="cpu", weights_only=True)
    if not (restored and set(restored[0]) == set(saved)
            and all(torch.equal(restored[0][k], saved[k]) for k in saved)):
        fail("guided: the resumed image_train weights are not the saved snapshot's")
    del loop, saved, restored
    gc.collect()
    torch.cuda.empty_cache()
    log("[guided] image_train --resume_checkpoint: the restored weights bit-equal to "
        f"{os.path.basename(snap)}")

    # (c) image_sample, ancestral and DDIM
    steps = ["--timestep_respacing", GUIDED_RESPACING]
    b = GUIDED_B["sample"]
    samples = {}
    for kind, extra in (("ancestral", []), ("ddim", ["--use_ddim", "True"])):
        t0 = time.perf_counter()
        samples[kind] = image_sample.main(model_flags + steps + extra + [
            "--model_path", snap, "--num_samples", str(b), "--batch_size", str(b),
            "--out_dir", os.path.join(GUIDED_LOGS, f"sample_{kind}")])
        report[f"sample_{kind}_s"] = time.perf_counter() - t0
        _npz_ok(samples[kind], b, side, labels=True)
    # phase 16 evaluates the ancestral batch against the synthetic images
    os.makedirs(EVAL_LOGS, exist_ok=True)
    shutil.copy(samples["ancestral"], os.path.join(EVAL_LOGS, "sample.npz"))
    log(f"[guided] image_sample B={b}, {GUIDED_RESPACING} respaced steps: ancestral "
        f"{report['sample_ancestral_s']:.2f} s, DDIM {report['sample_ddim_s']:.2f} s a batch "
        f"({smi})")

    # (d) classifier_train, then classifier-guided sampling
    b = GUIDED_B["classifier"]
    cls_flags = GUIDED_CLASSIFIER_FLAGS + GUIDED_FP16[2:] + cuda
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cls_ckpt = classifier_train.main(cls_flags + [
        "--data_dir", imgs, "--batch_size", str(b), "--max_steps", "2", "--save_interval", "0",
        "--log_interval", "1", "--out_dir", os.path.join(GUIDED_LOGS, "classifier")])
    torch.cuda.synchronize()
    report["classifier_train_s"] = time.perf_counter() - t0
    report["classifier_train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    cls_state = torch.load(cls_ckpt, map_location="cpu", weights_only=True)
    report["classifier_params"] = sum(v.numel() for v in cls_state.values())
    if not all(bool(torch.isfinite(v).all()) for v in cls_state.values()):
        fail("guided: classifier_train wrote non-finite weights")
    grads = []
    real_cond = classifier_sample.make_cond_fn

    def recording(classifier, scale):
        fn = real_cond(classifier, scale)

        def cond_fn(x, t, y=None):
            g = fn(x, t, y)
            if not grads:
                grads.append((bool(torch.isfinite(g).all()), float(g.abs().max())))
            return g
        return cond_fn

    t0 = time.perf_counter()
    with mock.patch.object(classifier_sample, "make_cond_fn", recording):
        guided = classifier_sample.main(model_flags + cls_flags + steps + [
            "--model_path", snap, "--classifier_path", cls_ckpt, "--classifier_scale", "1.0",
            "--num_samples", str(b), "--batch_size", str(b),
            "--out_dir", os.path.join(GUIDED_LOGS, "classifier_sample")])
    report["classifier_sample_s"] = time.perf_counter() - t0
    _npz_ok(guided, b, side, labels=True)
    if not (grads and grads[0][0] and grads[0][1] > 0):
        fail(f"guided: the first cond_fn gradient (finite, max |g|) {grads}")
    report["cond_fn_max_abs"] = grads[0][1]
    log(f"[guided] classifier_train: {report['classifier_params'] / 1e6:.1f} M params, B={b}, "
        f"2 steps {report['classifier_train_s']:.1f} s, peak "
        f"{report['classifier_train_peak_gib']:.2f} GiB; classifier_sample B={b}, "
        f"{GUIDED_RESPACING} steps {report['classifier_sample_s']:.2f} s, first cond_fn "
        f"max |grad| {grads[0][1]:.3e}")

    # (e) super_res_train, then a step with --use_checkpoint
    sr_flags = GUIDED_SR_FLAGS + GUIDED_FP16[:2] + cuda
    sr_dir = os.path.join(GUIDED_LOGS, "super_res")
    sr_argv = sr_flags + ["--data_dir", imgs, "--log_interval", "1", "--save_interval", "0"]
    loop = _guided_train(super_res_train.main, sr_argv + ["--max_steps", "2", "--out_dir", sr_dir],
                         GUIDED_B["sr_train"], report, "super_res_train")
    report["sr_params"] = sum(p.numel() for p in loop.model.parameters())
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    plain = report["super_res_train"]
    loop = _guided_train(super_res_train.main, sr_argv + [
        "--max_steps", "1", "--use_checkpoint", "True", "--out_dir", sr_dir + "_checkpoint"],
        plain["b"], report, "super_res_train_checkpoint")
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = report["super_res_train_checkpoint"]
    loss_diff = abs(ckpt["loss"][0] - plain["loss"][0])
    log(f"[guided] super_res_train: {report['sr_params'] / 1e6:.1f} M params; --use_checkpoint "
        f"True: first loss {ckpt['loss'][0]!r} against {plain['loss'][0]!r} (difference "
        f"{loss_diff:.3e}), peak {ckpt['peak_gib']:.2f} against {plain['peak_gib']:.2f} GiB")
    if loss_diff > 1e-3 * abs(plain["loss"][0]) or not ckpt["peak_gib"] < plain["peak_gib"]:
        fail("guided: --use_checkpoint changed the loss or did not lower the peak memory")

    # (f) super_res_sample on (c)'s samples
    n, b = GUIDED_B["sr_samples"], GUIDED_B["sr_sample"]
    big = int(GUIDED_SR_FLAGS[GUIDED_SR_FLAGS.index("--large_size") + 1])
    t0 = time.perf_counter()
    up = super_res_sample.main(sr_flags + steps + [
        "--model_path", os.path.join(sr_dir, "model000002.pt"),
        "--base_samples", samples["ancestral"], "--num_samples", str(n), "--batch_size", str(b),
        "--out_dir", os.path.join(GUIDED_LOGS, "super_res_sample")])
    report["super_res_sample_s"] = time.perf_counter() - t0
    _npz_ok(up, n, big, labels=True)
    log(f"[guided] super_res_sample: {n} images at B={b} ({-(-n // b)} batches, the tail padded), "
        f"{GUIDED_RESPACING} steps, {report['super_res_sample_s']:.2f} s, ({n}, {big}, {big}, 3)")

    # (g) image_nll
    b = GUIDED_B["nll"]
    nll_dir = os.path.join(GUIDED_LOGS, "nll")
    t0 = time.perf_counter()
    bpd = image_nll.main(model_flags + steps + [
        "--data_dir", imgs, "--model_path", snap, "--num_samples", str(b),
        "--batch_size", str(b), "--out_dir", nll_dir])
    report["nll_s"], report["bpd"] = time.perf_counter() - t0, bpd
    for term in ("vb", "mse", "xstart_mse"):
        with np.load(os.path.join(nll_dir, f"{term}_terms.npz")) as obj:
            vals = obj["arr_0"]
        if vals.shape != (int(GUIDED_RESPACING),) or not np.isfinite(vals).all():
            fail(f"guided: image_nll {term}_terms {vals.shape}, finite {np.isfinite(vals).all()}")
    if not np.isfinite(bpd):
        fail(f"guided: image_nll bpd={bpd}")
    log(f"[guided] image_nll: {b} images, {GUIDED_RESPACING} steps, bpd={bpd:.4f}, "
        f"{report['nll_s']:.2f} s")

    # (h) no hand kernel
    if any(launch_counts().values()):
        fail(f"guided: launched kernels {launch_counts()}")
    shutil.rmtree(GUIDED_LOGS, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[guided] no kernel of the port launched in the phase; phase 12 wall time "
        f"{report['phase_s']:.1f} s (budget {GUIDED_BUDGET_S}) ({smi})")
    return report


def lab_kernels(rk, routing_calls, dev):
    """Phase 13, the lab kernels' main paths, then their gates. The port's
    perf lab (`winobench2`, `tconvbench2`), the path that launches K14 and
    K15; K13 held against K3 at every K3 signature of the padded forward, on
    K3's first input set, bit for bit (the JAX package's own caller of K13,
    `tests/test_pallas_kernels.py:712`, holds it against K3). The counts are
    zeroed before and read after each. Then every lab kernel against its
    plain version on `SEEDS` input sets, timed: K13 at K3's signatures
    (weighted by K3's calls per forward), K14 at K10's signatures of
    `spatial_k10_k11` (weighted by K10's) and at the lab's, K15 at the lab's.
    Returns (lab launches, lab rows, the perf lab's rows and seconds, per
    shape rows, per-forward sums)."""
    from v2a_tpu_torch.scripts import perf_lab

    zero_launches()
    with recording() as lab_calls:
        t0 = time.perf_counter()
        lab_rows = perf_lab.main(["winobench2", "tconvbench2"], device=dev)
        torch.cuda.synchronize()
        lab_s = time.perf_counter() - t0
    launches = launch_counts()
    log(f"[lab] perf lab winobench2 + tconvbench2: {lab_s:.1f} s, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    k3_keys = sorted((k for k in routing_calls["padded"] if k[0] == "k3"), key=str)
    zero_launches()
    with torch.no_grad():
        for key in k3_keys:
            inp = Inputs(rk, torch.Generator(device=dev).manual_seed(seed_of(key, 0)), dev)
            args = _k3_args(key, inp)
            if not _k13_vs_k3(rk, key, args, rk.fused_conv_tconv_dma(*args))[0]:
                fail(f"K13 is not bit-equal to K3 at {_k3_label(key)}")
    torch.cuda.synchronize()
    launches["fused_conv_tconv_dma"] = launch_counts()["fused_conv_tconv_dma"]
    log(f"[lab] K13 ({K13_COPIES} copies) bit-equal to K3 (output interior and statistics) at "
        f"the {len(k3_keys)} K3 signatures of the padded forward")
    for name in ("fused_conv_tconv_dma", "winograd_conv3x3", "temporal_conv_taps"):
        if not launches[name]:
            fail(f"{name} was not launched on its path")
    gated = {("k13",) + k[1:]: routing_calls["padded"][k] for k in k3_keys}
    gated.update({("k14",) + k[1:]: v for k, v in routing_calls["spatial_k10_k11"].items()
                  if k[0] == "k10"})
    for k in lab_calls:
        if k[0] in ("k14", "k15"):
            gated.setdefault(k, 1 if k[0] == "k15" else 0)
    # K9 at head widths no release routing uses, each of which its kernel runs
    # in masked or 128-wide slices (C 640: one head of 640 down to 80 of 8)
    gated.update({("k9", 2, hw, 640, ch, True): 0 for hw in ((16, 16), (8, 8))
                  for ch in K9_WIDTHS})
    rows, agg = check_kernels(rk, {"lab": gated}, dev, timed=True, tag="lab")
    return launches, lab_rows, lab_s, rows, agg


def lab_paths(dev, smi):
    """Phase 13, the perf lab's paths at release width through its `main`:
    `LAB_FORWARDS` (each forward's launches equal to `LAB_PER_FORWARD`, its
    output finite), the two traces (each names every hand kernel of
    `LAB_TRACE_KERNELS` by its C entry with a nonzero device time; 0 < busy
    <= wall), the benches (finite ms). Returns the rows and seconds."""
    from v2a_tpu_torch.ops import resblock_kernels as rk
    from v2a_tpu_torch.scripts import perf_lab

    t0 = time.perf_counter()
    rows = perf_lab.main(list(LAB_FORWARDS), device=dev, iters=LAB_ITERS)
    forwards_s = time.perf_counter() - t0
    for r in rows:
        if r["launches"] != LAB_PER_FORWARD[r["name"]] or not r["finite"]:
            fail(f"lab {r['name']}: launches {r['launches']} (want "
                 f"{LAB_PER_FORWARD[r['name']]}), finite {r['finite']}")
    traces = perf_lab.main(["trace_chain"], device=dev, chain=LAB_CHAIN_STEPS)
    traces += perf_lab.main(["trace_vtrain:4:tfused"], device=dev)
    for r in traces:
        want = {rk.KERNELS[n]["k"]: rk.KERNELS[n]["entry"] for n in LAB_TRACE_KERNELS[r["bench"]]}
        got = {k: (h["entry"], h["ms"]) for k, h in r["hand"].items()}
        missing = [k for k, e in want.items() if k not in got or got[k][0] != e or got[k][1] <= 0]
        if not r["n_events"] or not 0 < r["busy_ms"] <= r["ms"] or missing:
            fail(f"lab {r['bench']}: {r['n_events']} kernels, busy {r['busy_ms']} of "
                 f"{r['ms']} ms wall; hand kernels {got}, missing {missing}")
        log(f"[lab] {smi}: {r['bench']} per {r['per']}: busy {r['busy_ms']:.3f} of "
            f"{r['ms']:.3f} ms wall, idle share {r['idle_share']:.3f}; hand kernels "
            + ", ".join(f"{k} {e} {ms:.3f} ms" for k, (e, ms) in sorted(got.items()))
            + "; top categories " + ", ".join(f"{c['category']} {c['ms']:.3f}"
                                              for c in r["categories"][:5]))
    zero_launches()
    benches = perf_lab.main(list(LAB_BENCHES), device=dev, chain=10, iters=3)
    bench_launches = {k: v for k, v in launch_counts().items() if v}
    if not all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in benches):
        fail("lab benches: a row without a finite time")
    lab_s = time.perf_counter() - t0
    log(f"[lab] {smi}: the perf lab's paths in {lab_s:.1f} s (forwards {forwards_s:.1f} s): "
        + ", ".join(f"{r['name']} {r['ms']:.2f} ms" for r in rows)
        + f"; the benches' launches {bench_launches}")
    return dict(forwards=rows, traces=traces, benches=benches, bench_launches=bench_launches,
                seconds=lab_s)



# phase 15, the mesh on torch.distributed and rematerialisation: the
# world-1 NCCL mesh's train step, sampler and online cycle against the runs
# without a mesh; on more than one card a dp step over them; the B=4 step
# under each remat policy against the step without remat
MESH_LOGS = os.path.join(ROOT, "logs", "chip_smoke_mesh")
MESH_SAMPLE_B = 2
MESH_ONLINE_STEPS = 5  # the guided cycle at step 4 (ONLINE_OVERRIDES' schedule)
REMAT_RUNS = {  # name: (trainer flags, the run its loss and gradients are held against)
    "none": (dict(train_fused=False), None),
    "blocks": (dict(train_fused=False, use_checkpoint=True, remat_policy="blocks"), "none"),
    "levels": (dict(train_fused=False, use_checkpoint=True, remat_policy="levels"), "none"),
    "mxu": (dict(train_fused=False, use_checkpoint=True, remat_policy="mxu"), "none"),
    "tfused": (dict(TRAIN_ROUTINGS["k6"]), None),
    "blocks_tfused": (dict(TRAIN_ROUTINGS["k6"], use_checkpoint=True, remat_policy="blocks"),
                      "tfused"),
}
# a remat step's gradient against the same step without remat: whole-vector
# relative L2 error (the recomputed forward is the same; the sums into the
# weight gradients may run in another order)
REMAT_GRAD_BOUND = 1e-2
XATTN_REMAT_B = 4
# dp cards of (b), where the machine has more than one: 4 or 2 (TRAIN_B rows)
MESH_DP_BOUND = dict(loss_rel=1e-2, param_abs=2e-4)


def _k1_in_res_blocks(net):
    """Counts K1 launches made inside the net's `ResBlock3D` forwards (what a
    "blocks" recomputation re-runs); returns (counter, hook handles)."""
    from v2a_tpu_torch.models.video_unet import ResBlock3D

    count, stack, handles = {"k1": 0}, [], []
    for mod in net.modules():
        if isinstance(mod, ResBlock3D):
            handles.append(mod.register_forward_pre_hook(
                lambda *_: stack.append(launch_counts()["fused_affine_conv3x3"])))
            handles.append(mod.register_forward_hook(lambda *_: count.__setitem__(
                "k1", count["k1"] + launch_counts()["fused_affine_conv3x3"] - stack.pop())))
    return count, handles


def _mesh_world1(model, vcfg, dev, smi, clips, batch, report, launches, calls_all):
    """Phase 15 (a): the world-1 NCCL mesh's train step, sampler and online
    cycle, each against its run without a mesh."""
    from v2a_tpu_torch.config import apply_overrides, load_config_module
    from v2a_tpu_torch.models.video_model import VideoPredModel
    from v2a_tpu_torch.parallel.mesh import make_mesh
    from v2a_tpu_torch.train.build import build_experiment
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    mesh = make_mesh(("dp", "tp"), (1, 1))
    cfg = VideoTrainerConfig(batch_size=TRAIN_B, n_train_steps=1, save_freq=10 ** 9,
                             log_freq=10 ** 9, **TRAIN_ROUTINGS["k6"])
    runs = {}
    for name, m in (("single", None), ("mesh", mesh)):
        trainer = VideoModelTrainer(model, clips, cfg, workdir=os.path.join(MESH_LOGS, name),
                                    seed=SEED, mesh=m)
        zero_launches()
        with recording() as calls:
            loss, per_sample = trainer.train_step(*batch)
        torch.cuda.synchronize()
        runs[name] = (loss, per_sample, {k: v.detach().clone()
                                         for k, v in trainer.train_unet.state_dict().items()},
                      {k: v for k, v in launch_counts().items() if v})
        if m is not None:
            for k, v in calls.items():
                calls_all[k] = calls_all.get(k, 0) + v
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    (l0, p0, w0, n0), (l1, p1, w1, n1) = runs["single"], runs["mesh"]
    want = EXPECTED_PER_TRAIN_STEP["k6"]
    if n0 != want or n1 != want:
        fail(f"mesh: train step launches {n1} (without a mesh {n0}), expected {want}")
    same = torch.equal(l0, l1) and torch.equal(p0, p1) and all(torch.equal(w0[k], w1[k])
                                                               for k in w0)
    if not same:
        fail("mesh: the world-1 mesh train step is not bit-equal to the step without a mesh")
    for k, v in n1.items():
        launches[k] += v
    report["train_step"] = dict(loss=float(l1), launches=n1, bit_equal=True)
    log(f"[mesh] {smi}: world-1 NCCL mesh (dp=1, tp=1), B={TRAIN_B} train_fused step: loss "
        f"{float(l1):.6f}, per-sample losses and post-step parameters bit-equal to the step "
        f"without a mesh, launches {n1}")
    del runs, w0, w1

    # the sampler: shard_for_mesh, a B=2 chain against the same chain without
    smodel = VideoPredModel(vcfg, device=dev)
    smodel.nets.load_state_dict(model.nets.state_dict())
    h, w = vcfg.image_size
    frames = torch.rand(MESH_SAMPLE_B, h, w, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 13))
    tasks = TASKS[:MESH_SAMPLE_B]
    v0 = smodel.sample(frames, tasks, generator=torch.Generator(device=dev).manual_seed(SEED))
    smodel.shard_for_mesh(mesh)
    zero_launches()
    t0 = time.perf_counter()
    with recording() as calls:
        v1 = smodel.sample(frames, tasks, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    got = launch_counts()
    n_fwd = vcfg.sampling_timesteps
    _gate_chains("mesh: sampler", got, calls,
                 {k: n_fwd * EXPECTED_PER_FORWARD["padded"].get(k, 0) for k in got})
    if not torch.equal(v0, v1):
        fail("mesh: the sharded sampler's video is not bit-equal to the one without a mesh")
    for k, v in got.items():
        launches[k] += v
    for k, v in calls.items():
        calls_all[k] = calls_all.get(k, 0) + v
    report["sampler"] = dict(b=MESH_SAMPLE_B, s=sample_s, bit_equal=True)
    log(f"[mesh] shard_for_mesh + sample (B={MESH_SAMPLE_B}, {n_fwd}-step ancestral): "
        f"{sample_s:.2f} s, bit-equal to the sample without a mesh, launches "
        f"{ {k: v for k, v in got.items() if v} } = {n_fwd} padded forwards'")
    del smodel, v0, v1
    torch.cuda.empty_cache()

    # the online loop: build_experiment with mesh_axes=("auto_dp",) on phase
    # 8's cut config, its env pool, one guided cycle
    ocfg = load_config_module(os.path.join(ROOT, "v2a_tpu_torch", "config", "libero",
                                           "lb_tk8_65to72.py"))
    ocfg = apply_overrides(ocfg, dict(ONLINE_OVERRIDES, logbase=MESH_LOGS, exp_name="online",
                                      mesh_axes=("auto_dp",), n_env_workers=POOL_WORKERS,
                                      **{"trainer.n_train_steps": MESH_ONLINE_STEPS}))
    t0 = time.perf_counter()
    trainer, _, env_list, video_model = build_experiment(ocfg, snapshot=False)
    try:
        if trainer.mesh is None or trainer.mesh.shape != {"dp": 1}:
            fail(f"mesh: the online trainer's mesh is {trainer.mesh}")
        checks = []
        check = trainer.check_buffers_equal

        def counted_check():
            check()
            checks.append(trainer.buffer_digest().hex()[:16])

        trainer.check_buffers_equal = counted_check
        zero_launches()
        with recording() as calls:
            trainer.train()
        torch.cuda.synchronize()
        online_s = time.perf_counter() - t0
        got = launch_counts()
    finally:
        trainer.env_pool.close()
    _gate_chains("mesh: online", got, calls,
                 {k: n_fwd * EXPECTED_PER_FORWARD["padded"].get(k, 0) for k in got})
    if (trainer.step != MESH_ONLINE_STEPS or trainer.cnt_vid_rollouts != len(env_list.task_list)
            or len(checks) != 1):
        fail(f"mesh: online ran {trainer.step} steps, {trainer.cnt_vid_rollouts} guided "
             f"rollouts, {len(checks)} buffer checks")
    for k, v in got.items():
        launches[k] += v
    for k, v in calls.items():
        calls_all[k] = calls_all.get(k, 0) + v
    report["online"] = dict(s=online_s, steps=trainer.step, rollouts=trainer.cnt_vid_rollouts,
                            digest=checks[0])
    log(f"[mesh] online loop on the auto_dp mesh ({POOL_WORKERS} env workers): build, "
        f"{MESH_ONLINE_STEPS} steps and one guided cycle {online_s:.1f} s, "
        f"{trainer.cnt_vid_rollouts} rollouts, the buffer digest check passed ({checks[0]}), "
        f"launches {n_fwd} B=8 padded forwards'")
    del trainer, video_model
    gc.collect()
    torch.cuda.empty_cache()


def _mesh_cards(model, vcfg, batch, noise, smi, report):
    """Phase 15 (b): where the machine has more than one card, one dp video
    train step over 4 (or 2) cards on NCCL against the single-card step."""
    from v2a_tpu_torch.parallel.dryrun import video_step_rank
    from v2a_tpu_torch.parallel.multihost import spawn_ranks
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    n = torch.cuda.device_count()
    if n < 2:
        report["cards"] = None
        log(f"[mesh] (b) NOT RUN: {n} card on this machine; the dp step over several cards "
            f"runs where torch.cuda.device_count() > 1 (the world-1 mesh of (a) ran)")
        return
    world = 4 if n >= 4 else 2
    train_kw = dict(batch_size=TRAIN_B, n_train_steps=1, save_freq=10 ** 9, log_freq=10 ** 9,
                    **TRAIN_ROUTINGS["k6"])
    out = os.path.join(MESH_LOGS, "cards")
    os.makedirs(out, exist_ok=True)
    problem = os.path.join(out, "problem.pt")
    torch.save(dict(unet=model.unet.state_dict(), batch=batch, noise=noise), problem)
    single = VideoModelTrainer(model, None, VideoTrainerConfig(**train_kw),
                               workdir=os.path.join(out, "single"))
    loss, _ = single.train_step(*batch, noise=noise)
    want = {k: v.detach() for k, v in single.train_unet.state_dict().items()}
    t0 = time.perf_counter()
    spawn_ranks(video_step_rank, world, os.path.join(out, "store"),
                args=(out, "cuda", dataclasses.asdict(vcfg), train_kw, problem), device="cuda")
    got = torch.load(os.path.join(out, "dp_step.pt"), weights_only=True)
    rel = abs(float(got["loss"]) - float(loss)) / abs(float(loss))
    worst = max(float((got["params"][k].to(v.device) - v).abs().max()) for k, v in want.items())
    if rel > MESH_DP_BOUND["loss_rel"] or worst > MESH_DP_BOUND["param_abs"]:
        fail(f"mesh: dp={world} step loss rel. error {rel:.3e}, parameters {worst:.3e} off "
             f"the single-card step's (bounds {MESH_DP_BOUND})")
    report["cards"] = dict(world=world, loss_rel=rel, param_abs=worst,
                           s=time.perf_counter() - t0)
    log(f"[mesh] {smi}: dp={world} NCCL ranks, one B={TRAIN_B} train_fused step: loss rel. "
        f"error {rel:.3e}, parameters within {worst:.3e} of the single-card step")
    single.close()


def _remat_steps(model, vcfg, dev, smi, clips, batch, noise, report, launches, calls_all):
    """Phase 15 (c): the B=4 release step under each remat policy against the
    step without remat, then the xattn backbone at B=4 with
    `--use-checkpoint`."""
    from v2a_tpu_torch.scripts import train_video
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    refs, rows = {}, {}
    for name, (flags, ref) in REMAT_RUNS.items():
        cfg = VideoTrainerConfig(batch_size=TRAIN_B, n_train_steps=2, save_freq=10 ** 9,
                                 log_freq=10 ** 9, **flags)
        trainer = VideoModelTrainer(model, clips, cfg, workdir=os.path.join(MESH_LOGS, name),
                                    seed=SEED)
        counter, hooks = _k1_in_res_blocks(trainer.train_unet)
        zero_launches()
        with recording() as calls:
            loss, _ = trainer.loss_and_grads(*batch, noise=noise)
        torch.cuda.synchronize()
        got = {k: v for k, v in launch_counts().items() if v}
        for h in hooks:
            h.remove()
        grads = {k: p.grad.detach().clone() for k, p in trainer.train_unet.named_parameters()}
        trainer.apply_gradients()
        # the timed step: gradients and the update
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        trainer.loss_and_grads(*batch, noise=noise)
        trainer.apply_gradients()
        e1.record()
        torch.cuda.synchronize()
        row = dict(ms=e0.elapsed_time(e1), peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   loss=float(loss), launches=got)
        if ref is None:
            refs[name] = (loss, grads, counter["k1"])
            want = EXPECTED_PER_TRAIN_STEP["k6" if flags.get("train_fused") else "plain"]
        else:
            l_ref, g_ref, k1_blocks = refs[ref]
            if not torch.equal(loss, l_ref):
                fail(f"remat {name}: loss {float(loss)} is not bit-equal to {ref}'s "
                     f"{float(l_ref)}")
            row["grad_rel"], row["grad_rel_worst_leaf"] = _grad_rel(grads, g_ref)
            if not row["grad_rel"] <= REMAT_GRAD_BOUND:
                fail(f"remat {name}: gradient rel. error {row['grad_rel']:.3e} against {ref} "
                     f"over {REMAT_GRAD_BOUND}")
            want = dict(EXPECTED_PER_TRAIN_STEP["k6" if flags.get("train_fused") else "plain"])
            if want:  # "blocks" re-runs every ResBlock's K1 forwards in the backward
                row["k1_recomputed"] = k1_blocks
                want["fused_affine_conv3x3"] += k1_blocks
        if got != want:
            fail(f"remat {name}: launches {got}, expected {want}")
        for k, v in got.items():
            launches[k] += v
        for k, v in calls.items():
            calls_all[k] = calls_all.get(k, 0) + v
        rows[name] = row
        log(f"[remat] {smi}: {name}, B={TRAIN_B}: {row['ms']:.1f} ms per step, peak "
            f"{row['peak_gib']:.2f} GiB, loss {row['loss']:.6f}"
            + (f" bit-equal to {ref}'s, gradient rel. error {row['grad_rel']:.3e} (worst leaf "
               f"{row['grad_rel_worst_leaf']:.3e})" if ref else "")
            + (f", launches {got} ({row['k1_recomputed']} K1 forwards recomputed)"
               if "k1_recomputed" in row else (f", launches {got}" if got else "")))
        trainer.close()
        del trainer, grads
        torch.cuda.empty_cache()
    for name in ("blocks", "levels"):
        if not rows[name]["peak_gib"] < rows["none"]["peak_gib"]:
            fail(f"remat {name}: peak {rows[name]['peak_gib']:.2f} GiB is not below the step "
                 f"without remat ({rows['none']['peak_gib']:.2f} GiB)")
    log(f"[remat] levels against blocks: {rows['levels']['peak_gib']:.2f} against "
        f"{rows['blocks']['peak_gib']:.2f} GiB, {rows['levels']['ms']:.1f} against "
        f"{rows['blocks']['ms']:.1f} ms per step")
    report["remat"] = rows
    del refs
    gc.collect()
    torch.cuda.empty_cache()

    # the xattn backbone through the CLI at B=4 with --use-checkpoint
    workdir = os.path.join(MESH_LOGS, "xattn")
    f, (h, w) = vcfg.video_future_horizon, vcfg.image_size
    argv = ["--data", "(synthetic clips)", "--workdir", workdir, "--tasks", ",".join(TASKS),
            "--batch-size", str(XATTN_REMAT_B), "--n-steps", str(VIDEO_STEPS), "--save-freq",
            str(VIDEO_STEPS), "--log-freq", "1", "--backbone", "xattn", "--use-checkpoint"]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    trainer = train_video.run(train_video.parse_args(argv), SyntheticClips(f, (h, w), SEED + 9),
                              TASKS)
    torch.cuda.synchronize()
    xs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer.close()
    with open(os.path.join(workdir, "metrics.jsonl")) as fh:
        losses = [r["video_train/loss"] for r in map(json.loads, fh) if "video_train/loss" in r]
    if (trainer.step != VIDEO_STEPS or len(losses) != VIDEO_STEPS
            or not np.all(np.isfinite(losses)) or not trainer.train_unet.use_checkpoint):
        fail(f"xattn --use-checkpoint: {trainer.step} steps, losses {losses}")
    if any(launch_counts().values()):
        fail(f"xattn --use-checkpoint: launched kernels {launch_counts()}")
    report["xattn"] = dict(b=XATTN_REMAT_B, s=xs, peak_gib=peak, losses=losses)
    log(f"[remat] {smi}: scripts/train_video.py --backbone xattn --use-checkpoint, "
        f"B={XATTN_REMAT_B}, {VIDEO_STEPS} steps {xs:.1f} s (build, steps, saves), peak "
        f"{peak:.2f} GiB, losses {[round(v, 4) for v in losses]}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


def mesh_and_remat(rk, held, model, vcfg, dev, smi):
    """Phase 15: the mesh on `torch.distributed` and rematerialisation, at
    release width, bf16. (a) A one-rank NCCL process group on an in-memory
    store: a B=4 train_fused `VideoModelTrainer` step on `make_mesh(("dp",
    "tp"), (1, 1))` bit-equal to the step without a mesh (loss, per-sample
    losses, post-step parameters; K1 / K6 launches phase 6's), a B=2
    `sample` after `shard_for_mesh` bit-equal to the sample without a mesh
    (exactly 100 padded forwards' launches), and one guided cycle of the
    online loop through `build_experiment` with `mesh_axes=("auto_dp",)` on
    phase 8's cut config (its env pool; exactly 100 B=8 forwards'; the
    buffer digest check run and passed). (b) With more than one card, a dp
    step over 4 (or 2) NCCL ranks against the single-card step; with one,
    a line saying it did not run. (c) The B=4 step under each remat policy
    (`REMAT_RUNS`): the loss bit-equal to the step without remat, the
    gradient within `REMAT_GRAD_BOUND`, "blocks" with train_fused
    launching K1 the step's 116 plus the ResBlock forwards it recomputes
    (counted by hooks on the step without remat), ms and peak GiB per
    policy, "blocks" and "levels" below the peak without remat; then
    `train_video --backbone xattn --use-checkpoint` at B=4 for 2 steps.
    Returns the report, the launches and the per-kernel errors of any
    signature not in `held`."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    shutil.rmtree(MESH_LOGS, ignore_errors=True)
    report, calls_all = {}, {}
    launches = {name: 0 for name in rk.KERNELS}
    clips = SyntheticClips(vcfg.video_future_horizon, vcfg.image_size, SEED + 11)
    rng = np.random.default_rng(SEED + 12)
    x_cond, video, tasks = clips.sample_batch(TRAIN_B, rng)
    batch = (torch.as_tensor(video, device=dev),
             (torch.as_tensor(x_cond, device=dev) * 2.0 - 1.0)[:, None],
             model.encode_batch_text(tasks),
             torch.as_tensor(rng.integers(0, vcfg.timesteps, TRAIN_B), device=dev),
             torch.ones(TRAIN_B, device=dev))
    noise = torch.randn(batch[0].shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 14))
    parts = report["parts_s"] = {}
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        _mesh_world1(model, vcfg, dev, smi, clips, batch, report, launches, calls_all)
    finally:
        dist.destroy_process_group()
    parts["world1"], t0 = time.perf_counter() - t0, time.perf_counter()
    _mesh_cards(model, vcfg, batch, noise, smi, report)
    parts["cards"], t0 = time.perf_counter() - t0, time.perf_counter()
    _remat_steps(model, vcfg, dev, smi, clips, batch, noise, report, launches, calls_all)
    parts["remat_and_xattn"] = time.perf_counter() - t0

    extra = {k: v for k, v in calls_all.items() if k not in held}
    extra_agg = {}
    if extra:
        _, extra_agg = check_kernels(rk, {"mesh": extra}, dev, timed=False, tag="mesh-shapes")
        extra_agg = extra_agg["mesh"]
    report["new_signatures"] = len(extra)
    held.update(extra)  # the later phases need not hold them again
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh] {smi}: {len(extra)} kernel signatures not held before; phase 15 wall time "
        f"{report['phase_s']:.1f} s (world-1 mesh {parts['world1']:.1f} s, the cards "
        f"{parts['cards']:.1f} s, remat and xattn {parts['remat_and_xattn']:.1f} s)")
    shutil.rmtree(MESH_LOGS, ignore_errors=True)
    return report, launches, extra_agg


# phase 16, the last modules: sample-quality evaluation on phase 12's
# samples, the policy trunk's pools, the U-Net's scale-shift norm and the
# train_fused routing's three switches
EVAL_LOGS = os.path.join(ROOT, "logs", "chip_smoke_eval")
# the JAX CLI's JSON keys, in its order (`scripts/evaluate_samples.py:108-117`)
EVAL_KEYS = ["inception_score", "inception_score_std", "fid", "sfid", "precision", "recall",
             "inception_calibrated", "n_ref", "n_sample"]
EVAL_CLI_FLAGS = []  # flags added to both CLI calls (a CPU rehearsal: --device cpu)
EVAL_CPU_N = 8  # images whose features are held against the CPU forward
EVAL_FEATURE_BOUND = 1e-3  # of the CPU features' std
EVAL_REPS = 5  # timed B=64 Inception forwards
POOL_STEPS = 2  # timed policy steps per pool
SSS_B = 8
# the scale-shift U-Net's unpadded fused forward: the unpadded routing's
# launches (tests/test_torch_left_out_options.py traces the same against JAX
# at a small size), every K1 without the GroupNorm affine
SSS_PER_FORWARD = {"fused_affine_conv3x3": 73, "temporal_conv_fused": 63}
# the train_fused routing's switches: VideoModelConfig fields, K6 as the
# wgrad in each, and the launches of one B=4 step (traced on the meta device)
TRAIN_SWITCHES = {
    "k6": ({}, {"fused_affine_conv3x3": 116, "wgrad_conv3x3": 58}),
    "k6_min_s_4096": (dict(wgrad_min_s=4096), {"fused_affine_conv3x3": 116,
                                                "wgrad_conv3x3": 22}),
    "dgrad_library": (dict(train_dgrad_kernel=False), {"fused_affine_conv3x3": 58,
                                                       "wgrad_conv3x3": 58}),
    "tconv_dot": (dict(train_tconv_dot=True), {"fused_affine_conv3x3": 116,
                                               "wgrad_conv3x3": 58}),
}
SWITCH_STEPS = 2  # timed steps after the gradient step
LAST_BUDGET_S = 75


def _run_counted(launches, calls_all, fn):
    """`fn()` with the counts zeroed before and read after: its launches
    (also added to `launches`) and its kernels' {signature: calls} (added to
    `calls_all`)."""
    zero_launches()
    with recording() as calls:
        out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    for k, v in got.items():
        launches[k] += v
    for k, v in calls.items():
        calls_all[k] = calls_all.get(k, 0) + v
    return out, got


def _evaluation(dev, smi):
    """Phase 16 (a): `python -m v2a_tpu_torch.scripts.evaluate_samples` on
    phase 12's ancestral `image_sample` batch against the synthetic images
    it was trained on, once with `--inception` on a synthetic
    `inception_v3` state dict (an fc head added, for IS) and once with the
    random conv trunk, both processes at once: the JSON keys in the JAX
    CLI's order, finite FID / sFID, precision and recall in [0, 1]. Then the
    Inception net in this process: the card's pooled and sFID features of
    `EVAL_CPU_N` images within `EVAL_FEATURE_BOUND` of their std of the CPU
    forward on the same weights (TF32 off), and ms per B=64 float32 forward
    (CUDA events, the resize to 299 included)."""
    from v2a_tpu_torch.ops import inception as inc

    sample = os.path.join(EVAL_LOGS, "sample.npz")
    if not os.path.exists(sample):
        fail("evaluation: phase 12's image_sample batch is missing")
    images = _guided_images()
    ref = os.path.join(EVAL_LOGS, "ref.npz")
    np.savez(ref, arr_0=images)
    sd = inc.synthetic_state_dict(SEED)
    rs = np.random.RandomState(SEED + 1)
    sd["fc.weight"] = (rs.randn(1000, inc.FEATURE_DIM) * 0.01).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    weights = os.path.join(EVAL_LOGS, "inception_v3.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, weights)
    argv = [sys.executable, "-m", "v2a_tpu_torch.scripts.evaluate_samples", ref, sample]
    runs = {"inception": argv + ["--inception", weights] + EVAL_CLI_FLAGS,
            "random_trunk": argv + EVAL_CLI_FLAGS}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(a, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True) for name, a in runs.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode:
            fail(f"evaluation: evaluate_samples ({name}) exited {proc.returncode}: "
                 f"{stderr[-2000:]}")
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    cli_s = time.perf_counter() - t0
    n_sample = len(np.load(sample)["arr_0"])
    for name, res in out.items():
        calibrated = name == "inception"
        if (list(res) != EVAL_KEYS or res["inception_calibrated"] is not calibrated
                or (res["n_ref"], res["n_sample"]) != (len(images), n_sample)
                or not np.isfinite(res["fid"]) or not 0 <= res["precision"] <= 1
                or not 0 <= res["recall"] <= 1
                or (res["sfid"] is not None) is not calibrated
                or (calibrated and not np.isfinite(res["sfid"]))
                or (not calibrated and res["inception_score"] is not None)):
            fail(f"evaluation: evaluate_samples ({name}) printed {res}")
    log(f"[eval] {smi}: evaluate_samples on image_sample's {n_sample} images against "
        f"{len(images)} references, both runs at once {cli_s:.1f} s wall: --inception "
        f"{out['inception']}; random trunk {out['random_trunk']}")

    params = inc.load_inception_params(weights)
    model = inc.inception_model(params, dev)
    cpu = inc.inception_model(params, "cpu")
    x = images[:EVAL_CPU_N].astype(np.float32) / 255.0
    got = [t.cpu() for t in inc.inception_forward(model, x, return_spatial=True)]
    want = inc.inception_forward(cpu, x, return_spatial=True)
    errs = {k: float((g - w).abs().max() / w.std())
            for k, g, w in zip(("pooled", "sfid"), got, want)}
    if not all(e <= EVAL_FEATURE_BOUND for e in errs.values()):
        fail(f"evaluation: the card's Inception features against the CPU's (err/std) {errs}")
    x64 = torch.as_tensor(images, device=dev).float() / 255.0
    ms = time_ms(lambda: inc.inception_forward(model, x64), EVAL_REPS, 2)
    log(f"[eval] {smi}: Inception (float32, TF32 off) B={len(images)} forward {ms:.2f} ms, "
        f"{len(images) / ms * 1e3:.0f} images/s; the card against the CPU on {EVAL_CPU_N} "
        f"images, max err/std pooled {errs['pooled']:.2e}, sFID features {errs['sfid']:.2e}")
    del model, cpu, x64
    torch.cuda.empty_cache()
    return dict(cli=out, cli_wall_s=cli_s, inception_ms=ms, batch=len(images),
                images_per_s=len(images) / ms * 1e3, feature_err_over_std=errs)


def _pools(dev, smi):
    """Phase 16 (b): the trunk's pools at the release policy's pool input
    (B=64 post-ReLU (64, 64, 64, 64) bf16): "packed" bit-equal to
    `F.max_pool2d`, its gradient within one bf16 ulp of `F.max_pool2d`'s;
    "mask_bwd" on a plateau reaching every position (its tie rule), its
    gradient equal to the CPU's; then a B=64 release policy step per pool
    (`train_policy`), ms per step."""
    from v2a_tpu_torch.ops import pool

    def grad(fn, inp, co):
        inp = inp.clone().requires_grad_(True)
        (fn(inp).float() * co.float()).sum().backward()
        return inp.grad

    def library(t):
        return F.max_pool2d(t, 3, 2, 1)

    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    x = F.relu(torch.randn(POLICY_B, 64, 64, 64, generator=gen, device=dev)).bfloat16()
    co = torch.randn(POLICY_B, 64, 32, 32, generator=gen, device=dev).bfloat16()
    if not torch.equal(pool.max_pool_3x3s2(x).view(torch.int16), library(x).view(torch.int16)):
        fail("pools: the packed forward is not bit-equal to F.max_pool2d")
    g_packed = grad(pool.max_pool_3x3s2, x, co)
    # against the library's bf16 gradient and its float32 one on the same values
    (ok, g_err, _, _), (ok32, g_err32, _, _) = (
        within_one_ulp(g_packed, grad(library, x, co)),
        within_one_ulp(g_packed, grad(library, x.float(), co)))
    if not (ok and ok32):
        fail(f"pools: the packed gradient strays beyond one bf16 ulp ({g_err:.3e}; of the "
             f"float32 gradient {g_err32:.3e})")
    plateau, ones = torch.zeros(1, 1, 8, 8).bfloat16(), torch.ones(1, 1, 4, 4).bfloat16()
    g_mask = grad(pool.max_pool_3x3s2_maskbwd, plateau.to(dev), ones.to(dev)).cpu()
    if not (bool((g_mask > 0).all())
            and torch.equal(g_mask, grad(pool.max_pool_3x3s2_maskbwd, plateau, ones))):
        fail(f"pools: mask_bwd's plateau gradient {g_mask}")
    log(f"[pools] {smi}: packed forward bit-equal to F.max_pool2d at {tuple(x.shape)} bf16, its "
        f"gradient within one ulp of F.max_pool2d's (max |err| {g_err:.3e}; of its float32 "
        f"gradient {g_err32:.3e}); mask_bwd reaches all 64 positions of an 8x8 plateau, as on "
        f"the CPU")
    steps = {p: train_policy(dev, pool=p, steps=POOL_STEPS) for p in ("max", "packed",
                                                                     "mask_bwd")}
    return dict(grad_max_abs_err=g_err, grad_max_abs_err_f32=g_err32,
                ms_per_step={p: r["ms_per_step"] for p, r in steps.items()},
                loss={p: r["loss"] for p, r in steps.items()})


def _scale_shift(model, vcfg, dev, smi, launches, calls_all):
    """Phase 16 (c): the release-width U-Net with `use_scale_shift_norm`,
    bf16, its own weights from the seed: a B=8 forward through the unpadded
    fused routing (`SSS_PER_FORWARD`'s launches) and the plain path, each
    within twice the bf16 plain path's error of the float32 plain forward
    (phase 4's gate), times in turns; the default (padded) routing refuses
    it with the JAX package's `ValueError`."""
    from v2a_tpu_torch.models.init import init_params
    from v2a_tpu_torch.models.video_unet import ConvRouting, VideoUNet

    kw = dict(_unet_kw(vcfg), use_scale_shift_norm=True)

    def net(dtype, **routing):
        return VideoUNet(dtype=dtype, **routing, **kw).to(dev).eval().requires_grad_(False)

    plain = net(torch.bfloat16)
    init_params(plain, torch.Generator(device=dev).manual_seed(SEED + 31))
    state = plain.state_dict()
    fused = net(torch.bfloat16, fused=True, routing=ConvRouting(padded_stream=False))
    fused.load_state_dict(state)
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    f, (h, w) = vcfg.video_future_horizon, vcfg.image_size
    inputs = (torch.randn(SSS_B, f, h, w, vcfg.channels + vcfg.cond_ch, generator=gen, device=dev),
              torch.randint(0, vcfg.timesteps, (SSS_B,), generator=gen, device=dev),
              model.encode_batch_text((TASKS * SSS_B)[:SSS_B]))
    with torch.no_grad():
        y_fused, got = _run_counted(launches, calls_all, lambda: fused(*inputs))
        if got != SSS_PER_FORWARD:
            fail(f"scale-shift: the unpadded fused forward launched {got}, "
                 f"expected {SSS_PER_FORWARD}")
        y_plain = plain(*inputs)
        ref32 = net(torch.float32)
        ref32.load_state_dict(state)
        y32 = ref32(*inputs)
        del ref32
        padded = net(torch.bfloat16, fused=True)
        padded.load_state_dict(state)
        try:
            padded(*inputs)
        except ValueError as e:
            refused = str(e)
        else:
            fail("scale-shift: the padded stream did not refuse the scale-shift U-Net")
        del padded
    if refused != "padded stream: plain-norm dropout-free blocks":
        fail(f"scale-shift: the padded stream refused with {refused!r}")
    std = float(y32.std())
    errs = {name: (float((y - y32).abs().max()) / std, float((y - y32).abs().mean()) / std)
            for name, y in (("fused", y_fused), ("plain_bf16", y_plain))}
    if not all(y.shape == y32.shape and bool(torch.isfinite(y).all()) for y in (y_fused, y_plain)):
        fail("scale-shift: a forward has the wrong shape or non-finite values")
    if errs["fused"][0] > 2 * errs["plain_bf16"][0] or errs["fused"][1] > 2 * errs["plain_bf16"][1]:
        fail(f"scale-shift: the fused forward strays further from float32 than twice the bf16 "
             f"plain path: {errs}")
    ms = {"plain_bf16": [], "fused": []}
    for name, m in (("plain_bf16", plain), ("fused", fused), ("fused", fused),
                    ("plain_bf16", plain)):
        with torch.no_grad():
            ms[name].append(time_ms(lambda: m(*inputs), 2, 1))
    log(f"[scale-shift] {smi}: release U-Net with use_scale_shift_norm "
        f"({sum(p.numel() for p in plain.parameters()) / 1e6:.1f} M params), B={SSS_B} bf16: "
        f"unpadded fused {got}, ms (in turns) {ms}; err/std (max, mean) vs float32 {errs}; the "
        f"padded routing refused it: {refused!r}")
    del plain, fused
    torch.cuda.empty_cache()
    return dict(launches=got, ms=ms, err_over_std=errs, refused=refused)


@contextlib.contextmanager
def _model_config(model, **fields):
    """`model.config` with `fields` replaced while the block runs (what a
    user's `VideoModelConfig` gives the trainer it builds)."""
    saved = model.config
    model.config = dataclasses.replace(saved, **fields)
    try:
        yield
    finally:
        model.config = saved


def _train_switches(model, vcfg, dev, smi, launches, calls_all):
    """Phase 16 (d): B=4 release train steps through `VideoModelTrainer`
    (train_fused, K6 as the wgrad) under each of `TRAIN_SWITCHES`, the
    `VideoModelConfig` fields set on the model, and the plain step: one
    gradient step on phase 6's fixed batch and noise (its launches the
    switch's, its gradient within twice the bf16 plain step's error of the
    float32 plain step: phase 6's gate), then `SWITCH_STEPS` timed steps
    (CUDA events)."""
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    clips, init, batch, noise, _, grads32 = _train_problem(model, vcfg, dev)
    torch.cuda.empty_cache()
    rows = {}
    runs = dict(plain=({}, {}), **TRAIN_SWITCHES)
    try:
        for name, (fields, want) in runs.items():
            model.unet.load_state_dict(init)
            flags = dict(train_fused=True, wgrad_kernel=True) if want else dict(train_fused=False)
            cfg = VideoTrainerConfig(batch_size=TRAIN_B, n_train_steps=2, save_freq=10 ** 9,
                                     log_freq=10 ** 9, **flags)
            with _model_config(model, **fields):
                trainer = VideoModelTrainer(model, clips, cfg,
                                            workdir=os.path.join(EVAL_LOGS, name), seed=SEED)
            routing = trainer.train_unet.routing
            if any(getattr(routing, k) != v for k, v in fields.items()):
                fail(f"train switches: {name}: the trainer's routing {routing}")
            (loss, _), got = _run_counted(
                launches, calls_all, lambda: trainer.loss_and_grads(*batch, noise=noise))
            if got != want:
                fail(f"train switches: {name}: launches per step {got}, expected {want}")
            grads = {k: p.grad.detach().clone() for k, p in trainer.train_unet.named_parameters()}
            trainer.apply_gradients()
            ms = []
            for _ in range(SWITCH_STEPS):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

                def step():
                    e0.record()
                    trainer.loss_and_grads(*batch, noise=noise)
                    trainer.apply_gradients()
                    e1.record()

                _run_counted(launches, calls_all, step)
                ms.append(e0.elapsed_time(e1))
            if not np.isfinite(float(loss)):
                fail(f"train switches: {name}: loss {float(loss)}")
            rel = _grad_rel(grads, grads32)
            rows[name] = dict(launches_per_step=got, ms=ms, loss=float(loss), grad_rel=rel[0],
                              grad_rel_worst_leaf=rel[1])
            log(f"[switches] {smi}: {name}, B={TRAIN_B}: ms per step {[round(v, 1) for v in ms]}, "
                f"launches per step {got or 'none'}, gradient rel. error vs float32 "
                f"{rel[0]:.3e} (worst leaf {rel[1]:.3e})")
            trainer.close()
            del trainer, grads
            torch.cuda.empty_cache()
    finally:
        model.unet.load_state_dict(init)
        shutil.rmtree(EVAL_LOGS, ignore_errors=True)
    plain = rows["plain"]
    for name, row in rows.items():
        if (row["grad_rel"] > 2 * plain["grad_rel"]
                or row["grad_rel_worst_leaf"] > 2 * plain["grad_rel_worst_leaf"]):
            fail(f"train switches: {name}'s gradient strays further from float32 than twice the "
                 "bf16 plain step's")
    return rows


def last_modules(rk, held, model, vcfg, dev, smi):
    """Phase 16, the last modules: (a) `_evaluation`, (b) `_pools`, (c)
    `_scale_shift`, (d) `_train_switches`; then every kernel signature
    (c) and (d) gave that no earlier phase held, against its plain version.
    Returns the report, the launches of (c) and (d) and the per-kernel
    errors of those signatures."""
    t_phase = time.perf_counter()
    report, calls_all = {}, {}
    launches = {name: 0 for name in rk.KERNELS}
    parts = report["parts_s"] = {}
    for name, fn in (("evaluation", lambda: _evaluation(dev, smi)),
                     ("pools", lambda: _pools(dev, smi)),
                     ("scale_shift", lambda: _scale_shift(model, vcfg, dev, smi, launches,
                                                          calls_all)),
                     ("train_switches", lambda: _train_switches(model, vcfg, dev, smi, launches,
                                                                calls_all))):
        t0 = time.perf_counter()
        report[name] = fn()
        parts[name] = time.perf_counter() - t0
    extra = {k: v for k, v in calls_all.items() if k not in held}
    extra_agg = {}
    if extra:
        _, extra_agg = check_kernels(rk, {"last": extra}, dev, timed=False, tag="last-shapes")
        extra_agg = extra_agg["last"]
    report["new_signatures"] = len(extra)
    held.update(extra)  # the later phases need not hold them again
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[last] {smi}: {len(extra)} kernel signatures not held before; phase 16 wall time "
        f"{report['phase_s']:.1f} s (budget {LAST_BUDGET_S}): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    shutil.rmtree(EVAL_LOGS, ignore_errors=True)
    return report, launches, extra_agg


# phase 17, the last entry points: verify_onchip's gates, the bring-up
# pipeline, the LIBERO line
ENTRY_CHAIN_B = 2  # the chains' batch (the CLI's is 8): the script's time limit
VERIFY_KW = {}  # run_configs arguments (a CPU rehearsal: smaller sizes)
# launches per forward of verify_onchip's routings (tests/test_torch_padded.py
# traces the same on the meta device, `pallas_attn` among its cases)
VERIFY_PER_FORWARD = {
    "unfused": {},
    "fused_nopad": EXPECTED_PER_FORWARD["unpadded"],
    "default": EXPECTED_PER_FORWARD["padded"],
    "pallas_attn": dict(EXPECTED_PER_FORWARD["padded"], fused_spatial_attention_padded=11),
}
# launches of one loss-and-gradients of --train-fused's U-Net: 25 convs, K1
# forward and dgrad [and K6] (tests/test_torch_verify_onchip.py, meta device)
VERIFY_TRAIN_FUSED = {"library_wgrad": {"fused_affine_conv3x3": 50},
                      "k6_wgrad": {"fused_affine_conv3x3": 50, "wgrad_conv3x3": 25}}
BRINGUP_LOGS = os.path.join(ROOT, "logs", "chip_smoke_bringup")
BRINGUP_STEPS = ["assets", "convert", "load", "tokenizer", "parity", "sample", "eval"]
BRINGUP_FLAGS = []  # flags added to both bringup calls (a CPU rehearsal: --device cpu)
ENTRY_BUDGET_S = 60


def _verify_parity(dev, smi, launches, calls_all):
    """Phase 17 (a), the main gate: `verify_onchip.run_configs` with every
    forward and chain counted (`VERIFY_PER_FORWARD`; a chain exactly its
    steps' forwards), then `parity_report`, the JAX script's gates."""
    from v2a_tpu_torch.scripts import verify_onchip as vo

    counts, steps = {}, VERIFY_KW.get("steps", vo.STEPS)

    def around(name, part, fn):
        out, counts[(name, part)] = _run_counted(launches, calls_all, fn)
        return out

    t0 = time.perf_counter()
    outs = vo.run_configs(dev, chain_batch=ENTRY_CHAIN_B, around=around, log=log,
                          **VERIFY_KW)
    wall = time.perf_counter() - t0
    for name, want in VERIFY_PER_FORWARD.items():
        fwd, chain = counts[(name, "forward")], counts[(name, "chain")]
        if fwd != want or chain != {k: steps * v for k, v in want.items()}:
            fail(f"verify_onchip: {name} launched {fwd} per forward and {chain} per "
                 f"{steps}-step chain, expected {want} per forward")
    report, ok = vo.parity_report(outs)
    deltas = vo.video_deltas(outs)
    log(f"[verify] {smi}: the release U-Net, N(0, 0.02) weights, bf16, B="
        f"{VERIFY_KW.get('batch', vo.BATCH)} forwards and {steps}-step chains at B="
        f"{ENTRY_CHAIN_B} (the CLI's chains are at B={vo.BATCH}; cut for the script's time), "
        f"the four routings in {wall:.1f} s: {json.dumps(report)}; the videos against "
        f"unfused, unrounded: {json.dumps(deltas)}")
    if not ok:
        fail(f"verify_onchip: the parity gate failed: {report}")
    return dict(report=report, video_deltas=deltas, wall_s=wall, chain_batch=ENTRY_CHAIN_B,
                steps=steps, launches={f"{n}/{p}": c for (n, p), c in counts.items()})


def _verify_train(dev, smi, launches, calls_all):
    """Phase 17 (a): `--train` (no kernel: the policy is plain PyTorch) and
    `--train-fused` with the library wgrad and with K6
    (`VERIFY_TRAIN_FUSED`'s launches), each through the JAX script's gates."""
    from v2a_tpu_torch.scripts import verify_onchip as vo

    t0 = time.perf_counter()
    out, got = _run_counted(launches, calls_all, lambda: vo.train_gate(dev))
    train_s = time.perf_counter() - t0
    opt = out["train_step_optimizer_gate"]
    log(f"[verify] {smi}: --train, the release policy ({opt['params'] / 1e6:.1f} M params) at "
        f"B={vo.POLICY_BATCH}, {vo.OPT_STEPS} updates in {train_s:.1f} s: {json.dumps(opt)}")
    if not out["pass"] or got:
        fail(f"verify_onchip --train: {opt}, launches {got}")
    t0 = time.perf_counter()
    state = vo.train_fused_state(dev)
    plain, got = _run_counted(launches, calls_all,
                              lambda: vo.train_fused_grads(dev, state, False))
    if got:
        fail(f"verify_onchip --train-fused: the plain path launched {got}")
    fused = {}
    for label, wgrad in (("library_wgrad", False), ("k6_wgrad", True)):
        grads, got = _run_counted(launches, calls_all,
                                  lambda: vo.train_fused_grads(dev, state, True, wgrad))
        report, ok = vo.grad_report(*plain, *grads)
        fused[label] = dict(report, launches=got)
        log(f"[verify] {smi}: --train-fused, {label}: launches {got}, {json.dumps(report)}")
        if got != VERIFY_TRAIN_FUSED[label] or not ok:
            fail(f"verify_onchip --train-fused ({label}): launches {got}, expected "
                 f"{VERIFY_TRAIN_FUSED[label]}; {report}")
    return dict(train=opt, train_s=train_s, train_fused=fused,
                train_fused_s=time.perf_counter() - t0)


def _bringup(smi):
    """Phase 17 (b): `bringup --synthetic --torch-oracle` in this process
    (its output kept to the step lines), every step PASS and no kernel
    launched; then `--pt <missing>` failing at its first step."""
    from v2a_tpu_torch.scripts import bringup

    def run(argv, out_dir):
        buf = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bringup.main(argv + BRINGUP_FLAGS + ["--out-dir", out_dir])
        wall = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            if line.startswith("["):
                log(f"[bringup] {line}")
        with open(os.path.join(out_dir, "bringup_manifest.json")) as fh:
            return rc, json.load(fh), wall, {k: v for k, v in launch_counts().items() if v}

    try:
        rc, manifest, wall, got = run(["--synthetic", "--torch-oracle"],
                                      os.path.join(BRINGUP_LOGS, "oracle"))
        steps = manifest["steps"]
        if (rc != 0 or not manifest["pass"] or [s["step"] for s in steps] != BRINGUP_STEPS
                or any(s["status"] != "PASS" for s in steps) or got):
            fail(f"bringup --torch-oracle: exit {rc}, launches {got}, manifest {manifest}")
        missing = os.path.join(BRINGUP_LOGS, "nope", "model-180000.pt")
        rc_m, manifest_m, wall_m, _ = run(["--pt", missing], os.path.join(BRINGUP_LOGS, "nope"))
        first = manifest_m["steps"]
        if (rc_m == 0 or manifest_m["pass"] or len(first) != 1 or first[0]["step"] != "assets"
                or first[0]["status"] != "FAIL" or missing not in first[0]["error"]):
            fail(f"bringup --pt <missing>: exit {rc_m}, manifest {manifest_m}")
    finally:
        shutil.rmtree(BRINGUP_LOGS, ignore_errors=True)
    info = {s["step"]: {k: v for k, v in s.items() if k not in ("step", "status")}
            for s in steps}
    log(f"[bringup] {smi}: --synthetic --torch-oracle (the release schema, "
        f"{info['convert']['params'] / 1e6:.1f} M converted params) all seven steps PASS in "
        f"{wall:.1f} s ({', '.join(f'{k} {v['seconds']} s' for k, v in info.items())}), parity "
        f"max |err| {info['parity']['max_abs_err']:.3e}, no kernel launched; --pt <missing> "
        f"exit {rc_m} in {wall_m:.2f} s: {first[0]['error']}")
    return dict(steps=info, wall_s=wall, missing=dict(exit=rc_m, wall_s=wall_m,
                                                      error=first[0]["error"]))


def _libero_line():
    """Phase 17 (c): the LIBERO backend is not run here; its import error."""
    from v2a_tpu_torch.envs.registration import make_env_list

    try:
        make_env_list("libero-1tk-65-v3")
    except ImportError as e:
        msg = f"{e} ({type(e.__cause__).__name__}: {e.__cause__})"
    else:
        msg = "LIBERO imports here, but no phase drives it"
    log(f"[libero] the LIBERO env backend (v2a_tpu_torch/envs/libero.py) is not run: {msg}")
    return msg


def last_entry_points(rk, held, dev, smi):
    """Phase 17, the last entry points: (a) `_verify_parity`,
    `_verify_train`, (b) `_bringup`, (c) `_libero_line`; then every kernel
    signature (a) gave that no earlier phase held, against its plain
    version. Returns the report, the launches of (a) and the per-kernel
    errors of those signatures."""
    t_phase = time.perf_counter()
    report, calls_all = {}, {}
    launches = {name: 0 for name in rk.KERNELS}
    parts = report["parts_s"] = {}
    for name, fn in (("verify_parity", lambda: _verify_parity(dev, smi, launches, calls_all)),
                     ("verify_train", lambda: _verify_train(dev, smi, launches, calls_all)),
                     ("bringup", lambda: _bringup(smi)),
                     ("libero", _libero_line)):
        t0 = time.perf_counter()
        report[name] = fn()
        parts[name] = time.perf_counter() - t0
    extra = {k: v for k, v in calls_all.items() if k not in held}
    t0 = time.perf_counter()
    extra_agg = {}
    if extra:
        _, extra_agg = check_kernels(rk, {"entry": extra}, dev, timed=False, tag="entry-shapes")
        extra_agg = extra_agg["entry"]
    parts["new_signatures"] = time.perf_counter() - t0
    report["new_signatures"] = len(extra)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[entry] {smi}: {len(extra)} kernel signatures not held before; phase 17 wall time "
        f"{report['phase_s']:.1f} s (budget {ENTRY_BUDGET_S}): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return report, launches, extra_agg


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "v2a_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    from v2a_tpu_torch.models.init import init_params
    from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
    from v2a_tpu_torch.ops import _build
    from v2a_tpu_torch.ops import resblock_kernels as rk

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {len(_build.sources())} sources in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc): " + ", ".join(f"{k} {v[0]:.1f}s" for k, v in built.items()))
    for name, (_, report) in built.items():
        for line in report.splitlines():
            if "registers" in line:
                log(f"[build] {name}: {line.strip()}")

    vcfg = VideoModelConfig(dtype="bfloat16")
    model = VideoPredModel(vcfg, device=dev).init(SEED)
    unet = model.unet
    if not (unet.fused and unet.routing.padded_stream) or unet.train_fused:
        fail("the video U-Net did not resolve to the padded-stream fused routing on cuda")
    nets = {"padded": unet}
    for routing in ROUTINGS:
        if routing != "padded":
            net = _routed_unet(vcfg, routing).to(dev).eval().requires_grad_(False)
            if _arch(routing):  # more attention blocks: its own weights from the seed
                init_params(net, torch.Generator(device=dev).manual_seed(SEED))
            else:
                net.load_state_dict(unet.state_dict())
            nets[routing] = net
    log(f"[model] video U-Net {sum(p.numel() for p in unet.parameters()) / 1e6:.1f} M params, "
        f"release width, bf16; routings: padded stream (shipped), {', '.join(list(nets)[1:])}")
    b, (h, w) = 8, vcfg.image_size
    gen = torch.Generator(device=dev).manual_seed(SEED)
    inputs = (
        torch.randn(b, vcfg.video_future_horizon, h, w, vcfg.channels + vcfg.cond_ch,
                    generator=gen, device=dev),
        torch.randint(0, vcfg.timesteps, (b,), generator=gen, device=dev),
        model.encode_batch_text((TASKS * 4)[:b]),
    )

    # 3. kernels against their plain versions at the shapes one B=8 release
    # forward of each routing gives them, timed; 4. those forwards
    routing_calls = {}
    for routing, net in nets.items():
        with recording() as calls, torch.no_grad():
            net(*inputs)
        routing_calls[routing] = calls
    torch.cuda.synchronize()
    rows, agg = check_kernels(rk, routing_calls, dev, timed=True, tag="kernels")
    forward = check_forward(rk, nets, inputs, vcfg, dev)
    del nets, net
    torch.cuda.empty_cache()
    # 5. the main paths, then the kernels at the shapes they gave them
    launches, req, serve_calls = serve(rk, model, vcfg, dev)
    served = {"serve": serve_calls}
    new_launches, new_req = {}, {}
    for routing in NEW_SERVED:
        new_launches[routing], new_req[routing], served[f"serve_{routing}"] = serve_routing(
            routing, model, vcfg, dev)
    serve_rows, serve_agg = check_kernels(rk, served, dev, timed=False, tag="serve-shapes")
    # 6. the train step, then K1 and K6 at the shapes one step gave them
    train_report, train_calls, train_launches, k1_roles = train(rk, model, vcfg, dev)
    train_rows, train_agg = check_kernels(rk, {"train": train_calls}, dev, timed=True,
                                          tag="train-shapes", roles=k1_roles)
    # 7. the policy train step
    policy_train = train_policy(dev)
    # 8. the online loop
    online, online_launches, online_agg, online_keys = online_loop(rk, routing_calls, dev, smi)
    # 9. the video entry points
    held = {k for calls in list(routing_calls.values()) + list(served.values()) + [train_calls]
            for k in calls} | online_keys
    video, video_launches, video_agg = video_entry_points(rk, held, dev, smi)
    # 10. the reference checkpoints: convert, load, serve
    ckpt, ckpt_launches, ckpt_agg = reference_checkpoints(rk, held, dev, smi)
    # 11. the model families: the env variants, the xattn backbone, the
    # transformer denoiser
    family, family_rows, family_agg, family_launches = model_families(rk, held, dev, smi)
    # 12. the guided image family through its CLIs: no kernel of the port
    guided = guided_family(dev, smi)
    # 13. the lab kernels' paths and gates
    lab_launches, lab_bench, lab_s, lab_rows, lab_agg = lab_kernels(rk, routing_calls, dev)
    lab = lab_paths(dev, smi)
    # 15. the mesh on torch.distributed and rematerialisation
    mesh, mesh_launches, mesh_agg = mesh_and_remat(rk, held, model, vcfg, dev, smi)
    # 16. the last modules: evaluation, the trunk's pools, scale-shift, the
    # train switches
    last, last_launches, last_agg = last_modules(rk, held, model, vcfg, dev, smi)
    # 17. the last entry points: verify_onchip's gates, bringup, the LIBERO line
    entry_pts, entry_launches, entry_agg = last_entry_points(rk, held, dev, smi)

    # 14. report: K1-K5 sums over one B=8 forward of the shipped routing, K8
    # and K9 of `padded_k8_k9`, K7 of `plain_k7`, K10 and K11 of
    # `spatial_k10_k11`, K12 of `padded_k12`, K6 over one B=4 train step,
    # K13 over K3's calls of one padded forward, K14 over K10's of one
    # spatial_k10_k11 forward, K15 over the perf lab's three shapes;
    # launches over every main-path run (the served requests of all five
    # routings, the K6 routing's train() run, the online loop's runs: its
    # train(), the eval with 8 workers, the pool cycle, the pipelined
    # train(); the video entry points' train and sample runs; sample_video
    # --ckpt on the converted checkpoint; K13-K15: their lab paths)
    lab_names = ("fused_conv_tconv_dma", "winograd_conv3x3", "temporal_conv_taps")
    source_routing = {"fused_group_norm_silu": "plain_k7",
                      "fused_downconv3x3_padded": "padded_k8_k9",
                      "fused_spatial_attention_padded": "padded_k8_k9",
                      "spatial_conv3x3": "spatial_k10_k11",
                      "temporal_conv_fused_hw": "spatial_k10_k11",
                      "fused_conv_tconv_stream": "padded_k12"}

    def entry(name, meta):
        if name in lab_names:
            src = lab_agg["lab"][name]
        elif name == "wgrad_conv3x3":
            src = train_agg["train"][name]
        else:
            src = agg[source_routing.get(name, "padded")][name]
        errs = [src["max_abs_err"], train_agg["train"][name]["max_abs_err"]]
        errs += [a[name]["max_abs_err"] for a in serve_agg.values()]
        errs += [online_agg[name]["max_abs_err"]] if online_agg else []
        errs += [video_agg[name]["max_abs_err"]] if video_agg else []
        errs += [ckpt_agg[name]["max_abs_err"]] if ckpt_agg else []
        errs += [family_agg[name]["max_abs_err"]] if family_agg else []
        errs += [mesh_agg[name]["max_abs_err"]] if mesh_agg else []
        errs += [last_agg[name]["max_abs_err"]] if last_agg else []
        errs += [entry_agg[name]["max_abs_err"]] if entry_agg else []
        n_launch = (lab_launches[name] if name in lab_names else launches[name]
                    + train_launches[name] + sum(nl[name] for nl in new_launches.values())
                    + online_launches[name] + video_launches[name] + ckpt_launches[name]
                    + family_launches[name] + mesh_launches[name] + last_launches[name]
                    + entry_launches[name])
        return dict(name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
                    launches=n_launch,
                    max_abs_err=max(errs), ms=src["ms"], plain_ms=src["plain_ms"],
                    bound_ms=src["bound_ms"],
                    bound_by="operations" if src["ops_s"] >= src["bytes_s"] else "bytes",
                    library_ms=src["library_ms"])

    kernels = [entry(name, meta) for name, meta in rk.KERNELS.items()]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_shapes.json"), "w") as fh:
        json.dump(dict(card=smi, per_shape=rows, per_forward=agg, serve_shapes=serve_rows,
                       requests_s=req, serve_launches=launches, new_routing_request_s=new_req,
                       new_routing_launches=new_launches, train=train_report,
                       train_launches=train_launches, train_shapes=train_rows,
                       per_train_step=train_agg, policy_train=policy_train, online=online,
                       online_launches=online_launches, video=video,
                       video_launches=video_launches, checkpoints=ckpt,
                       checkpoint_launches=ckpt_launches, families=family,
                       family_shapes=family_rows, family_launches=family_launches,
                       guided=guided,
                       lab_launches=lab_launches, lab_bench=lab_bench, lab_bench_s=lab_s,
                       lab_shapes=lab_rows, per_lab=lab_agg, lab_paths=lab, mesh=mesh,
                       mesh_launches=mesh_launches, last=last, last_launches=last_launches,
                       entry_points=entry_pts, entry_launches=entry_launches,
                       kernels=kernels,
                       **forward), fh, indent=1)
    log("[report] K1-K5 ms / plain_ms / bound_ms / library_ms are sums over one B=8 release "
        "forward of the padded-stream routing (per-shape time x calls per forward), K8 and K9 "
        "over one of padded_k8_k9, K7 over one of plain_k7, K10 and K11 over one of "
        "spatial_k10_k11, K12 over one of padded_k12; K6's are sums over one B=4 release train step (K1's per train step are "
        "in chiprun_out/chip_smoke_shapes.json, per_train_step); K13's over K3's calls in one "
        "padded forward, K14's over K10's in one spatial_k10_k11 forward, K15's over the perf "
        "lab's three shapes (per_lab); launches are those of the served requests of the five "
        "routings plus the K6 routing's train() run plus the online loop's runs (its train(), "
        "scripts/eval.py --workers 8, the pool cycle, the pipelined train()) plus the video "
        "entry points' runs (train_video's steps, its --sample-after chain) plus "
        "sample_video --ckpt's chain on the converted reference checkpoint plus the model "
        "families' requests and K6 train steps (Thor, Bridge, MW-flow) plus phase 15's "
        "mesh and remat runs (the world-1 mesh's train step, sampler and online cycle, the "
        "remat steps) plus phase 16's (the scale-shift U-Net's fused forward, the train "
        "switches' steps) plus phase 17's (verify_onchip's B=8 forwards and B=2 chains of "
        "its three fused routings, its two --train-fused gradients), and "
        "for K13-K15 those of their lab paths (the perf lab's benches; K13 against K3)")
    log(f"[report] total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
