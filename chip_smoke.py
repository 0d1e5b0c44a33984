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
  10. the lab kernels: the port's perf lab (`python -m
     v2a_tpu_torch.scripts.perf_lab winobench2 tconvbench2`), the path that
     launches K14 and K15; K13 against K3 at every K3 signature of the
     padded forward, bit for bit (K3's mainloop, its copies by TMA); then
     K13 (bit-equal to K3, K3's gates through K3's conv half, two launches
     bit-equal, timed in turns with K3, and against K4a -> K4b, its copy
     route logged), K14 at every K10 signature of `spatial_k10_k11` and
     the lab's (one ulp of its plain version; its difference from K10
     reported), K15 at the lab's three shapes (bit-equal to K2 with a zero
     bias: K2's launch) and K9 at head widths 8, 40, 80 and 160 (C 640),
     each on three input sets;
  11. prints the `kernels` JSON line, then the device line last.

Weights are random from a seed; text goes through the offline HashTokenizer.
The env workers start by `spawn` with the main module hidden, so they do
not import this file; its top level does no CUDA work all the same, and
everything runs from `main()`.
Per-shape results go to `chiprun_out/chip_smoke_shapes.json`; the trainers
write their checkpoints under `logs/chip_smoke_train/`,
`logs/chip_smoke_online/` and `logs/chip_smoke_video/` and the script removes
them.
"""

import contextlib
import dataclasses
import gc
import inspect
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
# the U-Net routings of phases 3-5: VideoModelConfig / VideoUNet arguments
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
    return dict(model_channels=vcfg.model_channels, channel_mult=vcfg.channel_mult,
                num_res_blocks=vcfg.num_res_blocks,
                attention_resolutions=vcfg.attention_resolutions,
                num_head_channels=vcfg.num_head_channels, task_token_dim=vcfg.text_dim)


def _arch(routing):
    """The U-Net arguments of a routing that change its parameters."""
    return {k: v for k, v in ROUTINGS[routing].items() if k in ARCH}


def check_forward(rk, nets, inputs, vcfg, dev):
    """Phase 4: launch counts, each routing vs plain vs float32, times in
    turns. `nets`: {routing: U-Net}. A routing with its own architecture
    (`padded_k8_k9_wide`) is held against plain paths of that architecture
    with its own weights."""
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
        log(f"[forward] {routing} routing, launches per forward: {per_fwd}")
        if per_fwd != EXPECTED_PER_FORWARD[routing]:
            fail(f"{routing} launch counts {per_fwd} != {EXPECTED_PER_FORWARD[routing]}")
    # the plain bf16 path and the float32 reference of each architecture
    refs, plain16 = {}, None
    for routing in ("padded", "padded_k8_k9_wide"):
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
    errs["plain_bf16_wide"] = err(*refs["padded_k8_k9_wide"])
    errs.update({f"{r}_vs_plain_bf16": err(outs[r], ref_of(r)[0]) for r in nets})
    log("[forward] err/std (max, mean) vs the float32 plain reference of the routing's "
        "architecture: " + "; ".join(f"{k} {v[0]:.3e} {v[1]:.3e}" for k, v in errs.items()))
    # the fused routings round at other places than the plain bf16 path, but
    # in the same class: each may stray from float32 at most twice as far
    for r in nets:
        e_plain = errs["plain_bf16_wide" if _arch(r) else "plain_bf16"]
        if errs[r][0] > 2 * e_plain[0] or errs[r][1] > 2 * e_plain[1]:
            fail(f"{r} forward strays further from the float32 reference than the bf16 plain path")
    fwd_ms = {name: [] for name in list(nets) + ["plain_bf16"]}
    turns = list(nets.items()) + [("plain_bf16", plain16)]
    for label, net in turns + turns[::-1]:
        fwd_ms[label].append(time_ms(lambda: fwd(net), 2, 1))
    log(f"[forward] B=8 F=7 128^2 ms (in turns): {fwd_ms}")
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


def train(rk, model, vcfg, dev):
    """Phase 6: the video-model train step through `VideoModelTrainer.train`
    in each routing. Returns the report, the kernels' {signature: calls} of
    one K6-routing gradient step, the launches of the K6 routing's run, and
    {K1 signature: its forward and dgrad calls} of that step."""
    from v2a_tpu_torch.models.video_unet import VideoUNet
    from v2a_tpu_torch.train import checkpoint as ckpt
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    clips = SyntheticClips(vcfg.video_future_horizon, vcfg.image_size, SEED + 2)
    init = {k: v.clone() for k, v in model.unet.state_dict().items()}
    # one batch and one noise draw for the gradient comparison
    rng = np.random.default_rng(SEED + 3)
    x_cond, video, tasks = clips.sample_batch(TRAIN_B, rng)
    batch = (torch.as_tensor(video, device=dev),
             (torch.as_tensor(x_cond, device=dev) * 2.0 - 1.0)[:, None],
             model.encode_batch_text(tasks),
             torch.as_tensor(rng.integers(0, vcfg.timesteps, TRAIN_B), device=dev),
             torch.ones(TRAIN_B, device=dev))
    noise = torch.randn(batch[0].shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 4))

    # the float32 plain step: the reference for every routing's gradient
    torch.cuda.reset_peak_memory_stats()
    ref = VideoUNet(dtype=torch.float32, **_unet_kw(vcfg)).to(dev)
    ref.load_state_dict(init)
    loss32 = model.diffusion.p_losses(ref, *batch[:3], t=batch[3], sample_weights=batch[4],
                                      noise=noise)
    loss32.backward()
    grads32 = {k: p.grad for k, p in ref.named_parameters()}
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] float32 plain step at B={TRAIN_B}: loss {loss32.item():.6f}, "
        f"peak memory {peak32:.1f} GiB")
    del ref, loss32
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


def train_policy(dev):
    """Phase 7: the policy train step at the release batch,
    `make_train_step(policy.loss, fused_clip_adamw(cfg), EMAConfig())` on a
    bf16-compute policy with float32 parameters and moments (the release
    recipe: AdamW lr 1e-4, betas (0.95, 0.999), eps 1e-8, wd 1e-6, clip 1.0,
    EMA power 0.75 every step), on a synthetic batch from the seed: one
    warm-up step, then `POLICY_STEPS` steps timed by CUDA events; the peak
    memory; finite loss, gradient norm, weights and EMA. It runs no kernel
    of the port (plain PyTorch, as the JAX step runs plain XLA)."""
    from v2a_tpu_torch.models.policy import DiffusionPolicy, PolicyConfig
    from v2a_tpu_torch.train.train_state import (
        EMAConfig, OptimizerConfig, PolicyTrainState, fused_clip_adamw, make_train_step)

    policy = DiffusionPolicy.create(PolicyConfig(dtype="bfloat16"), device=dev).init(SEED)
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
    for _ in range(1 + POLICY_STEPS):
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
    if state.step != 1 + POLICY_STEPS or launches:
        fail(f"policy train step: {state.step} steps, kernel launches {launches}")
    report = dict(batch=POLICY_B, steps_timed=POLICY_STEPS, ms_per_step=ms[1:], warmup_ms=ms[0],
                  loss=losses, grad_norm=norms,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  params_m=sum(p.numel() for p in state.params) / 1e6)
    log(f"[policy-train] B={POLICY_B}, {report['params_m']:.1f} M params, bf16 compute: ms per "
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
    if not (video_model.unet.fused and video_model.unet.padded_stream):
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
    if model.diffusion.is_ddim_sampling or not model.unet.padded_stream:
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
    a, b = first.state.state_dict(first.train_unet), again.state.state_dict(again.train_unet)
    same = (a["step"] == b["step"] == VIDEO_STEPS and all(
        torch.equal(a[part][k], b[part][k]) for part in ("params", "ema_params") for k in a[part])
        # Adam's `step` stays on the CPU in the trained run, the load puts
        # it on the card
        and all(torch.equal(x, b["opt_state"]["state"][i][k].to(x.device))
                for i, st in a["opt_state"]["state"].items() for k, x in st.items()
                if isinstance(x, torch.Tensor)))
    if not same:
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


def lab_kernels(rk, routing_calls, dev):
    """Phase 10, the lab kernels' main paths, then their gates. The port's
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
    from v2a_tpu_torch.models.video_unet import VideoUNet
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
    if not (unet.fused and unet.padded_stream) or unet.train_fused:
        fail("the video U-Net did not resolve to the padded-stream fused routing on cuda")
    nets = {"padded": unet}
    for routing, flags in ROUTINGS.items():
        if routing != "padded":
            net = VideoUNet(in_channels=2 * vcfg.channels, out_channels=vcfg.channels,
                            dtype=torch.bfloat16, **dict(_unet_kw(vcfg), **flags))
            net = net.to(dev).eval().requires_grad_(False)
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
        torch.randn(b, vcfg.video_future_horizon, h, w, 2 * vcfg.channels, generator=gen,
                    device=dev),
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
    # 10. the lab kernels' paths and gates
    lab_launches, lab_bench, lab_s, lab_rows, lab_agg = lab_kernels(rk, routing_calls, dev)

    # 11. report: K1-K5 sums over one B=8 forward of the shipped routing, K8
    # and K9 of `padded_k8_k9`, K7 of `plain_k7`, K10 and K11 of
    # `spatial_k10_k11`, K12 of `padded_k12`, K6 over one B=4 train step,
    # K13 over K3's calls of one padded forward, K14 over K10's of one
    # spatial_k10_k11 forward, K15 over the perf lab's three shapes;
    # launches over every main-path run (the served requests of all five
    # routings, the K6 routing's train() run, the online loop's runs: its
    # train(), the eval with 8 workers, the pool cycle, the pipelined
    # train(); the video entry points' train and sample runs; K13-K15: their
    # lab paths)
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
        n_launch = (lab_launches[name] if name in lab_names else launches[name]
                    + train_launches[name] + sum(nl[name] for nl in new_launches.values())
                    + online_launches[name] + video_launches[name])
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
                       video_launches=video_launches,
                       lab_launches=lab_launches, lab_bench=lab_bench, lab_bench_s=lab_s,
                       lab_shapes=lab_rows, per_lab=lab_agg, kernels=kernels,
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
        "entry points' runs (train_video's steps, its --sample-after chain), and "
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
