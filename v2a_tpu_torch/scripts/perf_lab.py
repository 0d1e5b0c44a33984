"""The port's perf lab: the counterpart of the JAX package's
`scripts/perf_lab.py`, name for name: the U-Net forward's ablations and
routing variants, four traces, and benches of the kernels at the U-Net's
level shapes.

    python -m v2a_tpu_torch.scripts.perf_lab [name ...]

With no name it runs the JAX lab's default, the five ablations `base
no_attn no_temporal no_gn conv_only`, then the share lines: base - X
estimates component X's time (interactions ignored). Every name is checked
before anything runs.

Sizes. On the card, the JAX lab's `build()` at release width: the video
U-Net with model_channels 128, mult (1, 2, 3, 4, 5), 2 res blocks, heads
of 32, text width 512, bf16, fed B=8, F=7, 128^2 and 16 tokens. With
`device="cpu"`, the JAX lab's CPU sizes (32 channels, float32, 32^2), timed
by the host clock, which every line says; `sizes` takes smaller ones.
Weights are drawn from one seeded `torch.Generator`, times 0.02, as the JAX
lab draws them (:54-57).

Forward names (`FORWARDS`, one table: name -> `ConvRouting`, attention
resolutions, fused). Each name's routing is the JAX lab's module flags for
that name, run alone: its `main` first sets `PERF_PALLAS_SPATIAL2_MIN_CH=0`,
`PERF_SKIP1X1_DOT=False` and `PERF_PALLAS_SPATIAL2_MAX_S=512` (`LAB`), and
the names that measure the shipped routing restore the defaults
(`SHIPPED`). (Within one call the JAX lab leaves some flags behind: after
`fused_mega`, `fused_stream`, `fused_upconv` or `fused_padded` it runs the
later names with the padded stream, the mega-kernel and K5 off. Here every
name runs from its own row.) Patterns: `fused_min<C>`,
`fused_spatial2_<N>`, `fused_sp2dot_<N>`, `fused_sp2all[<N>]`,
`fused_xla2d[<N>]`. Each prints the mean ms of a forward (CUDA events over
`iters` forwards after one warm forward, each ending in a float32 checksum
of its output) and its kernel launches from the port's counters.

Names with no counterpart on this card raise `ValueError`:
`fused_tbudget_<KB>` sets the TPU's VMEM budget of the temporal conv's tile
(`TCONV_TILE_BUDGET`; the port's plan, `rk.temporal_conv_plan`, has no such
budget), and `fused_join_<mode>` picks K3's TPU-only tap-join form
(`TAPJOIN`), which is not a kernel of its own.

Traces (`torch.profiler`, read by `utils/profiling.py::rollup`): `trace` /
`trace_base` (one B=8 forward, fused or plain; three traced, per forward),
`trace_sp2` (the K1 gate at 512 channels), `trace_default` (the shipped
routing), `trace_chain[:<topk>]` (the video chain as the benchmark samples:
pred_v, a 100-step cosine schedule, DDIM-20, B=8, the shipped routing, per
DDIM step), `trace_train[_chain]` (the policy train step at B=64 through
`make_train_step`, once or 20 chained steps, per step) and
`trace_vtrain:<B>:<policy>` (the video train step through
`VideoModelTrainer`, 3 chained steps, per step; `off` the plain path,
`tfused` train_fused with K6 as the wgrad, `blocks` / `levels` / `mxu` the
plain path under that remat policy, `tfused-<remat>` both, as the JAX
lab's `parse_policy`; the device's peak memory).

Benches (ms per call over chained calls, y = fn(y), by CUDA events on the
card; one row per line, the card's name on each): `convbench` (`F.conv2d`
against the im2col matmul at L2-L4), `affconvbench` (`F.conv2d`, plain and
on the materialised affine + SiLU activation, against K1 plain and with
its affine at L0-L4), `dotbench` (the throughput of `streams` independent
`torch.matmul` chains at the JAX lab's per-tap shapes, and the stream sweep
at L0), `megabench[:L<i>]` (K3 at its own plan, K4a -> K4b for the same
work, and the dot ceiling: one tap's product over every pixel, (B*F*H*W,
C) x (C, D), timed by `torch.matmul` and scaled to the kernel's products;
the gap printed; the TPU lab's band-height sweep has no counterpart, the
port's plan is not a band height), `winobench` (a plain-PyTorch Winograd
F(2x2, 3x3) against `F.conv2d`), `winobench2` (`F.conv2d`, K10 and K14),
`tconvbench` (the transpose + `F.conv1d` form, K2 with and without its
emb / statistics, and the (3, 1) `F.conv2d` form at L0-L4) and
`tconvbench2` (K15 against one stacked `torch.matmul`).

Every function returns rows (dicts), each with its `ms`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys
import tempfile
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from v2a_tpu_torch.device import resolve_device
from v2a_tpu_torch.models.video_unet import ConvRouting, VideoUNet, _im2col_conv, _tconv_conv2d
from v2a_tpu_torch.ops import resblock_kernels as rk
from v2a_tpu_torch.utils import profiling

# (level, N = B*F, H, W, C): the JAX lab's winobench2 shapes
WINO_SHAPES = [("L0", 56, 128, 128, 128), ("L1", 56, 64, 64, 256), ("L2", 56, 32, 32, 384)]
# (level, B, F, S, C): the JAX lab's tconvbench2 shapes
TCONV_SHAPES = [("L0", 8, 7, 128 * 128, 128), ("L1", 8, 7, 64 * 64, 256), ("L4", 8, 7, 64, 640)]
# (level, N, H, W, C) of every U-Net level (conv_bench :132, affconv_bench
# :178, winograd_bench :452)
LEVELS = [("L0", 56, 128, 128, 128), ("L1", 56, 64, 64, 256), ("L2", 56, 32, 32, 384),
          ("L3", 56, 16, 16, 512), ("L4", 56, 8, 8, 640)]
# (level, H, C) of megabench (:319)
MEGA_LEVELS = {"L0": ("L0", 128, 128), "L1": ("L1", 64, 256), "L2": ("L2", 32, 384)}
# (m, k, n) of dot_ceiling_bench (:284-291): the TPU kernels' per-tap dots
DOT_SHAPES = [(512, 128, 128), (1024, 128, 128), (256, 256, 256), (512, 256, 256),
              (128, 384, 384), (896, 128, 128)]
# the benches' shapes on the CPU, where the plain versions run: levels cut
# to a few samples and narrow widths
CPU_LEVELS = [("L0", 2, 16, 16, 32), ("L1", 2, 8, 8, 64)]
CPU_TCONV = [("L0", 1, 3, 64, 32), ("L1", 1, 3, 16, 64)]
CPU_MEGA = {"L0": ("L0", 16, 64), "L1": ("L1", 8, 64)}
CPU_DOT_SHAPES = [(64, 32, 32)]

# the routings of the JAX lab's main: the flags it zeroes first (:1018-1027),
# and the shipped defaults its *_default / trace_chain names restore
LAB = ConvRouting(spatial2_min_ch=0, spatial2_max_s=512, skip1x1_dot=False)
SHIPPED = ConvRouting()
ATTN = (8, 16)


class Forward(NamedTuple):
    """One forward name: its routing, attention resolutions and `fused`."""
    routing: ConvRouting
    attn: Tuple[int, ...]
    fused: bool


def _r(base: ConvRouting, **kw) -> ConvRouting:
    return dataclasses.replace(base, **kw)


# name -> (routing, attention, fused): the JAX lab's flags for each name
FORWARDS: Dict[str, Forward] = {
    "base": Forward(LAB, ATTN, False),
    "no_attn": Forward(LAB, (), False),
    "no_temporal": Forward(_r(LAB, ablate_temporal=True), ATTN, False),
    "no_gn": Forward(_r(LAB, ablate_gn=True), ATTN, False),
    "conv_only": Forward(_r(LAB, ablate_temporal=True, ablate_gn=True), (), False),
    "base_im2col": Forward(_r(LAB, spatial_im2col=True), ATTN, False),
    "fused": Forward(LAB, ATTN, True),
    "fused_default": Forward(SHIPPED, ATTN, True),
    "default_noattn": Forward(SHIPPED, (), True),
    "fused_attn": Forward(_r(SHIPPED, attn_kernel=True), ATTN, True),
    "fused_mega": Forward(SHIPPED, ATTN, True),
    "fused_stream": Forward(_r(SHIPPED, stream_kernel=True), ATTN, True),
    "fused_upconv": Forward(SHIPPED, ATTN, True),
    "fused_padded": Forward(SHIPPED, ATTN, True),
    "fused_dot1x1": Forward(_r(LAB, skip1x1_dot=True), ATTN, True),
    "fused_im2col": Forward(_r(LAB, spatial_im2col=True), ATTN, True),
    "fused_hw": Forward(_r(LAB, tconv_hw=True), ATTN, True),
    "fused_spatial": Forward(_r(LAB, pallas_spatial=True), ATTN, True),
}
ABLATIONS = ("base", "no_attn", "no_temporal", "no_gn", "conv_only")
# the name patterns of the JAX lab, each a function of its suffix
PATTERNS: Dict[str, Callable[[str], Forward]] = {
    "fused_spatial2_": lambda s: Forward(_r(LAB, spatial2_min_ch=int(s)), ATTN, True),
    "fused_sp2dot_": lambda s: Forward(_r(LAB, spatial2_min_ch=int(s), skip1x1_dot=True),
                                       ATTN, True),
    "fused_sp2all": lambda s: Forward(_r(LAB, spatial2_min_ch=int(s) if s else 128,
                                         spatial2_max_s=16384, skip1x1_dot=True), ATTN, True),
    "fused_xla2d": lambda s: Forward(_r(LAB, tconv_conv2d_min_s=int(s) if s else 1), ATTN, True),
    "fused_min": lambda s: Forward(_r(LAB, fused_min_ch=int(s)), ATTN, True),
}
# names with no counterpart on this card, and why
NO_COUNTERPART = {
    "fused_tbudget_": "sets the TPU's VMEM budget of the temporal conv's tile "
                      "(TCONV_TILE_BUDGET); the port's plan, rk.temporal_conv_plan, has no "
                      "such budget",
    "fused_join_": "picks K3's TPU-only tap-join form (TAPJOIN), which is not a kernel of "
                   "its own",
}
REMAT_POLICIES = ("blocks", "levels", "mxu")


def forward_of(name: str) -> Optional[Forward]:
    """The forward row of `name` (a table name or a pattern), else None;
    raises `ValueError` for the names with no counterpart."""
    if name in FORWARDS:
        return FORWARDS[name]
    for prefix, why in NO_COUNTERPART.items():
        if name.startswith(prefix):
            raise ValueError(f"perf lab {name!r} has no counterpart on this card: it {why}")
    for prefix, make in PATTERNS.items():
        if name.startswith(prefix):
            try:
                return make(name[len(prefix):])
            except ValueError:
                raise ValueError(f"perf lab {name!r}: {prefix}<int> expected") from None
    return None


class LabSizes(NamedTuple):
    """What the lab builds: the U-Net's width, dtype, levels and res blocks,
    the forward's batch, frames, side and tokens; the policy step's batch
    and `PolicyConfig` fields; the video train step's `VideoModelConfig`
    fields."""
    mc: int
    dtype: torch.dtype
    batch: int
    frames: int
    hw: int
    tokens: int = 16
    mult: Tuple[int, ...] = (1, 2, 3, 4, 5)
    res_blocks: int = 2
    policy_batch: int = 64
    policy: Tuple[Tuple[str, object], ...] = (("dtype", "bfloat16"),)
    vtrain: Tuple[Tuple[str, object], ...] = (("dtype", "bfloat16"),)


def lab_sizes(dev: torch.device) -> LabSizes:
    """The JAX lab's sizes: release width on the card, its CPU build on the
    CPU (`build` :33-44), with a small policy and video train step there."""
    if dev.type == "cuda":
        return LabSizes(128, torch.bfloat16, 8, 7, 128)
    return LabSizes(32, torch.float32, 8, 7, 32, policy_batch=4,
                    policy=(("image_size", (32, 32)), ("down_dims", (32, 64)),
                            ("vision_stage_features", (16, 32, 64, 128))),
                    vtrain=(("image_size", (32, 32)), ("model_channels", 32)))


def _device_label(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host clock)"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counts() -> Dict[str, int]:
    return {k: v for k, v in rk.launches.items() if v}


def zero_launches() -> None:
    for k in rk.launches:
        rk.launches[k] = 0


# -- K15: the lab's plain temporal conv --------------------------------------------


def temporal_conv_taps_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K15: y[f] = sum_t x[f + t - 1] @ W_t, frames
    zero-padded, the three taps' products of x.dtype operands summed in
    float32 and rounded once; x (B, F, S, C), w (3C, C) tap-major."""
    f, c = x.shape[1], x.shape[-1]
    xp = F.pad(x.float(), (0, 0, 0, 0, 1, 1))
    stacked = torch.cat([xp[:, :f], xp[:, 1:f + 1], xp[:, 2:]], -1)
    return (stacked @ w.to(x.dtype).float()).to(x.dtype)


# a float32 zero bias of C elements per (device, C): K15 is K2's launch without one
_zero_bias: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def temporal_conv_taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The JAX perf lab's temporal-conv kernel (`scripts/perf_lab.py:627`,
    `tconv_variants_bench.make_call`): y[f] = sum_t x[f + t - 1] @ W_t with
    zero frames outside, no bias. x (B, F, S, C); w (3C, C), rows t*C ..
    t*C + C - 1 for tap t. Returns (B, F, S, C) in x.dtype.

    Kernel note (csrc/temporal_conv.cu): K2's function with a zero bias, so
    this is K2's launch (`rk._temporal_conv_launch`: K2's Hopper body and
    plan, its float32 body for float32) on x's own memory with w as K2's
    (3, C, C) tap-major kernel, a cached float32 zero bias and no emb,
    residual or statistics; y is K2's bit for bit (adding +0.0 changes no
    value). Its own count is `launches["temporal_conv_taps"]`.
    """
    rk._no_grad_inputs("temporal_conv_taps", x, w)
    if x.dim() != 4:
        raise ValueError(f"x must be (B, F, S, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(w.shape) != (3 * c, c):
        raise ValueError(f"w {tuple(w.shape)} vs (3C, C) = {(3 * c, c)}")
    if x.device.type == "cpu":
        return temporal_conv_taps_plain(x, w)
    zero = _zero_bias.get((x.device, c))
    if zero is None:
        zero = _zero_bias[(x.device, c)] = torch.zeros(c, dtype=torch.float32, device=x.device)
    return rk._temporal_conv_launch("temporal_conv_taps", x, w.reshape(3, c, c), zero, None,
                                    None, False)


# -- timing ------------------------------------------------------------------------


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else _device_of(x[0])


def time_calls(fn: Callable[[], object], dev: torch.device, iters: int, warm: int = 1) -> float:
    """Mean ms of `fn()` over `iters` calls after `warm` calls: CUDA events
    around the calls on the card, the host clock on the CPU."""
    for _ in range(warm):
        fn()
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def time_chained(fn: Callable, x, chain: int = 10, iters: int = 3) -> float:
    """Mean ms per call of `y = fn(y)` chained `chain` times, over `iters`
    chains after one warm-up chain: the counterpart of the JAX lab's
    `_time_chained` (:94). `x` is a tensor or a tuple of them. On the card,
    CUDA events around the chains; on the CPU, the host clock."""
    def run():
        y = x
        for _ in range(chain):
            y = fn(y)
        return y

    return time_calls(run, _device_of(x), iters) / chain


# -- the U-Net forward -------------------------------------------------------------


def build(fwd: Forward, sizes: LabSizes, dev: torch.device, seed: int = 0) -> VideoUNet:
    """The JAX lab's `build(attn, fused)` (:33) with `fwd`'s routing; every
    parameter drawn from one seeded generator times 0.02 (:54-57), in place
    on `dev` (the net is built on the meta device)."""
    with torch.device("meta"):
        net = VideoUNet(in_channels=6, model_channels=sizes.mc, out_channels=3,
                        num_res_blocks=sizes.res_blocks, attention_resolutions=fwd.attn,
                        channel_mult=sizes.mult, num_head_channels=32, task_token_dim=512,
                        dtype=sizes.dtype, fused=fwd.fused, routing=fwd.routing)
    net = net.to_empty(device=dev).eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    return net


def forward_inputs(sizes: LabSizes, dev: torch.device, seed: int = 0):
    """(x, t, tokens) of the JAX lab's `time_forward` (:47-50)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    b = sizes.batch
    return (torch.randn(b, sizes.frames, sizes.hw, sizes.hw, 6, generator=gen, device=dev),
            torch.full((b,), 50, dtype=torch.long, device=dev),
            torch.randn(b, sizes.tokens, 512, generator=gen, device=dev) * 0.1)


def time_forward(name: str, sizes: LabSizes, dev: torch.device, iters: int = 20,
                 out: Callable = print) -> dict:
    """`time_forward` (:46) of forward `name`: the launches of one forward
    (counts zeroed before, read after), then the mean ms of `iters`
    forwards after one warm forward, each ending in a float32 checksum."""
    fwd = forward_of(name)
    net = build(fwd, sizes, dev)
    inputs = forward_inputs(sizes, dev)
    with torch.no_grad():
        zero_launches()
        y = net(*inputs)
        _sync(dev)
        launches = launch_counts()
        checksum = float(y.float().sum())
        ms = time_calls(lambda: net(*inputs).float().sum(), dev, iters)
    row = dict(bench="forward", name=name, ms=ms, launches=launches, checksum=checksum,
               finite=bool(torch.isfinite(y).all()), fused=fwd.fused, attn=fwd.attn,
               routing=dataclasses.asdict(fwd.routing), device=_device_label(dev))
    out(f"{name:<16} fwd {ms:9.3f} ms  launches {launches}  [{row['device']}]")
    del net
    return row


# -- traces ------------------------------------------------------------------------


def _traced(run_once: Callable[[], object], dev: torch.device, runs: int, per_run: int,
            topk: int, out: Callable) -> dict:
    """`_trace_rollup` (:903): one warm call, then `runs` calls under
    `torch.profiler`, rolled up per `per_run` (forwards, steps) by
    `utils/profiling.py::rollup`, against the host's wall ms of the traced
    window."""
    run_once()
    _sync(dev)
    with profiling.trace(None) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run_once()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    return profiling.rollup(prof, per_run=runs * per_run, topk=topk, wall_ms=wall,
                            device=dev.type, out=out)


def _trace_row(bench: str, res: dict, dev: torch.device, **extra) -> dict:
    return dict(bench=bench, ms=res["wall_ms"], busy_ms=res["busy_ms"],
                summed_ms=res["summed_ms"], idle_share=res["idle_share"],
                categories=res["categories"], hand=res["hand"], kernels=res["kernels"],
                ops=res["ops"], n_events=res["n_events"], device=_device_label(dev), **extra)


def trace_forward(name: str, fwd: Forward, sizes: LabSizes, dev: torch.device, runs: int = 3,
                  topk: int = 30, out: Callable = print) -> dict:
    """One forward of `fwd`'s routing traced (:717): per forward."""
    net = build(fwd, sizes, dev)
    inputs = forward_inputs(sizes, dev)
    with torch.no_grad():
        zero_launches()
        net(*inputs)
        _sync(dev)
        launches = launch_counts()
        out(f"{name}: one B={sizes.batch} forward [{_device_label(dev)}], launches {launches}")
        res = _traced(lambda: net(*inputs).float().sum(), dev, runs, 1, topk, out)
    return _trace_row(name, res, dev, launches=launches, per="forward")


def trace_chain(sizes: LabSizes, dev: torch.device, steps: int = 20, topk: int = 30,
                out: Callable = print) -> dict:
    """The video chain as the benchmark samples it (:740): pred_v, a
    100-step cosine schedule, DDIM-`steps`, B=8, the shipped routing, through
    `GaussianDiffusion.sample_steps` / `sample_step`; one chain traced, per
    DDIM step."""
    from v2a_tpu_torch.ops.gaussian_diffusion import GaussianDiffusion
    from v2a_tpu_torch.ops.schedules import DiffusionSchedule

    net = build(FORWARDS["fused_default"], sizes, dev)
    diffusion = GaussianDiffusion(schedule=DiffusionSchedule.create(100, "cosine", device=dev),
                                  objective="pred_v", sampling_timesteps=steps)
    gen = torch.Generator(device=dev).manual_seed(42)
    b, hw = sizes.batch, sizes.hw
    x_cond = torch.rand(b, 1, hw, hw, 3, generator=gen, device=dev) * 2.0 - 1.0
    task_embed = torch.randn(b, sizes.tokens, 512, generator=gen, device=dev) * 0.1

    def run_once():
        img = torch.randn(b, sizes.frames, hw, hw, 3, generator=gen, device=dev)
        for step in diffusion.sample_steps():
            img = diffusion.sample_step(net, img, step, x_cond, task_embed, gen)
        return diffusion.sample_finish(img).float().sum()

    with torch.no_grad():
        zero_launches()
        run_once()
        _sync(dev)
        launches = {k: v / steps for k, v in launch_counts().items()}
        out(f"trace_chain: DDIM-{steps} at B={b}, the shipped routing "
            f"[{_device_label(dev)}], launches per step {launches}")
        res = _traced(run_once, dev, 1, steps, topk, out)
    return _trace_row("trace_chain", res, dev, launches=launches, steps=steps, per="DDIM step")


def trace_train(sizes: LabSizes, dev: torch.device, chain: int = 0, topk: int = 30,
                out: Callable = print) -> dict:
    """The policy train step (:793) at its batch through `make_train_step`:
    one step traced, or `chain` steps, per step."""
    from v2a_tpu_torch.models.policy import DiffusionPolicy, PolicyConfig
    from v2a_tpu_torch.train.train_state import (
        EMAConfig, OptimizerConfig, PolicyTrainState, fused_clip_adamw, make_train_step)

    policy = DiffusionPolicy.create(PolicyConfig(**dict(sizes.policy)), device=dev).init(0)
    policy.nets.requires_grad_(True)
    cfg, b = policy.config, sizes.policy_batch
    gen = torch.Generator(device=dev).manual_seed(1)
    h, w = cfg.image_size
    batch = {"obs": {k: torch.rand(b, h, w, 3, generator=gen, device=dev) for k in cfg.obs_keys},
             "action": policy.action_norm.unnormalize(
                 torch.rand(b, cfg.horizon, cfg.action_dim, generator=gen, device=dev) * 2 - 1)}
    tx = fused_clip_adamw(OptimizerConfig())
    state = PolicyTrainState(policy.nets, tx)
    step = make_train_step(policy.loss, tx, EMAConfig())
    n = max(chain, 1)

    def run_once():
        for _ in range(n):
            loss = step(state, batch, gen).loss
        return loss

    out(f"trace_train: the policy step at B={b}, {n} step(s) a run [{_device_label(dev)}]")
    res = _traced(run_once, dev, 1, n, topk, out)
    return _trace_row("trace_train_chain" if chain else "trace_train", res, dev, steps=n,
                      per="step")


def parse_vtrain(name: str) -> Tuple[int, str]:
    """(batch, policy) of `trace_vtrain[:<B>[:<policy>]]` (:1036-1043); the
    policy is `off`, `tfused`, a remat policy or `tfused-<remat>`, else
    `ValueError`."""
    parts = name.split(":")
    batch = int(parts[1]) if len(parts) > 1 else 4
    policy = parts[2] if len(parts) > 2 else "off"
    if policy not in ("off", "tfused") + REMAT_POLICIES + tuple(
            f"tfused-{r}" for r in REMAT_POLICIES):
        raise ValueError(f"perf lab {name!r}: policy {policy!r} is not off, tfused, a remat "
                         f"policy {REMAT_POLICIES} or tfused-<remat>")
    return batch, policy


def trace_vtrain(sizes: LabSizes, dev: torch.device, batch: int = 4, policy: str = "off",
                 chain: int = 3, topk: int = 40, out: Callable = print) -> dict:
    """The release video train step (:858) through `VideoModelTrainer`:
    pred_v `p_losses`, backward, clip, Adam, EMA; `chain` steps on one fixed
    batch traced, per step. `off`: the plain path; `tfused`: train_fused
    with K6 as the wgrad; a remat policy, alone or after `tfused-`, turns
    the trainer's `use_checkpoint` on with it (the JAX lab's
    `bench_video_train.parse_policy`). The device's peak memory over the
    steps from `device_memory_stats()` (not measured on the CPU)."""
    from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
    from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

    tfused = policy.startswith("tfused")
    remat = policy.split("-", 1)[1] if "-" in policy else (
        None if policy in ("off", "tfused") else policy)
    vcfg = VideoModelConfig(**dict(sizes.vtrain))
    hw = vcfg.image_size[0]
    model = VideoPredModel(vcfg, device=dev).init(0)
    workdir = tempfile.TemporaryDirectory(prefix="v2a_vtrain_")
    trainer = VideoModelTrainer(model, dataset=None, workdir=workdir.name,
                                config=VideoTrainerConfig(
                                    batch_size=batch, train_fused=tfused, wgrad_kernel=tfused,
                                    use_checkpoint=remat is not None,
                                    remat_policy=remat or "blocks"))
    gen = torch.Generator(device=dev).manual_seed(0)
    f = vcfg.video_future_horizon
    video = torch.rand(batch, f, hw, hw, 3, generator=gen, device=dev)
    x_cond = torch.rand(batch, 1, hw, hw, 3, generator=gen, device=dev) * 2 - 1
    task_embed = torch.randn(batch, sizes.tokens, vcfg.text_dim, generator=gen, device=dev) * 0.1
    t = torch.randint(0, vcfg.timesteps, (batch,), generator=gen, device=dev)
    weights = torch.ones(batch, device=dev)

    def run_once():
        for _ in range(chain):
            loss, _ = trainer.train_step(video, x_cond, task_embed, t, weights)
        return loss

    zero_launches()
    run_once()
    _sync(dev)
    launches = {k: v / chain for k, v in launch_counts().items()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out(f"trace_vtrain: B={batch} {policy} ({'train_fused, K6 wgrad' if tfused else 'plain'}"
        f"{f', remat {remat}' if remat else ''}), "
        f"{chain} steps a run [{_device_label(dev)}], launches per step {launches}")
    res = _traced(run_once, dev, 1, chain, topk, out)
    peak = (profiling.device_memory_stats()[f"cuda:{dev.index or 0}"]["peak_bytes_in_use"]
            if dev.type == "cuda" else None)
    out(f"trace_vtrain: peak device memory "
        + (f"{peak / 2 ** 30:.2f} GiB" if peak is not None else "not measured on the CPU"))
    trainer.metrics.close()
    workdir.cleanup()
    return _trace_row(f"trace_vtrain:{batch}:{policy}", res, dev, launches=launches,
                      steps=chain, per="step", peak_bytes=peak)


# -- the benches -------------------------------------------------------------------


def _flops_line(tag: str, ms: float, flops: float, dev: torch.device, extra: str = "") -> str:
    return (f"{tag} {ms:8.3f} ms  {flops / ms / 1e9:7.2f} TFLOP/s{extra}  "
            f"[{_device_label(dev)}]")


def _library_conv(w: torch.Tensor) -> Callable:
    """`F.conv2d` of (N, H, W, C) channels-last data with an HWIO kernel."""
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def conv(y):
        return F.conv2d(y.permute(0, 3, 1, 2), wl, padding=1).permute(0, 2, 3, 1)
    return conv


def _level_inputs(n, h, w, c, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    x = torch.randn(n, h, w, c, generator=gen, device=dev).to(dt)
    wgt = (torch.randn(3, 3, c, c, generator=gen, device=dev) * 0.02).to(dt)
    return x, wgt


def convbench(shapes=None, device=None, chain: int = 20, iters: int = 5,
              out: Callable = print) -> List[dict]:
    """The 3x3 conv at L2-L4 (`conv_bench` :126): `F.conv2d` against the
    im2col form (one (N*H*W, 9C) x (9C, D) matmul, the patch matrix built
    in the call)."""
    dev = resolve_device(device)
    shapes = shapes or (LEVELS[2:] if dev.type == "cuda" else CPU_LEVELS)
    rows = []
    for name, n, h, w, c in shapes:
        x, wgt = _level_inputs(n, h, w, c, dev)
        flops = 2.0 * 9 * c * c * h * w * n
        for label, fn in (("library", _library_conv(wgt)),
                          ("im2col", lambda y: _im2col_conv(y, wgt))):
            ms = time_chained(fn, x, chain, iters)
            rows.append(dict(bench="convbench", shape=name, impl=label, ms=ms,
                             tflops=flops / ms / 1e9))
            out(_flops_line(f"conv {name:<5} {label:<8}", ms, flops, dev))
    return rows


def affconvbench(shapes=None, device=None, chain: int = 20, iters: int = 5,
                 out: Callable = print) -> List[dict]:
    """The deep-level conv at L0-L4 (`affconv_bench` :171): the library conv
    of x and of the materialised silu(a * x + b), against K1 plain and with
    its affine + SiLU applied inside."""
    dev = resolve_device(device)
    shapes = shapes or (LEVELS if dev.type == "cuda" else CPU_LEVELS)
    rows = []
    for name, n, h, w, c in shapes:
        x, wgt = _level_inputs(n, h, w, c, dev)
        bias = torch.zeros(c, device=dev)
        a, b = torch.ones(n, c, device=dev), torch.zeros(n, c, device=dev)
        conv = _library_conv(wgt)
        flops = 2.0 * 9 * c * c * h * w * n
        impls = (("library", conv),
                 ("library+aff", lambda y: conv(F.silu(y.float() * a[:, None, None]
                                                       + b[:, None, None]).to(y.dtype))),
                 ("K1", lambda y: rk.fused_affine_conv3x3(y, wgt, bias)),
                 ("K1+aff", lambda y: rk.fused_affine_conv3x3(y, wgt, bias, a, b, silu=True)))
        for label, fn in impls:
            ms = time_chained(fn, x, chain, iters)
            rows.append(dict(bench="affconvbench", shape=name, impl=label, ms=ms,
                             tflops=flops / ms / 1e9))
            out(_flops_line(f"affconv {name:<4} {label:<12}", ms, flops, dev))
    return rows


def dot_rate(m: int, k: int, n: int, dev: torch.device, streams: int = 4, chain: int = 50,
             iters: int = 3, out: Optional[Callable] = print) -> float:
    """Throughput (FLOP/s) of `streams` independent chains of (M, K) x (K, N)
    then (M, N) x (N, K) `torch.matmul`s, advanced together (`_dot_rate`
    :236): one chain measures latency, several their throughput."""
    gen = torch.Generator(device=dev).manual_seed(91)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    ys = tuple(torch.randn(m, k, generator=gen, device=dev).to(dt) for _ in range(streams))
    wa = (torch.randn(k, n, generator=gen, device=dev) * 0.05).to(dt)
    wb = (torch.randn(n, k, generator=gen, device=dev) * 0.05).to(dt)
    ms = time_chained(lambda ys_: tuple((y @ wa) @ wb for y in ys_), ys, chain, iters)
    rate = streams * 4.0 * m * k * n / (ms / 1e3)
    if out is not None:
        out(f"    dot ({m:6d},{k:4d})x({k:4d},{n:4d}) x{streams}  {rate / 1e12:7.2f} TF/s  "
            f"[{_device_label(dev)}]")
    return rate


def dotbench(shapes=None, device=None, chain: int = 50, iters: int = 3,
             out: Callable = print) -> List[dict]:
    """`dot_ceiling_bench` (:272): the stream sweep (1, 2, 4, 8) at the L0
    per-tap shape, then 4 streams at each of the JAX lab's per-tap shapes."""
    dev = resolve_device(device)
    shapes = shapes or (DOT_SHAPES if dev.type == "cuda" else CPU_DOT_SHAPES)
    rows = []
    for s in (1, 2, 4, 8):
        m, k, n = shapes[0]
        rate = dot_rate(m, k, n, dev, s, chain, iters, out)
        rows.append(dict(bench="dotbench", shape=(m, k, n), streams=s, tflops=rate / 1e12,
                         ms=s * 4.0 * m * k * n / rate * 1e3))
    for m, k, n in shapes:
        rate = dot_rate(m, k, n, dev, 4, chain, iters, out)
        rows.append(dict(bench="dotbench", shape=(m, k, n), streams=4, tflops=rate / 1e12,
                         ms=16.0 * m * k * n / rate * 1e3))
    return rows


def megabench(levels: Optional[Sequence[str]] = None, device=None, chain: int = 10,
              iters: int = 3, out: Callable = print) -> List[dict]:
    """`mega_bench` (:293): at each level's in_dn (one part), out (one part
    with residual, emb and statistics) and in_up (two parts) configuration,
    K3 at its own plan (`rk.conv_tconv_plan`) where the JAX rule runs it,
    K4a then K4b for the same work, and the dot ceiling: one tap's product
    over every pixel, (B*F*H*W, C) x (C, D) by `torch.matmul`, scaled to the
    kernel's 2*F*B*H*W*D*C*(9*parts + 3) FLOP; gap = time / ceiling."""
    dev = resolve_device(device)
    table = MEGA_LEVELS if dev.type == "cuda" else CPU_MEGA
    b, f = (8, 7) if dev.type == "cuda" else (1, 3)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    rows = []
    for lv in levels or list(table):
        name, h, c = table[lv]
        w, d = h, c
        hp, wp = rk.padded_hw(h, w)
        m_tap = b * f * h * w
        ceiling = dot_rate(m_tap, c, d, dev, streams=1, chain=chain, iters=iters, out=out)
        gen = torch.Generator(device=dev).manual_seed(3)
        kernel = (torch.randn(3, 3, c, d, generator=gen, device=dev) * 0.02).to(dt)
        tkernel = (torch.randn(3, d, d, generator=gen, device=dev) * 0.02).to(dt)
        a = torch.ones(b * f, c, device=dev)
        sh = torch.zeros(b * f, c, device=dev)
        kbias, tbias = torch.zeros(d, device=dev), torch.zeros(d, device=dev)
        x0 = torch.randn(b, f, hp, wp, c, generator=gen, device=dev).to(dt)
        for variant, n_parts, with_out in (("in_dn", 1, False), ("out", 1, True),
                                           ("in_up", 2, False)):
            emb = torch.randn(b, d, generator=gen, device=dev) * 0.1 if with_out else None
            flops = 2.0 * f * b * h * w * d * c * (9 * n_parts + 3)
            band = rk.conv_tconv_band_rows(h, w, wp, [c] * n_parts, d, f, has_res=with_out)

            def k3(y, n_parts=n_parts, with_out=with_out, emb=emb):
                o = rk.fused_conv_tconv_padded([(y, kernel, a, sh)] * n_parts, kbias, tkernel,
                                               tbias, (h, w), emb, y if with_out else None,
                                               silu=True, want_stats=with_out)
                return ((o[0] if with_out else o) * 0.5).to(dt)

            def k4(y, n_parts=n_parts, with_out=with_out, emb=emb):
                flat = [(y.reshape(b * f, hp, wp, c), kernel, a, sh)] * n_parts
                yc = rk.fused_affine_conv3x3_padded(flat, kbias, (h, w), silu=True)
                o = rk.temporal_conv_padded(yc.reshape(b, f, hp, wp, d), tkernel, tbias, (h, w),
                                            emb, y if with_out else None, None, None, with_out)
                return ((o[0] if with_out else o) * 0.5).to(dt)

            sol = flops / ceiling * 1e3
            impls = [("K4a+K4b", k4)] + ([("K3", k3)] if band else [])
            plan = rk.conv_tconv_plan(b, f, h, w, d) if band else None
            for label, fn in impls:
                ms = time_chained(fn, x0, chain, iters)
                rows.append(dict(bench="megabench", shape=f"{name}.{variant}", impl=label,
                                 ms=ms, tflops=flops / ms / 1e9, dot_sol_ms=sol, gap=ms / sol,
                                 plan=plan._asdict() if label == "K3" else None))
                out(_flops_line(f"mega {name}.{variant:<5} {label:<8}", ms, flops, dev,
                                f"  dotSoL {sol:8.3f} ms  gap {ms / sol:5.2f}x"
                                + (f"  plan pixels {plan.pixels} cluster {plan.cluster} "
                                   f"grid {plan.grid}" if label == "K3" else "")))
            if not band:
                out(f"mega {name}.{variant}: K3 not run, the JAX rule runs K4a -> K4b here  "
                    f"[{_device_label(dev)}]")
    return rows


def winograd_conv(x: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Winograd F(2x2, 3x3) 3x3 SAME conv in plain PyTorch (`_winograd_conv`
    :382): 16 strided input slices, B^T d B in float32, 16 batched (M, C) x
    (C, D) products in x.dtype (`torch.bmm`, its output rounded to x.dtype
    where the JAX form keeps float32), A^T M A, interleaved. Even H and W."""
    n, h, w, c = x.shape
    d = wgt.shape[-1]
    nh, nw = h // 2, w // 2
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    dd = [[xp[:, a:a + 2 * nh - 1:2, bb:bb + 2 * nw - 1:2] for bb in range(4)] for a in range(4)]

    def bt(v):
        return [v[0] - v[2], v[1] + v[2], v[2] - v[1], v[1] - v[3]]

    t = [bt([dd[a][bb] for a in range(4)]) for bb in range(4)]
    v16 = [bt([t[bb][a] for bb in range(4)]) for a in range(4)]
    v = torch.stack([v16[a][bb] for a in range(4) for bb in range(4)])
    v = v.reshape(16, n * nh * nw, c).to(x.dtype)
    g = torch.tensor([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]],
                     dtype=torch.float32, device=x.device)
    u = torch.einsum("ai,bj,ijcd->abcd", g, g, wgt.float()).reshape(16, c, d).to(x.dtype)
    m = torch.bmm(v, u).float().reshape(4, 4, n, nh, nw, d)

    def at(v4):
        return [v4[0] + v4[1] + v4[2], v4[1] - v4[2] - v4[3]]

    ta = [at([m[a, bb] for a in range(4)]) for bb in range(4)]
    y = [at([ta[bb][i] for bb in range(4)]) for i in range(2)]
    yy = torch.stack([torch.stack(y[i], 0) for i in range(2)], 0)
    return yy.permute(2, 3, 0, 4, 1, 5).reshape(n, h, w, d).to(x.dtype)


def winobench(shapes=None, device=None, chain: int = 20, iters: int = 5,
              out: Callable = print) -> List[dict]:
    """`winograd_bench` (:448): the plain Winograd form against `F.conv2d`
    at L0-L4, its error relative to the library conv's largest value."""
    dev = resolve_device(device)
    shapes = shapes or (LEVELS if dev.type == "cuda" else CPU_LEVELS)
    rows = []
    for name, n, h, w, c in shapes:
        x, wgt = _level_inputs(n, h, w, c, dev)
        conv = _library_conv(wgt)
        ref = conv(x).float()
        relerr = float((winograd_conv(x, wgt).float() - ref).abs().max()
                       / (ref.abs().max() + 1e-6))
        flops = 2.0 * 9 * c * c * h * w * n
        for label, fn in (("library", conv), ("winograd", lambda y: winograd_conv(y, wgt))):
            ms = time_chained(fn, x, chain, iters)
            rows.append(dict(bench="winobench", shape=name, impl=label, ms=ms,
                             tflops=flops / ms / 1e9,
                             relerr=relerr if label == "winograd" else None))
            out(_flops_line(f"wino {name:<4} {label:<9}", ms, flops, dev,
                            "(direct-equiv)" + (f"  relerr={relerr:.2e}"
                                                if label == "winograd" else "")))
    return rows


def winobench2(shapes=None, device=None, chain: int = 10, iters: int = 3,
               out: Callable = print) -> List[dict]:
    """The 3x3 conv (C -> C, bf16) at each (level, N, H, W, C) through the
    library conv, K10 and K14, chained; K14's max error relative to the
    library conv's largest magnitude, as the JAX bench prints it
    (`winograd_pallas_bench` :485-531)."""
    dev = resolve_device(device)
    shapes = shapes or (WINO_SHAPES if dev.type == "cuda" else CPU_LEVELS)
    rows = []
    for name, n, h, w, c in shapes:
        x, wgt = _level_inputs(n, h, w, c, dev)
        bias = torch.zeros(c, device=dev)
        flops = 2.0 * 9 * c * c * h * w * n
        impls = (("library", _library_conv(wgt)),
                 ("direct", lambda y: rk.spatial_conv3x3(y, wgt, bias)),
                 ("wino", lambda y: rk.winograd_conv3x3(y, wgt, bias)))
        ref = impls[0][1](x).float()
        relerr = float((impls[2][1](x).float() - ref).abs().max() / (ref.abs().max() + 1e-6))
        for label, fn in impls:
            ms = time_chained(fn, x, chain, iters)
            rows.append(dict(bench="winobench2", shape=name, impl=label, ms=ms,
                             tflops=flops / ms / 1e9,
                             relerr=relerr if label == "wino" else None))
            out(f"winop {name:<4} {label:<7} {ms:8.3f} ms  {flops / ms / 1e9:6.1f} "
                f"TF/s(direct-equiv)" + (f"  relerr={relerr:.2e}" if label == "wino" else "")
                + f"  [{_device_label(dev)}]")
    return rows


def tconvbench(shapes=None, device=None, chain: int = 20, iters: int = 5,
               out: Callable = print) -> List[dict]:
    """The temporal conv at L0-L4 (`tconv_bench` :534): the transpose +
    `F.conv1d` form (frames on the conv axis), K2 plain and with its fused
    emb / statistics, and the (3, 1) `F.conv2d` form over (B, F, H*W, C)
    with and without the emb add and the statistics after it."""
    dev = resolve_device(device)
    if shapes is None:
        shapes = ([(lv, 8, 7, h, w, c) for lv, _, h, w, c in LEVELS] if dev.type == "cuda"
                  else [(lv, b, f, int(math.isqrt(s)), int(math.isqrt(s)), c)
                        for lv, b, f, s, c in CPU_TCONV])
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    rows = []
    for name, b, f, h, w, c in shapes:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(b, f, h, w, c, generator=gen, device=dev).to(dt)
        kernel = torch.randn(3, c, c, generator=gen, device=dev) * 0.05
        bias = torch.zeros(c, device=dev)
        emb = torch.randn(b, c, generator=gen, device=dev)
        w1d = kernel.to(dt).permute(2, 1, 0).contiguous()  # (C_out, C_in, 3)
        flops = 2.0 * 3 * c * c * h * w * b * f

        def transpose_form(y):
            t = y.permute(0, 2, 3, 4, 1).reshape(b * h * w, c, f)
            t = F.conv1d(t, w1d, bias.to(dt), padding=1)
            return t.reshape(b, h, w, c, f).permute(0, 4, 1, 2, 3)

        impls = (("transpose", transpose_form),
                 ("K2", lambda y: rk.temporal_conv_fused(y, kernel, bias)),
                 ("K2+es", lambda y: rk.temporal_conv_fused(y, kernel, bias, emb=emb,
                                                            want_stats=True)[0]),
                 ("conv2d", lambda y: _tconv_conv2d(y, kernel, bias, None, None, False)),
                 ("conv2d+es", lambda y: _tconv_conv2d(y, kernel, bias, emb, None, True)[0]))
        for label, fn in impls:
            ms = time_chained(fn, x, chain, iters)
            rows.append(dict(bench="tconvbench", shape=name, impl=label, ms=ms,
                             tflops=flops / ms / 1e9))
            out(_flops_line(f"tconv {name:<4} {label:<10}", ms, flops, dev))
    return rows


def tconvbench2(shapes=None, device=None, chain: int = 10, iters: int = 3,
                out: Callable = print) -> List[dict]:
    """The plain 3-tap temporal conv (bf16) at each (level, B, F, S, C)
    through K15 and the library yardstick (one `torch.matmul` of the
    frame-stacked operand, which the chained call stacks first), chained
    (`tconv_variants_bench` :613-716; its three TPU schedules of the kernel
    are TPU tiling experiments with no counterpart here)."""
    dev = resolve_device(device)
    shapes = shapes or (TCONV_SHAPES if dev.type == "cuda" else CPU_TCONV)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, b, f, s, c in shapes:
        x = torch.randn(b, f, s, c, generator=gen, device=dev).to(dt)
        w = (torch.randn(3 * c, c, generator=gen, device=dev) * 0.05).to(dt)
        flops = 2.0 * 3 * c * c * s * b * f

        def library(y, f=f, c=c, w=w):
            yp = F.pad(y, (0, 0, 0, 0, 1, 1))
            stacked = torch.cat([yp[:, :f], yp[:, 1:f + 1], yp[:, 2:]], -1)
            return torch.matmul(stacked.reshape(-1, 3 * c), w).reshape(y.shape)

        for label, fn in (("kernel", lambda y: temporal_conv_taps(y, w)),
                          ("stacked-matmul", library)):
            ms = time_chained(fn, x, chain, iters)
            rows.append(dict(bench="tconvbench2", shape=name, impl=label, ms=ms,
                             tflops=flops / ms / 1e9))
            out(f"tconv2 {name} {label:<14} {ms:8.3f} ms  {flops / ms / 1e9:6.1f} TFLOP/s"
                f"  [{_device_label(dev)}]")
    return rows


BENCHES = {"convbench": convbench, "affconvbench": affconvbench, "dotbench": dotbench,
           "megabench": megabench, "winobench": winobench, "winobench2": winobench2,
           "tconvbench": tconvbench, "tconvbench2": tconvbench2}
TRACE_FORWARDS = {"trace": FORWARDS["fused"], "trace_base": FORWARDS["base"],
                  "trace_sp2": Forward(_r(LAB, spatial2_min_ch=512), ATTN, True),
                  "trace_default": FORWARDS["fused_default"]}


def resolve(name: str, dev: torch.device, sizes: LabSizes, chain: Optional[int],
            iters: Optional[int], out: Callable) -> Callable[[], List[dict]]:
    """The run of one lab name; raises `ValueError` for an unknown name or
    `trace_vtrain` policy and the names with no counterpart."""
    kw = {k: v for k, v in (("chain", chain), ("iters", iters)) if v is not None}
    if name in BENCHES:
        return functools.partial(BENCHES[name], device=dev, out=out, **kw)
    if name.startswith("megabench:"):
        lv = name.split(":", 1)[1]
        if lv not in MEGA_LEVELS:
            raise ValueError(f"perf lab {name!r}: level one of {sorted(MEGA_LEVELS)}")
        return functools.partial(megabench, [lv], device=dev, out=out, **kw)
    runs = {} if iters is None else {"runs": iters}
    if name in TRACE_FORWARDS:
        return lambda: [trace_forward(name, TRACE_FORWARDS[name], sizes, dev, out=out, **runs)]
    if name == "trace_chain" or name.startswith("trace_chain:"):
        topk = int(name.split(":")[1]) if ":" in name else 30
        steps = {} if chain is None else {"steps": chain}
        return lambda: [trace_chain(sizes, dev, topk=topk, out=out, **steps)]
    if name in ("trace_train", "trace_train_chain"):
        n = 0 if name == "trace_train" else (chain or 20)
        return lambda: [trace_train(sizes, dev, chain=n, out=out)]
    if name == "trace_vtrain" or name.startswith("trace_vtrain:"):
        batch, policy = parse_vtrain(name)
        steps = {} if chain is None else {"chain": chain}
        return lambda: [trace_vtrain(sizes, dev, batch, policy, out=out, **steps)]
    if forward_of(name) is not None:
        fw = {} if iters is None else {"iters": iters}
        return lambda: [time_forward(name, sizes, dev, out=out, **fw)]
    raise ValueError(f"perf lab: unknown name {name!r}")


def main(argv: Optional[Sequence[str]] = None, device=None, sizes: Optional[LabSizes] = None,
         chain: Optional[int] = None, iters: Optional[int] = None,
         out: Callable = print) -> List[dict]:
    """Runs the named lab entries in order (the JAX lab's `main`, :1015);
    with no name, the five ablations, then the share lines. `chain` and
    `iters` override each entry's own (chain length or DDIM steps; timed
    iterations or traced runs). Every name is checked before any runs."""
    want = list(sys.argv[1:] if argv is None else argv) or list(ABLATIONS)
    dev = resolve_device(device)
    sizes = sizes or lab_sizes(dev)
    runs = [resolve(name, dev, sizes, chain, iters, out) for name in want]
    rows: List[dict] = []
    for run in runs:
        rows += run()
    ms = {r["name"]: r["ms"] for r in rows if r["bench"] == "forward"}
    if "base" in ms:
        for name, v in ms.items():
            if name != "base":
                out(f"  {name:<16} share ~= {ms['base'] - v:9.3f} ms")
    if "fused_default" in ms and "default_noattn" in ms:
        out(f"  attention in the shipped routing: fused_default - default_noattn = "
            f"{ms['fused_default'] - ms['default_noattn']:9.3f} ms")
    return rows


if __name__ == "__main__":
    main()
