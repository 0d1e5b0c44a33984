"""On-card numerical parity gate for the port's fused and padded kernels.

    python -m v2a_tpu_torch.scripts.verify_onchip            # the main gate
    python -m v2a_tpu_torch.scripts.verify_onchip --train    # the optimiser gate
    python -m v2a_tpu_torch.scripts.verify_onchip --train-fused  # the gradient gate

Counterpart of `scripts/verify_onchip.py`. The kernels' CPU tests hold each
kernel against its plain version one call at a time; this gate catches what
builds up over a whole sampling chain, such as a pad row that a consumer
forgot to mask: every step's forward can look fine while the sampled video
is wrong. It runs the release-width video U-Net (in 6, mc 128, mult
(1, 2, 3, 4, 5), 2 res blocks, attention at ds 8 / 16, head 32, text 512;
bf16 on the card) under each routing of `CONFIGS` on the same weights and
inputs: one B=8 forward, then a whole 100-step ancestral chain (cosine
schedule, pred_v), each held against the plain path (`unfused`) with the
JAX script's gates and report keys. Every parameter is N(0, 1) * 0.02 from
one seeded generator in `named_parameters` order, loaded into every
routing's U-Net, as the JAX script draws every leaf, norms included. The
routings are arguments here (`ConvRouting`), so everything runs in one
process, where the JAX script needs a subprocess per set of environment
flags.

`CONFIGS` is the JAX script's minus `tapjoin_f`: that name sets
`V2A_TAPJOIN=f`, a TPU-only form of the tap join inside K3's Pallas body,
not a kernel or a routing. The port's K3 has no such form, and its perf
lab refuses the `fused_join_*` names for the same reason.

`--train` takes one set of gradients from the release policy's loss at
B=16, then runs three clip + AdamW updates three ways: (a) the port's
`fused_clip_adamw`, (b) an independent chain of
`torch.nn.utils.clip_grad_norm_` and `torch.optim.AdamW` with the same
`OptimizerConfig` (where the JAX script runs `optax.chain`), (c) a host
float64 version. Gates: (a)-(b) < 1e-6, (a)-(c) < 3e-6, the JAX gates.
`torch.optim.AdamW` decays p by (1 - lr * wd) before its Adam step where
optax adds wd * p to the update, and `clip_grad_norm_` divides by norm +
1e-6: equal in exact arithmetic, rounded differently; the report gives
the measured gap.

`--train-fused` holds the loss and every gradient of a small eligible
U-Net (mc 128, mult (1, 2), attention at ds 8; B=2, F=3, 32^2) through the
`train_fused` routing (K1 forward and dgrad through `ops/conv_vjp.py`)
against the plain path: worst cosine > 0.999, norm ratio < 1.02, relative
loss difference < 2e-2, the worst leaf by the port's parameter name. It
runs twice: with the library's weight gradient (`wgrad_kernel=False`, the
JAX default) and with K6 (`wgrad_kernel=True`).

Each prints one JSON object; the exit code is 0 only when it passes. The
card unless `--device cpu` (a missing card raises).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from v2a_tpu_torch.device import resolve_device
from v2a_tpu_torch.models.init import init_params
from v2a_tpu_torch.models.video_unet import ConvRouting, VideoUNet
from v2a_tpu_torch.ops.gaussian_diffusion import GaussianDiffusion
from v2a_tpu_torch.ops.schedules import DiffusionSchedule

# name -> VideoUNet routing; "unfused" is the ground truth (the plain path,
# no kernel of the port in the forward)
CONFIGS = {
    "unfused": dict(fused=False, routing=ConvRouting(padded_stream=False)),
    # K1 and K2 only
    "fused_nopad": dict(fused=True, routing=ConvRouting(padded_stream=False)),
    # the shipped routing: the padded stream (K1, K2, K3, K4a, K4b, K5)
    "default": dict(fused=True, routing=ConvRouting()),
    # the shipped routing with K9 in every attention block (V2A_PALLAS_ATTN=1)
    "pallas_attn": dict(fused=True, routing=ConvRouting(attn_kernel=True)),
}
REFERENCE = "unfused"

BATCH = 8  # the production operating point: kernel plans depend on it
FRAMES = 7
HW = 128
TOKENS = 16
STEPS = 100
UNET = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=2,
            attention_resolutions=(8, 16), channel_mult=(1, 2, 3, 4, 5),
            num_head_channels=32, task_token_dim=512)
# --train-fused: the smallest U-Net whose convs all take the train_fused routing
TRAIN_FUSED_UNET = dict(UNET, attention_resolutions=(8,), channel_mult=(1, 2))
TRAIN_FUSED_SHAPE = (2, 3, 32)  # b, f, hw
TRAIN_FUSED_T = (7, 61)
POLICY_BATCH = 16
OPT_STEPS = 3

Around = Callable[[str, str, Callable], object]


def compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, float32 on the CPU (the JAX script's rule)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize()


# -- the main gate ------------------------------------------------------------


def random_state(device: torch.device, unet_kw: dict = UNET,
                 seed: int = 0) -> Dict[str, torch.Tensor]:
    """The U-Net's state dict with every parameter N(0, 1) * 0.02, drawn from
    one generator in `named_parameters` order."""
    with torch.device(device):
        net = VideoUNet(**unet_kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for _, p in net.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
    return net.state_dict()


def build(name: str, state: Dict[str, torch.Tensor], device: torch.device,
          unet_kw: dict = UNET) -> VideoUNet:
    """The frozen U-Net of routing `name` holding `state`."""
    with torch.device(device):
        net = VideoUNet(dtype=compute_dtype(device), **CONFIGS[name], **unet_kw)
    net.eval().requires_grad_(False).load_state_dict(state)
    return net


def gate_inputs(device: torch.device, batch: int = BATCH, frames: int = FRAMES, hw: int = HW,
                unet_kw: dict = UNET, seed: int = 1234):
    """x (B, F, hw, hw, in) * 0.5, t = arange(B) * 12, tokens (B, 16, text) *
    0.1 and the conditioning frame (B, 1, hw, hw, out) in [-1, 1], from one
    generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, frames, hw, hw, unet_kw["in_channels"], generator=gen,
                    device=device) * 0.5
    t = torch.arange(batch, device=device) * 12
    emb = torch.randn(batch, TOKENS, unet_kw["task_token_dim"], generator=gen,
                      device=device) * 0.1
    x_cond = torch.rand(batch, 1, hw, hw, unet_kw["out_channels"], generator=gen,
                        device=device) * 2.0 - 1.0
    return x, t, emb, x_cond


def chain_diffusion(steps: int, device: torch.device) -> GaussianDiffusion:
    """The ancestral chain of `steps` steps: cosine schedule, pred_v."""
    return GaussianDiffusion(schedule=DiffusionSchedule.create(steps, "cosine", device=device),
                             objective="pred_v", sampling_timesteps=steps)


def sample_chain(net: VideoUNet, diffusion: GaussianDiffusion, x_cond: torch.Tensor,
                 emb: torch.Tensor, frames: int, seed: int) -> torch.Tensor:
    """x_T and every step's noise from one generator seeded `seed`; the
    video in [0, 1]."""
    b, _, h, w, c = x_cond.shape
    gen = torch.Generator(device=x_cond.device).manual_seed(seed)
    img = torch.randn(b, frames, h, w, c, generator=gen, device=x_cond.device)
    with torch.no_grad():
        for step in diffusion.sample_steps():
            img = diffusion.sample_step(net, img, step, x_cond, emb, gen)
        return diffusion.sample_finish(img)


def run_configs(device: torch.device, batch: int = BATCH, chain_batch: Optional[int] = None,
                steps: int = STEPS, frames: int = FRAMES, hw: int = HW, unet_kw: dict = UNET,
                around: Optional[Around] = None,
                log: Optional[Callable] = None) -> Dict[str, Dict[str, np.ndarray]]:
    """Each routing of `CONFIGS` on the same weights and inputs: a forward at
    `batch`, then the chain at `chain_batch` (the first rows; `batch` by
    default). `around(name, part, fn)` runs `fn` ("forward" or "chain") and
    returns its result (a caller's counting hook). Returns {name: {"fwd",
    "video"}} as float32 host arrays."""
    chain_batch = batch if chain_batch is None else chain_batch
    if not 0 < chain_batch <= batch:
        raise ValueError(f"chain batch {chain_batch} not in 1..{batch}")
    around = around or (lambda name, part, fn: fn())
    log = log or (lambda msg: print(msg, flush=True))
    state = random_state(device, unet_kw)
    x, t, emb, x_cond = gate_inputs(device, batch, frames, hw, unet_kw)
    diffusion = chain_diffusion(steps, device)
    outs = {}
    for name in CONFIGS:
        log(f"== running config {name} ==")
        net = build(name, state, device, unet_kw)
        t0 = time.perf_counter()
        with torch.no_grad():
            y = around(name, "forward", lambda: net(x, t, emb))
        y = y.float().cpu().numpy()
        t1 = time.perf_counter()
        video = around(name, "chain", lambda: sample_chain(
            net, diffusion, x_cond[:chain_batch], emb[:chain_batch], frames, seed=1237))
        video = video.float().cpu().numpy()
        t2 = time.perf_counter()
        log(f"[verify] {name}: B={batch} forward {t1 - t0:.2f} s, {steps}-step chain at "
            f"B={chain_batch} {t2 - t1:.2f} s; fwd std={y.std():.4f} video mean="
            f"{video.mean():.4f} std={video.std():.4f}")
        outs[name] = dict(fwd=y, video=video)
        del net
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return outs


def parity_report(outs: Dict[str, Dict[str, np.ndarray]]):
    """Every routing against `REFERENCE` with the JAX script's gates and
    keys (`scripts/verify_onchip.py:357-405`): (report, pass)."""
    ref = outs[REFERENCE]
    report = {}
    ok = True
    for name, got in outs.items():
        if name == REFERENCE:
            continue
        # forward: bf16-level closeness, normalized by the output scale. ~25
        # bf16 layers of re-rounded compute accumulate relative error well
        # past one bf16 ulp; the gate is against corruption (a garbage pad
        # row leaking in is O(1) against the output std), not bit equality
        scale = float(ref["fwd"].std())
        err = np.abs(got["fwd"] - ref["fwd"])
        fwd_max = float(err.max()) / scale
        fwd_mean = float(err.mean()) / scale
        # chain: 100 steps amplify bf16 noise; videos sampled from the same
        # generator and weights must still be finite, in range and
        # statistically indistinguishable
        v, vr = got["video"], ref["video"]
        chain = {
            "finite": bool(np.isfinite(v).all()),
            "mean_delta": abs(float(v.mean()) - float(vr.mean())),
            "std_ratio": float(v.std()) / float(vr.std()),
            "pix_mae": float(np.abs(v - vr).mean()),
        }
        passed = bool(
            fwd_max < 0.25 and fwd_mean < 0.01 and chain["finite"]
            and chain["mean_delta"] < 0.05
            and 0.9 < chain["std_ratio"] < 1.1
        )
        ok &= passed
        report[name] = {
            "fwd_max_err_over_std": round(fwd_max, 5),
            "fwd_mean_err_over_std": round(fwd_mean, 6),
            **{k: (round(val, 5) if isinstance(val, float) else val)
               for k, val in chain.items()},
            "pass": passed,
        }
    return report, ok


def video_deltas(outs: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, Dict[str, float]]:
    """Each routing's sampled video against `REFERENCE`'s, unrounded (the
    report rounds `pix_mae` to 5 decimals): mean and max |difference|."""
    ref = outs[REFERENCE]["video"]
    return {name: {"pix_mae": float(np.abs(o["video"] - ref).mean()),
                   "pix_max": float(np.abs(o["video"] - ref).max())}
            for name, o in outs.items() if name != REFERENCE}


def parity_gate(device: torch.device, **kw):
    """`run_configs` then `parity_report`: {"onchip_parity": report,
    "pass": ok}, the JAX script's JSON; the unrounded video differences
    printed on a line of their own."""
    outs = run_configs(device, **kw)
    print(f"[verify] sampled videos against {REFERENCE}, unrounded: "
          f"{json.dumps(video_deltas(outs))}", flush=True)
    report, ok = parity_report(outs)
    return {"onchip_parity": report, "pass": ok}


# -- --train: the optimiser gate ----------------------------------------------


def policy_grads(device: torch.device, config=None, batch: int = POLICY_BATCH):
    """One set of gradients of the policy's loss (the release policy, bf16
    compute on the card, by default) on a batch from RandomState(0): the
    parameters and gradients as float32 tensors on the device."""
    from v2a_tpu_torch.models.policy import DiffusionPolicy, PolicyConfig

    cfg = config or PolicyConfig(dtype="bfloat16" if device.type == "cuda" else "float32")
    policy = DiffusionPolicy.create(cfg, device=device).init(0)
    policy.nets.requires_grad_(True)
    h, w = cfg.image_size
    rs = np.random.RandomState(0)
    data = {"obs": {k: torch.as_tensor(rs.rand(batch, h, w, 3), dtype=torch.float32,
                                       device=device) for k in cfg.obs_keys},
            "action": torch.as_tensor(rs.uniform(-1, 1, (batch, cfg.horizon, cfg.action_dim)),
                                      dtype=torch.float32, device=device)}
    params = [p for _, p in policy.nets.named_parameters()]
    loss = policy.loss(data, torch.Generator(device=device).manual_seed(1))
    grads = torch.autograd.grad(loss, params)
    return ([p.detach().float().clone() for p in params],
            [g.detach().float() for g in grads])


def optimizer_gate(params, grads, ocfg=None):
    """`OPT_STEPS` clip + AdamW updates on the same gradients each step,
    three ways (module docstring): (report, pass)."""
    from v2a_tpu_torch.train.train_state import OptimizerConfig, fused_clip_adamw

    ocfg = ocfg or OptimizerConfig()
    device = params[0].device
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        _sync(device)
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    tx = fused_clip_adamw(ocfg)
    fused = [p.clone() for p in params]
    state = tx.init(fused)
    for _ in range(OPT_STEPS):
        updates, state = tx.update(grads, state, fused)
        torch._foreach_add_(fused, updates)
    lap("fused")

    chain = [torch.nn.Parameter(p.clone()) for p in params]
    opt = torch.optim.AdamW(chain, lr=ocfg.lr, betas=(ocfg.b1, ocfg.b2), eps=ocfg.eps,
                            weight_decay=ocfg.weight_decay)
    for _ in range(OPT_STEPS):
        for p, g in zip(chain, grads):
            p.grad = g.clone()
        torch.nn.utils.clip_grad_norm_(chain, ocfg.grad_clip)
        opt.step()
    lap("torch_chain")

    # the host float64 version of clip + AdamW, the same gradients each step
    # (torch on the CPU, in place: numpy's one thread takes several times
    # as long over the release policy's 87 M parameters)
    cpu = torch.device("cpu")
    g_host = [g.to(cpu, torch.float64) for g in grads]
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in g_host)))
    scale = min(1.0, ocfg.grad_clip / max(norm, 1e-30))
    d_fused_chain = d_fused_ref = d_chain_ref = 0.0
    for p0, g, a, b in zip(params, g_host, fused, chain):
        p = p0.to(cpu, torch.float64)
        g = g * scale
        gg = g * g
        m = torch.zeros_like(p)
        v = torch.zeros_like(p)
        for k in range(1, OPT_STEPS + 1):
            m.mul_(ocfg.b1).add_(g, alpha=1 - ocfg.b1)
            v.mul_(ocfg.b2).add_(gg, alpha=1 - ocfg.b2)
            upd = (m / (1 - ocfg.b1 ** k)).div_((v / (1 - ocfg.b2 ** k)).sqrt_().add_(ocfg.eps))
            p.sub_(upd.add_(p, alpha=ocfg.weight_decay), alpha=ocfg.lr)
        a64, b64 = a.detach().to(cpu, torch.float64), b.detach().to(cpu, torch.float64)
        d_fused_chain = max(d_fused_chain, float((a64 - b64).abs().max()))
        d_fused_ref = max(d_fused_ref, float((a64 - p).abs().max()))
        d_chain_ref = max(d_chain_ref, float((b64 - p).abs().max()))
    lap("host_f64")
    # an update moves a weight by ~lr = 1e-4 a step; the gates are relative to it
    passed = d_fused_chain < 1e-6 and d_fused_ref < 3e-6
    return {
        "fused_vs_torch_chain_max_abs": d_fused_chain,
        "fused_vs_host_f64_max_abs": d_fused_ref,
        "torch_chain_vs_host_f64_max_abs": d_chain_ref,
        "grad_global_norm": norm,
        "params": int(sum(p.numel() for p in params)),
        "seconds": seconds,
        "pass": passed,
    }, passed


def train_gate(device: torch.device, config=None, batch: int = POLICY_BATCH):
    """`policy_grads` then `optimizer_gate`: {"train_step_optimizer_gate":
    report, "pass": ok}."""
    t0 = time.perf_counter()
    params, grads = policy_grads(device, config, batch)
    _sync(device)
    grads_s = time.perf_counter() - t0
    report, ok = optimizer_gate(params, grads)
    report["seconds"] = dict(gradients=grads_s, **report["seconds"])
    return {"train_step_optimizer_gate": report, "pass": ok}


# -- --train-fused: the gradient gate -----------------------------------------


def train_fused_state(device: torch.device, unet_kw: dict = TRAIN_FUSED_UNET, seed: int = 0):
    """The small U-Net's weights: `init_params` from one seeded generator."""
    with torch.device(device):
        net = VideoUNet(**unet_kw)
    init_params(net, torch.Generator(device=device).manual_seed(seed))
    return net.state_dict()


def train_fused_grads(device: torch.device, state, train_fused: bool, wgrad_kernel: bool = False,
                      unet_kw: dict = TRAIN_FUSED_UNET, shape=TRAIN_FUSED_SHAPE):
    """The denoising loss of the U-Net holding `state` (plain or
    `train_fused`) on a batch from RandomState(0) with the noise from one
    seeded generator, and every gradient: (loss, {name: float64 array})."""
    b, f, hw = shape
    with torch.device(device):
        net = VideoUNet(dtype=compute_dtype(device), fused=False, train_fused=train_fused,
                        wgrad_kernel=wgrad_kernel, **unet_kw)
    net.load_state_dict(state)
    diffusion = GaussianDiffusion(schedule=DiffusionSchedule.create(100, "cosine", device=device),
                                  objective="pred_v")
    rs = np.random.RandomState(0)

    def host(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    video = host(rs.rand(b, f, hw, hw, unet_kw["out_channels"]))
    x_cond = host(rs.rand(b, 1, hw, hw, unet_kw["out_channels"]) * 2 - 1)
    emb = host(rs.randn(b, TOKENS, unet_kw["task_token_dim"]) * 0.1)
    t = torch.as_tensor(TRAIN_FUSED_T[:b], device=device)
    names, params = zip(*net.named_parameters())
    loss = diffusion.p_losses(net, video, x_cond, emb, t=t,
                              generator=torch.Generator(device=device).manual_seed(1))
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), {n: g.detach().double().cpu().numpy()
                                  for n, g in zip(names, grads)}


def grad_report(loss0: float, g0: Dict[str, np.ndarray], loss1: float,
                g1: Dict[str, np.ndarray]):
    """The train_fused loss and gradients `g1` against the plain path's `g0`
    with the JAX script's gates (`scripts/verify_onchip.py:303-328`):
    (report, pass)."""
    worst_cos, worst_leaf, worst_ratio = 1.0, None, 1.0
    for name, a in g0.items():
        a, bb = a.ravel(), g1[name].ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(bb)
        if na < 1e-12 and nb < 1e-12:
            continue
        cos = float(a @ bb / max(na * nb, 1e-30))
        ratio = float(max(na, nb) / max(min(na, nb), 1e-30))
        if cos < worst_cos:
            worst_cos, worst_leaf = cos, name
        worst_ratio = max(worst_ratio, ratio)
    dloss = abs(loss0 - loss1) / max(abs(loss0), 1e-9)
    passed = worst_cos > 0.999 and worst_ratio < 1.02 and dloss < 2e-2
    return {
        "loss_plain": loss0, "loss_train_fused": loss1,
        "rel_loss_diff": dloss,
        "worst_grad_cosine": worst_cos, "worst_leaf": worst_leaf,
        "worst_grad_norm_ratio": worst_ratio,
        "pass": passed,
    }, passed


def train_fused_gate(device: torch.device, unet_kw: dict = TRAIN_FUSED_UNET,
                     shape=TRAIN_FUSED_SHAPE):
    """The plain path's loss and gradients, then the train_fused routing's
    with the library's wgrad and with K6: {"train_fused_grad_gate":
    {"library_wgrad": report, "k6_wgrad": report}, "pass": ok}."""
    state = train_fused_state(device, unet_kw)
    plain = train_fused_grads(device, state, False, unet_kw=unet_kw, shape=shape)
    reports, ok = {}, True
    for label, wgrad in (("library_wgrad", False), ("k6_wgrad", True)):
        fused = train_fused_grads(device, state, True, wgrad, unet_kw=unet_kw, shape=shape)
        reports[label], passed = grad_report(*plain, *fused)
        ok &= passed
    return {"train_fused_grad_gate": reports, "pass": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="run the train-step optimizer numerics gate only")
    ap.add_argument("--train-fused", action="store_true",
                    help="run the differentiable fused-conv grad gate only")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if args.train:
        out = train_gate(device)
    elif args.train_fused:
        out = train_fused_gate(device)
    else:
        out = parity_gate(device)
    _sync(device)
    print(f"[verify] {time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}",
          flush=True)
    print(json.dumps(out, indent=2))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
