#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (`v2a_tpu_torch`) through its serving path on
one NVIDIA card and holds its hand-written kernels against their plain
PyTorch versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit, torch and CUDA versions;
  2. builds every kernel in `v2a_tpu_torch/csrc/` with nvcc (sm_90a);
  3. K1 / K2 against their plain versions in bf16 at every shape the
     release-width U-Net forward gives them (recorded from one forward),
     with kernel, plain and one-call PyTorch (`library_ms`) times;
  4. one release-width U-Net forward (B=8, F=7, 128^2, bf16): fused routing
     against the port's plain path and a float32 plain reference, with the
     kernels' launch counts per forward;
  5. serves requests: `VideoPredModel.sample` (100-step ancestral chain) per
     task, then `DiffusionPolicy.predict_action` (DDIM-8) on (current frame,
     first goal frame); checks shapes, range, finiteness and launch counts,
     then holds K1 / K2 against their plain versions at the shapes this
     serving run gave them;
  6. prints the `kernels` JSON line, then the device line last.

Weights are random from a seed; text goes through the offline HashTokenizer.
Per-shape results go to `chiprun_out/chip_smoke_shapes.json`.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

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
EXPECTED_PER_FORWARD = {"fused_affine_conv3x3": 73, "temporal_conv_fused": 63}
ROOT = os.path.dirname(os.path.abspath(__file__))


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


def within_one_ulp(got, want):
    """bf16: kernel and plain version sum the same rounded products in float32
    in another order, so the final rounding may differ by one unit in the
    last place (2^-7 of the value at most); near zero an absolute 1e-3 of
    the output's std absorbs the float32 summation noise."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    std = want.std()
    bad = int((err > want.abs() * 2.0 ** -7 + 1e-3 * std).sum())
    if bad:
        log(f"[kernels] {bad} of {want.numel()} elements beyond one bf16 ulp")
    return bad == 0, float(err.max()), float(err.max() / std)


def stats_rel_err(got, want):
    """Sum and sum of squares, each relative to its largest magnitude."""
    return max(
        float((got[:, :, i] - want[:, :, i]).abs().max() / want[:, :, i].abs().max())
        for i in range(2)
    )


def check_k1(rk, key, gen, dev, timed):
    """K1 at one recorded signature: (ok, max|err|, max|err|/std, None,
    times or None, flops, bytes, label)."""
    _, (n, h, w, c), d, affine, silu = key
    x = torch.randn(n, h, w, c, generator=gen, device=dev).bfloat16()
    kern = torch.randn(3, 3, c, d, generator=gen, device=dev) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn(d, generator=gen, device=dev)
    a = b = None
    if affine:
        a = 1 + 0.1 * torch.randn(n, c, generator=gen, device=dev)
        b = 0.1 * torch.randn(n, c, generator=gen, device=dev)
    got = rk.fused_affine_conv3x3(x, kern, bias, a, b, silu)
    want = rk.fused_affine_conv3x3_plain(x, kern, bias, a, b, silu)
    ok, abs_err, rel = within_one_ulp(got, want)
    times = None
    if timed:
        times = dict(
            ms=time_ms(lambda: rk.fused_affine_conv3x3(x, kern, bias, a, b, silu)),
            plain_ms=time_ms(lambda: rk.fused_affine_conv3x3_plain(x, kern, bias, a, b, silu),
                             3, 1),
        )
        # yardstick: cuDNN on the pre-activated input, channels_last bf16
        xa = x
        if affine:
            xf = x.float() * a[:, None, None, :] + b[:, None, None, :]
            xa = (xf * torch.sigmoid(xf) if silu else xf).bfloat16()
        xa = xa.permute(0, 3, 1, 2)  # NCHW view of channels_last data
        wl = kern.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bl = bias.bfloat16()
        times["library_ms"] = time_ms(lambda: F.conv2d(xa, wl, bl, padding=1))
    # only taps inside the frame: the zero halo needs no products
    flops = 2.0 * n * (3 * h - 2) * (3 * w - 2) * c * d
    nbytes = 2 * (n * h * w * (c + d) + 9 * c * d) + 4 * d + (8 * n * c if affine else 0)
    mode = "affine+silu" if silu else "affine" if affine else "plain-conv"
    return ok, abs_err, rel, None, times, flops, nbytes, f"K1 {n}x{h}x{w}x{c}->{d} {mode}"


def check_k2(rk, key, gen, dev, timed):
    """K2 at one recorded signature, as `check_k1`."""
    _, shape, has_emb, has_res, stats = key
    b, f, c = shape[0], shape[1], shape[-1]
    s = 1
    for dim in shape[2:-1]:
        s *= dim
    x = torch.randn(*shape, generator=gen, device=dev).bfloat16()
    kern = torch.randn(3, c, c, generator=gen, device=dev) / (3 * c) ** 0.5
    bias = 0.1 * torch.randn(c, generator=gen, device=dev)
    emb = torch.randn(b, c, generator=gen, device=dev).bfloat16() if has_emb else None
    res = torch.randn(*shape, generator=gen, device=dev).bfloat16() if has_res else None
    got = rk.temporal_conv_fused(x, kern, bias, emb, res, stats)
    want = rk.temporal_conv_fused_plain(x, kern, bias, emb, res, stats)
    st_err = None
    if stats:
        (got, gst), (want, wst) = got, want
        st_err = stats_rel_err(gst, wst)
    ok, abs_err, rel = within_one_ulp(got, want)
    ok = ok and (st_err is None or st_err <= 1e-3)
    times = None
    if timed:
        times = dict(
            ms=time_ms(lambda: rk.temporal_conv_fused(x, kern, bias, emb, res, stats)),
            plain_ms=time_ms(lambda: rk.temporal_conv_fused_plain(x, kern, bias, emb, res,
                                                                  stats), 3, 1),
        )
        # yardstick: one matmul of the frame-stacked (B*F*S, 3C) x (3C, C) form
        xp = F.pad(x.reshape(b, f, s, c), (0, 0, 0, 0, 1, 1))
        stacked = torch.cat([xp[:, :f], xp[:, 1:f + 1], xp[:, 2:]], -1).reshape(-1, 3 * c)
        w2d = kern.bfloat16().reshape(3 * c, c)
        times["library_ms"] = time_ms(lambda: torch.matmul(stacked, w2d))
    x_numel = b * f * s * c
    flops = 2.0 * b * s * c * c * (3 * f - 2)  # the padded frame taps multiply zeros
    nbytes = (2 * x_numel * (2 + has_res) + 2 * 3 * c * c + 4 * c
              + (4 * b * c if has_emb else 0) + (8 * b * f * c if stats else 0))
    label = f"K2 {b}x{f}x{s}x{c} emb={int(has_emb)} res={int(has_res)} stats={int(stats)}"
    return ok, abs_err, rel, st_err, times, flops, nbytes, label


@contextlib.contextmanager
def recording(rk):
    """Yields {signature: calls} of K1 / K2 made inside the block. The shim
    only records and passes on; the wrappers still count their launches."""
    calls = {}
    k1, k2 = rk.fused_affine_conv3x3, rk.temporal_conv_fused

    def rec_k1(x, kernel, bias, a=None, b=None, silu=False):
        key = ("k1", tuple(x.shape), kernel.shape[-1], a is not None, bool(silu))
        calls[key] = calls.get(key, 0) + 1
        return k1(x, kernel, bias, a, b, silu)

    def rec_k2(x, kernel, bias, emb=None, residual=None, want_stats=False):
        key = ("k2", tuple(x.shape), emb is not None, residual is not None, bool(want_stats))
        calls[key] = calls.get(key, 0) + 1
        return k2(x, kernel, bias, emb, residual, want_stats)

    rk.fused_affine_conv3x3, rk.temporal_conv_fused = rec_k1, rec_k2
    try:
        yield calls
    finally:
        rk.fused_affine_conv3x3, rk.temporal_conv_fused = k1, k2


def check_kernels(rk, calls, dev, timed, tag):
    """Each recorded signature against the plain version. With `timed`, K2
    without statistics (which the path never asks for) is added, each shape
    is timed, and the per-kernel sums weight each shape by its calls."""
    keys = sorted(calls, key=str)
    if timed:
        no_stats = next(k for k in calls if k[0] == "k2" and not k[2] and not k[3])
        keys.append(("k2", no_stats[1], False, False, False))
    rows = []
    agg = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_s=0.0,
                      bytes_s=0.0, max_abs_err=0.0) for name in rk.KERNELS}
    with torch.no_grad():
        for idx, key in enumerate(keys):
            count = calls.get(key, 0)
            gen = torch.Generator(device=dev).manual_seed(SEED + idx)
            check = check_k1 if key[0] == "k1" else check_k2
            ok, abs_err, rel, st_err, times, flops, nbytes, label = check(rk, key, gen, dev,
                                                                          timed)
            ops_s, bytes_s = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
            bound_ms = max(ops_s, bytes_s) * 1e3
            rows.append(dict(shape=label, calls=count, ok=ok, max_abs_err=abs_err,
                             max_err_over_std=rel, stats_rel_err=st_err, bound_ms=bound_ms,
                             bound_by="operations" if ops_s >= bytes_s else "bytes",
                             **(times or {})))
            log(f"[{tag}] {label:44s} x{count:<5d} ok={ok} err/std={rel:.2e} "
                + (f"stats_rel={st_err:.1e} " if st_err is not None else "")
                + (f"ms={times['ms']:.3f} plain={times['plain_ms']:.3f} "
                   f"lib={times['library_ms']:.3f} " if timed else "")
                + f"bound={bound_ms:.3f}")
            if not ok:
                fail(f"{label} disagrees with its plain version")
            a = agg["fused_affine_conv3x3" if key[0] == "k1" else "temporal_conv_fused"]
            a["max_abs_err"] = max(a["max_abs_err"], abs_err)
            for k, v in dict(times or {}, bound_ms=bound_ms, ops_s=ops_s,
                             bytes_s=bytes_s).items():
                a[k] += count * v
            torch.cuda.empty_cache()
    return rows, agg


def check_forward(rk, unet, inputs, vcfg, dev):
    """Phase 4: launch counts, fused vs plain vs float32, times in turns."""
    from v2a_tpu_torch.models.video_unet import VideoUNet

    def fwd(net):
        with torch.no_grad():
            return net(*inputs)

    for k in rk.launches:
        rk.launches[k] = 0
    out_fused = fwd(unet)
    torch.cuda.synchronize()
    per_fwd = dict(rk.launches)
    log(f"[forward] launches per forward: {per_fwd} (expected {EXPECTED_PER_FORWARD})")
    if per_fwd != EXPECTED_PER_FORWARD:
        fail(f"launch counts {per_fwd} != {EXPECTED_PER_FORWARD}")
    kw = dict(model_channels=vcfg.model_channels, channel_mult=vcfg.channel_mult,
              num_res_blocks=vcfg.num_res_blocks,
              attention_resolutions=vcfg.attention_resolutions,
              num_head_channels=vcfg.num_head_channels, task_token_dim=vcfg.text_dim)
    plain16 = VideoUNet(dtype=torch.bfloat16, **kw).to(dev).eval()
    plain16.load_state_dict(unet.state_dict())
    ref32 = VideoUNet(dtype=torch.float32, **kw).to(dev).eval()
    ref32.load_state_dict(unet.state_dict())
    out_plain, out_ref = fwd(plain16), fwd(ref32)
    for o in (out_fused, out_plain, out_ref):
        if o.shape != inputs[0].shape[:-1] + (vcfg.channels,) or not bool(torch.isfinite(o).all()):
            fail("forward output has the wrong shape or non-finite values")
    std = float(out_ref.std())

    def err(o):
        d = (o - out_ref).abs()
        return float(d.max()) / std, float(d.mean()) / std

    e_fused, e_plain = err(out_fused), err(out_plain)
    d = (out_fused - out_plain).abs()
    e_pair = (float(d.max()) / std, float(d.mean()) / std)
    log(f"[forward] vs float32 plain reference (err/std, max mean): fused {e_fused[0]:.3e} "
        f"{e_fused[1]:.3e} | bf16 plain {e_plain[0]:.3e} {e_plain[1]:.3e}; "
        f"fused vs bf16 plain {e_pair[0]:.3e} {e_pair[1]:.3e}")
    # the fused routing rounds at other places than the plain bf16 path, but
    # in the same class: it may stray from float32 at most twice as far
    if e_fused[0] > 2 * e_plain[0] or e_fused[1] > 2 * e_plain[1]:
        fail("fused forward strays further from the float32 reference than the bf16 plain path")
    fwd_ms = {"fused": [], "plain_bf16": []}
    for label, net in (("fused", unet), ("plain_bf16", plain16), ("plain_bf16", plain16),
                       ("fused", unet)):
        fwd_ms[label].append(time_ms(lambda: fwd(net), 2, 1))
    log(f"[forward] B=8 F=7 128^2 ms (fused, plain, in turns): {fwd_ms}")
    return dict(forward_ms=fwd_ms,
                forward_err=dict(fused=e_fused, plain_bf16=e_plain, fused_vs_plain=e_pair))


def serve(rk, model, vcfg, dev):
    """Phase 5, the main path: goal video, then actions, per request; the
    launch counts are read from this run only. Returns the launches, the
    request times and the kernels' {signature: calls} on this path."""
    from v2a_tpu_torch.models.policy import DiffusionPolicy, PolicyConfig

    policy = DiffusionPolicy.create(PolicyConfig(dtype="bfloat16"), device=dev).init(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    h, w = vcfg.image_size
    frames = torch.rand(N_REQUESTS, h, w, 3, generator=gen, device=dev)
    for k in rk.launches:
        rk.launches[k] = 0
    with recording(rk) as calls:
        req = _requests(model, policy, frames, vcfg, gen)
    launches = dict(rk.launches)
    n_fwd = N_REQUESTS * vcfg.sampling_timesteps
    log(f"[serve] {N_REQUESTS} requests (reduced from the 8 release tasks to keep the run "
        f"short; width and step count unchanged): launches {launches} over {n_fwd} forwards")
    for name, k in (("fused_affine_conv3x3", "k1"), ("temporal_conv_fused", "k2")):
        want = n_fwd * EXPECTED_PER_FORWARD[name]
        made = sum(v for key, v in calls.items() if key[0] == k)
        if launches[name] != want or made != want:
            fail(f"{name}: {made} calls and {launches[name]} launches on the serving path, "
                 f"expected {want}")
    return launches, req, calls


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
    if not unet.fused:
        fail("the video U-Net did not resolve to the fused routing on cuda")
    log(f"[model] video U-Net {sum(p.numel() for p in unet.parameters()) / 1e6:.1f} M params, "
        "release width, bf16, fused routing")
    b, (h, w) = 8, vcfg.image_size
    gen = torch.Generator(device=dev).manual_seed(SEED)
    inputs = (
        torch.randn(b, vcfg.video_future_horizon, h, w, 2 * vcfg.channels, generator=gen,
                    device=dev),
        torch.randint(0, vcfg.timesteps, (b,), generator=gen, device=dev),
        model.encode_batch_text((TASKS * 4)[:b]),
    )

    # 3. kernels against their plain versions at the shapes one B=8 release
    # forward gives them, timed; 4. that forward
    with recording(rk) as calls, torch.no_grad():
        unet(*inputs)
    torch.cuda.synchronize()
    rows, agg = check_kernels(rk, calls, dev, timed=True, tag="kernels")
    forward = check_forward(rk, unet, inputs, vcfg, dev)
    torch.cuda.empty_cache()
    # 5. the main path, then the kernels at the shapes it gave them
    launches, req, serve_calls = serve(rk, model, vcfg, dev)
    serve_rows, serve_agg = check_kernels(rk, serve_calls, dev, timed=False, tag="serve-shapes")

    # 6. report
    kernels = [
        dict(name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
             launches=launches[name],
             max_abs_err=max(agg[name]["max_abs_err"], serve_agg[name]["max_abs_err"]),
             ms=agg[name]["ms"], plain_ms=agg[name]["plain_ms"],
             bound_ms=agg[name]["bound_ms"],
             bound_by="operations" if agg[name]["ops_s"] >= agg[name]["bytes_s"] else "bytes",
             library_ms=agg[name]["library_ms"])
        for name, meta in rk.KERNELS.items()
    ]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_shapes.json"), "w") as fh:
        json.dump(dict(card=smi, per_shape=rows, serve_shapes=serve_rows, requests_s=req,
                       kernels=kernels, **forward), fh, indent=1)
    log("[report] kernel ms / plain_ms / bound_ms / library_ms are sums over one "
        "B=8 release forward (per-shape time x calls per forward)")
    log(f"[report] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
