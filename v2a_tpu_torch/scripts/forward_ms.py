"""Milliseconds of one B=8 release-width video U-Net forward, on the card.

    python -m v2a_tpu_torch.scripts.forward_ms [--routing unpadded] [--reps 10]

Builds `VideoUNet` at its release widths (the defaults, as `VideoModelConfig`
gives them) in bf16 with one of the fused routings of `chip_smoke.py`,
weights drawn from `--seed`, and B=8, F=7, 128^2 inputs from the same seed
(a random (8, 77, 512) text encoding in place of the text encoder's). It
prints one JSON line: the routing, its launches per forward, and the mean
ms of a forward by CUDA events over `--reps` forwards after two warm ones,
with the card's name and power limit.

To hold two checkouts against each other on one card, run this file of one
checkout with the other's package first on the path, in turns:

    PYTHONPATH=<checkout> python <this checkout>/v2a_tpu_torch/scripts/forward_ms.py
"""

import argparse
import json
import subprocess
import sys

import torch

# the VideoUNet arguments of chip_smoke.py's fused routings that this times
ROUTINGS = {
    "padded": dict(fused=True),
    "unpadded": dict(fused=True, padded_stream=False),
    "spatial_k10_k11": dict(fused=True, spatial2_min_ch=0, pallas_spatial=True, tconv_hw=True),
    "plain_k7": dict(fused=False, use_pallas_gn=True),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--routing", default="unpadded", choices=sorted(ROUTINGS))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("forward_ms needs a CUDA device")
    from v2a_tpu_torch.models.init import init_params
    from v2a_tpu_torch.models.video_unet import VideoUNet
    from v2a_tpu_torch.ops import resblock_kernels as rk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    net = VideoUNet(dtype=torch.bfloat16, **ROUTINGS[opts.routing]).to(dev).eval()
    init_params(net, gen)
    b = 8
    inputs = (torch.randn(b, 7, 128, 128, 6, generator=gen, device=dev),
              torch.randint(0, 100, (b,), generator=gen, device=dev),
              torch.randn(b, 77, 512, generator=gen, device=dev))
    with torch.no_grad():
        for k in rk.launches:
            rk.launches[k] = 0
        out = net(*inputs)
        torch.cuda.synchronize()
        launches = {k: v for k, v in rk.launches.items() if v}
        if not bool(torch.isfinite(out).all()):
            sys.exit("the forward gave non-finite values")
        net(*inputs)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(opts.reps):
            net(*inputs)
        end.record()
        torch.cuda.synchronize()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    row = dict(routing=opts.routing, ms=start.elapsed_time(end) / opts.reps, reps=opts.reps,
               launches=launches, card=card)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
