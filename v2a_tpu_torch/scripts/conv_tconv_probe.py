"""Where K3's and K12's time goes, on the card.

    python -m v2a_tpu_torch.scripts.conv_tconv_probe [--ablate]

Times K3 (`fused_conv_tconv_padded`) and K12 (`fused_conv_tconv_stream`) in
bf16 at release-level shapes (F=7, emb and residual) against the same work
as K4a -> K4b, ms by CUDA events over chained calls, with each launch's tile
plan. `--ablate` also times copies of the shared mainloop
(`csrc/conv_tconv_hopper.cuh`) with one part cut out: the activation, the
conv products, the temporal epilogue or the whole temporal phase. The cut
copies compute wrong outputs by design; only their times mean anything.
Cutting the epilogue leaves the temporal products unused, so the compiler
drops them too: that cut times the epilogue and the products together.
They are built from copies of `csrc/` under `_build/variants/`.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Tuple

import torch

from v2a_tpu_torch.ops import _build
from v2a_tpu_torch.ops import resblock_kernels as rk

# (kernel, B, (H, W), input channel parts, D)
CASES = [("k3", 8, (128, 128), (128,), 128), ("k3", 8, (32, 32), (384, 384), 384),
         ("k12", 8, (64, 64), (256,), 256), ("k12", 1, (32, 32), (384,), 384)]

# variant -> [(text in a csrc/ file, its replacement)]
CUTS: Dict[str, List[Tuple[str, str]]] = {
    "no_activation": [("      if (g + 1 < nchunk) activate(", "      if (false) activate(")],
    "no_conv_products": [("      mma_taps(g % WSTAGES, j % STAGES, di);", "")],
    "no_epilogue": [("        store_out(g0 + j / mid);", "")],
    "no_temporal_phase": [("    m.tconv_frames(f - 1, 1, 3);", ""),
                          ("  m.tconv_frames(0, a.F, 0);", "")],
}


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _case_args(b, hw, cins, d, dev, f=7):
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def stream(c):
        return rk._place(randn(b, f, *hw, c), *rk.padded_hw(*hw)).bfloat16()

    parts = [(stream(c), randn(3, 3, c, d, scale=(9 * sum(cins)) ** -0.5),
              1 + randn(b * f, c, scale=0.1), randn(b * f, c, scale=0.1)) for c in cins]
    return (parts, randn(d, scale=0.1), randn(3, d, d, scale=(3 * d) ** -0.5),
            randn(d, scale=0.1), hw, randn(b, d).bfloat16(), stream(d))


def _runs(kernel, args):
    parts, kbias, tk, tbias, hw, emb, res = args
    b, f, hp, wp = parts[0][0].shape[:4]
    d = tk.shape[-1]
    flat = [(x.reshape(b * f, hp, wp, -1), k, a, bb) for x, k, a, bb in parts]
    if kernel == "k3":
        fused = lambda: rk.fused_conv_tconv_padded(parts, kbias, tk, tbias, hw, emb, res,
                                                   want_stats=True)
    else:
        fused = lambda: rk.fused_conv_tconv_stream(parts, kbias, tk, tbias, hw, emb, res,
                                                   want_stats=True)
    split = lambda: rk.temporal_conv_padded(
        rk.fused_affine_conv3x3_padded(flat, kbias, hw).reshape(b, f, hp, wp, d), tk, tbias,
        hw, emb, res, want_stats=True)
    return fused, split


def _variant_dir(csrc: str, build_dir: str, name: str, cuts) -> str:
    """A copy of `csrc` with `cuts` applied, under `build_dir`."""
    root = os.path.join(build_dir, "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(csrc, root)
    for old, new in cuts:
        hits = 0
        for fn in os.listdir(root):
            path = os.path.join(root, fn)
            with open(path) as fh:
                src = fh.read()
            if old in src:
                hits += 1
                with open(path, "w") as fh:
                    fh.write(src.replace(old, new))
        if not hits:
            raise RuntimeError(f"{name}: the mainloop no longer has {old.strip()!r}")
    return root


def _use_sources(csrc: str, build_dir: str) -> None:
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    _build._libs.clear()
    rk._lib.cache_clear()


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", action="store_true", help="also time the cut copies")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_tconv_probe: needs a CUDA card")
    dev = torch.device("cuda")
    rows = []
    cases = [(c, _case_args(*c[1:], dev)) for c in CASES]
    with torch.no_grad():
        for case, args in cases:
            kernel, b, hw, cins, d = case
            fused, split = _runs(kernel, args)
            plan = rk.conv_tconv_plan(b, 7, *hw, d, ring=kernel == "k12")
            row = dict(kernel=kernel, b=b, hw=hw, cins=cins, d=d, ms=time_ms(fused),
                       k4a_k4b_ms=time_ms(split), pixels=plan.pixels, cluster=plan.cluster,
                       grid=plan.grid)
            rows.append(row)
            print(row, flush=True)
        if opts.ablate:
            csrc, build_dir = _build.CSRC, _build.BUILD_DIR
            try:
                for name, cuts in CUTS.items():
                    root = _variant_dir(csrc, build_dir, name, cuts)
                    _use_sources(root, root + "_build")
                    for case, args in cases:
                        row = dict(variant=name, kernel=case[0], b=case[1], hw=case[2],
                                   ms=time_ms(_runs(case[0], args)[0]))
                        rows.append(row)
                        print(row, flush=True)
            finally:
                _use_sources(csrc, build_dir)
    return rows


if __name__ == "__main__":
    main()
