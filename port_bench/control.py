"""The readings that the limits on `correct` are set from, on the card.

    python3 port_bench/control.py --workload <name> --seeds 1,2,... [--control-seeds 1,2,3]

For each seed, in one process: the cell's set-up, its window cut to the
requests that a run compares (`check.requests` whole requests; a train
cell needs no window: its first steps are set-up), and the check (the
program's readings, the lower ones). For each control seed also the
control: the reference at float8 e4m3 put in the program's place, and in a
train cell the fault of half the batch, the mean taken over the rest (the
upper readings). One JSON line per seed. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed: int, control: bool, device) -> dict:
    """The program's numbers for one seed and, with `control`, the
    control's and the faults'."""
    from port_bench.trace import Tracer

    driver = cell.driver(cell, seed, device, Tracer(False, {}))
    driver.setup()
    if cell.traffic["kind"] == "goal_video":
        driver.window(float("inf"), requests=cell.traffic["check"]["requests"])
    driver.free_program()
    t0 = time.perf_counter()
    out = {"seed": seed, "program": driver.check()}
    out["check_s"] = time.perf_counter() - t0
    if getattr(driver, "notes", None):
        out["notes"] = driver.notes
    if control:
        out["fp8"] = driver.check("fp8")
        if cell.traffic["kind"] == "video_train":
            out["half_batch"] = driver.check(half_batch=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    from port_bench import run, spec

    run.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + sorted(controls)
    for seed in dict.fromkeys(seeds):
        t0 = time.perf_counter()
        res = readings(cell, seed, seed in controls, "cuda:0")
        res["s"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
