"""Runs one cell of `BENCHMARK.json` once and prints its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run makes its weights and inputs from the
seed on the card, warms up the cell's own shapes (set-up, timed from the
start of this process to the first timed request or step), measures for
`--seconds`, then holds what the window produced against the plain float32
reference (`reference/`). With `--trace 0` the metrics are the cell's
end-to-end metrics. With `--trace 1` the metrics are its per-layer ones,
each read by `metrics/<name>.py`: the same untraced window runs first (its
counts are what the host-clock metrics read), then a second window of half
its length under the profiler (what the device metrics read).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (`busy_s` and `window_s` when
traced), `breakdown` when traced, and last `checks`, each compared number
beside its limit; the same numbers are the last lines of standard error.
Exits 3 without a result where there is no CUDA device or fewer than the
cell asks for, 4 where JAX, flax or the JAX package is loaded once the
window has closed, 2 on an unknown workload.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "v2a_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: the port's own name begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment() -> None:
    """No JAX or TensorFlow through `transformers`. (The port builds its
    kernels into `v2a_tpu_torch/_build/` inside the checkout; it uses
    neither Triton nor `torch.utils.cpp_extension`.)"""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def smi() -> str:
    """The card's name, power limit, SM clock, power draw and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not available ({exc})"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float = T_START,
             log=print) -> dict:
    """One run of `cell` on `device`; the result object (with `checks`)."""
    import torch

    from port_bench import cells, roofline
    from port_bench import trace as tr

    device = torch.device(device)
    kernel_modules = {}
    if trace:
        from v2a_tpu_torch.ops import resblock_kernels as rk

        kernel_modules = {n: rk.wrapper_module(n) for n in roofline.SIGNATURES if n in rk.KERNELS}
    tracer = tr.Tracer(trace, kernel_modules)
    driver = cell.driver(cell, seed, device, tracer)
    driver.setup()
    cells.sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[port_bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s")
    if device.type == "cuda":
        log(f"[port_bench] card before the window: {smi()}")
    e2e = dict(driver.window(seconds), setup_s=setup_s)
    untraced, attempted = dict(driver.counts), driver.attempted
    log(f"[port_bench] counts: {json.dumps(untraced)}")
    if trace:
        with tracer.active(), tracer.window(device):
            driver.window(seconds / 2)
        attempted += driver.attempted
        log(f"[port_bench] counts, traced: {json.dumps(driver.counts)}")
    if device.type == "cuda":
        log(f"[port_bench] card after the window: {smi()}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if device.type == "cuda" else 0}
    units = {m.name: m.unit for m in cell.end_to_end + cell.per_layer}
    breakdown = None
    if trace:
        t_read = time.perf_counter()
        data = tracer.data(driver.counts, untraced)
        log(f"[port_bench] {len(data.events)} device intervals read in "
            f"{time.perf_counter() - t_read:.3f} s")
        values = {m.name: cell.readers[m.name](data) for m in cell.per_layer}
        dev.update(busy_s=data.busy_s(), window_s=data.window_s)
        breakdown = data.breakdown()
        for cat, s in sorted(data.by_category().items(), key=lambda kv: -kv[1]):
            log(f"[port_bench] device {s:12.6f} s  {cat}")
        for name, s in breakdown["device_ops"]:
            log(f"[port_bench] kernel {s:12.6f} s  {name[:120]}")
        for name, s in breakdown["idle_gaps"]:
            log(f"[port_bench] idle   {s:12.6f} s  {name[:120]}")
        del data
    else:
        values = {m.name: e2e.get(m.name) for m in cell.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None}
    log(f"[port_bench] memory peak {dev['memory_peak_bytes']} bytes")
    driver.free_program()
    t_check = time.perf_counter()
    numbers = driver.check()
    log(f"[port_bench] check {time.perf_counter() - t_check:.3f} s")
    if getattr(driver, "notes", None):
        log(f"[port_bench] check notes: {json.dumps(driver.notes)}")
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in cell.limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": 0,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    from port_bench import spec

    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as exc:
        print(f"[port_bench] {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[port_bench] {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"[port_bench] loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"[port_bench] check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
