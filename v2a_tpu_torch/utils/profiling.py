"""Tracing, profiling and reporting: the counterpart of
`v2a_tpu/utils/profiling.py`, function for function, on `torch.profiler`
and the CUDA caching allocator.

- `Timer`, `param_count` / `report_parameters`, `print_color`: the JAX
  module's call shapes (`Timer` is `train/metrics.py`'s, one class).
- `trace(logdir, enabled)`: `torch.profiler` over the CPU and, where there
  is a card, CUDA activities; writes a Chrome trace under `logdir` and
  yields the profile.
- `device_memory_stats()`: per-device allocator statistics under the JAX
  runtime's keys; raises on a machine with no CUDA device.
- `rollup(prof, per_run, topk)`: the one reader of `torch.profiler` in the
  port, the counterpart of the JAX perf lab's `_trace_rollup`
  (`scripts/perf_lab.py:903-1012`): device time per kernel, the busy share
  (the union of the kernels' intervals against the host's wall), the time
  per category, and the host ops by the device time of the kernels they
  launch.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional

import torch
from torch import nn

from v2a_tpu_torch.ops import resblock_kernels as rk
from v2a_tpu_torch.train.metrics import Timer  # noqa: F401 (`luo_utils.py:37-46`)


@contextlib.contextmanager
def trace(logdir: Optional[str], enabled: bool = True):
    """Record `torch.profiler` over the block (CPU ops, and CUDA kernels
    where there is a card) and, with a `logdir`, write its Chrome trace to
    `logdir/trace_<pid>_<ns>.json` (`v2a_tpu/utils/profiling.py:43`).
    Yields the profile, or None when not `enabled`."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir,
                                              f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-device statistics of the CUDA caching allocator under the JAX
    runtime's keys (`v2a_tpu/utils/profiling.py:57`): bytes_in_use,
    peak_bytes_in_use, bytes_reserved, peak_bytes_reserved, num_allocs
    (allocations so far) and bytes_limit (the card's memory). Raises where
    there is no CUDA device: there are no statistics to give."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_stats: no CUDA device is available")
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = dict(
            bytes_in_use=int(s.get("allocated_bytes.all.current", 0)),
            peak_bytes_in_use=int(s.get("allocated_bytes.all.peak", 0)),
            bytes_reserved=int(s.get("reserved_bytes.all.current", 0)),
            peak_bytes_reserved=int(s.get("reserved_bytes.all.peak", 0)),
            num_allocs=int(s.get("allocation.all.allocated", 0)),
            bytes_limit=int(torch.cuda.get_device_properties(i).total_memory),
        )
    return out


def _named_tensors(tree: Any):
    """(name, tensor) of a module's parameters or of a state dict."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, Mapping):
        return [(k, v) for k, v in tree.items() if isinstance(v, torch.Tensor)]
    raise TypeError(f"expected an nn.Module or a state dict, got {type(tree).__name__}")


def param_count(tree: Any) -> int:
    """Elements in a module's parameters or a state dict's tensors (`:76`)."""
    return sum(int(t.numel()) for _, t in _named_tensors(tree))


def report_parameters(tree: Any, topk: int = 10, name: str = "model") -> int:
    """Total and largest tensors (`:84`, `diffuser/utils/arrays.py:95-112`)."""
    named = _named_tensors(tree)
    total = sum(int(t.numel()) for _, t in named)
    print_color(f"[ utils ] {name}: {total:,} parameters", c="g")
    for key, t in sorted(named, key=lambda kv: -kv[1].numel())[:topk]:
        print(f"  {int(t.numel()):>12,}  {tuple(t.shape)}  {key}")
    return total


_COLORS = {"r": 31, "g": 32, "y": 33, "b": 34, "m": 35, "c": 36}


def print_color(s: str, c: str = "y", **kwargs):
    """Colored stdout (`:104`, `eval_utils.py:201-217`)."""
    code = _COLORS.get(c, 33)
    print(f"\033[{code}m{s}\033[0m", **kwargs)


# -- the rollup ---------------------------------------------------------------------


class DeviceEvent(NamedTuple):
    """One interval of the device (a kernel, copy or set; on the CPU, a
    top-level host op) and what launched it: the wrapper's range for a hand
    kernel, else the innermost host op ('' when the profiler linked none)."""

    name: str
    start_us: float
    end_us: float
    launcher: str


def _is_api(name: str) -> bool:
    """A CUDA runtime or driver call (`cudaLaunchKernel`, `cuLaunchKernelEx`)."""
    return name.startswith("cu") and not name.startswith("cudnn")


def device_events(prof, device: str = "cuda") -> List[DeviceEvent]:
    """The intervals of `prof` on `device`, from the profiler's own event
    records (`prof.profiler.kineto_results`: no tree of host events is
    built). "cuda": every kernel, copy and set on the card, each with the
    host op the profiler links it to (its linked correlation id). "cpu":
    the outermost `aten::` ops of each host thread, each its own launcher,
    for a profile of a run on the CPU."""
    raw = sorted(prof.profiler.kineto_results.events(), key=lambda k: k.start_ns())
    if device == "cpu":
        out, end = [], {}
        for k in raw:
            if not str(k.device_type()).endswith("CPU") or not k.name().startswith("aten::"):
                continue
            t0, tid = k.start_ns(), k.start_thread_id()
            if t0 >= end.get(tid, -1):  # not inside an earlier op of its thread
                end[tid] = t0 + k.duration_ns()
                out.append(DeviceEvent(k.name(), t0 / 1e3, end[tid] / 1e3, k.name()))
        return out
    ops = {k.correlation_id(): k.name() for k in raw
           if str(k.device_type()).endswith("CPU") and not _is_api(k.name())}
    return [DeviceEvent(k.name(), k.start_ns() / 1e3, (k.start_ns() + k.duration_ns()) / 1e3,
                        ops.get(k.linked_correlation_id(), ""))
            for k in raw if not str(k.device_type()).endswith("CPU")
            # the device-side spans of host ranges are not work of the card
            and k.name() not in rk.KERNELS]


def busy_us(events: Iterable[DeviceEvent]) -> float:
    """The union of the events' intervals: overlapping work (two streams)
    counted once."""
    total, end = 0.0, None
    for ev in sorted(events, key=lambda e: e.start_us):
        if end is None or ev.start_us > end:
            total += ev.end_us - ev.start_us
            end = ev.end_us
        elif ev.end_us > end:
            total += ev.end_us - end
            end = ev.end_us
    return total


_COPIES = ("aten::copy_", "aten::_to_copy", "aten::to", "aten::clone", "aten::contiguous")
_GEMMS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
          "aten::linear", "aten::_addmm_activation", "aten::addbmm", "aten::dot", "aten::mv")


def _hand(launcher: str) -> Optional[str]:
    meta = rk.KERNELS.get(launcher)
    return None if meta is None else f"{meta['k']} {launcher} [{meta['entry']}]"


def category(ev: DeviceEvent) -> str:
    """The rollup's category of one interval (the JAX rollup's :967-1003,
    with the card's categories): a hand kernel by its K-number, wrapper and
    C entry; cuDNN convolutions; cuBLAS GEMMs; attention (SDPA); copies and
    casts; other elementwise and reduction kernels; the rest."""
    hand = _hand(ev.launcher)
    if hand:
        return hand
    name, op = ev.name.lower(), ev.launcher
    if "scaled_dot_product" in op or "attention" in op or "fmha" in name or "flash" in name:
        return "attention (SDPA)"
    if "conv" in op or "cudnn" in name or "convolve" in name or "fprop" in name:
        return "cuDNN convolutions"
    if op in _GEMMS or "gemm" in name or "cublas" in name or "cutlass" in name:
        return "cuBLAS GEMMs"
    if op in _COPIES or name.startswith("memcpy") or name.startswith("memset"):
        return "copies and casts"
    if op.startswith("aten::") or "elementwise" in name or "reduce" in name:
        return "elementwise and reductions"
    return "the rest"


def rollup_events(events: List[DeviceEvent], per_run: int = 1, topk: int = 30,
                  wall_ms: Optional[float] = None, out: Optional[Callable] = print,
                  label: str = "device") -> dict:
    """The rollup of `events` (see `rollup`), ms per run."""
    div = 1e3 * per_run
    summed = sum(e.end_us - e.start_us for e in events)
    busy = busy_us(events)
    if wall_ms is None:
        wall_ms = (max(e.end_us for e in events) - min(e.start_us for e in events)) / 1e3 \
            if events else 0.0
    wall = wall_ms / per_run
    per_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    per_cat: Dict[str, float] = defaultdict(float)
    per_op: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        d = e.end_us - e.start_us
        per_kernel[e.name][0] += d
        per_kernel[e.name][1] += 1
        per_cat[category(e)] += d
        if e.launcher.startswith("aten::"):
            per_op[e.launcher][0] += d
            per_op[e.launcher][1] += 1
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    hand = {}
    for e in events:
        meta = rk.KERNELS.get(e.launcher)
        if meta is not None:
            row = hand.setdefault(meta["k"], dict(wrapper=e.launcher, entry=meta["entry"],
                                                  ms=0.0, kernels=0))
            row["ms"] += (e.end_us - e.start_us) / div
            row["kernels"] += 1
    res = dict(
        per_run=per_run, n_events=len(events), wall_ms=wall, busy_ms=busy / div,
        summed_ms=summed / div, idle_share=(1.0 - busy / div / wall) if wall > 0 else None,
        kernels=[dict(name=n, ms=v[0] / div, calls=v[1] / per_run) for n, v in ranked[:topk]],
        categories=[dict(category=c, ms=v / div)
                    for c, v in sorted(per_cat.items(), key=lambda kv: -kv[1])],
        hand=hand,
        ops=[dict(op=o, ms=v[0] / div, calls=v[1] / per_run)
             for o, v in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:topk]],
    )
    if out is not None:
        idle = "n/a" if res["idle_share"] is None else f"{res['idle_share']:.3f}"
        out(f"trace: {len(per_kernel)} distinct {label} kernels, busy {res['busy_ms']:.3f} ms "
            f"(union; summed {res['summed_ms']:.3f}) of {wall:.3f} ms host wall per run, "
            f"idle share {idle}")
        for k in res["kernels"]:
            out(f"  {k['ms']:9.3f} ms  {k['calls']:7.1f}x  {k['name'][:110]}")
        out(f"-- category rollup ({label} ms per run) --")
        for c in res["categories"]:
            out(f"  {c['ms']:9.3f}  {c['category']}")
        out(f"-- host ops by the {label} time of the kernels they launch (ms per run) --")
        for o in res["ops"]:
            out(f"  {o['ms']:9.3f} ms  {o['calls']:7.1f}x  {o['op']}")
    return res


def rollup(prof, per_run: int = 1, topk: int = 30, wall_ms: Optional[float] = None,
           device: str = "cuda", out: Optional[Callable] = print) -> dict:
    """The JAX lab's `_trace_rollup` (`scripts/perf_lab.py:903-1012`) on a
    `torch.profiler` profile, every number in ms per run (`per_run` runs
    traced): the `topk` device kernels by time, grouped by name; the busy
    ms, the union of the kernel intervals (two streams' overlapping kernels
    counted once; `summed_ms` beside it), against the host's wall ms of the
    traced window (`wall_ms`, the caller's clock around it; else the span
    of the events) and `idle_share` = 1 - busy / wall; the categories
    (`category`), which sum to the kernels' total; `hand`, per K-number,
    the device time of the kernels launched inside each wrapper's range
    (`resblock_kernels._launching`); and the top host ops by the device
    time of the kernels they launch. `device="cpu"` reads a profile of a
    run on the CPU, its top-level host ops in place of kernels."""
    return rollup_events(device_events(prof, device), per_run, topk, wall_ms, out,
                         "device" if device == "cuda" else "host (CPU)")
