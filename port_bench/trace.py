"""The traced run: spans that the benchmark places around its calls into the
program, `torch.profiler` over the window (CPU and CUDA activities), the
launches of the hand kernels with their signatures, and what the per-layer
readers read from them.

The reading of the profile is a copy of the port's
`utils/profiling.py::device_events`, `busy_us` and `category` (the rollup's
arithmetic), with the host launch time of each device interval added, so
that a device interval belongs to the span in which its launch was made.
"""

from __future__ import annotations

import bisect
import contextlib
import inspect
import time
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

from port_bench import roofline

SPAN_PREFIX = "port_bench."


class DeviceEvent(NamedTuple):
    """One interval of the device and the host op that launched it (the
    kernel wrapper's range for a hand kernel), with the launch's host time."""

    name: str
    start_us: float
    end_us: float
    launcher: str
    launch_us: float


def busy_us(events: Iterable[DeviceEvent]) -> float:
    """The union of the events' intervals."""
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


def category(ev: DeviceEvent) -> str:
    """The rollup's category of one interval: a hand kernel, cuDNN
    convolutions, cuBLAS GEMMs, attention, copies and casts, elementwise and
    reductions, the rest."""
    if ev.launcher in roofline.SIGNATURES:
        return "hand kernels"
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


def _is_api(name: str) -> bool:
    return name.startswith("cu") and not name.startswith("cudnn")


class TraceData:
    """What the per-layer readers read: the device intervals of the traced
    window, the benchmark's spans by name, the hand-kernel launches as
    (tag, signature), the traced window's host wall and the cell's counts
    in it, and the counts of the run's untraced window (`untraced`, its
    host wall under `window_s`), which host-clock metrics read."""

    def __init__(self, events: List[DeviceEvent], spans: Dict[str, List[Tuple[float, float]]],
                 calls: List[Tuple[str, tuple]], window_s: float, counts: Dict[str, float],
                 untraced: Dict[str, float]):
        self.events = events
        self.spans = spans
        self.calls = calls
        self.window_s = window_s
        self.counts = counts
        self.untraced = untraced
        self._by_launch = sorted(events, key=lambda e: e.launch_us)
        self._launch_us = [e.launch_us for e in self._by_launch]

    def busy_s(self, events: Optional[Iterable[DeviceEvent]] = None) -> float:
        return busy_us(self.events if events is None else events) / 1e6

    def launched_in(self, span: str) -> List[List[DeviceEvent]]:
        """Per span of this name, the device intervals launched inside it."""
        out = []
        for a, b in self.spans.get(SPAN_PREFIX + span, []):
            i = bisect.bisect_left(self._launch_us, a)
            j = bisect.bisect_right(self._launch_us, b)
            out.append(self._by_launch[i:j])
        return out

    def hand_events(self) -> List[DeviceEvent]:
        return [e for e in self.events if e.launcher in roofline.SIGNATURES]

    def by_category(self) -> Dict[str, float]:
        """Summed device seconds per `category`."""
        out: Dict[str, float] = defaultdict(float)
        for e in self.events:
            out[category(e)] += (e.end_us - e.start_us) / 1e6
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the longest idle gaps
        summed by what the host was doing (the innermost benchmark span
        around the gap, else the op that ends it)."""
        per_op: Dict[str, float] = defaultdict(float)
        for e in self.events:
            per_op[e.name] += (e.end_us - e.start_us) / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        spans = sorted((a, b, n[len(SPAN_PREFIX):]) for n, v in self.spans.items() for a, b in v)
        starts = [a for a, _, _ in spans]
        end = None
        for e in sorted(self.events, key=lambda e: e.start_us):
            if end is not None and e.start_us > end:
                mid = 0.5 * (end + e.start_us)
                i = bisect.bisect_right(starts, mid) - 1
                label = spans[i][2] if i >= 0 and spans[i][1] >= mid else \
                    f"before {e.launcher or e.name[:60]}"
                gaps[label] += (e.start_us - end) / 1e6
            end = e.end_us if end is None else max(end, e.end_us)

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(per_op), "idle_gaps": ranked(gaps)}


def read_profile(prof) -> Tuple[List[DeviceEvent], Dict[str, List[Tuple[float, float]]]]:
    """Device intervals and benchmark spans of a `torch.profiler` profile,
    from the profiler's own event records, each read once."""
    cpu = torch.autograd.DeviceType.CPU
    ops, spans, cpu_names, device = {}, defaultdict(list), set(), []
    for k in prof.profiler.kineto_results.events():
        name = k.name()
        if k.device_type() != cpu:
            device.append((name, k.start_ns(), k.duration_ns(), k.linked_correlation_id()))
            continue
        cpu_names.add(name)
        if name.startswith(SPAN_PREFIX):
            spans[name].append((k.start_ns() / 1e3, (k.start_ns() + k.duration_ns()) / 1e3))
        elif not _is_api(name):
            ops[k.correlation_id()] = (name, k.start_ns() / 1e3)
    events = []
    for name, start, dur, link in device:
        if name in cpu_names:  # the device-side mirrors of host ranges
            continue
        launcher, launch_us = ops.get(link, ("", start / 1e3))
        events.append(DeviceEvent(name, start / 1e3, (start + dur) / 1e3, launcher, launch_us))
    return events, {n: sorted(v) for n, v in spans.items()}


class Tracer:
    """Spans and the profiler of one run; inert unless `enabled` and inside
    `active()`, so that an untraced window of a traced run runs as in an
    untraced run.

    `span(name)` marks a host range that the profiler records; `window()`
    opens the profiler and records the signature of every hand-kernel
    launch inside it, by shims on the port's wrapper functions that only
    record and pass on."""

    def __init__(self, enabled: bool, kernel_modules: Dict[str, object]):
        self.enabled = enabled
        self.on = False
        self.kernel_modules = kernel_modules  # wrapper name -> module that holds it
        self.calls: List[Tuple[str, tuple]] = []
        self._prof = None
        self._t0 = self._t1 = 0.0

    @contextlib.contextmanager
    def active(self):
        """Spans and `window()` record inside this block (if `enabled`)."""
        self.on = self.enabled
        try:
            yield
        finally:
            self.on = False

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def synced_span(self, name: str, device: torch.device):
        """`span`, with the device synchronized at both of its ends when
        tracing, so that the span holds the device work of the call too."""
        if not self.on:
            yield
            return
        _sync(device)
        with self.span(name):
            yield
            _sync(device)

    @contextlib.contextmanager
    def window(self, device: torch.device):
        """The traced window: the profiler and the launch shims open, the
        host wall taken around it with the device synchronized at both
        ends."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with record_launches(self.kernel_modules, self.calls):
            _sync(device)
            with profile(activities=activities) as prof:
                self._t0 = time.perf_counter()
                yield
                _sync(device)
                self._t1 = time.perf_counter()
            self._prof = prof

    def data(self, counts: Dict[str, float], untraced: Dict[str, float]) -> TraceData:
        events, spans = read_profile(self._prof)
        return TraceData(events, spans, self.calls, self._t1 - self._t0, counts, untraced)


@contextlib.contextmanager
def record_launches(kernel_modules: Dict[str, object], calls: List[Tuple[str, tuple]]):
    """Appends (tag, signature) of every call of the port's kernel wrappers
    inside the block to `calls`, by shims that only record and pass on
    (`kernel_modules`: wrapper name -> the module that holds it)."""
    originals = {name: getattr(mod, name) for name, mod in kernel_modules.items()}

    def shim(name):
        tag, signature = roofline.SIGNATURES[name]
        fn = originals[name]
        sig = inspect.signature(fn)

        def recorded(*a, **k):
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            calls.append((tag, signature(bound.arguments)))
            return fn(*a, **k)
        return recorded

    for name, mod in kernel_modules.items():
        setattr(mod, name, shim(name))
    try:
        yield calls
    finally:
        for name, mod in kernel_modules.items():
            setattr(mod, name, originals[name])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
