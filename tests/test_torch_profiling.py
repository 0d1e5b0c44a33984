"""`v2a_tpu_torch/utils/profiling.py` against `v2a_tpu/utils/profiling.py`,
and its `rollup` (the port's one reader of `torch.profiler`) on a profile
of known events, on the CPU."""

import contextlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_video import _unet_inputs, random_params  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu.utils import profiling as jprof  # noqa: E402
from v2a_tpu_torch.convert.from_jax import video_tree  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402
from v2a_tpu_torch.utils import profiling as tprof  # noqa: E402

KW = dict(in_channels=6, model_channels=32, out_channels=3, num_res_blocks=1,
          attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
          task_token_dim=64)


def test_param_count_and_report_match_jax(capsys):
    """The converted net's parameters, as a module and as a state dict, count
    what JAX's `param_count` / `report_parameters` count of the same tree."""
    x, t, tok = _unet_inputs(16, seed=5)
    params = random_params(jvu.VideoUNet(**KW), x, t, tok, seed=5)
    state = video_tree(params, "")
    net = tvu.VideoUNet(**KW)
    net.load_state_dict(state, strict=True)
    want = jprof.param_count(params)
    assert tprof.param_count(net) == tprof.param_count(state) == want
    assert jprof.report_parameters(params, topk=3) == tprof.report_parameters(net, topk=3) == want
    out = capsys.readouterr().out
    assert out.count(f"{want:,} parameters") == 2
    with pytest.raises(TypeError):
        tprof.param_count([torch.zeros(3)])


def test_timer_matches_jax(monkeypatch):
    """The same clock readings give the same intervals, with and without a
    reset."""
    clock = iter([10.0, 10.5, 11.25, 11.5, 13.0, 20.0, 20.5, 21.25, 21.5, 23.0])
    monkeypatch.setattr("time.time", lambda: next(clock))
    seen = []
    for make in (jprof.Timer, tprof.Timer):
        timer = make()
        seen.append([timer(), timer(reset=False), timer(), timer()])
    assert seen[0] == seen[1] == [0.5, 0.75, 1.0, 1.5]


def test_trace_writes_a_trace_file(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert prof is not None and len(files) == 1
    with open(os.path.join(tmp_path, files[0])) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::mm" in names
    with tprof.trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")


def test_device_memory_stats_needs_a_card():
    """No statistics without a card (no zeros); with one, the JAX keys."""
    if torch.cuda.is_available():
        stats = tprof.device_memory_stats()["cuda:0"]
        assert 0 <= stats["bytes_in_use"] <= stats["peak_bytes_in_use"] <= stats["bytes_limit"]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.device_memory_stats()


def test_rollup_counts_overlapping_kernels_once():
    """Two kernels of two streams overlapping by 5 us, a copy after: busy is
    their union (17 us), the categories sum to the kernels' total (22 us),
    the hand kernel's row is its K-number and C entry."""
    ev = tprof.DeviceEvent
    events = [ev("k1_body", 0.0, 10.0, "fused_affine_conv3x3"),
              ev("sm90_gemm", 5.0, 12.0, "aten::mm"),
              ev("Memcpy DtoD (Device -> Device)", 20.0, 25.0, "aten::copy_")]
    res = tprof.rollup_events(events, per_run=1, wall_ms=0.034, out=None)
    assert res["busy_ms"] == pytest.approx(0.017) and res["summed_ms"] == pytest.approx(0.022)
    assert res["idle_share"] == pytest.approx(0.5)
    assert sum(c["ms"] for c in res["categories"]) == pytest.approx(res["summed_ms"])
    cats = {c["category"]: c["ms"] for c in res["categories"]}
    assert cats == pytest.approx({"K1 fused_affine_conv3x3 [v2a_affine_conv3x3]": 0.010,
                                  "cuBLAS GEMMs": 0.007, "copies and casts": 0.005})
    assert res["hand"] == {"K1": dict(wrapper="fused_affine_conv3x3",
                                      entry="v2a_affine_conv3x3", ms=pytest.approx(0.010),
                                      kernels=1)}
    assert [o["op"] for o in res["ops"]] == ["aten::mm", "aten::copy_"]
    assert tprof.busy_us(events[:2] + [ev("inner", 1.0, 2.0, "")]) == 12.0
    halves = tprof.rollup_events(events, per_run=2, wall_ms=0.034, out=None)
    assert halves["busy_ms"] == pytest.approx(0.0085)
    assert halves["wall_ms"] == pytest.approx(0.017)


def test_every_hand_kernel_maps_to_its_k_number():
    ks = [meta["k"] for meta in trk.KERNELS.values()]
    assert len(set(ks)) == len(ks) == 16
    for name, meta in trk.KERNELS.items():
        cat = tprof.category(tprof.DeviceEvent("any", 0.0, 1.0, name))
        assert cat == f"{meta['k']} {name} [{meta['entry']}]"
    for launcher, name, want in (
            ("aten::cudnn_convolution", "sm90_xmma_fprop", "cuDNN convolutions"),
            ("aten::_efficient_attention_forward", "fmha_cutlassF", "attention (SDPA)"),
            ("", "Memset (Device)", "copies and casts"),
            ("aten::mul", "vectorized_elementwise_kernel", "elementwise and reductions"),
            ("", "mystery", "the rest")):
        assert tprof.category(tprof.DeviceEvent(name, 0.0, 1.0, launcher)) == want


class _Raw:
    """A profiler event record with the accessors `device_events` reads."""

    def __init__(self, name, device, start, dur, corr=0, linked=0, tid=1):
        self._v = dict(name=name, device_type=device, start_ns=start, duration_ns=dur,
                       correlation_id=corr, linked_correlation_id=linked, start_thread_id=tid)

    def __getattr__(self, key):
        return lambda: self._v[key]


def test_device_events_link_kernels_to_their_launchers():
    """A kernel goes to the host op of its linked correlation id: a wrapper's
    op for a hand kernel, the innermost aten op else; runtime calls sharing
    an id are not ops; device spans named like a wrapper are not work."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = [_Raw("temporal_conv_fused", cpu, 0, 50, corr=7),
           _Raw("cudaLaunchKernel", cpu, 10, 5, corr=9),
           _Raw("aten::mm", cpu, 60, 20, corr=9),
           _Raw("temporal_conv_bf16", cuda, 100, 40, corr=9, linked=7),
           _Raw("reduce_tiles_kernel", cuda, 140, 5, corr=10, linked=7),
           _Raw("sm90_gemm", cuda, 150, 30, corr=11, linked=9),
           _Raw("temporal_conv_fused", cuda, 100, 45, linked=7),
           _Raw("unlinked", cuda, 200, 1)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(reversed(raw)))))
    got = tprof.device_events(prof)
    assert [(e.name, e.launcher) for e in got] == [
        ("temporal_conv_bf16", "temporal_conv_fused"),
        ("reduce_tiles_kernel", "temporal_conv_fused"),
        ("sm90_gemm", "aten::mm"), ("unlinked", "")]
    assert tprof.rollup(prof, out=None)["hand"]["K2"]["ms"] == pytest.approx(45e-6)  # ns
    host = tprof.device_events(prof, "cpu")
    assert [(e.name, e.start_us, e.end_us) for e in host] == [("aten::mm", 0.06, 0.08)]


def test_rollup_of_a_cpu_profile_and_the_wrapper_ops(monkeypatch):
    """A tiny forward traced on the CPU: its outermost host ops rolled up
    (busy within the window, categories summing to the total); no device
    events; and a wrapper's launch is a host op named by the wrapper (the
    card's device context stubbed)."""
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    net = tvu.VideoUNet(**KW).eval()
    x, t, tok = (torch.from_numpy(np.asarray(a)) for a in _unet_inputs(16, seed=6))
    with torch.no_grad(), tprof.trace(None) as prof:
        net(x, t, tok)
        with trk._launching("temporal_conv_fused", torch.device("meta")):
            pass
    res = tprof.rollup(prof, device="cpu", out=None)
    span = max(e.end_us for e in tprof.device_events(prof, "cpu")) - min(
        e.start_us for e in tprof.device_events(prof, "cpu"))
    assert res["n_events"] > 10 and 0 < res["busy_ms"] <= span / 1e3 + 1e-9
    assert sum(c["ms"] for c in res["categories"]) == pytest.approx(res["summed_ms"])
    assert tprof.rollup(prof, out=None)["n_events"] == 0
    names = {k.name() for k in prof.profiler.kineto_results.events()}
    assert "temporal_conv_fused" in names
