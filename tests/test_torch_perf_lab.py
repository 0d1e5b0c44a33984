"""The port's perf lab (`v2a_tpu_torch/scripts/perf_lab.py`) and the lab's
switches of `ConvRouting`, on the CPU.

- The name table against the JAX lab: the JAX `scripts/perf_lab.py` `main`,
  imported by path, runs each forward and trace name with its forward,
  `build` and traces patched to record the `video_unet.PERF_*` flags,
  `attn` and `fused` (no forward runs); the port's row of the same name
  holds the same routing.
- Each of the six new switches against its JAX flag: a small U-Net, one
  seed, the JAX tree through the converter (strict load, so the ablated
  trees convert), the JAX module with the flag set (Pallas in interpret
  mode) against the port with the field set, the same launches per kernel.
- Every lab name runs on the CPU at small sizes, `trace_vtrain`'s remat
  policies included; the names with no counterpart raise `ValueError`.
"""

import dataclasses
import importlib.util
import math
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_padded import PACKAGE_KERNELS, _counting, _jax_defaults, _jax_module  # noqa: E402
from test_torch_video import UNET_TOL, _load, _unet_inputs, japply, random_params  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402
from v2a_tpu_torch.scripts import perf_lab  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX module flag behind each `ConvRouting` field
FLAG_OF = {
    "padded_stream": "PERF_PADDED_STREAM", "downconv": "PERF_DOWNCONV",
    "attn_kernel": "PERF_PALLAS_ATTN", "spatial2_min_ch": "PERF_PALLAS_SPATIAL2_MIN_CH",
    "spatial2_max_s": "PERF_PALLAS_SPATIAL2_MAX_S", "pallas_spatial": "PERF_PALLAS_SPATIAL",
    "tconv_hw": "PERF_TCONV_HW", "stream_kernel": "PERF_STREAM_KERNEL",
    "mega_kernel": "PERF_MEGA_KERNEL", "upconv": "PERF_UPCONV", "entry_pad": "PERF_ENTRY_PAD",
    "ablate_temporal": "PERF_ABLATE_TEMPORAL", "ablate_gn": "PERF_ABLATE_GN",
    "spatial_im2col": "PERF_SPATIAL_IM2COL", "fused_min_ch": "PERF_FUSED_MIN_CH",
    "skip1x1_dot": "PERF_SKIP1X1_DOT", "tconv_conv2d_min_s": "PERF_TCONV_XLA2D_MIN_S",
    "train_dgrad_kernel": "PERF_TRAIN_DGRAD_PALLAS", "wgrad_min_s": "PERF_TRAIN_WGRAD_MIN_S",
    "train_tconv_dot": "PERF_TRAIN_TCONV_DOT",
}
# the lab's pattern names, one or two instances each
PATTERN_NAMES = ["fused_min256", "fused_spatial2_512", "fused_sp2dot_512", "fused_sp2all",
                 "fused_sp2all512", "fused_xla2d", "fused_xla2d4096"]
FORWARD_NAMES = list(perf_lab.FORWARDS) + PATTERN_NAMES
TRACE_NAMES = ["trace", "trace_base", "trace_sp2", "trace_default", "trace_chain",
               "trace_chain:60"]


@pytest.fixture(scope="module")
def jax_lab():
    spec = importlib.util.spec_from_file_location("jax_perf_lab",
                                                  os.path.join(ROOT, "scripts", "perf_lab.py"))
    lab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lab)
    return lab


def _routing_of_flags(flags):
    """The `ConvRouting` the JAX flags give (use_pallas_gn: the lab never
    sets it)."""
    return tvu.ConvRouting(**{field: flags[flag] for field, flag in FLAG_OF.items()})


def _record(monkeypatch, jax_lab, name):
    """(flags, attn, fused) of each U-Net the JAX lab's main builds or
    traces for `name`, with the module flags at the JAX defaults first."""
    _jax_defaults(monkeypatch)
    for flag, value in (("PERF_SKIP1X1_DOT", True), ("PERF_PALLAS_SPATIAL", False),
                        ("PERF_TCONV_HW", False), ("PERF_FUSED_MIN_CH", 0),
                        ("PERF_SPATIAL_IM2COL", False), ("PERF_TCONV_XLA2D_MIN_S", 0),
                        ("PERF_ABLATE_TEMPORAL", False), ("PERF_ABLATE_GN", False)):
        monkeypatch.setattr(jvu, flag, value)
    seen = []

    def flags():
        return {flag: getattr(jvu, flag) for flag in FLAG_OF.values()}

    def build(attn=(8, 16), fused=False):
        seen.append((flags(), tuple(attn), fused))
        return None

    monkeypatch.setattr(jax_lab, "build", build)
    monkeypatch.setattr(jax_lab, "time_forward", lambda unet, label, iters=20: 0.0)
    monkeypatch.setattr(jax_lab, "trace_forward",
                        lambda fused=True, topk=30: seen.append((flags(), (8, 16), fused)))
    monkeypatch.setattr(jax_lab, "trace_chain",
                        lambda steps=20, topk=30: seen.append((flags(), (8, 16), True)))
    monkeypatch.setattr(sys, "argv", ["perf_lab.py", name])
    jax_lab.main()
    return seen


@pytest.mark.parametrize("name", FORWARD_NAMES + TRACE_NAMES)
def test_name_table_matches_the_jax_lab(monkeypatch, jax_lab, name):
    """The port's routing, attention and `fused` of each name are the JAX
    lab's flags for it, state for state."""
    seen = _record(monkeypatch, jax_lab, name)
    assert len(seen) == 1
    flags, attn, fused = seen[0]
    want = perf_lab.Forward(_routing_of_flags(flags), attn, fused)
    if name.startswith("trace_chain"):
        got = perf_lab.FORWARDS["fused_default"]
    elif name in perf_lab.TRACE_FORWARDS:
        got = perf_lab.TRACE_FORWARDS[name]
    else:
        got = perf_lab.forward_of(name)
    assert got == want


def test_routing_defaults_are_the_jax_flags():
    """Every `ConvRouting` field's default is its JAX flag's default."""
    defaults = tvu.ConvRouting()
    for field, flag in FLAG_OF.items():
        assert getattr(defaults, field) == getattr(jvu, flag), field
    assert {f.name for f in dataclasses.fields(tvu.ConvRouting)} == set(FLAG_OF) | {
        "use_pallas_gn"}


# -- the six switches against their JAX flags --------------------------------------

R = tvu.ConvRouting
# one level (its up path's skip concat still changes channels), or two
PLAIN = dict(model_channels=32, hw=8, channel_mult=(1,), attention_resolutions=(1,))
ONE = dict(model_channels=128, hw=8, channel_mult=(1,), attention_resolutions=(1,))
WIDE = dict(model_channels=128, hw=8, channel_mult=(1, 2), attention_resolutions=(2,))
# (JAX flags, fused, port routing, U-Net size)
SWITCHES = {
    "ablate_temporal": (dict(PERF_ABLATE_TEMPORAL=True), False, R(ablate_temporal=True), PLAIN),
    "ablate_gn": (dict(PERF_ABLATE_GN=True), False, R(ablate_gn=True), PLAIN),
    "spatial_im2col": (dict(PERF_SPATIAL_IM2COL=True), False, R(spatial_im2col=True), PLAIN),
    # the fused forward without the K1 gate (the lab's `fused`): the 1x1 skip
    # convs, single and of the split up path, through the library conv
    "skip1x1_dot_off_fused": (dict(PERF_PALLAS_SPATIAL2_MIN_CH=0, PERF_SKIP1X1_DOT=False,
                                   PERF_PALLAS_SPATIAL2_MAX_S=512), True,
                              R(spatial2_min_ch=0, spatial2_max_s=512, skip1x1_dot=False), ONE),
    # K2 only at the 256-channel level
    "fused_min_ch": (dict(PERF_PALLAS_SPATIAL2_MIN_CH=0, PERF_FUSED_MIN_CH=256), True,
                     R(spatial2_min_ch=0, fused_min_ch=256), WIDE),
    # the temporal convs at 8^2 (64 >= 32) as one (3, 1) conv, K2 at 4^2
    "tconv_conv2d_min_s": (dict(PERF_PALLAS_SPATIAL2_MIN_CH=0, PERF_TCONV_XLA2D_MIN_S=32),
                           True, R(spatial2_min_ch=0, tconv_conv2d_min_s=32), WIDE),
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_lab_switch_matches_jax(monkeypatch, switch):
    """A small U-Net (one or two levels, 1 res block, attention at the
    last, 8x8, F=2) with the switch: the port against the JAX module with its flag set,
    the same launches per kernel; float32 within 1e-5 of the output's
    largest magnitude on the plain path, the fused-vs-plain tolerance of
    `test_switch_unet_matches_jax` through the kernels' plain versions."""
    _jax_defaults(monkeypatch)
    flags, fused, routing, size = SWITCHES[switch]
    for flag, value in flags.items():
        monkeypatch.setattr(jvu, flag, value)
    kw = dict(in_channels=6, model_channels=size["model_channels"], out_channels=3,
              num_res_blocks=1, attention_resolutions=size["attention_resolutions"],
              channel_mult=size["channel_mult"], num_head_channels=32, task_token_dim=64)
    x, t, tok = _unet_inputs(size["hw"], seed=71)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=71)
    jcalls = _counting(monkeypatch, _jax_module, PACKAGE_KERNELS)
    want = np.asarray(japply(jvu.VideoUNet(fused=fused, **kw), params, x, t, tok))
    tcalls = _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS)
    got = _load(tvu.VideoUNet(fused=fused, routing=routing, **kw), params)(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(tok)).numpy()
    assert jcalls == tcalls
    assert bool(jcalls) == fused
    if fused:
        np.testing.assert_allclose(got, want, **UNET_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_ablations_change_the_tree_and_refuse_the_fused_forwards():
    """The ablations drop the temporal convs and the norms' parameters, as
    in JAX; the fused and train_fused forwards have no ablated form."""
    kw = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(2,), task_token_dim=64)
    full = set(tvu.VideoUNet(**kw).state_dict())
    no_t = set(tvu.VideoUNet(routing=R(ablate_temporal=True), **kw).state_dict())
    no_gn = set(tvu.VideoUNet(routing=R(ablate_gn=True), **kw).state_dict())
    assert full - no_t and all("temporal_conv" in k for k in full - no_t)
    assert full - no_gn and all(k.endswith(("norm.scale", "norm.bias")) for k in full - no_gn)
    for routing in (R(ablate_temporal=True), R(ablate_gn=True)):
        for arg in ("fused", "train_fused"):
            with pytest.raises(ValueError, match="perf-lab"):
                tvu.VideoUNet(routing=routing, **{arg: True}, **kw)


def test_build_unet_takes_one_routing():
    """`VideoPredModel.build_unet` builds the config's `ConvRouting` unless
    handed one; the config's fields are the routing's."""
    from v2a_tpu_torch.models import video_model as tvm

    cfg = tvm.VideoModelConfig(image_size=(8, 8), model_channels=32, channel_mult=(1,),
                               attention_resolutions=(), text_dim=64, padded_stream=False,
                               downconv=True, mega_kernel=False)
    model = tvm.VideoPredModel(cfg, device="cpu")
    assert model.unet.routing == cfg.conv_routing() == R(padded_stream=False, downconv=True,
                                                         mega_kernel=False)
    assert model.build_unet(routing=R(ablate_gn=True)).routing == R(ablate_gn=True)


# the launches per release forward (B=8, F=7, 128^2, bf16) of the lab's fused
# names that `chip_smoke.py` phase 13 holds the card to beyond the routings
# `tests/test_torch_padded.py` traces (`fused_default` and `fused_upconv` are
# its `padded`; the ablations are plain and launch nothing)
PADDED = {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30, "fused_conv_tconv_padded": 16,
          "fused_affine_conv3x3_padded": 14, "temporal_conv_padded": 17,
          "fused_upconv3x3_padded": 3}
LAB_COUNTS = {"fused": {"temporal_conv_fused": 63},
              "fused_attn": dict(PADDED, fused_spatial_attention_padded=11),
              "fused_default": PADDED}


@pytest.mark.parametrize("name", list(LAB_COUNTS))
def test_lab_release_forward_launch_counts(monkeypatch, name):
    """The release U-Net with each fused name's row (routing, attention),
    traced on the meta device through the kernels' plain versions: its
    launches."""
    calls = _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    fwd = perf_lab.FORWARDS[name]
    with torch.device("meta"), torch.no_grad():
        tvu.VideoUNet(attention_resolutions=fwd.attn, dtype=torch.bfloat16, fused=fwd.fused,
                      routing=fwd.routing)(torch.randn(1, 7, 128, 128, 6),
                                           torch.zeros(1, dtype=torch.long),
                                           torch.randn(1, 16, 512))
    assert calls == LAB_COUNTS[name]


# -- every lab name on the CPU ------------------------------------------------------

# four 32-channel levels down to 1x1 at 8x8, attention at ds 8
TINY = perf_lab.LabSizes(mc=32, dtype=torch.float32, batch=1, frames=2, hw=8, tokens=4,
                         mult=(1, 1, 1, 1), res_blocks=1, policy_batch=2,
                         policy=(("image_size", (32, 32)), ("down_dims", (32, 64)),
                                 ("vision_stage_features", (16, 32, 64, 128)),
                                 ("horizon", 8), ("n_action_steps", 4)),
                         vtrain=(("image_size", (8, 8)), ("model_channels", 32),
                                 ("channel_mult", (1, 1)), ("num_res_blocks", 1),
                                 ("attention_resolutions", (2,)), ("text_dim", 64),
                                 ("sample_per_seq", 3)))
BENCH_NAMES = list(perf_lab.BENCHES) + ["megabench:L1"]
RUN_NAMES = (FORWARD_NAMES + ["trace", "trace_base", "trace_sp2", "trace_default",
                              "trace_chain:5", "trace_train", "trace_train_chain",
                              "trace_vtrain:1:off", "trace_vtrain:1:tfused"] + BENCH_NAMES)


def test_every_name_runs_on_the_cpu():
    """Each name at tiny sizes (chain 2, iters 1): rows with finite ms, the
    forwards' outputs finite; then the default (the five ablations) with
    its share lines."""
    lines = []
    rows = perf_lab.main(RUN_NAMES, device="cpu", sizes=TINY, chain=2, iters=1,
                         out=lines.append)
    seen = {r.get("name", r["bench"]) for r in rows}
    assert {n for n in FORWARD_NAMES} <= seen
    assert {"trace_chain", "trace_train", "trace_train_chain", "trace_vtrain:1:off",
            "trace_vtrain:1:tfused"} <= seen
    assert {b for b in perf_lab.BENCHES} <= {r["bench"] for r in rows}
    assert all(math.isfinite(r["ms"]) and r["ms"] >= 0 for r in rows)
    assert all(r["finite"] for r in rows if r["bench"] == "forward")
    for r in rows:
        if "busy_ms" in r:  # a trace: the host's top-level ops on the CPU
            assert 0 < r["busy_ms"] <= r["ms"] * 1.001 + 1e-3
            assert abs(sum(c["ms"] for c in r["categories"]) - r["summed_ms"]) < 1e-6
    assert all("cpu (host clock)" in line for line in lines if " ms " in line and "[" in line)
    defaults = perf_lab.main([], device="cpu", sizes=TINY, iters=1, out=lines.append)
    assert [r["name"] for r in defaults] == list(perf_lab.ABLATIONS)
    assert sum("share ~=" in line for line in lines) == 4 + len(FORWARD_NAMES) - 1


@pytest.mark.parametrize("name,match", [
    ("fused_tbudget_512", "VMEM"), ("fused_join_wide", "tap-join"),
    ("trace_vtrain:4:all", "not off, tfused"), ("no_such_name", "unknown"),
    ("megabench:L7", "level")])
def test_names_without_a_counterpart_raise_before_anything_runs(name, match):
    """An unknown name or `trace_vtrain` policy, and the TPU-only names,
    raise before any name of the call runs."""
    lines = []
    with pytest.raises(ValueError, match=match):
        perf_lab.main(["base", name], device="cpu", sizes=TINY, out=lines.append)
    assert not lines


@pytest.mark.parametrize("name", ["trace_vtrain:4:blocks", "trace_vtrain:8:levels",
                                  "trace_vtrain:4:mxu", "trace_vtrain:4:tfused-blocks"])
def test_vtrain_remat_policies_run(name):
    """`trace_vtrain`'s remat policies (the JAX lab's `parse_policy`: a
    policy alone on the plain path, after `tfused-` with train_fused) run
    one traced step at tiny sizes with the trainer's `use_checkpoint`."""
    lines = []
    rows = perf_lab.main([name], device="cpu", sizes=TINY, chain=1, out=lines.append)
    assert [r["bench"] for r in rows] == [name]
    assert math.isfinite(rows[0]["ms"]) and rows[0]["ms"] > 0
    remat = name.rsplit(":", 1)[1].split("-")[-1]
    assert any(f"remat {remat}" in line for line in lines), lines[:2]
