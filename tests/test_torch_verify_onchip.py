"""The port's on-card parity gate (`v2a_tpu_torch/scripts/verify_onchip.py`)
at tiny sizes on the CPU, where the kernel wrappers run their plain
versions.

The configuration names are the JAX script's minus `tapjoin_f` (read by
path: the JAX script imports JAX only inside its functions). The main gate
runs a tiny U-Net (mc 128, so the fused routings reach the kernels'
wrappers) through every routing and passes with the JAX report's keys; the
same comparison fails when one routing's chain output is corrupted (NaN
rows, or noise at the output's std). The optimiser gate passes on a small
`PolicyConfig`; the gradient gate passes on a tiny eligible U-Net with
either weight gradient and fails on a sign-flipped gradient leaf.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from v2a_tpu_torch.models.policy import PolicyConfig
from v2a_tpu_torch.ops import resblock_kernels as trk
from v2a_tpu_torch.scripts import verify_onchip as vo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# the keys of one routing's row in the JAX script's report (:398-404)
JAX_ROW_KEYS = ["fwd_max_err_over_std", "fwd_mean_err_over_std", "finite", "mean_delta",
                "std_ratio", "pix_mae", "pass"]
TINY = dict(vo.UNET, channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(2,),
            task_token_dim=64)
TINY_RUN = dict(batch=2, chain_batch=1, steps=4, frames=2, hw=24, unet_kw=TINY)
TINY_TRAIN_FUSED = dict(unet_kw=dict(vo.TRAIN_FUSED_UNET, task_token_dim=64, num_res_blocks=1),
                        shape=(1, 2, 16))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_verify_onchip", os.path.join(REPO, "scripts", "verify_onchip.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_configs_are_the_jax_configs_minus_tapjoin():
    """The port's routings carry the JAX script's names in its order, less
    `tapjoin_f` (a TPU-only form inside K3), at the JAX operating point."""
    jax_script = _jax_script()
    assert list(vo.CONFIGS) == [n for n in jax_script.CONFIGS if n != "tapjoin_f"]
    assert "tapjoin_f" in jax_script.CONFIGS and "tapjoin_f" in vo.__doc__
    assert (vo.BATCH, vo.FRAMES, vo.HW, vo.TOKENS) == (
        jax_script.BATCH, jax_script.FRAMES, jax_script.HW, jax_script.TOKENS)
    assert vo.CONFIGS["unfused"]["fused"] is False
    assert vo.CONFIGS["pallas_attn"]["routing"].attn_kernel
    assert not vo.CONFIGS["fused_nopad"]["routing"].padded_stream


@pytest.fixture(scope="module")
def tiny_outs():
    """Every routing of the tiny U-Net, with the kernel wrappers each part
    called: ({name: {"fwd", "video"}}, {(name, part): {wrapper: calls}})."""
    names = [n for n, e in trk.KERNELS.items() if e["replaces"].startswith("v2a_tpu/")]
    calls, current = {}, {}
    saved = {n: getattr(trk.wrapper_module(n), n) for n in names}

    def counted(name, fn):
        def wrapper(*a, **k):
            current[name] = current.get(name, 0) + 1
            return fn(*a, **k)
        return wrapper

    def around(name, part, fn):
        current.clear()
        out = fn()
        calls[(name, part)] = dict(current)
        return out

    for n, fn in saved.items():
        setattr(trk.wrapper_module(n), n, counted(n, fn))
    try:
        outs = vo.run_configs(CPU, around=around, **TINY_RUN)
    finally:
        for n, fn in saved.items():
            setattr(trk.wrapper_module(n), n, fn)
    return outs, calls


def test_parity_gate_passes_on_a_tiny_unet(tiny_outs):
    """Every routing passes with the JAX report's keys; the fused routings
    went through their kernels' wrappers, K9 only under `pallas_attn`, the
    padded stream's only under `default` and `pallas_attn`, in the forward
    and in every chain step; the plain path through none."""
    outs, calls = tiny_outs
    report, ok = vo.parity_report(outs)
    assert ok and list(report) == ["fused_nopad", "default", "pallas_attn"]
    for row in report.values():
        assert list(row) == JAX_ROW_KEYS and row["pass"] and row["finite"]
    assert outs["unfused"]["fwd"].shape == (2, 2, 24, 24, 3)
    assert outs["unfused"]["video"].shape == (1, 2, 24, 24, 3)
    assert calls[("unfused", "forward")] == calls[("unfused", "chain")] == {}
    for name in ("fused_nopad", "default", "pallas_attn"):
        fwd, chain = calls[(name, "forward")], calls[(name, "chain")]
        assert chain == {k: TINY_RUN["steps"] * v for k, v in fwd.items()}
        assert fwd.get("fused_affine_conv3x3") and fwd.get("temporal_conv_fused")
        assert bool(fwd.get("fused_conv_tconv_padded")) == (name != "fused_nopad")
        assert bool(fwd.get("fused_spatial_attention_padded")) == (name == "pallas_attn")
    assert vo.parity_gate(CPU, **TINY_RUN) == {"onchip_parity": report, "pass": True}


@pytest.mark.parametrize("corruption", ["nan_rows", "noise"])
def test_parity_gate_fails_on_a_corrupted_chain(tiny_outs, corruption):
    """One routing's sampled video corrupted (NaN rows, as an unmasked pad
    row would leave; or noise at the video's std) fails that routing and
    the gate, and only that routing."""
    outs = {n: dict(o) for n, o in tiny_outs[0].items()}
    video = outs["default"]["video"].copy()
    if corruption == "nan_rows":
        video[:, :, 5] = np.nan
    else:
        noise = np.random.RandomState(0).randn(*video.shape).astype(np.float32)
        video = video + noise * video.std()
    outs["default"]["video"] = video
    report, ok = vo.parity_report(outs)
    assert not ok and not report["default"]["pass"]
    assert report["fused_nopad"]["pass"] and report["pallas_attn"]["pass"]
    if corruption == "nan_rows":
        assert not report["default"]["finite"]
    else:
        assert report["default"]["std_ratio"] > 1.1


def test_train_gate_passes_on_a_small_policy():
    """Three clip + AdamW updates: `fused_clip_adamw` within 1e-6 of the
    torch.optim chain and 3e-6 of the host float64 version."""
    cfg = PolicyConfig(image_size=(32, 32), down_dims=(32, 64),
                       vision_stage_features=(16, 32, 64, 128))
    out = vo.train_gate(CPU, cfg, batch=4)
    report = out["train_step_optimizer_gate"]
    assert out["pass"] and report["pass"]
    assert report["fused_vs_torch_chain_max_abs"] < 1e-6
    assert report["fused_vs_host_f64_max_abs"] < 3e-6
    assert report["grad_global_norm"] > 0 and report["params"] > 10 ** 6


@pytest.mark.parametrize("wgrad_kernel", [False, True], ids=["library_wgrad", "k6_wgrad"])
def test_train_fused_gate_passes_and_catches_a_flipped_leaf(monkeypatch, wgrad_kernel):
    """The train_fused loss and gradients pass the JAX gates against the
    plain path, through K1 forward and dgrad [and K6]; one gradient leaf
    with its sign flipped fails, naming that leaf."""
    calls = {}
    for name in ("fused_affine_conv3x3", "wgrad_conv3x3"):
        fn = getattr(trk, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(trk, name, counted)
    state = vo.train_fused_state(CPU, TINY_TRAIN_FUSED["unet_kw"])
    plain = vo.train_fused_grads(CPU, state, False, **TINY_TRAIN_FUSED)
    assert calls == {}
    fused = vo.train_fused_grads(CPU, state, True, wgrad_kernel, **TINY_TRAIN_FUSED)
    assert calls["fused_affine_conv3x3"] > 0
    assert bool(calls.get("wgrad_conv3x3")) == wgrad_kernel
    report, ok = vo.grad_report(*plain, *fused)
    assert ok and report["worst_grad_cosine"] > 0.999 and report["worst_leaf"] in fused[1]
    leaf = "down_res_0.in_conv.spatial_conv.kernel"
    flipped = dict(fused[1], **{leaf: -fused[1][leaf]})
    report, ok = vo.grad_report(*plain, fused[0], flipped)
    assert not ok and report["worst_leaf"] == leaf and report["worst_grad_cosine"] < 0


@pytest.mark.parametrize("wgrad_kernel", [False, True], ids=["library_wgrad", "k6_wgrad"])
def test_train_fused_launch_counts(monkeypatch, wgrad_kernel):
    """The gradient gate's U-Net (mc 128, mult (1, 2), B=2, F=3, 32^2, bf16)
    through train_fused, forward and backward traced on the meta device: 25
    convs (12 ResBlocks x 2 + the upsample conv), each one K1 forward and
    one K1 dgrad [and one K6], the counts `chip_smoke.py` holds the card
    to."""
    calls = {}
    for name in ("fused_affine_conv3x3", "wgrad_conv3x3"):
        fn = getattr(trk, name + "_plain")

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(trk, name, counted)
    b, f, hw = vo.TRAIN_FUSED_SHAPE
    with torch.device("meta"):
        net = vo.VideoUNet(dtype=torch.bfloat16, train_fused=True, wgrad_kernel=wgrad_kernel,
                           **vo.TRAIN_FUSED_UNET)
        y = net(torch.randn(b, f, hw, hw, 6), torch.zeros(b, dtype=torch.long),
                torch.randn(b, vo.TOKENS, 512))
        assert calls == {"fused_affine_conv3x3": 25}
        y.float().square().mean().backward()
    assert calls == ({"fused_affine_conv3x3": 50, "wgrad_conv3x3": 25} if wgrad_kernel
                     else {"fused_affine_conv3x3": 50})
