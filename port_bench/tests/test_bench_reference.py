"""The reference and the comparison that decides `correct`, on the CPU at a
tiny size: the reference takes the port's state dict; the comparison passes
on the port's path and fails on a perturbed weight, on the U-Net's output
rounded to float8, on the control (the reference at float8 in the
program's place) and on each fault a cell can have; nothing the benchmark
runs imports JAX, flax or the JAX package, and the reference nothing of
the port."""

import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench import cells, run, spec

ROOT = spec.ROOT
SEED = 2 ** 31 + 3


def _run(tiny_root, name):
    cell = spec.load_cell(name, root=tiny_root)
    return run.run_cell(cell, SEED, 3.0, False, "cpu", log=lambda *a: None)


def _failed(res):
    return [k for k, c in res["checks"].items()
            if c["value"] is None or not c["value"] <= c["limit"]]


def test_reference_takes_the_ports_state_dict(tiny_root):
    cell = spec.load_cell("tiny_goal_video", root=tiny_root)
    vm = cells.build_model(cell.config["model"], 1, "cpu")
    ours = {k: v.shape for k, v in vm.nets.state_dict().items()}
    assert ours == dict(cells.weight_shapes(cell.config["model"]))


def test_comparison_passes_on_the_port_and_the_control_fails(tiny_root):
    for name in ("tiny_goal_video", "tiny_video_train"):
        cell = spec.load_cell(name, root=tiny_root)
        d = cell.driver(cell, SEED, "cpu", run_tracer())
        d.setup()
        if cell.traffic["kind"] == "goal_video":
            d.window(float("inf"), requests=2)
        d.free_program()
        got = d.check()
        assert all(got[k] <= lim for k, lim in cell.limits.items()), got
        ctrl = d.check("fp8")
        assert any(ctrl[k] > lim for k, lim in cell.limits.items() if k in ctrl), ctrl


def run_tracer():
    from port_bench.trace import Tracer

    return Tracer(False, {})


def test_perturbed_weight_fails(tiny_root, monkeypatch):
    build = cells.build_model

    def perturbed(*a, **k):
        vm = build(*a, **k)
        with torch.no_grad():
            vm.nets.unet.out_conv.spatial_conv.bias.add_(0.5)
        return vm

    monkeypatch.setattr(cells, "build_model", perturbed)
    assert "unet_rel_err" in _failed(_run(tiny_root, "tiny_goal_video"))


def test_output_rounded_below_bf16_fails(tiny_root, monkeypatch):
    from v2a_tpu_torch.models import video_unet

    forward = video_unet.VideoUNet.forward

    def rounded(self, *a, **k):
        out = forward(self, *a, **k)
        s = 448.0 / out.abs().amax()
        return (out * s).to(torch.float8_e4m3fn).float() / s

    monkeypatch.setattr(video_unet.VideoUNet, "forward", rounded)
    assert "unet_rel_err" in _failed(_run(tiny_root, "tiny_goal_video"))


def _serve_faults():
    from v2a_tpu_torch.models import video_model, video_unet
    from v2a_tpu_torch.ops import gaussian_diffusion

    step = gaussian_diffusion.GaussianDiffusion.sample_step
    forward = video_unet.VideoUNet.forward
    result_u8 = video_model.VideoSampleStream.result_u8

    def unchanged(self, model_fn, img, *a, **k):
        step(self, model_fn, img, *a, **k)
        return img

    def half_batch(self, x, t, task_embed=None, **k):
        h = x.shape[0] // 2
        out = forward(self, x[:h], t[:h], task_embed[:h], **k)
        return torch.cat([out, out[:x.shape[0] - h]])

    def altered(self):
        video = result_u8(self).clone()
        video.view(-1)[0] ^= 1
        return video

    return {"step_unchanged": (gaussian_diffusion.GaussianDiffusion, "sample_step", unchanged),
            "half_batch": (video_unet.VideoUNet, "forward", half_batch),
            "answer_altered": (video_model.VideoSampleStream, "result_u8", altered)}


def _train_faults():
    from v2a_tpu_torch.train import video_trainer

    adam = torch.optim.Adam

    class AdamEps(adam):
        """Adam with eps 1e-4 in place of 1e-8."""

        def __init__(self, params, **kw):
            super().__init__(params, **dict(kw, eps=1e-4))

    class AdamNoBiasCorrection(adam):
        """Adam with its bias corrections left out (as far as eps allows)."""

        def step(self, closure=None):
            self.n = getattr(self, "n", 0) + 1
            lrs = [g["lr"] for g in self.param_groups]
            for g in self.param_groups:
                b1, b2 = g["betas"]
                g["lr"] *= (1 - b1 ** self.n) / (1 - b2 ** self.n) ** 0.5
            try:
                return super().step(closure)
            finally:
                for g, lr in zip(self.param_groups, lrs):
                    g["lr"] = lr

    trainer = video_trainer.VideoModelTrainer
    loss_and_grads = trainer.loss_and_grads

    def unchanged(self):
        self.state.step += 1

    def half_batch(self, video, x_cond_n, task_embed, t, weights, noise=None):
        h = video.shape[0] // 2
        return loss_and_grads(self, video[:h], x_cond_n[:h], task_embed[:h], t[:h], weights[:h])

    return {"state_unchanged": (trainer, "apply_gradients", unchanged),
            "half_batch": (trainer, "loss_and_grads", half_batch),
            "adam_eps": (torch.optim, "Adam", AdamEps),
            "adam_no_bias_correction": (torch.optim, "Adam", AdamNoBiasCorrection)}


@pytest.mark.parametrize("cell_name,fault", [("tiny_goal_video", f) for f in
                                             ("step_unchanged", "half_batch", "answer_altered")]
                         + [("tiny_video_train", f) for f in ("state_unchanged", "half_batch",
                                                              "adam_eps",
                                                              "adam_no_bias_correction")])
def test_each_fault_comes_out_not_correct(tiny_root, monkeypatch, cell_name, fault):
    faults = _serve_faults() if cell_name == "tiny_goal_video" else _train_faults()
    owner, attr, fn = faults[fault]
    monkeypatch.setattr(owner, attr, fn)
    res = _run(tiny_root, cell_name)
    assert res["correct"] is False, res["checks"]
    assert all(c["value"] is not None for c in res["checks"].values()), res["checks"]


_CHECK = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("what", ["harness", "reference"])
def test_import_check(what):
    if what == "harness":
        imports = ("import port_bench.run, port_bench.cells, port_bench.trace, "
                   "port_bench.control\n"
                   "from port_bench import cells, spec\n"
                   "cells.model_config(spec.load_cell('lb_goal_video_b8').config['model'])\n"
                   "spec.load_cell('lb_video_train_b4')\n"
                   "import v2a_tpu_torch.train.video_trainer, v2a_tpu_torch.ops.resblock_kernels")
        banned = set(run.FORBIDDEN)
    else:
        imports = "import port_bench.reference.nets, port_bench.reference.diffusion"
        banned = set(run.FORBIDDEN) | {"v2a_tpu_torch"}
    env = dict(os.environ, USE_FLAX="0", USE_JAX="0", USE_TF="0")
    p = subprocess.run([sys.executable, "-c", _CHECK.format(root=ROOT, imports=imports)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & banned, loaded & banned
    if what == "harness":
        assert "v2a_tpu_torch" in loaded


def test_tiny_goal_video_on_the_card_passes_and_its_control_fails(tiny_root, card):
    """The control at a size a test run holds, on the card: the fused
    routing against the reference; the float8 reference fails."""
    cell = spec.load_cell("tiny_goal_video", root=tiny_root)
    d = cell.driver(cell, SEED, card, run_tracer())
    d.setup()
    d.window(float("inf"), requests=2)
    d.free_program()
    got, ctrl = d.check(), d.check("fp8")
    assert all(got[k] <= lim for k, lim in cell.limits.items()), got
    assert any(ctrl[k] > lim for k, lim in cell.limits.items() if k in ctrl), ctrl


test_tiny_goal_video_on_the_card_passes_and_its_control_fails = pytest.mark.gpu(
    test_tiny_goal_video_on_the_card_passes_and_its_control_fails)
