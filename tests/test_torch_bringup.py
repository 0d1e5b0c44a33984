"""The port's bring-up pipeline (`v2a_tpu_torch/scripts/bringup.py`) on the
CPU: the synthetic mode runs convert -> load -> tokenize -> parity ->
sample -> eval end to end with the JAX test's step set and checks
(`tests/test_bringup.py:27-39`); the port's converted file equals the JAX
converter's output on the same written `.pt` (through
`convert/from_jax.py`); the fail-fast paths fail loudly: a missing
checkpoint gives the JAX script's manifest (the JAX script run as a
subprocess with `--cpu`), and without `transformers` the assets step fails
with its `ImportError`."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("transformers")

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu_torch.convert.from_jax import video_tree  # noqa: E402
from v2a_tpu_torch.convert.torch_import import load_video_params  # noqa: E402
from v2a_tpu_torch.scripts import bringup  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ["assets", "convert", "load", "tokenizer", "parity", "sample", "eval"]


def _manifest(out):
    with open(os.path.join(out, "bringup_manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bringup"))
    rc = bringup.main(["--synthetic", "--device", "cpu", "--out-dir", out])
    return rc, out


def test_synthetic_bringup_end_to_end(synthetic_run):
    """Every step passes on the CPU, in the JAX script's order, with its
    checks: the real BPE tokenizer, forward parity within 2e-3, a uint8
    video of the config's shape, an eval episode with rollout frames."""
    rc, out = synthetic_run
    manifest = _manifest(out)
    assert rc == 0 and manifest["pass"]
    assert [s["step"] for s in manifest["steps"]] == STEPS
    steps = {s["step"]: s for s in manifest["steps"]}
    assert all(s["status"] == "PASS" for s in steps.values())
    assert steps["tokenizer"]["is_real"] and steps["load"]["tokenizer_real"]
    assert steps["parity"]["max_abs_err"] < 2e-3
    assert steps["eval"]["episode_frames"] > 1 and steps["eval"]["videos_predicted"] >= 1
    cfg = bringup.small_config()
    video = np.load(os.path.join(out, "bringup_video.npy"))
    assert video.dtype == np.uint8
    assert video.shape == (1, cfg.video_future_horizon, *cfg.image_size, 3)
    assert steps["convert"]["has_text"] and os.path.isdir(os.path.join(out, "tokenizer"))


def test_converted_file_equals_the_jax_converter(synthetic_run, tmp_path):
    """The JAX package's converter on the `.pt` and the CLIP weights the
    synthetic run wrote, its trees through `convert/from_jax.py::
    video_tree`: the port's converted file, key for key and bit for bit."""
    pytest.importorskip("jax")
    from v2a_tpu.convert import torch_import as jti
    from v2a_tpu.models.video_model import VideoModelConfig as JaxVideoModelConfig

    _, out = synthetic_run
    port = load_video_params(os.path.join(out, "torch-video-model.pt"))
    cfg = bringup.small_config()
    jcfg = JaxVideoModelConfig(
        image_size=cfg.image_size, sample_per_seq=cfg.sample_per_seq, timesteps=cfg.timesteps,
        sampling_timesteps=cfg.sampling_timesteps, text_dim=cfg.text_dim, fused=False,
        **bringup.SMALL)
    jax_params = jti.convert_video_checkpoint(
        os.path.join(out, "synthetic-model-180000.pt"), str(tmp_path / "jax.msgpack"),
        config=jcfg, clip_path=os.path.join(out, "synthetic-clip"))
    assert set(port) == set(jax_params) == {"unet", "text"}
    for part in port:
        want = video_tree(jax_params[part])
        assert port[part].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(port[part][k].numpy(), v.numpy(), err_msg=k)


def test_missing_checkpoint_fails_fast_like_jax(tmp_path):
    """`--pt <missing> --cpu`: one step, `assets`, FAIL naming the path, a
    non-zero exit, the JAX script's manifest entry for entry (its timing
    aside)."""
    missing = str(tmp_path / "nope.pt")
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert bringup.main(["--pt", missing, "--cpu", "--out-dir", port_out]) == 1
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "bringup.py"), "--pt",
                        missing, "--cpu", "--out-dir", jax_out],
                       env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0, r.stderr[-2000:]
    got, want = _manifest(port_out), _manifest(jax_out)
    for m in (got, want):
        assert not m["pass"] and len(m["steps"]) == 1
        m["steps"][0].pop("seconds")
    assert got == want
    assert got["steps"][0]["status"] == "FAIL" and "nope.pt" in got["steps"][0]["error"]


def test_assets_fail_without_transformers(monkeypatch, tmp_path):
    """Without `transformers` the synthetic assets step fails with its
    `ImportError` (no quiet fall back to the hash tokenizer), and nothing
    after it runs."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    out = str(tmp_path / "out")
    assert bringup.main(["--synthetic", "--device", "cpu", "--out-dir", out]) == 1
    steps = _manifest(out)["steps"]
    assert [s["step"] for s in steps] == ["assets"]
    # ModuleNotFoundError is the ImportError an absent module raises
    assert steps[0]["status"] == "FAIL"
    assert steps[0]["error"].startswith(("ImportError", "ModuleNotFoundError"))


def test_the_jax_script_is_the_port_scripts_counterpart():
    """The port keeps the JAX script's release schema and small config."""
    spec = importlib.util.spec_from_file_location(
        "jax_bringup", os.path.join(REPO, "scripts", "bringup.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    assert bringup.REAL == jax_script.REAL and bringup.SMALL == jax_script.SMALL
    assert (bringup.REAL_TEXT_DIM, bringup.SMALL_TEXT_DIM) == (
        jax_script.REAL_TEXT_DIM, jax_script.SMALL_TEXT_DIM)
