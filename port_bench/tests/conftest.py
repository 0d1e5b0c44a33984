"""Fixtures of the benchmark's CPU tests: a checkout copy of the benchmark's
data files with dummy cells added from new files alone (a tiny release
model under both kinds of traffic, a new kind of traffic with its own
end-to-end metric, their limits and more per-layer metrics), and the card
fixture of the tests marked `gpu`."""

import json
import os
import shutil
import sys

import pytest
import torch

# several test processes share the cores: a 3-s window of the tiny served
# cell has to finish a request even so
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = dict(image_size=[16, 16], model_channels=32, channel_mult=[1, 2],
                  num_res_blocks=1, attention_resolutions=[2], text_dim=64, timesteps=4,
                  sampling_timesteps=4)
# CPU readings of the tiny cells (bf16 plain path, 4 seeds): text 1.1-1.5%,
# U-Net 1.6-1.8% (its output rounded to float8 e4m3: 3.1-3.2%; the float8
# reference: 10-15% and 17-19%); train (4 seeds) loss 0.04-0.11% (float8
# 0.42%), first gradient 1.6-4.1% (float8 14%), change 2.0-5.6% (the
# worst leaf a 64-wide norm bias)
TINY_LIMITS = {
    "tiny_goal_video": {"text_rel_err": 0.03, "unet_rel_err": 0.024, "xT_maxdiff": 0.0,
                        "sampler_maxdiff": 0.0, "video_u8_maxdiff": 0.0},
    "tiny_video_train": {"loss_gap": 0.002, "grad_norm_gap": 0.06, "update_norm_gap": 0.08,
                         "ema_norm_gap": 0.08},
    "tiny_products": {"max_err": 1e-9},
}
DUMMY_READER = '''"""A dummy per-layer metric of the tests: the window's host wall, ms."""


def read(trace):
    return 1e3 * trace.window_s
'''
DUMMY_PRODUCTS_READER = '''"""A dummy per-layer metric of the tests: products in the untraced window."""


def read(trace):
    return float(trace.untraced["products"])
'''
DUMMY_KIND = '''"""A dummy kind of traffic of the tests: products of a seeded float64
matrix with itself, checked against numpy's."""

import time

import numpy as np
import torch


class Driver:
    def __init__(self, cell, seed, device, tracer):
        self.seed, self.device = seed, torch.device(device)
        self.n, self.outputs = cell.traffic["size"], []

    def setup(self):
        self.a = np.random.default_rng(self.seed).standard_normal((self.n, self.n))
        self.x = torch.as_tensor(self.a, device=self.device)

    def window(self, seconds):
        t0, k = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            out = (self.x @ self.x).cpu()
            if k < 16:
                self.outputs.append(out)
            k += 1
        window_s = time.perf_counter() - t0
        self.counts, self.attempted = dict(products=k, window_s=window_s), k
        return {"dummy_products_per_s": k / window_s}

    def free_program(self):
        del self.x

    def check(self):
        want = self.a @ self.a
        return {"max_err": max(float(np.abs(o.numpy() - want).max()) for o in self.outputs)}
'''


def make_root(dest: str) -> str:
    """`dest` as a checkout: `BENCHMARK.json` and the benchmark's data files
    copied, then the dummy cells `tiny_goal_video`, `tiny_video_train` and
    `tiny_products` (a kind of its own, `kinds/tiny_products.py`), the
    metric `dummy_products_per_s` and the per-layer metrics
    `dummy_wall_ms.tiny` and `dummy_products.tiny` added as new files and
    entries."""
    bench = os.path.join(ROOT, "port_bench")
    for d in ("configs", "traffic", "limits", "metrics", "kinds"):
        shutil.copytree(os.path.join(bench, d), os.path.join(dest, "port_bench", d))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    with open(os.path.join(bench, "configs", "libero_release.json")) as fh:
        lib = json.load(fh)

    def write(rel, obj):
        with open(os.path.join(dest, "port_bench", rel), "w") as fh:
            json.dump(obj, fh) if not isinstance(obj, str) else fh.write(obj)

    write("configs/tiny.json", dict(lib, name="tiny", model=dict(lib["model"], **TINY_MODEL)))
    for kind, extra in (("goal_video", dict(batch=2, pool=3, reference_rows=2)),
                        ("video_train", dict(batch=2, pool=8, reference_rows=1))):
        with open(os.path.join(bench, "traffic", kind + ".json")) as fh:
            write(f"traffic/tiny_{kind}.json", dict(json.load(fh), **extra))
        write(f"limits/tiny_{kind}.json", {"limits": TINY_LIMITS["tiny_" + kind]})
        b["workloads"].append({"name": "tiny_" + kind, "config": "tiny",
                               "traffic": "tiny_" + kind, "chips": 1, "why": "tests"})
    write("kinds/tiny_products.py", DUMMY_KIND)
    write("traffic/tiny_products.json", {"kind": "tiny_products", "size": 8})
    write("limits/tiny_products.json", {"limits": TINY_LIMITS["tiny_products"]})
    b["workloads"].append({"name": "tiny_products", "config": "tiny", "traffic": "tiny_products",
                           "chips": 1, "why": "tests"})
    write("metrics/dummy_wall_ms.tiny.py", DUMMY_READER)
    write("metrics/dummy_products.tiny.py", DUMMY_PRODUCTS_READER)
    b["configs"].append({"name": "tiny", "source": "tests", "reduced": [], "why": "tests",
                         "file": "port_bench/configs/tiny.json"})
    for e in b["end_to_end"] + b["per_layer"]:
        if "workloads" in e:
            serve = any(w.startswith("lb_goal") for w in e["workloads"])
            e["workloads"].append("tiny_goal_video" if serve else "tiny_video_train")
    b["per_layer"].append({"name": "dummy_wall_ms.tiny", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "tests",
                           "moves": "goal_frames_per_s", "workloads": ["tiny_goal_video"]})
    b["end_to_end"].append({"name": "dummy_products_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock", "workloads": ["tiny_products"]})
    b["per_layer"].append({"name": "dummy_products.tiny", "unit": "1", "better": "higher",
                           "source": "host_clock", "layer": "tests",
                           "moves": "dummy_products_per_s", "workloads": ["tiny_products"]})
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(b, fh)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
