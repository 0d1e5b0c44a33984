"""The harness on the CPU: every cell resolves to its files by name, an
unknown name fails, a run without a card exits before timing, the result
line's keys, the names and units of `BENCHMARK.json`, and dummy cells added
from new files alone run end to end."""

import json
import os
import re
import subprocess
import sys

import pytest

from port_bench import run, spec

ROOT = spec.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    BENCH = json.load(_fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["kind"] in ("goal_video", "video_train")
    assert cell.limits and all(isinstance(v, float) for v in cell.limits.values())
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer and set(cell.readers) == {m.name for m in cell.per_layer}
    assert all(m.moves in names for m in cell.per_layer)


def test_unknown_workload_fails():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no_such_cell")
    assert run.main(["--workload", "no_such_cell", "--seed", "1", "--seconds", "1"]) == 2


def test_a_run_without_a_card_exits_before_timing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "lb_goal_video_b8",
                        "--seed", "2147483747", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_names_units_and_shape_of_the_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell_name", ["tiny_goal_video", "tiny_video_train", "tiny_products"])
@pytest.mark.parametrize("trace", [0, 1])
def test_dummy_cells_from_new_files_run(tiny_root, cell_name, trace):
    cell = spec.load_cell(cell_name, root=tiny_root)
    res = run.run_cell(cell, 2 ** 31 + 11, 3.0, bool(trace), "cpu", log=lambda *a: None)
    assert set(res) == RESULT_KEYS | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        if cell_name == "tiny_goal_video":  # the dummy reader, found by its name
            assert res["metrics"]["dummy_wall_ms.tiny"]["value"] > 0
        if cell_name == "tiny_products":  # the dummy kind's reader, of the untraced window
            assert res["metrics"]["dummy_products.tiny"]["value"] > 0
    else:
        assert set(res["metrics"]) == {m.name for m in cell.end_to_end}
    assert json.loads(json.dumps(res)) == res
