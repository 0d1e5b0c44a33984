"""`BENCHMARK.json` and the files that its names lead to.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

- a configuration: the `file` of its `configs` entry (`configs/<name>.json`);
- a traffic mix: `traffic/<traffic>.json`, parameters that the driver of
  its `kind` reads;
- a kind of traffic: `kinds/<kind>.py`, a driver class `Driver` (the
  interface in `cells.py`);
- a cell's limits on the numbers that decide `correct`: `limits/<cell>.json`;
- a per-layer metric: `metrics/<metric>.py`, a reader with
  `read(trace) -> float | None`.

A later change that brings a configuration, a mix, a kind, a cell or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = os.path.basename(HERE)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    moves: Optional[str] = None  # the end-to-end metric a per-layer one moves


@dataclasses.dataclass
class Cell:
    """One workload with what its names lead to."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    readers: Dict[str, Callable]
    driver: type


class SpecError(ValueError):
    pass


def _load_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise SpecError(f"missing file {path}")
    with open(path) as fh:
        return json.load(fh)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _load_module(root: str, folder: str, name: str, what: str):
    path = os.path.join(root, BENCH, folder, name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"{what} {name!r} has no file at {path}")
    spec = importlib.util.spec_from_file_location(f"{BENCH}_{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(root: str, name: str) -> Callable:
    """`read` of `metrics/<name>.py` under the benchmark's folder in `root`."""
    return _load_module(root, "metrics", name, "per-layer metric").read


def load_driver(root: str, kind: str) -> type:
    """`Driver` of `kinds/<kind>.py` under the benchmark's folder in `root`."""
    return _load_module(root, "kinds", kind, "traffic kind").Driver


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `<root>/BENCHMARK.json`; raises `SpecError` for an
    unknown name or a file that is missing."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names an unknown config {w['config']!r}")
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, BENCH, "traffic", w["traffic"] + ".json"))
    limits = _load_json(os.path.join(root, BENCH, "limits", name + ".json"))["limits"]

    def metrics(key):
        return [Metric(m["name"], m["unit"], m.get("moves"))
                for m in bench[key] if _applies(m, name)]

    per_layer = metrics("per_layer")
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic=traffic, limits=limits,
                end_to_end=metrics("end_to_end"), per_layer=per_layer,
                readers={m.name: load_reader(root, m.name) for m in per_layer},
                driver=load_driver(root, traffic["kind"]))
