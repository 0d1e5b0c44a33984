"""Metrics logging to JSON lines, and a wall-clock timer.

Copied from `v2a_tpu/train/metrics.py` without its optional TensorBoard and
wandb sinks: records go to an append-only `metrics.jsonl` under the workdir.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, "metrics.jsonl")
        self._file = open(self.path, "a", buffering=1)

    def log(self, metrics: Dict[str, float], step: int):
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        self._file.write(json.dumps(record) + "\n")

    def close(self):
        self._file.close()


class Timer:
    """Wall-clock delta timer (`diffuser/utils/luo_utils.py:37-46`)."""

    def __init__(self):
        self._start = time.time()

    def __call__(self, reset: bool = True) -> float:
        now = time.time()
        diff = now - self._start
        if reset:
            self._start = now
        return diff
