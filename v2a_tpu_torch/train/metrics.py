"""Metrics logging to JSON lines, and a wall-clock timer.

Copied from `v2a_tpu/train/metrics.py` without its optional TensorBoard and
wandb sinks: records go to an append-only `metrics.jsonl` under the workdir,
the per-task metric axes (`define_metric`) as header records.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def per_task_metric_names(task: str):
    """The reference's per-task wandb keys (`make_wandb_dict_per_tk`,
    `lb_online_trainer_v7.py:1314-1323`): (rollout counter, success-vs-
    rollouts counter)."""
    return (
        f"explo/{task}-cnt_vid_rollouts",
        f"explo/{task}-cnt_explore_suc_vsR",
    )


class MetricsLogger:
    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, "metrics.jsonl")
        self._file = open(self.path, "a", buffering=1)

    def define_metric(self, name: str, step_metric: Optional[str] = None):
        """A custom metric axis (`lb_online_trainer_v7.py:1326-1332`),
        recorded in the JSONL so offline plotting can honor it."""
        record = {"_define_metric": name}
        if step_metric is not None:
            record["step_metric"] = step_metric
        self._file.write(json.dumps(record) + "\n")

    def init_per_task_metrics(self, task_list):
        """Per task, `cnt_vid_rollouts` is itself an axis and
        `cnt_explore_suc_vsR` plots against it."""
        for tk in task_list:
            roll, suc = per_task_metric_names(tk)
            self.define_metric(roll)
            self.define_metric(suc, step_metric=roll)

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
