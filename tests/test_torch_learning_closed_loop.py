"""The port's closed-loop learning gate, tier (b): the port's counterpart of
`tests/test_learning_closed_loop.py::test_online_loop_learns_to_succeed`.

Runs the port's entry points end to end: `python -m
v2a_tpu_torch.scripts.train` on `v2a_tpu_torch/config/fake/fake_learn.py`
(the fake reach-and-grasp world, the scripted oracle goal-frame generator in
place of the video model; the whole online loop: live random phase,
video-guided exploration with the grasp heuristic, hindsight-relabeled
mixed-buffer training, checkpoints, 2,500 steps), then `python -m
v2a_tpu_torch.scripts.eval` on its workdir with the eval-time overrides,
twice: `--epoch 0` (the step-1 checkpoint, the near-random baseline) and
`--epoch latest` (the trained policy). The JAX gate's margins: trained >=
baseline + 0.25 and trained >= 0.4, over 12 episodes each (2 tasks x 6
held-out seeds).

`slow`: tier-1 does not run it. It runs on the card when one is present,
else on the CPU (`--device cpu`):

    python -m pytest -m slow tests/test_torch_learning_closed_loop.py
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "v2a_tpu_torch", "config", "fake", "fake_learn.py")


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.environ.get("PYTHONPATH", ""), REPO) if p))
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, (
        f"{args[:1]} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def _eval_suc_rate(workdir, epoch, eval_seed):
    out = _run(["v2a_tpu_torch.scripts.eval", "--workdir", workdir, "--epoch", str(epoch),
                "--n_seeds", "6", "--vis", "0", "--eval_seed", str(eval_seed)], timeout=2400)
    path = out.strip().splitlines()[-1].rsplit(" -> ", 1)[1]
    with open(path) as fh:
        return json.load(fh)["suc_rate"]


@pytest.mark.slow
def test_online_loop_learns_to_succeed(tmp_path):
    device = [] if torch.cuda.is_available() else ["--device", "cpu"]
    t0 = time.perf_counter()
    _run(["v2a_tpu_torch.scripts.train", "--config", CFG, "--logbase", str(tmp_path), *device],
         timeout=5000)
    t_train = time.perf_counter() - t0
    workdirs = [root for root, _dirs, files in os.walk(tmp_path)
                if "experiment_config.json" in files]
    assert len(workdirs) == 1, workdirs
    wd = workdirs[0]

    t0 = time.perf_counter()
    baseline = _eval_suc_rate(wd, epoch=0, eval_seed=0)
    trained = _eval_suc_rate(wd, epoch="latest", eval_seed=0)
    print(f"[learning] closed loop on {'cuda' if not device else 'cpu'}: baseline "
          f"{baseline:.3f}, trained {trained:.3f}; train {t_train:.1f} s, the two evals "
          f"{time.perf_counter() - t0:.1f} s")
    assert trained >= baseline + 0.25, (
        f"online loop did not learn: baseline {baseline:.3f} -> trained {trained:.3f}")
    assert trained >= 0.4, f"trained success rate too low: {trained:.3f}"
