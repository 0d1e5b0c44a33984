#!/bin/bash
# The port's copy of `scripts/plan_lb_list.sh` (the reference's
# `diffuser/libero/plan_lb_list.sh`): evaluate a list of experiment
# workdirs. Usage:
#   bash v2a_tpu_torch/scripts/plan_lb_list.sh <n_seeds> <workdir> [workdir...]
set -e
if [ "$#" -lt 2 ]; then
  echo "usage: plan_lb_list.sh <n_seeds> <workdir> [workdir...]" >&2
  exit 2
fi
n_seeds=$1
shift || true
cd "$(dirname "$0")/../.."
for wd in "$@"; do
  python -m v2a_tpu_torch.scripts.eval --workdir "$wd" --n_seeds "$n_seeds" --eval_seed 0 --vis 1
done
