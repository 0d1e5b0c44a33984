#!/bin/bash
# The port's copy of `scripts/train_libero_dp.sh` (the reference's
# `scripts/train_libero_dp.sh`): pick a config, pin host threading, launch
# training on the card. Usage:
#   bash v2a_tpu_torch/scripts/train_libero_dp.sh [config] [extra CLI overrides...]
set -e
config=${1:-v2a_tpu_torch/config/libero/lb_tk8_luotest.py}
shift || true
export OMP_NUM_THREADS=1
cd "$(dirname "$0")/../.."
python -m v2a_tpu_torch.scripts.train --config "$config" "$@"
