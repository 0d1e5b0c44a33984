"""Offline random-action dataset generator.

Counterpart of `scripts/gen_randsam.py` (the reference's
`environment/libero/lb_data/lb_randsam.py` + `gen_lb_randsam.sh`), with its
CLI and output layout:

    python -m v2a_tpu_torch.scripts.gen_randsam --env fake-8tk-v0 \
        --num_ep_per_task 5 --out data/randsam_fake-8tk-v0_perTk5.hdf5

Writes `{task}/{ep}/{agentview_image, action, ee_poses}` HDF5 consumed by
the trainer's random-buffer ingestion (`data/h5_ingest.py`), then chmods the
file read-only. Host only (numpy and the env registry); needs `h5py`.
"""

import os
import sys

from v2a_tpu_torch.config import parse_cli
from v2a_tpu_torch.data.h5_ingest import write_randsam_file
from v2a_tpu_torch.envs.randsam import RandSamConfig, generate_randsam_dataset
from v2a_tpu_torch.envs.registration import make_env_list


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    _, kv = parse_cli(argv)
    args = {f"--{k}": v for k, v in kv.items()}
    env_name = args.get("--env", "fake-8tk-v0")
    n_ep = int(args.get("--num_ep_per_task", 5))
    out = args.get("--out", f"data/randsam_{env_name}_perTk{n_ep}.hdf5")
    seed = int(args.get("--seed", 27))
    rand_ep_len = int(args.get("--rand_ep_len", 120))

    envs = make_env_list(env_name)
    cfg = RandSamConfig(rand_ep_len=rand_ep_len)
    episodes = generate_randsam_dataset(envs, n_ep, cfg, seed=seed)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_randsam_file(out, episodes, read_only=True)
    n_total = sum(len(v) for v in episodes.values())
    print(f"[gen_randsam] wrote {n_total} episodes -> {out}")


if __name__ == "__main__":
    main()
