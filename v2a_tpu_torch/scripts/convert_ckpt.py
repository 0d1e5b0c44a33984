"""Convert the reference's torch checkpoints into the port's files.

Counterpart of `scripts/convert_ckpt.py`, with the same flags:

    # the frozen video model (+ an optional local HF CLIP weights dir)
    python -m v2a_tpu_torch.scripts.convert_ckpt --kind video \
        --pt ckpts/libero/libero_ep20_bs12_aug/model-180000.pt \
        --out ckpts/libero/libero_ep20_bs12_aug/torch-model-180000.pt \
        [--clip path/to/clip-vit-base-patch32]

    # a trained policy (from a reference trainer model-{milestone}.pt;
    # --ema 0 takes the online weights instead of the EMA)
    python -m v2a_tpu_torch.scripts.convert_ckpt --kind policy \
        --pt logs/.../model-200000.pt --out policy-200000.pt [--ema 1]

The video file is {"unet": state dict, "text": state dict} (`--clip` adds
`text` and copies the tokenizer assets to `<out dir>/tokenizer/`), which
`VideoPredModel.load_converted` reads and `train/build.py::make_video_model`
finds as `<video_ckpt_dir>/torch-model-{milestone}.pt`; the policy file is
the `PolicyNets` state dict (`DiffusionPolicy.load_state_dict`). The
conversion runs on the host: no card is needed.
"""

import sys

from v2a_tpu_torch.config import parse_cli
from v2a_tpu_torch.convert import torch_import as ti


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    _, kv = parse_cli(argv)
    kind = kv.get("kind", "video")
    pt, out = kv.get("pt"), kv.get("out")
    if not pt or not out:
        raise SystemExit(__doc__)

    if kind == "video":
        params = ti.convert_video_checkpoint(pt, out, clip_path=kv.get("clip"))
        n = sum(v.numel() for sd in params.values() for v in sd.values())
    elif kind == "policy":
        state = ti.convert_policy_checkpoint(pt, out, use_ema=kv.get("ema", "1") == "1")
        n = sum(v.numel() for v in state.values())
    else:
        raise SystemExit(f"unknown --kind {kind!r}")
    print(f"[convert] {kind}: {n:,} params -> {out}")
    return n


if __name__ == "__main__":
    main()
