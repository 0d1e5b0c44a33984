"""Sample videos from the video diffusion model: the guided-diffusion
`scripts/image_sample.py` surface at the video level.

Counterpart of `scripts/sample_video.py` (reference vendored CLI:
`flowdiffusion/flowdiffusion/guided_diffusion/scripts/image_sample.py`;
sampling semantics `flowdiffusion/flowdiffusion/goal_diffusion.py:583-650`):

    # hermetic smoke (random init, tiny model) — exercises the full path
    python -m v2a_tpu_torch.scripts.sample_video --smoke 1 --out samples/ \
        [--n 2] [--steps 2] [--task "put the bowl on the stove"] [--device cpu]

`--ckpt` (a converted checkpoint) is not ported yet: it raises
`NotImplementedError` (ROADMAP.md, Queue 1, `load_converted`) rather than
sample from weights other than the ones asked for. The model runs on the
card unless `--device cpu` is given.

Outputs per sample: `video_{i}.png` (frame strip), `video_{i}.mp4` (when
imageio/ffmpeg are available), plus one `videos.npy` (B, F, H, W, 3 uint8).
"""

import os
import sys

import numpy as np
import torch

from v2a_tpu_torch.config import parse_cli
from v2a_tpu_torch.data.img_utils import save_episode_mp4, save_episode_png
from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    _, kv = parse_cli(argv)
    out_dir = kv.get("out", "samples")
    n = int(kv.get("n", "1"))
    var_temp = float(kv.get("var_temp", "1.0"))
    seed = int(kv.get("seed", "0"))
    smoke = kv.get("smoke", "0") == "1"
    tasks = [kv.get("task", "a robot arm completes the task")] * n

    if not smoke:
        if not kv.get("ckpt"):
            raise SystemExit(__doc__)
        raise NotImplementedError(
            "sampling from a converted checkpoint (VideoPredModel.load_converted) is not "
            "ported yet (ROADMAP.md, Queue 1)")
    os.makedirs(out_dir, exist_ok=True)
    cfg = VideoModelConfig(
        image_size=(32, 32), model_channels=32, channel_mult=(1, 2),
        num_res_blocks=1, attention_resolutions=(2,), timesteps=10,
        sampling_timesteps=int(kv.get("steps", "2")), text_dim=64, var_temp=var_temp,
    )
    model = VideoPredModel(cfg, device=kv.get("device")).init(seed)

    h, w = model.config.image_size
    cond_path = kv.get("cond")
    if cond_path and cond_path.endswith(".npy"):
        cond = np.load(cond_path)
    elif cond_path:
        import imageio.v2 as imageio

        cond = np.asarray(imageio.imread(cond_path))[..., :3]
    else:
        # deterministic synthetic frame for smoke runs
        yy, xx = np.mgrid[0:h, 0:w]
        cond = np.stack([yy, xx, (yy + xx) // 2], -1).astype(np.uint8)
        cond = (cond * (255 // max(h + w, 1))).astype(np.uint8)
    if cond.ndim == 3:
        cond = cond[None]
    cond01 = cond.astype(np.float32) / 255.0
    if cond01.shape[1:3] != (h, w):
        raise SystemExit(
            f"conditioning frame is {cond01.shape[1:3]}, model wants {(h, w)}"
        )
    cond01 = np.ascontiguousarray(np.broadcast_to(cond01[0], (n,) + cond01.shape[1:]))

    gen = torch.Generator(device=model.device).manual_seed(seed)
    videos_u8 = model.sample_u8(cond01, tasks, generator=gen).cpu().numpy()
    np.save(os.path.join(out_dir, "videos.npy"), videos_u8)
    for i in range(n):
        save_episode_png(os.path.join(out_dir, f"video_{i}.png"), videos_u8[i])
        try:
            save_episode_mp4(os.path.join(out_dir, f"video_{i}.mp4"), list(videos_u8[i]), fps=4)
        except Exception:  # the mp4 writer (ffmpeg) is optional
            pass
    print(
        f"[sample_video] wrote {n} videos "
        f"({videos_u8.shape[1]} frames, {h}x{w}) to {out_dir}"
    )
    return videos_u8


if __name__ == "__main__":
    main()
