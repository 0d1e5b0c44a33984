"""The port's video entry points on the CPU: `scripts/train_video.py` on a
small H5 clip file (its header line against the JAX package's tasks, clip
count and parameter count; its `VideoClipDataset` drawing the JAX
package's batches from one seed; two steps, a save and a resume;
`--use-checkpoint` and `--mesh`) and `scripts/sample_video.py --smoke 1` (the
outputs `tests/test_config.py::test_sample_video_cli_smoke` checks)."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu.data.h5_ingest import write_randsam_file  # noqa: E402
from v2a_tpu.train import video_trainer as jvt  # noqa: E402
from v2a_tpu_torch.scripts import sample_video, train_video  # noqa: E402
from v2a_tpu_torch.train import video_trainer as tvt  # noqa: E402

TASKS = ["task a", "task b"]
# the JAX CLI test's tiny model (`tests/test_train_video_cli.py`)
TINY = [
    "--image-size", "16", "--frames", "3", "--stride", "2",
    "--model-channels", "32", "--channel-mult", "1,2",
    "--num-res-blocks", "1", "--attention-resolutions", "8",
    "--timesteps", "8", "--text-dim", "32",
    "--batch-size", "2", "--log-freq", "1", "--device", "cpu",
]


@pytest.fixture(scope="module")
def clip_h5(tmp_path_factory):
    rs = np.random.RandomState(0)
    eps = {}
    for tk in TASKS:
        eps[tk] = [(rs.randint(0, 255, (15, 16, 16, 3), np.uint8),
                    rs.uniform(-1, 1, (14, 7)).astype(np.float32)) for _ in range(2)]
    path = str(tmp_path_factory.mktemp("clips") / "clips.hdf5")
    write_randsam_file(path, eps, read_only=False)
    return path


def _jax_param_count(args):
    """The JAX model's `param_count` for these CLI arguments, from the
    parameter shapes alone."""
    from v2a_tpu.models.video_model import VideoModelConfig, VideoPredModel

    cfg = VideoModelConfig(
        image_size=(args.image_size,) * 2, sample_per_seq=args.frames + 1,
        timesteps=args.timesteps, sampling_timesteps=args.timesteps,
        model_channels=args.model_channels,
        channel_mult=tuple(int(m) for m in args.channel_mult.split(",")),
        num_res_blocks=args.num_res_blocks,
        attention_resolutions=tuple(int(r) for r in args.attention_resolutions.split(",")),
        text_dim=args.text_dim)
    shapes = jax.eval_shape(VideoPredModel(cfg).init, jax.random.PRNGKey(0))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))


def test_video_clip_dataset_matches_jax(clip_h5):
    """Both datasets index the same clips and draw the same batches from one
    seed, and the generators' next draws agree."""
    jds = jvt.VideoClipDataset(clip_h5, TASKS, frames=3, stride=2)
    tds = tvt.VideoClipDataset(clip_h5, TASKS, frames=3, stride=2)
    try:
        assert len(tds) == len(jds) == 4
        jr, tr = np.random.default_rng(3), np.random.default_rng(3)
        for bs in (2, 5):
            for a, b in zip(jds.sample_batch(bs, jr), tds.sample_batch(bs, tr)):
                if isinstance(a, list):
                    assert a == b
                else:
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
        assert tr.integers(1 << 30) == jr.integers(1 << 30)
    finally:
        jds.h5.close()
        tds.close()


def test_train_video_trains_saves_and_resumes(clip_h5, tmp_path, capsys):
    """Two steps with a validation sample, then `--resume`: the header line
    is the JAX package's, the resumed trainer holds the saved step, weights,
    EMA and optimizer state bit for bit."""
    wd = str(tmp_path / "wd")
    first = train_video.main(["--data", clip_h5, "--workdir", wd, "--n-steps", "2",
                              "--save-freq", "2", "--sample-after", *TINY])
    out = capsys.readouterr().out
    header = json.loads(out.splitlines()[0])
    args = train_video.parse_args(["--data", clip_h5, *TINY])
    assert header == {"tasks": TASKS, "clips": 4, "params": _jax_param_count(args),
                      "dtype": "float32", "mesh": None, "workdir": wd}
    vids = np.load(os.path.join(wd, "validation_videos.npy"))
    assert vids.shape == (2, 3, 16, 16, 3) and np.isfinite(vids).all()
    assert first.step == 2

    again = train_video.main(["--data", clip_h5, "--workdir", wd, "--resume",
                              "--n-steps", "2", *TINY])
    assert "resumed at step 2" in capsys.readouterr().out
    assert again.step == 2
    a, b = first.state.state_dict(first.train_unet), again.state.state_dict(again.train_unet)
    for part in ("params", "ema_params"):
        assert a[part].keys() == b[part].keys()
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    assert sa.keys() == sb.keys() and all(
        torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])


@pytest.mark.parametrize("flag", [["--mesh", "dp=2"], ["--use-checkpoint"],
                                  ["--backbone", "xattn", "--use-checkpoint"]])
def test_train_video_left_out_flags_raise(flag, clip_h5, tmp_path, monkeypatch):
    """The flags once left out now run: `--use-checkpoint` trains a step
    with the U-Net's block recomputation and the xattn backbone's per-block
    one; `--mesh dp=2` in one process with no cluster environment raises
    before any model is built (the mesh does not fit a world of one; under
    `torchrun --nproc_per_node 2` it trains, `tests/test_torch_parallel.py`
    runs the trainer on two ranks), as a malformed mesh spec does."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--data", clip_h5, "--workdir", str(tmp_path / "wd"), "--n-steps", "1", *flag, *TINY]
    if "--mesh" in flag:
        with pytest.raises(ValueError, match="#ranks 1"):
            train_video.main(argv)
        with pytest.raises(ValueError, match="malformed mesh spec"):
            train_video.parse_mesh("dp:2", device="cpu")
        return
    trainer = train_video.main(argv)
    assert trainer.step == 1 and trainer.train_unet.use_checkpoint is True
    assert all(bool(torch.isfinite(p).all()) for p in trainer.train_unet.parameters())


def test_sample_video_smoke(tmp_path):
    """`--smoke 1` writes what the JAX CLI's test checks; `--ckpt` of a file
    that is not there raises rather than sample from other weights
    (`tests/test_torch_convert.py` samples from a converted file)."""
    videos = sample_video.main(["--smoke", "1", "--n", "2", "--steps", "2", "--device", "cpu",
                                "--out", str(tmp_path), "--task", "pick up the bowl"])
    vids = np.load(tmp_path / "videos.npy")
    assert vids.shape == (2, 7, 32, 32, 3) and vids.dtype == np.uint8
    np.testing.assert_array_equal(vids, videos)
    assert (tmp_path / "video_0.png").exists() and (tmp_path / "video_1.png").exists()
    with pytest.raises(FileNotFoundError):
        sample_video.main(["--ckpt", str(tmp_path / "model.pt"), "--device", "cpu",
                           "--out", str(tmp_path)])
