"""The cross-attention video backbone (`models/video_unet_xattn.py`) in the
port against the JAX package, on the CPU in float32.

One set of seeded numpy weights through `convert/from_jax.py`: the network
(UNET_TOL, at a square and a non-square size, with the flow variants'
5-channel input and 2-channel output), `VideoPredModel.sample` with
`backbone="xattn"` (a 2-step DDIM chain from shared x_T, equal in pixels,
atol 2e-3) and its `loss` (JAX noise passed in, rtol 1e-4 / atol 1e-6, as
`test_torch_train.py::test_p_losses_matches_jax`); the unknown-backbone
`ValueError` of both packages; `scripts/train_video.py --backbone xattn`
for one step, its header's parameter count the JAX package's, and
`--resume` bit-equal.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_train import _jax_noise  # noqa: E402
from test_torch_variants import chain_matches_jax, load_pair  # noqa: E402
from test_torch_video import UNET_TOL, _load, japply, random_params  # noqa: E402
from v2a_tpu.models import video_model as jvm  # noqa: E402
from v2a_tpu.models import video_unet_xattn as jxa  # noqa: E402
from v2a_tpu_torch.models import video_model as tvm  # noqa: E402
from v2a_tpu_torch.models import video_unet_xattn as txa  # noqa: E402
from v2a_tpu_torch.scripts import train_video  # noqa: E402

NET = dict(block_out_channels=(32, 64), layers_per_block=1, attn_heads=2, context_dim=64)
SMALL = dict(image_size=(16, 16), sample_per_seq=3, timesteps=6, sampling_timesteps=2,
             model_channels=32, channel_mult=(1, 2), num_res_blocks=1, text_dim=64,
             backbone="xattn")


@pytest.mark.parametrize("cin,cout,hw", [(6, 3, (16, 16)), (5, 2, (8, 16))])
def test_xattn_unet_matches_jax(cin, cout, hw):
    rs = np.random.RandomState(cin)
    x = rs.randn(2, 3, *hw, cin).astype(np.float32)
    t, tok = np.array([1, 5]), rs.randn(2, 5, 64).astype(np.float32)
    jnet = jxa.VideoUNetXAttn(in_channels=cin, out_channels=cout, **NET)
    params = random_params(jnet, x, t, tok, seed=cin)
    want = japply(jnet, params, x, t, tok)
    net = _load(txa.VideoUNetXAttn(in_channels=cin, out_channels=cout, **NET), params)
    got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(tok))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3) + hw + (cout,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


def _pair(**kw):
    cfg = dict(SMALL, **kw)
    jm = jvm.VideoPredModel(jvm.VideoModelConfig(**cfg))
    tm = tvm.VideoPredModel(tvm.VideoModelConfig(**cfg), device="cpu")
    load_pair(jm, tm, seed=7)
    return jm, tm


@pytest.mark.parametrize("kw", [{}, dict(channels=2, cond_channels=3)], ids=["rgb", "flow"])
def test_xattn_sample_matches_jax(kw):
    jm, tm = _pair(**kw)
    assert isinstance(tm.unet, txa.VideoUNetXAttn) and tm.loss_unet is tm.unet
    chain_matches_jax(jm, tm)


def test_xattn_loss_matches_jax():
    jm, tm = _pair()
    rs = np.random.RandomState(5)
    video = rs.rand(2, 2, 16, 16, 3).astype(np.float32)
    x_cond = rs.rand(2, 16, 16, 3).astype(np.float32)
    te = rs.randn(2, 5, 64).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    t = np.array([3, 1])
    want = jax.jit(lambda p: jm.diffusion.p_losses(
        jm._model_fn(p, for_training=True), rng, jnp.asarray(video),
        jnp.asarray((x_cond * 2 - 1)[:, None]), jnp.asarray(te), t=jnp.asarray(t)))(
        jm.params["unet"])
    with torch.no_grad():
        got = tm.loss(torch.from_numpy(video), torch.from_numpy(x_cond), torch.from_numpy(te),
                      t=torch.from_numpy(t),
                      noise=torch.from_numpy(np.array(_jax_noise(rng, video.shape))))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_xattn_bf16_strays_from_float32_as_far_as_jax(seed):
    """On the same converted weights and inputs, the port's bf16 forward
    strays from its float32 forward (max |bf16 - f32| / std(f32), the
    card's gate in `chip_smoke.py` phase 11) no more than 1.5x as far as
    the JAX package's bf16 forward from its float32 one. JAX forms the
    logits in float32 and rounds the weights to bf16 before PV; the port
    calls `F.scaled_dot_product_attention` on bf16 q, k, v. Over these four
    seeds the port's error ran 0.81-1.10x JAX's."""
    rs = np.random.RandomState(100 + seed)
    x = rs.randn(2, 3, 16, 16, 6).astype(np.float32)
    t, tok = np.array([1, 5]), rs.randn(2, 5, 64).astype(np.float32)
    kw = dict(in_channels=6, out_channels=3, **NET)
    params = random_params(jxa.VideoUNetXAttn(**kw), x, t, tok, seed=100 + seed)
    j32 = np.asarray(japply(jxa.VideoUNetXAttn(**kw), params, x, t, tok))
    j16 = np.asarray(japply(jxa.VideoUNetXAttn(dtype=jnp.bfloat16, **kw), params, x, t, tok),
                     np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(tok))
    with torch.no_grad():
        t32 = _load(txa.VideoUNetXAttn(**kw), params)(*args).numpy()
        t16 = _load(txa.VideoUNetXAttn(dtype=torch.bfloat16, **kw), params)(*args).numpy()
    jerr = np.abs(j16 - j32).max() / j32.std()
    terr = np.abs(t16 - t32).max() / t32.std()
    assert t16.dtype == np.float32 and 0 < terr <= 1.5 * jerr, (terr, jerr)


def test_unknown_backbone_raises():
    for vm in (jvm, tvm):
        with pytest.raises(ValueError, match="unknown backbone"):
            kw = {} if vm is jvm else dict(device="cpu")
            vm.VideoPredModel(vm.VideoModelConfig(**dict(SMALL, backbone="dit")), **kw)
    assert txa.VideoUNetXAttn(use_checkpoint=True).use_checkpoint  # tests/test_torch_remat.py


class _Clips:
    """`sample_batch` / `__len__` on seeded uint8 episodes (16x16, 3 frames)."""

    def __init__(self):
        self.eps = np.random.RandomState(0).randint(0, 256, (2, 12, 16, 16, 3), np.uint8)

    def __len__(self):
        return len(self.eps)

    def sample_batch(self, batch, rng):
        e = rng.integers(len(self.eps), size=batch)
        s = rng.integers(0, 12 - 4, size=batch)
        conds = np.stack([self.eps[i, j] for i, j in zip(e, s)])
        vids = np.stack([self.eps[i, j + 1:j + 4] for i, j in zip(e, s)])
        return (conds.astype(np.float32) / 255, vids.astype(np.float32) / 255,
                [f"task {i}" for i in e])


TINY = ["--data", "(in memory)", "--image-size", "16", "--frames", "3",
        "--model-channels", "32", "--channel-mult", "1,2", "--num-res-blocks", "1",
        "--timesteps", "4", "--text-dim", "32", "--batch-size", "2", "--n-steps", "1",
        "--save-freq", "1", "--log-freq", "1", "--device", "cpu", "--backbone", "xattn"]


def test_train_video_xattn_trains_and_resumes(tmp_path, capsys):
    """One step of the xattn backbone through `run`, then `--resume
    --sample-after` in a fresh call: the parameter count is the JAX
    package's, the state bit-equal, the validation videos finite."""
    tasks = ["task 0", "task 1"]
    wd = ["--workdir", str(tmp_path / "wd")]
    first = train_video.run(train_video.parse_args(TINY + wd), _Clips(), tasks)
    header = json.loads(capsys.readouterr().out.splitlines()[0])
    assert isinstance(first.train_unet, txa.VideoUNetXAttn) and first.step == 1
    jcfg = jvm.VideoModelConfig(**{f.name: getattr(first.model.config, f.name)
                                   for f in dataclasses.fields(jvm.VideoModelConfig)})
    shapes = jax.eval_shape(jvm.VideoPredModel(jcfg).init, jax.random.PRNGKey(0))
    assert header["params"] == sum(int(np.prod(s.shape))
                                   for s in jax.tree_util.tree_leaves(shapes))
    again = train_video.run(train_video.parse_args(TINY + wd + ["--resume", "--sample-after"]),
                            _Clips(), tasks)
    assert "resumed at step 1" in capsys.readouterr().out
    a, b = first.state.state_dict(first.train_unet), again.state.state_dict(again.train_unet)
    assert a["step"] == b["step"] == 1
    for part in ("params", "ema_params"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    vids = np.load(tmp_path / "wd" / "validation_videos.npy")
    assert vids.shape == (2, 3, 16, 16, 3) and np.isfinite(vids).all()
    first.close()
    again.close()
