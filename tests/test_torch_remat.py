"""Rematerialisation in the port (`use_checkpoint` / `remat_policy`), on the
CPU in float32, at the sizes of `tests/test_remat.py`.

- The small `VideoUNet` of `tests/test_remat.py` under "blocks", "levels"
  and "mxu" (the trainer's selective checkpoint of conv / matmul outputs):
  the output bit-equal to the net without remat and every gradient within
  rtol 1e-4 / atol 1e-4 of it (the JAX test's tolerance: only the order of
  the gradient sums changes; the net without remat is held against the
  JAX package in `tests/test_torch_video.py` and `test_torch_train.py`);
  the same with
  `train_fused=True` at the width where every conv takes K1's routing (its
  plain kernel versions here), where the recomputation re-runs K1's
  forward in the backward: its launches are the ResBlocks' forwards once
  more.
- "levels" keeps the fewest tensors for the backward, "blocks" fewer than
  none (bytes saved by autograd, counted with `saved_tensors_hooks`).
- The xattn backbone's per-block checkpointing, the same way.
- `VideoModelTrainer` with `use_checkpoint` against the trainer without,
  as `tests/test_remat.py:245-307`: the same loss, a same-scale update.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the train_fused case's weights: tests/test_torch_train.py
pytest.importorskip("flax")
pytest.importorskip("optax")

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_padded import _counting  # noqa: E402
from test_torch_train import K1_NAMES, UNET_KW, _unet_problem  # noqa: E402
from test_torch_video import _t  # noqa: E402
from torch_mesh_ranks import Clips  # noqa: E402
from v2a_tpu_torch.convert.from_jax import video_tree  # noqa: E402
from v2a_tpu_torch.models.init import init_params  # noqa: E402
from v2a_tpu_torch.models import video_model as tvm  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.models import video_unet_xattn as txa  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402
from v2a_tpu_torch.train import video_trainer as tvt  # noqa: E402

# tests/test_remat.py's small U-Net and input
KW = dict(in_channels=6, model_channels=32, out_channels=3, num_res_blocks=1,
          attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16,
          task_token_dim=16)
REMAT_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_remat.py:30-37


def _problem():
    """tests/test_remat.py's input, the port's seeded weights."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 8, 8, 6).astype(np.float32)
    t, tok = np.array([1, 7]), rs.randn(2, 5, 16).astype(np.float32)
    net = tvu.VideoUNet(**KW)
    init_params(net, torch.Generator().manual_seed(0))
    return x, t, tok, net.state_dict()


def _grads(net, state, x, t, tok, wrap=None):
    """Output and gradients of sum(y^2) through the port's net."""
    net.load_state_dict(state, strict=True)
    fn = wrap(net) if wrap else net
    y = fn(_t(x), torch.from_numpy(t), _t(tok))
    (y ** 2).sum().backward()
    return y.detach(), {k: p.grad.clone() for k, p in net.named_parameters()}


def _mxu(net):
    return tvt.mxu_checkpointed(net)


@pytest.mark.parametrize("policy", ["blocks", "levels", "mxu"])
def test_unet_remat_grads_match(policy):
    """The plain small U-Net: output bit-equal, gradients REMAT_TOL of the
    net without remat."""
    x, t, tok, state = _problem()
    y0, g0 = _grads(tvu.VideoUNet(**KW), state, x, t, tok)
    net = tvu.VideoUNet(**KW, use_checkpoint=True, remat_policy=policy)
    y1, g1 = _grads(net, state, x, t, tok, _mxu if policy == "mxu" else None)
    assert torch.equal(y1, y0)
    assert g1.keys() == g0.keys()
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), err_msg=k, **REMAT_TOL)


@pytest.mark.parametrize("policy", ["blocks", "levels", "mxu"])
def test_train_fused_remat_grads_match(monkeypatch, policy):
    """`train_fused=True` at `tests/test_torch_train.py`'s width (every conv
    through K1's autograd Functions, their plain versions on the CPU):
    output bit-equal and gradients REMAT_TOL of the same net without remat.
    The backward re-runs the recomputed convs' K1 forwards: "blocks" and
    "mxu" recompute every ResBlock (16 K1 forwards more than the 17 + 17
    of the step without remat, the upsample conv outside a block only with
    "mxu"), "levels" every level (all 17 again and the down levels' 8
    twice: their skips are recomputed in the up segments)."""
    x, t, tok, params = _unet_problem()
    params = video_tree(params, "")
    calls = _counting(monkeypatch, trk, K1_NAMES)
    y0, g0 = _grads(tvu.VideoUNet(**UNET_KW, train_fused=True), params, x, t, tok)
    base = calls.pop("fused_affine_conv3x3")
    net = tvu.VideoUNet(**UNET_KW, train_fused=True, use_checkpoint=True, remat_policy=policy)
    y1, g1 = _grads(net, params, x, t, tok, _mxu if policy == "mxu" else None)
    assert base == 34
    assert calls["fused_affine_conv3x3"] == {"blocks": 50, "levels": 59, "mxu": 51}[policy]
    assert torch.equal(y1, y0)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), err_msg=k, **REMAT_TOL)


def test_levels_keep_the_fewest_tensors():
    """Bytes autograd keeps for the backward of one forward (a three-level
    U-Net at 32^2): "levels" < "blocks" < none; "mxu" changes nothing in
    the module itself (the trainer wraps it)."""
    kw = dict(KW, num_res_blocks=2, channel_mult=(1, 2, 3), attention_resolutions=(4,))
    x = torch.randn(2, 3, 32, 32, 6)
    t, tok = torch.tensor([1, 7]), torch.randn(2, 5, 16)
    saved = {}
    for policy in (None, "blocks", "levels", "mxu"):
        net = tvu.VideoUNet(**kw, use_checkpoint=policy is not None,
                            remat_policy=policy or "blocks")
        seen = {}

        def pack(tensor, seen=seen):
            seen[(tensor.data_ptr(), tuple(tensor.shape))] = tensor.numel() * tensor.element_size()
            return tensor

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
            net(x, t, tok)
        saved[policy] = sum(seen.values())
    assert saved["levels"] < saved["blocks"] < saved[None] == saved["mxu"], saved
    assert saved["levels"] < 0.1 * saved[None], saved


def test_xattn_remat_grads_match():
    """The xattn backbone with `use_checkpoint` (per block) against the
    port without it: output bit-equal, gradients REMAT_TOL, at
    `tests/test_remat.py`'s size."""
    kw = dict(in_channels=6, out_channels=3, block_out_channels=(32, 64), layers_per_block=1,
              attn_heads=2, context_dim=16)
    rs = np.random.RandomState(3)
    x = rs.randn(1, 2, 8, 8, 6).astype(np.float32)
    t, tok = np.array([5]), rs.randn(1, 4, 16).astype(np.float32)
    base = txa.VideoUNetXAttn(**kw)
    init_params(base, torch.Generator().manual_seed(3))
    state = base.state_dict()
    y0, g0 = _grads(base, state, x, t, tok)
    y1, g1 = _grads(txa.VideoUNetXAttn(**kw, use_checkpoint=True), state, x, t, tok)
    assert torch.equal(y1, y0)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), err_msg=k, **REMAT_TOL)


# tests/test_remat.py:245-307's trainer config
TRAINER_VIDEO = dict(image_size=(8, 8), sample_per_seq=3, timesteps=10, sampling_timesteps=2,
                     model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                     attention_resolutions=(2,), num_head_channels=16, text_dim=16)


@pytest.mark.parametrize("policy", ["blocks", "levels", "mxu"])
def test_video_trainer_use_checkpoint_step_matches(tmp_path, policy):
    """One `VideoModelTrainer` step with `use_checkpoint` against the same
    step without: the U-Net is the non-fused one with the policy (the "mxu"
    apply wraps it), the loss is bit-equal, and every parameter is within
    2e-4 of the step without remat (one Adam step moves an element by about
    lr = 1e-4, sign-normalized where the gradient is ~0, as the JAX test
    says)."""
    after, losses = [], []
    for ckpt in (False, True):
        model = tvm.VideoPredModel(tvm.VideoModelConfig(**TRAINER_VIDEO), device="cpu").init(0)
        tr = tvt.VideoModelTrainer(
            model, Clips(frames=2), tvt.VideoTrainerConfig(
                batch_size=2, n_train_steps=1, save_freq=10 ** 9, log_freq=10 ** 9,
                use_checkpoint=ckpt, remat_policy=policy),
            workdir=str(tmp_path / f"w{ckpt}"), seed=0)
        assert tr.train_unet.use_checkpoint is ckpt and tr.train_unet.fused is False
        if ckpt:
            assert tr.train_unet.remat_policy == policy
            assert (tr._train_apply is tr.train_unet) is (policy != "mxu")
        x_cond, video, tasks = Clips(frames=2).sample_batch(2, np.random.default_rng(1))
        t, w = tr.sampler.sample(2, tr.np_rng)
        loss, _ = tr.train_step(_t(video), (_t(x_cond) * 2 - 1)[:, None],
                                model.encode_batch_text(tasks), torch.from_numpy(t).long(),
                                _t(w))
        losses.append(loss.item())
        after.append({k: v.clone() for k, v in tr.train_unet.state_dict().items()})
        assert all(bool(torch.isfinite(v).all()) for v in after[-1].values())
        tr.close()
    assert losses[0] == losses[1]
    assert max(float((after[0][k] - after[1][k]).abs().max()) for k in after[0]) < 2e-4


def test_remat_policy_checks(tmp_path):
    """An unknown policy raises; the xattn backbone recomputes per block
    only (the JAX xattn module has no policy field)."""
    with pytest.raises(ValueError, match="remat_policy"):
        tvu.VideoUNet(**KW, use_checkpoint=True, remat_policy="all")
    model = tvm.VideoPredModel(tvm.VideoModelConfig(**dict(
        TRAINER_VIDEO, backbone="xattn", channel_mult=(1,))), device="cpu")
    with pytest.raises(ValueError, match="per block"):
        tvt.VideoModelTrainer(model, None, tvt.VideoTrainerConfig(
            use_checkpoint=True, remat_policy="levels"), workdir=str(tmp_path))
    tr = tvt.VideoModelTrainer(model, None, tvt.VideoTrainerConfig(use_checkpoint=True),
                               workdir=str(tmp_path))
    assert tr.train_unet.use_checkpoint is True
    tr.close()


def test_xattn_attention_chunks_are_the_same_function(monkeypatch):
    """From 2 * `_SDPA_CHUNK` sequences on (the temporal attention of the
    128^2 level at B=4, where cuDNN's backward fails on the card), the
    xattn attention runs in chunks of sequences: the same outputs and input
    gradients as one call, within 1e-6 (float32)."""
    monkeypatch.setattr(txa, "_SDPA_CHUNK", 4)
    g = torch.Generator().manual_seed(5)
    qkv = [torch.randn(10, 2, 7, 8, generator=g, requires_grad=True) for _ in range(3)]
    out = txa._sdpa(*qkv)
    grads = torch.autograd.grad(out.square().sum(), qkv)
    ref = torch.nn.functional.scaled_dot_product_attention(*qkv)
    ref_grads = torch.autograd.grad(ref.square().sum(), qkv)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
