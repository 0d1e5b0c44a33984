"""The options the first slices left out, now ported, against the JAX
package on the CPU in float32 (its Pallas kernels in interpret mode):

- the video U-Net's `use_scale_shift_norm` and `dropout`: the plain path
  and the unpadded fused routing against JAX (deterministic; the existing
  U-Net gate, atol 5e-4 / rtol 1e-3), each kernel's launches equal to the
  JAX forward's; the padded stream refuses them where JAX does (the same
  `ValueError`); with `deterministic=False` the mask rate and the
  1 / (1 - p) scale, masks drawn from the generator, the same under
  `use_checkpoint`;
- the train_fused routings' three switches (`ConvRouting.
  train_dgrad_kernel`, `wgrad_min_s`, `train_tconv_dot`): together against
  JAX with its flags set (loss rtol 1e-5, gradients rtol 5e-4 / atol 5e-5,
  tests/test_conv_vjp.py's), launches equal to the JAX trace's; each alone
  against the port's plain path; the library dgrad against the JAX
  `dgrad_pallas=False` conv function (rtol / atol 2e-4);
- `ConditionalUnet1D(no_down_up=True)` through `policy_from_jax`;
- `MultiImageObsEncoder`'s resize, crop and ImageNet norm;
- the config fields that carry them (`VideoModelConfig`, `PolicyConfig`).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_padded import PACKAGE_KERNELS, _counting, _jax_module  # noqa: E402
from test_torch_policy import random_params as policy_params  # noqa: E402
from test_torch_train import (  # noqa: E402
    GRAD_TOL, UNET_KW, _plain_grads, _port_grads, _unet_problem,
)
from test_torch_video import UNET_TOL, _load, _t, _unet_inputs, japply, random_params  # noqa: E402
from v2a_tpu.models import unet1d as ju1d  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu.models import vision as jvision  # noqa: E402
from v2a_tpu.ops import conv_vjp as jcv  # noqa: E402
from v2a_tpu.ops import resblock_kernels as jrk  # noqa: E402
from v2a_tpu_torch.convert.from_jax import (  # noqa: E402
    policy_from_jax, video_model_from_jax, video_tree,
)
from v2a_tpu_torch.models import policy as tpolicy  # noqa: E402
from v2a_tpu_torch.models import unet1d as tu1d  # noqa: E402
from v2a_tpu_torch.models import video_model as tvm  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.models import vision as tvision  # noqa: E402
from v2a_tpu_torch.ops import conv_vjp as tcv  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402

R = tvu.ConvRouting
UNET = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
            task_token_dim=64)
OPTS = dict(use_scale_shift_norm=True, dropout=0.1)
# the unpadded fused forward of UNET at 8x8 with OPTS (or dropout alone):
# the plain-norm routing's launches (K1 at every 3x3 conv, one per part of
# the split up blocks; K2 at every temporal conv), equal to the JAX trace
# (test_scale_shift_unet_fused_matches_jax), but every K1 launch without
# the GroupNorm affine (no block hands its norm to K1)
PLAIN_NORM_COUNTS = {"fused_affine_conv3x3": 21, "temporal_conv_fused": 19}
TF_KERNELS = ("fused_affine_conv3x3", "wgrad_conv3x3")
POLICY_TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_torch_policy.py's


def _run(net, x, t, tok, **kw):
    return net(_t(x), torch.from_numpy(t), _t(tok), **kw)


# -- use_scale_shift_norm and dropout -------------------------------------------------


def test_scale_shift_unet_plain_matches_jax():
    """The plain path (mc 32, 16x16) with scale-shift norm and dropout 0.1,
    deterministic: the JAX forward within the U-Net gate; the doubled emb
    dense carried by `video_model_from_jax` (a strict load)."""
    kw = dict(UNET, model_channels=32, **OPTS)
    x, t, tok = _unet_inputs(16, seed=31)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=31)
    want = japply(jvu.VideoUNet(**kw), params, x, t, tok)
    sd = video_model_from_jax(params, {})
    assert sd["unet.down_res_0.emb_proj.weight"].shape == (64, 128)
    net = tvu.VideoUNet(**kw)
    net.load_state_dict({k[len("unet."):]: v for k, v in sd.items()}, strict=True)
    got = net.eval()(_t(x), torch.from_numpy(t), _t(tok))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **UNET_TOL)


@functools.lru_cache(maxsize=None)
def _fused_problem():
    x, t, tok = _unet_inputs(8, seed=32)
    return x, t, tok, random_params(jvu.VideoUNet(**UNET, **OPTS), x, t, tok, seed=32)


def test_scale_shift_unet_fused_matches_jax(monkeypatch):
    """The unpadded fused routing (mc 128, 8x8) with scale-shift norm and
    dropout 0.1, deterministic, against JAX `fused=True` with the padded
    stream off: within the U-Net gate, and the same launches per kernel
    (`PLAIN_NORM_COUNTS`); against the port's plain path too."""
    monkeypatch.setattr(jvu, "PERF_PADDED_STREAM", False)
    x, t, tok, params = _fused_problem()
    jcalls = _counting(monkeypatch, _jax_module, PACKAGE_KERNELS)
    want = japply(jvu.VideoUNet(fused=True, **UNET, **OPTS), params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS)
    fused = _load(tvu.VideoUNet(fused=True, routing=R(padded_stream=False), **UNET, **OPTS),
                  params)
    got = _run(fused, x, t, tok)
    assert jcalls == tcalls == PLAIN_NORM_COUNTS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)
    plain = _run(_load(tvu.VideoUNet(**UNET, **OPTS), params), x, t, tok)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **UNET_TOL)


def _k1_affine_calls(monkeypatch):
    """The K1 launches that apply a GroupNorm affine (+ SiLU)."""
    seen = []
    k1 = trk.fused_affine_conv3x3

    def counted(*a, **k):
        seen.append(k.get("silu", False))
        return k1(*a, **k)

    monkeypatch.setattr(trk, "fused_affine_conv3x3", counted)
    return seen


def test_dropout_alone_leaves_the_affine_routes(monkeypatch):
    """Dropout without scale-shift (mc 128, 8x8, deterministic): the fused
    blocks leave the affine-handing routes as the JAX block does (:1164):
    `PLAIN_NORM_COUNTS` with no K1 launch applying a norm (20 of the 21 do
    without dropout); the output the port's plain path's within the U-Net
    gate."""
    x, t, tok = _unet_inputs(8, seed=33)
    kw = dict(UNET, dropout=0.1)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=33)
    calls = _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS)
    affine = _k1_affine_calls(monkeypatch)
    got = _run(_load(tvu.VideoUNet(fused=True, routing=R(padded_stream=False), **kw), params),
               x, t, tok)
    assert calls == PLAIN_NORM_COUNTS and len(affine) == 21 and not any(affine)
    affine.clear()
    _run(_load(tvu.VideoUNet(fused=True, routing=R(padded_stream=False), **UNET), params),
         x, t, tok)
    assert sum(affine) == 20  # every K1 launch but the upsample conv's
    plain = _run(_load(tvu.VideoUNet(**kw), params), x, t, tok)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **UNET_TOL)


@pytest.mark.parametrize("opt", [dict(use_scale_shift_norm=True), dict(dropout=0.1)],
                         ids=["scale_shift", "dropout"])
def test_padded_stream_refuses_them(opt):
    """The default fused routing (the padded stream at 24x24, mc 128)
    raises the JAX package's `ValueError`, on both sides."""
    kw = dict(UNET, channel_mult=(1,), attention_resolutions=(), **opt)
    x, t, tok = _unet_inputs(24, seed=34)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=34)
    msg = "padded stream: plain-norm dropout-free blocks"
    with pytest.raises(ValueError, match=msg):
        jax.eval_shape(functools.partial(jvu.VideoUNet(fused=True, **kw).apply), params, x, t,
                       tok)
    net = _load(tvu.VideoUNet(fused=True, **kw), params)
    with pytest.raises(ValueError, match=msg):
        _run(net, x, t, tok)
    _run(_load(tvu.VideoUNet(fused=True, routing=R(padded_stream=False), **kw), params), x,
         t, tok)


def test_dropout_draws_masks_from_the_generator():
    """`deterministic=False`: a mask rate of p (within 0.01 over 2^16
    units) and kept units scaled by 1 / (1 - p); one generator seed gives
    one output, another seed another, `deterministic=True` the dropout-free
    output; no generator raises; the "blocks" recomputation redraws the
    same masks (loss bit-equal, gradients within 1e-6)."""
    block = tvu.ResBlock3D(32, 32, 16, dropout=0.25)
    ones = torch.ones(2, 4, 8, 8, 64, 2)
    dropped = block._drop(ones, seed=7)
    assert abs(float((dropped == 0).float().mean()) - 0.25) < 0.01
    assert torch.equal(dropped[dropped != 0], torch.full_like(dropped[dropped != 0], 4 / 3))
    assert torch.equal(block._drop(ones, seed=None), ones)

    kw = dict(UNET, model_channels=32, dropout=0.3)
    x, t, tok = _unet_inputs(8, seed=35)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=35)
    net = _load(tvu.VideoUNet(**kw), params)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    a = _run(net, x, t, tok, deterministic=False, generator=gen(1))
    assert torch.equal(a, _run(net, x, t, tok, deterministic=False, generator=gen(1)))
    assert not torch.allclose(a, _run(net, x, t, tok, deterministic=False, generator=gen(2)))
    clean = _run(_load(tvu.VideoUNet(**dict(kw, dropout=0.0)), params), x, t, tok)
    assert torch.equal(_run(net, x, t, tok), clean) and not torch.allclose(a, clean)
    with pytest.raises(ValueError, match="generator"):
        _run(net, x, t, tok, deterministic=False)

    grads = []
    for ckpt in (False, True):
        m = _load(tvu.VideoUNet(**kw, use_checkpoint=ckpt), params).train().requires_grad_(True)
        loss = (_run(m, x, t, tok, deterministic=False, generator=gen(3)) ** 2).mean()
        loss.backward()
        grads.append((loss.item(), {k: p.grad for k, p in m.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for k, g in grads[0][1].items():
        np.testing.assert_allclose(grads[1][1][k].numpy(), g.numpy(), atol=1e-6, err_msg=k)


# -- the train_fused routings ---------------------------------------------------------

JAX_FLAGS = dict(PERF_TRAIN_DGRAD_PALLAS=False, PERF_TRAIN_WGRAD_PALLAS=True,
                 PERF_TRAIN_WGRAD_MIN_S=64, PERF_TRAIN_TCONV_DOT=True)
ROUTINGS = {  # each alone: (routing, wgrad_kernel, K1 and K6 launches of one gradient)
    "dgrad_library": (R(train_dgrad_kernel=False), False, {"fused_affine_conv3x3": 17}),
    # 64 = the 8x8 level: K6 at its 7 convs (down_res_0, up_res_2, up_res_3,
    # the upsample conv), the library wgrad at the 10 of the 4x4 level
    "wgrad_min_s": (R(wgrad_min_s=64), True, {"fused_affine_conv3x3": 34,
                                              "wgrad_conv3x3": 7}),
    "tconv_dot": (R(train_tconv_dot=True), False, {"fused_affine_conv3x3": 34}),
}


def test_train_routings_match_jax(monkeypatch):
    """All three switches at once (the library dgrad, K6 at H*W >= 64, the
    tap-product temporal convs) against JAX `train_fused=True` with its
    flags set: loss and every gradient of mean(y^2) within the tolerances
    of tests/test_conv_vjp.py, and K1 / K6 launched as often as the JAX
    trace calls its kernels (17 K1 forwards, no K1 dgrad, 7 K6)."""
    for flag, value in JAX_FLAGS.items():
        monkeypatch.setattr(jvu, flag, value)
    x, t, tok, params = _unet_problem()
    jk1 = _counting(monkeypatch, jcv, ["fused_affine_conv3x3"])
    jk6 = _counting(monkeypatch, jrk, ["wgrad_conv3x3"])
    jm = jvu.VideoUNet(**UNET_KW, train_fused=True)
    v0, g0 = jax.jit(jax.value_and_grad(lambda p: jnp.mean(jm.apply(p, x, t, tok) ** 2)))(params)
    calls = _counting(monkeypatch, trk, TF_KERNELS)
    net = tvu.VideoUNet(**UNET_KW, train_fused=True, wgrad_kernel=True,
                        routing=R(train_dgrad_kernel=False, wgrad_min_s=64,
                                  train_tconv_dot=True))
    v1, got = _port_grads(net, params, x, t, tok)
    assert {**jk1, **jk6} == calls == {"fused_affine_conv3x3": 17, "wgrad_conv3x3": 7}
    np.testing.assert_allclose(v1, float(v0), rtol=1e-5, atol=1e-7)
    want = video_tree(g0, "")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("name", list(ROUTINGS))
def test_train_routing_alone_matches_the_plain_path(monkeypatch, name):
    """Each switch alone: loss and gradients of the port's plain path within
    the U-Net gradient gate, and the launches in `ROUTINGS` (those of the
    combined JAX trace above, per switch)."""
    routing, wgrad, counts = ROUTINGS[name]
    x, t, tok, params = _unet_problem()
    calls = _counting(monkeypatch, trk, TF_KERNELS)
    net = tvu.VideoUNet(**UNET_KW, train_fused=True, wgrad_kernel=wgrad, routing=routing)
    v1, got = _port_grads(net, params, x, t, tok)
    assert calls == counts
    v2, plain = _plain_grads()
    np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)
    for k in plain:
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(), err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("form", ["affine_silu", "plain"])
def test_library_dgrad_matches_jax(monkeypatch, form):
    """The conv functions with `dgrad_kernel=False` against the JAX custom
    VJPs with `dgrad_pallas=False` (the XLA conv backward), value and every
    gradient of sum(sin(y)) within rtol / atol 2e-4; no K1 dgrad launch."""
    rs = np.random.RandomState(9)
    args = (rs.randn(2, 8, 8, 128).astype(np.float32),
            (0.05 * rs.randn(3, 3, 128, 128)).astype(np.float32),
            (0.1 * rs.randn(128)).astype(np.float32),
            (1 + 0.3 * rs.randn(2, 128)).astype(np.float32),
            (0.2 * rs.randn(2, 128)).astype(np.float32))
    if form == "plain":
        args, jfn, tfn = args[:3], jcv.plain_conv3x3, tcv.plain_conv3x3
    else:
        jfn, tfn = jcv.affine_silu_conv3x3, tcv.affine_silu_conv3x3
    jfn = functools.partial(jfn, dgrad_pallas=False, interpret=True)
    v0, g0 = jax.value_and_grad(lambda ar: jnp.sum(jnp.sin(jfn(*ar))))(
        tuple(jnp.asarray(a) for a in args))
    calls = _counting(monkeypatch, tcv, ["_dgrad_kernel", "_library_dgrad"])
    targs = [_t(a).requires_grad_(True) for a in args]
    v1 = torch.sin(tfn(*targs, dgrad_kernel=False)).sum()
    v1.backward()
    assert calls == {"_library_dgrad": 1}
    np.testing.assert_allclose(v1.item(), float(v0), rtol=2e-5, atol=2e-5)
    for want, got in zip(g0, targs):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_configs_carry_the_options():
    """`VideoModelConfig` builds the three switches into its routing;
    `PolicyConfig.vision_pool` reaches both trunks."""
    cfg = tvm.VideoModelConfig(train_dgrad_kernel=False, wgrad_min_s=4096,
                               train_tconv_dot=True)
    assert cfg.conv_routing() == R(train_dgrad_kernel=False, wgrad_min_s=4096,
                                   train_tconv_dot=True)
    assert tvm.VideoModelConfig().conv_routing() == R()
    nets = tpolicy.PolicyNets(tpolicy.PolicyConfig(vision_pool="mask_bwd",
                                                   vision_stage_features=(16, 32, 64, 128)))
    enc = nets.obs_encoder
    assert [getattr(enc, f"enc_{k}").backbone.pool for k in enc.rgb_keys] == ["mask_bwd"] * 2


# -- the policy's options ---------------------------------------------------------------


def test_unet1d_no_down_up_matches_jax():
    """`ConditionalUnet1D(no_down_up=True)`: no down / up convs in the JAX
    tree or the port's state dict; `policy_from_jax` carries the tree (a
    strict load); the output within the policy tests' tolerance."""
    kw = dict(input_dim=7, down_dims=(32, 64), diffusion_step_embed_dim=32, kernel_size=5,
              n_groups=8)
    rs = np.random.RandomState(11)
    traj, ts = rs.randn(2, 16, 7).astype(np.float32), np.array([3, 40])
    cond = rs.randn(2, 24).astype(np.float32)
    jm = ju1d.ConditionalUnet1D(**kw, no_down_up=True)
    params = policy_params(jm, jnp.asarray(traj), jnp.asarray(ts), jnp.asarray(cond), seed=11)
    want = jax.jit(jm.apply)(params, traj, ts, cond)
    net = tu1d.ConditionalUnet1D(global_cond_dim=24, **kw, no_down_up=True)
    sd = policy_from_jax(params)
    assert not any("sample" in k for k in sd)
    net.load_state_dict(sd, strict=True)
    got = net(_t(traj), torch.from_numpy(ts), _t(cond))
    assert got.shape == (2, 16, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **POLICY_TOL)


@pytest.mark.parametrize("pre", [dict(resize_shape=(24, 20), crop_shape=(20, 16),
                                      imagenet_norm=True),
                                 dict(resize_shape=(40, 36), crop_shape=(32, 32))],
                         ids=["shrink_crop_norm", "grow_crop"])
def test_obs_encoder_preprocessing_matches_jax(pre):
    """`MultiImageObsEncoder`'s resize (bilinear, anti-aliased when it
    shrinks), centre crop and ImageNet norm against the JAX encoder's, on
    [0, 1] images of 32x28, a small trunk: the policy tests' tolerance."""
    kw = dict(rgb_keys=("img_b", "img_a"), feature_dimension=16, num_kp=8,
              stage_sizes=(1, 1), stage_features=(16, 32), **pre)
    rs = np.random.RandomState(12)
    obs = {k: rs.rand(2, 32, 28, 3).astype(np.float32) for k in kw["rgb_keys"]}
    jm = jvision.MultiImageObsEncoder(**kw)
    params = policy_params(jm, {k: jnp.asarray(v) for k, v in obs.items()}, seed=12)
    want = jax.jit(jm.apply)(params, obs)
    enc = tvision.MultiImageObsEncoder(**kw)
    enc.load_state_dict(policy_from_jax(params), strict=True)
    got = enc({k: torch.from_numpy(v) for k, v in obs.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **POLICY_TOL)
