"""The port's video train step against the JAX package, on the CPU in float32.

On the CPU the K1 and K6 wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do. Inputs,
weights and noise are made with numpy (or taken from the JAX package) and
handed to both. Tolerances are stated beside each assertion.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
pytest.importorskip("optax")  # the JAX trainer needs it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_padded import _counting  # noqa: E402
from test_torch_video import _t, random_params  # noqa: E402
from v2a_tpu.models import video_model as jvm  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu.ops import conv_vjp as jcv  # noqa: E402
from v2a_tpu.ops import resample as jrs  # noqa: E402
from v2a_tpu.ops import resblock_kernels as jrk  # noqa: E402
from v2a_tpu.train import train_state as jts  # noqa: E402
from v2a_tpu.train import video_trainer as jvt  # noqa: E402
from v2a_tpu_torch.convert.from_jax import video_model_from_jax, video_tree  # noqa: E402
from v2a_tpu_torch.models import video_model as tvm  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.ops import conv_vjp as tcv  # noqa: E402
from v2a_tpu_torch.ops import resample as trs  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402
from v2a_tpu_torch.train import checkpoint as tck  # noqa: E402
from v2a_tpu_torch.train import train_state as tts  # noqa: E402
from v2a_tpu_torch.train import video_trainer as tvt  # noqa: E402

GRAD_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_conv_vjp.py:123-126, U-Net gradients
K1_NAMES = ("fused_affine_conv3x3", "wgrad_conv3x3")


def _opt(a):
    return None if a is None else jnp.asarray(a)


# -- K6 ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("n,hw,c,d", [(4, 8, 128, 128), (2, 16, 128, 256)])
def test_wgrad_plain_matches_pallas(dtype, affine, n, hw, c, d):
    """K6's plain version against the Pallas kernel in interpret mode: the
    activation rounded to the input dtype, zero after it, sums in float32.
    Both sum the same products in another order: atol 1e-4 against outputs
    of ~50-100 (float32 sums of 128-512 products of unit normals)."""
    rs = np.random.RandomState(n * hw)
    x = rs.randn(n, hw, hw, c).astype(np.float32)
    g = rs.randn(n, hw, hw, d).astype(np.float32)
    a = (1 + 0.1 * rs.randn(n, c)).astype(np.float32) if affine else None
    b = (0.3 * rs.randn(n, c)).astype(np.float32) if affine else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jrk.wgrad_conv3x3(jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt), _opt(a),
                             _opt(b), silu=affine, interpret=True)
    before = trk.launches["wgrad_conv3x3"]
    got = trk.wgrad_conv3x3(_t(x).to(tdt), _t(g).to(tdt), None if a is None else _t(a),
                            None if b is None else _t(b), silu=affine)
    assert trk.launches["wgrad_conv3x3"] == before  # CPU: the plain version, no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, c, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


def test_wgrad_keeps_the_jax_guards():
    x, g = torch.zeros(1, 4, 4, 64), torch.zeros(1, 4, 4, 64)
    with pytest.raises(NotImplementedError):  # silu without the affine
        trk.wgrad_conv3x3(x, g, silu=True)
    with pytest.raises(ValueError):  # g's leading shape must be x's
        trk.wgrad_conv3x3(x, torch.zeros(1, 4, 5, 64))


# K6's 26 signatures (N, H, W, C, D) in a B=4 release train step (N = B x F),
# each once (`test_release_train_step_k6_shapes` traces them)
RELEASE_K6 = [
    (28, 128, 128, 128, 128), (28, 128, 128, 256, 128), (28, 128, 128, 256, 256),
    (28, 128, 128, 384, 128), (28, 64, 64, 128, 256), (28, 64, 64, 256, 256),
    (28, 64, 64, 384, 256), (28, 64, 64, 384, 384), (28, 64, 64, 512, 256),
    (28, 64, 64, 640, 256), (28, 32, 32, 256, 384), (28, 32, 32, 384, 384),
    (28, 32, 32, 512, 512), (28, 32, 32, 640, 384), (28, 32, 32, 768, 384),
    (28, 32, 32, 896, 384), (28, 16, 16, 384, 512), (28, 16, 16, 512, 512),
    (28, 16, 16, 640, 640), (28, 16, 16, 896, 512), (28, 16, 16, 1024, 512),
    (28, 16, 16, 1152, 512), (28, 8, 8, 512, 640), (28, 8, 8, 640, 640),
    (28, 8, 8, 1152, 640), (28, 8, 8, 1280, 640)]
# shapes off the release path: W below the 8-pixel tile, H and W not
# multiples of it, one-pixel columns, a chunk boundary mid-sample
RAGGED_K6 = [(2, 4, 5, 64, 64), (3, 5, 7, 64, 192), (5, 48, 40, 128, 128), (1, 1, 1, 64, 64),
             (2, 3, 1, 64, 64), (1, 130, 9, 64, 64)]


@pytest.mark.parametrize("n,h,w,c,d", RELEASE_K6 + RAGGED_K6)
def test_wgrad_chunks_cover_the_pixels(n, h, w, c, d):
    """K6's plan (`trk.wgrad_plan`): its tiles, walked in chunk order as the
    kernel walks them ((sample, tile row, tile col) from the chunk's first
    tile), cover each pixel exactly once; the chunks are contiguous, in
    order and none empty; the shared memory fits a CTA; the grid has a CTA
    per SM where the tiles allow; two calls give the same plan."""
    plan = trk.wgrad_plan(n, h, w, c, d)
    assert plan == trk.wgrad_plan(n, h, w, c, d)
    th, tw = plan.tile_h, plan.tile_w
    tiles_w = -(-w // tw)
    per_image = -(-h // th) * tiles_w
    assert plan.tiles == n * per_image and th * tw <= 64
    starts = [k * plan.per_chunk for k in range(plan.chunks)]
    ends = [min(s + plan.per_chunk, plan.tiles) for s in starts]
    assert starts[0] == 0 and ends[-1] == plan.tiles and all(e > s for s, e in zip(starts, ends))
    assert all(e == s for e, s in zip(ends, starts[1:]))
    covered = np.zeros((n, h, w), np.int32)
    for s, e in zip(starts, ends):
        for t in range(s, e):
            i, r = divmod(t, per_image)
            h0, w0 = (r // tiles_w) * th, (r % tiles_w) * tw
            covered[i, h0:h0 + th, w0:w0 + tw] += 1
    assert (covered == 1).all()
    assert plan.smem <= trk.HOPPER_SMEM
    blocks = (c // 32) * (d // (128 if d % 128 == 0 else 64))
    assert plan.grid == blocks * plan.chunks
    assert plan.grid >= min(trk.HOPPER_SMS, blocks * plan.tiles)


def test_release_train_step_k6_shapes(monkeypatch):
    """The B=4 release train step, traced on the meta device, calls K6 at
    exactly the 26 signatures `RELEASE_K6` lists (the plan test's cases)."""
    _counting(monkeypatch, trk, K1_NAMES, via_plain=True)
    shapes = set()

    def record(x, g, *a, **k):
        shapes.add(tuple(x.shape) + (g.shape[-1],))
        return trk.wgrad_conv3x3_plain(x, g, *a, **k)

    monkeypatch.setattr(trk, "wgrad_conv3x3", record)
    with torch.device("meta"):
        net = tvu.VideoUNet(dtype=torch.bfloat16, train_fused=True, wgrad_kernel=True)
        y = net(torch.randn(4, 7, 128, 128, 6), torch.zeros(4, dtype=torch.long),
                torch.randn(4, 77, 512))
        y.float().square().mean().backward()
    assert shapes == set(RELEASE_K6)


# -- the autograd Functions against the JAX custom_vjp's -------------------------


def _problem(n=4, h=8, w=8, c=128, d=128, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, h, w, c).astype(np.float32),
            (0.05 * rs.randn(3, 3, c, d)).astype(np.float32),
            (0.1 * rs.randn(d)).astype(np.float32),
            (1 + 0.3 * rs.randn(n, c)).astype(np.float32),
            (0.2 * rs.randn(n, c)).astype(np.float32))


@pytest.mark.parametrize("wgrad", [False, True], ids=["xla_wgrad", "k6_wgrad"])
@pytest.mark.parametrize("jax_dgrad", [False, True], ids=["jax_xla_dgrad", "jax_pallas_dgrad"])
@pytest.mark.parametrize("form", ["affine_silu", "plain"])
def test_conv_functions_match_jax(form, jax_dgrad, wgrad):
    """Value and every gradient of sum(sin(y)) against the JAX custom_vjp
    with the same wgrad routing, and with either of its dgrad routings: the
    port's one dgrad (K1 with flipped, transposed weights) against both the
    JAX package's default (Pallas K1) and its XLA conv backward; rtol 2e-4 /
    atol 2e-4, the JAX test's tolerance (tests/test_conv_vjp.py:48-55)."""
    args = _problem()
    if form == "plain":
        args, names = args[:3], ("dx", "dkernel", "dbias")
        jfn, tfn = jcv.plain_conv3x3, tcv.plain_conv3x3
    else:
        names = ("dx", "dkernel", "dbias", "da", "db")
        jfn, tfn = jcv.affine_silu_conv3x3, tcv.affine_silu_conv3x3
    jfn = functools.partial(jfn, dgrad_pallas=jax_dgrad, interpret=True, wgrad_pallas=wgrad)
    v0, g0 = jax.value_and_grad(lambda ar: jnp.sum(jnp.sin(jfn(*ar))))(
        tuple(jnp.asarray(a) for a in args))
    targs = [_t(a).requires_grad_(True) for a in args]
    v1 = torch.sin(tfn(*targs, wgrad_kernel=wgrad)).sum()
    v1.backward()
    np.testing.assert_allclose(v1.item(), float(v0), rtol=2e-5, atol=2e-5)
    for name, want, got in zip(names, g0, targs):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_conv_function_matches_its_reference():
    """The port's Function against the port's plain autograd reference
    (`affine_silu_conv3x3_reference`), as tests/test_conv_vjp.py:30-55."""
    args = [_t(a).requires_grad_(True) for a in _problem(h=16, w=16, seed=1)]
    ref = [_t(a).requires_grad_(True) for a in _problem(h=16, w=16, seed=1)]
    torch.sin(tcv.affine_silu_conv3x3(*args, wgrad_kernel=True)).sum().backward()
    torch.sin(tcv.affine_silu_conv3x3_reference(*ref)).sum().backward()
    for got, want in zip(args, ref):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), rtol=2e-4, atol=2e-4)


def test_conv_function_gradient_dtypes():
    """bf16 activations, float32 parameters: dx in bf16, the rest float32
    (tests/test_conv_vjp.py:58-70)."""
    x, k, bias, a, b = _problem()
    args = [_t(x).bfloat16().requires_grad_(True)] + [_t(v).requires_grad_(True)
                                                      for v in (k, bias, a, b)]
    y = tcv.affine_silu_conv3x3(*args, wgrad_kernel=True)
    assert y.dtype == torch.bfloat16
    (y.float() ** 2).sum().backward()
    assert args[0].grad.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.float32 for t in args[1:])


# -- the U-Net's train_fused routing ---------------------------------------------

UNET_KW = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=1,
               attention_resolutions=(), channel_mult=(1, 2), num_head_channels=32,
               task_token_dim=64)  # tests/test_conv_vjp.py:94-107


@functools.lru_cache(maxsize=None)
def _unet_problem():
    """8x8, F=2: the smallest input at which every conv of the small U-Net
    still passes K1's gate (both levels, the upsample conv)."""
    rs = np.random.RandomState(21)
    x = rs.randn(1, 2, 8, 8, 6).astype(np.float32)
    t, tok = np.array([3]), rs.randn(1, 4, 64).astype(np.float32)
    params = random_params(jvu.VideoUNet(**UNET_KW), x, t, tok, seed=21)
    return x, t, tok, params


def _port_grads(net, params, x, t, tok):
    net.load_state_dict(video_tree(params, ""), strict=True)
    loss = (net(_t(x), torch.from_numpy(t), _t(tok)) ** 2).mean()
    loss.backward()
    return loss.item(), {k: p.grad for k, p in net.named_parameters()}


@functools.lru_cache(maxsize=None)
def _plain_grads():
    """The port's plain-path loss and gradients on `_unet_problem`, once for
    both wgrad routings."""
    x, t, tok, params = _unet_problem()
    return _port_grads(tvu.VideoUNet(**UNET_KW), params, x, t, tok)


@pytest.mark.parametrize("wgrad", [False, True], ids=["xla_wgrad", "k6_wgrad"])
def test_train_fused_unet_matches_jax(monkeypatch, wgrad):
    """Loss and every parameter gradient of mean(y^2) through the port's
    `VideoUNet(train_fused=True)` against JAX `VideoUNet(train_fused=True)`
    (its wgrad routed through K6 by its module flag when `wgrad`), and
    against the port's plain path; rtol 5e-4 / atol 5e-5, the JAX package's
    own train_fused-vs-plain tolerance. 17 convs take the routing: 8
    ResBlocks x 2 and the upsample conv, each one K1 forward and one K1
    dgrad [and one K6] launch."""
    monkeypatch.setattr(jvu, "PERF_TRAIN_WGRAD_PALLAS", wgrad)
    x, t, tok, params = _unet_problem()
    jm = jvu.VideoUNet(**UNET_KW, train_fused=True)
    v0, g0 = jax.jit(jax.value_and_grad(lambda p: jnp.mean(jm.apply(p, x, t, tok) ** 2)))(params)
    want = video_tree(g0, "")
    calls = _counting(monkeypatch, trk, K1_NAMES)
    net = tvu.VideoUNet(**UNET_KW, train_fused=True, wgrad_kernel=wgrad)
    v1, got = _port_grads(net, params, x, t, tok)
    assert calls == ({"fused_affine_conv3x3": 34, "wgrad_conv3x3": 17} if wgrad
                     else {"fused_affine_conv3x3": 34})
    v2, plain = _plain_grads()
    np.testing.assert_allclose(v1, float(v0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)
    assert got.keys() == want.keys() == plain.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(), err_msg=k, **GRAD_TOL)


def test_train_fused_launches_match_jax(monkeypatch):
    """K1 forward, K1 dgrad and K6 calls of one train_fused gradient at the
    small config, against the JAX package's, traced by `jax.eval_shape`."""
    monkeypatch.setattr(jvu, "PERF_TRAIN_WGRAD_PALLAS", True)
    x, t, tok, params = _unet_problem()
    jm = jvu.VideoUNet(**UNET_KW, train_fused=True)
    jk1 = _counting(monkeypatch, jcv, ["fused_affine_conv3x3"])
    jk6 = _counting(monkeypatch, jrk, ["wgrad_conv3x3"])
    jax.eval_shape(jm.apply, params, x, t, tok)
    jfwd = dict(jk1)
    jk1.clear()
    jax.eval_shape(jax.grad(lambda p: jnp.mean(jm.apply(p, x, t, tok) ** 2)), params)
    calls = _counting(monkeypatch, trk, K1_NAMES)
    net = tvu.VideoUNet(**UNET_KW, train_fused=True, wgrad_kernel=True)
    net.load_state_dict(video_tree(params, ""))
    y = net(_t(x), torch.from_numpy(t), _t(tok))
    fwd = dict(calls)
    (y ** 2).mean().backward()
    assert fwd == jfwd == {"fused_affine_conv3x3": 17}
    # the grad trace runs each conv's forward rule once and its backward once
    assert calls["fused_affine_conv3x3"] - fwd["fused_affine_conv3x3"] == 17
    assert jk1 == {"fused_affine_conv3x3": 34} and calls["wgrad_conv3x3"] == jk6["wgrad_conv3x3"]


@pytest.mark.parametrize("wgrad", [False, True], ids=["xla_wgrad", "k6_wgrad"])
def test_release_train_step_launch_counts(monkeypatch, wgrad):
    """The release U-Net (128^2, F=7, bf16) at B=4, forward and backward
    traced on the meta device: 58 convs take the train_fused routing (27
    ResBlocks x 2 + 4 upsample convs), each one K1 forward, one K1 dgrad
    [and one K6], the counts `chip_smoke.py` holds the card to."""
    calls = _counting(monkeypatch, trk, K1_NAMES, via_plain=True)
    with torch.device("meta"):
        net = tvu.VideoUNet(dtype=torch.bfloat16, train_fused=True, wgrad_kernel=wgrad)
        y = net(torch.randn(4, 7, 128, 128, 6), torch.zeros(4, dtype=torch.long),
                torch.randn(4, 77, 512))
        assert calls == {"fused_affine_conv3x3": 58}
        y.float().square().mean().backward()
    assert calls == ({"fused_affine_conv3x3": 116, "wgrad_conv3x3": 58} if wgrad
                     else {"fused_affine_conv3x3": 116})


def test_fused_forward_refuses_trainable_parameters():
    """The kernels have no backward: a fused forward with parameters that
    require grad raises instead of silently dropping their gradients; frozen
    and under no_grad it runs, and the plain versions stay differentiable."""
    kw = dict(UNET_KW, channel_mult=(1,))
    net = tvu.VideoUNet(fused=True, **kw)
    x, t, tok = torch.randn(1, 2, 8, 8, 6), torch.tensor([3]), torch.randn(1, 4, 64)
    with pytest.raises(RuntimeError, match="has no backward"):
        net(x, t, tok)
    with torch.no_grad():
        assert net(x, t, tok).shape == (1, 2, 8, 8, 3)
    xg = torch.randn(1, 4, 4, 128, requires_grad=True)
    k, bias = torch.randn(3, 3, 128, 128), torch.zeros(128)
    with pytest.raises(RuntimeError, match="has no backward"):
        trk.fused_affine_conv3x3(xg, k, bias)
    trk.fused_affine_conv3x3_plain(xg, k, bias).sum().backward()
    assert xg.grad is not None


# -- the loss, the samplers and the trainer ---------------------------------------

SMALL = dict(image_size=(8, 8), sample_per_seq=3, timesteps=4, sampling_timesteps=4,
             model_channels=32, channel_mult=(1,), num_res_blocks=1, attention_resolutions=(),
             num_head_channels=32, text_dim=64)


def _models(loss_type="l2", seed=0):
    jm = jvm.VideoPredModel(jvm.VideoModelConfig(fused=False, loss_type=loss_type, **SMALL))
    f, (h, w) = jm.config.video_future_horizon, jm.config.image_size
    unet = random_params(jm.unet, np.zeros((1, f, h, w, 6), np.float32),
                         np.zeros((1,), np.int32), np.zeros((1, 4, 64), np.float32), seed=seed)
    text = random_params(jm.text_encoder, np.zeros((1, 4), np.int32), np.ones((1, 4), np.int32),
                         seed=seed + 1)
    jm.params = {"unet": unet, "text": text}
    tm = tvm.VideoPredModel(tvm.VideoModelConfig(loss_type=loss_type, **SMALL), device="cpu")
    tm.load_state_dict(video_model_from_jax(unet, text))
    return jm, tm


def _batch(rs, b=2):
    video = rs.rand(b, 2, 8, 8, 3).astype(np.float32)
    x_cond = rs.rand(b, 8, 8, 3).astype(np.float32)
    return video, x_cond, rs.randn(b, 5, 64).astype(np.float32)


def _jax_noise(rng, shape):
    """The noise JAX p_losses draws from `rng` (ops/gaussian_diffusion.py:412-416)."""
    _, noise_rng = jax.random.split(rng)
    return np.asarray(jax.random.normal(noise_rng, shape))


@pytest.mark.parametrize("loss_type", ["l2", "l1"])
def test_p_losses_matches_jax(loss_type):
    """pred_v target, min-SNR weights, sample weights, per-sample losses,
    with the JAX noise passed in; rtol 1e-4 / atol 1e-6 (float32 forwards)."""
    jm, tm = _models(loss_type)
    rs = np.random.RandomState(5)
    video, x_cond, te = _batch(rs)
    t, wts = np.array([3, 1]), np.array([0.5, 2.0], np.float32)
    rng = jax.random.PRNGKey(7)
    x_cond_n = (x_cond * 2 - 1)[:, None]
    want, want_ps = jax.jit(lambda p: jm.diffusion.p_losses(
        jm._model_fn(p, for_training=True), rng, jnp.asarray(video), jnp.asarray(x_cond_n),
        jnp.asarray(te), t=jnp.asarray(t), sample_weights=jnp.asarray(wts),
        return_per_sample=True))(jm.params["unet"])
    with torch.no_grad():
        got, got_ps = tm.diffusion.p_losses(
            tm.unet, _t(video), _t(x_cond_n), _t(te), t=torch.from_numpy(t),
            sample_weights=_t(wts), return_per_sample=True,
            noise=_t(_jax_noise(rng, video.shape)))
        plain = tm.loss(_t(video), _t(x_cond), _t(te), t=torch.from_numpy(t),
                        noise=_t(_jax_noise(rng, video.shape)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_ps.numpy(), np.asarray(want_ps), rtol=1e-4, atol=1e-6)
    # the model's loss: the same objective without sample weights
    np.testing.assert_allclose(plain.item(), float(np.mean(np.asarray(want_ps) * np.asarray(
        jm.diffusion.schedule.loss_weight("pred_v", True)[t]))), rtol=1e-4, atol=1e-6)


def test_ema_decay_matches_jax():
    for cfg in (jts.EMAConfig(), jts.EMAConfig(update_after_step=3, inv_gamma=2.0, power=0.5,
                                               min_value=0.1, beta=0.99)):
        tcfg = tts.EMAConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        for step in (0, 1, 2, 3, 4, 10, 1000, 10 ** 6):
            assert tts.ema_decay(step, tcfg) == pytest.approx(
                float(jts.ema_decay(jnp.asarray(step), cfg)), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("name", ["uniform", "loss-second-moment"])
def test_resamplers_match_jax(name):
    """Same numpy seed, same losses: the same timesteps and weights, before
    and after the second-moment sampler warms up."""
    js, ts = jrs.create_named_schedule_sampler(name, 5), trs.create_named_schedule_sampler(name, 5)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(30):
        jt, jw = js.sample(4, jr)
        tt, tw = ts.sample(4, tr)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tw, jw)
        losses = np.abs(np.sin(jt + i)).astype(np.float32)
        js.update_with_losses(jt, losses)
        ts.update_with_losses(tt, losses)
    if name != "uniform":
        assert ts._warmed_up() and np.array_equal(ts.weights(), js.weights())


@pytest.mark.parametrize("grad_clip", [1.0, 1e-6], ids=["clip_default", "clip_engaged"])
def test_trainer_steps_match_jax(tmp_path, grad_clip):
    """Three steps of the port's `VideoModelTrainer` against JAX
    `VideoModelTrainer._train_step` from the same weights, batches, timesteps
    and noise, both on the plain path (what both resolve to on the CPU).

    - loss and per-sample losses: rtol 1e-4;
    - pre-clip gradients at every step: the U-Net tolerance, rtol 5e-4 /
      atol 5e-5;
    - each step's update p_after - p_before: rtol 1e-3 / atol 1e-3*lr plus two
      float32 ulps of the weight (both updates are differences of float32
      weights), on the
      elements whose gradient is well determined (|g| >= 1e-4, twice the
      gradient atol) at every step so far, and the EMA there within the
      same atol and a few float32 ulps of the weight (rtol 2e-6). Adam
      moves every element by about lr whatever its gradient's size, so a
      near-zero gradient of either sign moves it by +-lr: elsewhere the
      parameters and the EMA are compared within 2*lr absolute.

    The global gradient norm is 0.18, 0.85 and 1.41 on the three steps, so
    the default clip (1.0) engages on the third. With grad_clip 1e-6 it
    engages on every step and the clipped gradients are of the size of
    Adam's eps, so the clip's scale shows in every update. About a quarter
    of the weights have gradients of 1e-4 and more; at this size the rest
    (the time-embedding and text-pooling paths) have gradients below 1e-8."""
    jm, tm = _models()
    cfg = dict(batch_size=2, lr=1e-4, grad_clip=grad_clip)
    jt = jvt.VideoModelTrainer(jm, None, jvt.VideoTrainerConfig(**cfg),
                               workdir=str(tmp_path / "jax"))
    tt = tvt.VideoModelTrainer(tm, None, tvt.VideoTrainerConfig(**cfg),
                               workdir=str(tmp_path / "port"))
    assert tt.train_unet.train_fused is False and tt.train_unet.fused is False

    def loss_fn(p, rng, video, x_cond_n, te, t, w):
        return jm.diffusion.p_losses(lambda x, tt_, e: jt.train_unet.apply(p, x, tt_, e), rng,
                                     video, x_cond_n, te, t=t, sample_weights=w)

    jgrad = jax.jit(jax.grad(loss_fn))
    rs, rng, lr = np.random.RandomState(9), jax.random.PRNGKey(11), cfg["lr"]
    sure, clipped = None, []
    for step in range(3):
        video, x_cond, te = _batch(rs)
        t, w = jt.sampler.sample(2, jt.np_rng)
        tt_t, tt_w = tt.sampler.sample(2, tt.np_rng)
        np.testing.assert_array_equal(t, tt_t)
        rng, sub = jax.random.split(rng)
        x_cond_n = (x_cond * 2 - 1)[:, None]
        jargs = tuple(jnp.asarray(a) for a in (video, x_cond_n, te, t, w))
        targs = (_t(video), _t(x_cond_n), _t(te), torch.from_numpy(t).long(), _t(tt_w))
        noise = _t(_jax_noise(sub, video.shape))
        jg = {k: v.numpy() for k, v in video_tree(jgrad(jt.state.params, sub, *jargs), "").items()}
        norm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for g in jg.values()))
        clipped.append(bool(norm > grad_clip))
        big = {k: np.abs(g) >= 1e-4 for k, g in jg.items()}
        sure = big if sure is None else {k: sure[k] & big[k] for k in big}
        before = {k: v.clone() for k, v in tt.train_unet.state_dict().items()}
        jbefore = {k: v.numpy() for k, v in video_tree(jt.state.params, "").items()}

        loss, ps = tt.loss_and_grads(*targs, noise=noise)
        for k, p in tt.train_unet.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), jg[k], err_msg=k, **GRAD_TOL)
        tt.apply_gradients()
        jt.state, jloss, jps = jt._train_step(jt.state, sub, *jargs)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ps.numpy(), np.asarray(jps), rtol=1e-4, atol=1e-6)

        got, want = tt.train_unet.state_dict(), video_tree(jt.state.params, "")
        gema, wema = tt.state.ema, video_tree(jt.state.ema_params, "")
        for k in want:
            m = sure[k]
            upd, jupd = (got[k] - before[k]).numpy()[m], (want[k].numpy() - jbefore[k])[m]
            # each side's update is a difference of float32 weights: one ulp of the weight
            ulp = np.spacing(np.abs(jbefore[k][m]).astype(np.float32))
            bad = np.abs(upd - jupd) > 1e-3 * np.abs(jupd) + 1e-3 * lr + 2 * ulp
            assert not bad.any(), (k, upd[bad][:4], jupd[bad][:4])
            np.testing.assert_allclose(gema[k].numpy()[m], wema[k].numpy()[m], rtol=2e-6,
                                       atol=1e-3 * lr, err_msg=f"ema {k}")
            for name, g_, w_ in (("params", got, want), ("ema", gema, wema)):
                np.testing.assert_allclose(g_[k].numpy(), w_[k].numpy(), rtol=0, atol=2 * lr,
                                           err_msg=f"{name} {k}")
    assert clipped == ([True] * 3 if grad_clip < 1.0 else [False, False, True])
    n_sure = sum(int(m.sum()) for m in sure.values())
    assert n_sure > 0.15 * sum(m.size for m in sure.values()), n_sure
    assert tt.step == int(jt.state.step) == 3
    tt.close()


def test_trainer_checkpoint_and_publish(tmp_path):
    """save -> load restores step, parameters, optimizer state and EMA; the
    label and n_saves rules are the JAX package's; `publish_ema` puts the
    EMA weights into the model."""
    _, tm = _models()
    cfg = tvt.VideoTrainerConfig(batch_size=2, n_train_steps=4, n_saves=2)
    tr = tvt.VideoModelTrainer(tm, None, cfg, workdir=str(tmp_path))
    rs = np.random.RandomState(2)
    for step in range(3):
        video, x_cond, te = _batch(rs)
        tr.train_step(_t(video), _t((x_cond * 2 - 1)[:, None]), _t(te), torch.tensor([1, 3]),
                      torch.ones(2))
        tr.save()  # labels step // 2 * 2: 0, 2, 2
    assert tck.available_labels(str(tmp_path)) == [0, 2] and tck.latest_label(str(tmp_path)) == 2
    saved = {k: v.clone() for k, v in tr.train_unet.state_dict().items()}
    ema = {k: v.clone() for k, v in tr.state.ema.items()}
    with torch.no_grad():
        for p in tr.train_unet.parameters():
            p.zero_()
    tr.state.step = 0
    tr.load()
    assert tr.step == 3 and tr.state.optimizer.state_dict()["state"]
    for k, v in tr.train_unet.state_dict().items():
        assert torch.equal(v, saved[k])
    tr.publish_ema()
    for k, v in tm.unet.state_dict().items():
        assert torch.equal(v, ema[k])
    tr.close()


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """`use_checkpoint` and the mesh are ported (`tests/test_torch_remat.py`,
    `tests/test_torch_parallel.py`): the trainer builds with checkpointing
    (its U-Net carries the policy, `train_fused` off by the JAX rule), and
    refuses an unknown policy and a mesh object of the wrong type."""
    _, tm = _models()
    tr = tvt.VideoModelTrainer(tm, None, tvt.VideoTrainerConfig(use_checkpoint=True),
                               workdir=str(tmp_path))
    assert tr.train_unet.use_checkpoint and tr.train_unet.remat_policy == "blocks"
    assert tr.train_unet.train_fused is False
    tr.close()
    with pytest.raises(ValueError, match="remat_policy"):
        tvt.VideoModelTrainer(tm, None, tvt.VideoTrainerConfig(
            use_checkpoint=True, remat_policy="none"), workdir=str(tmp_path))
    with pytest.raises(TypeError, match="Mesh"):
        tvt.VideoModelTrainer(tm, None, workdir=str(tmp_path), mesh=object())
