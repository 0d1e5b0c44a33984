"""The port's video side against the JAX package, on the CPU in float32.

Weights: a JAX parameter tree of seeded numpy arrays (shapes from
`jax.eval_shape` of the flax init, values random so that biases and norm
affines are not trivial), carried into the port by `convert/from_jax.py`.
Inputs come from numpy seeds and go to both packages.
"""

import functools
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu.models import clip_text as jclip  # noqa: E402
from v2a_tpu.models import perceiver as jperc  # noqa: E402
from v2a_tpu.models import video_model as jvm  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu.ops import schedules as jsch  # noqa: E402
from v2a_tpu_torch.convert.from_jax import video_tree, video_model_from_jax  # noqa: E402
from v2a_tpu_torch.models import clip_text as tclip  # noqa: E402
from v2a_tpu_torch.models import perceiver as tperc  # noqa: E402
from v2a_tpu_torch.models import video_model as tvm  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.ops import schedules as tsch  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-4)
UNET_TOL = dict(atol=5e-4, rtol=1e-3)  # the JAX package's fused-vs-plain tolerance


def random_params(module, *args, seed=0, **kwargs):
    """A flax module's parameter tree, filled with seeded numpy values."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rs = np.random.RandomState(seed)

    def fill(path, sd):
        name, shape = path[-1].key, sd.shape
        if name in ("scale", "g", "q_scale", "k_scale"):
            return (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rs.randn(*shape)).astype(np.float32)
        if "temporal_conv" in str(path):  # near-identity (k, C, C)
            eye = np.zeros(shape, np.float32)
            eye[shape[0] // 2] = np.eye(shape[1])
            return (eye + 0.05 * rs.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rs.randn(*shape) / math.sqrt(max(fan_in, shape[-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def japply(module, params, *args, **static):
    """The JAX forward, compiled once (eager dispatch compiles per op)."""
    return jax.jit(functools.partial(module.apply, **static))(params, *args)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _load(module, params):
    module.load_state_dict(video_tree(params, ""), strict=True)
    return module.eval().requires_grad_(False)


def test_timestep_embedding_orders_cos_then_sin():
    t = np.array([0, 3, 17, 99])
    for dim in (128, 33):
        want = np.asarray(jvu.timestep_embedding(jnp.asarray(t), dim))
        got = tvu.timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert got[0, 0] == 1.0 and got[0, 16] == 0.0  # cos(0) first, sin(0) second half


@pytest.mark.parametrize("form", ["plain", "stats", "affine"])
def test_group_norm32_matches_jax(form):
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 3, 4, 4, 64) * 3 + 1).astype(np.float32)
    stats = np.stack([x.sum((1, 2, 3)), (x * x).sum((1, 2, 3))], 1)
    jm = jvu.GroupNorm32(with_silu=True)
    params = random_params(jm, jnp.asarray(x))
    want = japply(jm, params, jnp.asarray(x), jnp.asarray(stats) if form == "stats" else None,
                  return_affine=form == "affine")
    tm = _load(tvu.GroupNorm32(64, with_silu=True), params)
    got = tm(_t(x), stats=_t(stats) if form == "stats" else None,
             return_affine=form == "affine")
    if form == "affine":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_stats", [False, True])
def test_attention_block_matches_jax(with_stats):
    """Legacy qkv layout, ch^-1/4 on both q and k, per-(b, f) norm, stats out."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 2, 4, 4, 64).astype(np.float32)
    xf = x.reshape(2, 2, 16, 64)
    stats = np.stack([xf.sum(2), (xf * xf).sum(2)], 2) if with_stats else None
    jm = jvu.SpatialAttentionBlock(num_head_channels=32)
    params = random_params(jm, jnp.asarray(x))
    want = japply(jm, params, jnp.asarray(x), None if stats is None else jnp.asarray(stats),
                  want_stats=with_stats)
    got = _load(tvu.SpatialAttentionBlock(64, 32), params)(
        _t(x), None if stats is None else _t(stats), with_stats)
    if with_stats:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-3)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_perceiver_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 64).astype(np.float32)
    jm = jperc.PerceiverResampler(dim=64, depth=2)
    params = random_params(jm, jnp.asarray(x))
    want = japply(jm, params, jnp.asarray(x))
    got = _load(tperc.PerceiverResampler(dim=64, depth=2), params)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_text_matches_jax():
    tasks = ["pick_up the-black bowl", "open the top drawer of the cabinet"]
    assert tclip.sanitize_task_strings(tasks) == jclip.sanitize_task_strings(tasks)
    ids, mask = tclip.HashTokenizer()(tclip.sanitize_task_strings(tasks))
    jids, jmask = jclip.HashTokenizer()(jclip.sanitize_task_strings(tasks))
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    jm = jclip.ClipTextEncoder(width=64, layers=2, heads=8, mlp_dim=256)
    params = random_params(jm, jnp.asarray(jids), jnp.asarray(jmask))
    want = japply(jm, params, jnp.asarray(jids), jnp.asarray(jmask))
    tm = _load(tclip.ClipTextEncoder(width=64, layers=2, heads=8, mlp_dim=256), params)
    got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # causal: a token's state ignores later tokens
    ids2 = ids.copy()
    ids2[1, 4] = 7
    got2 = tm(torch.from_numpy(ids2), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got2[1, :4], got.numpy()[1, :4], atol=1e-6)


@pytest.mark.parametrize("name", ["linear", "cosine", "sigmoid", "squaredcos_cap_v2"])
def test_schedules_match_jax(name):
    want = jsch.DiffusionSchedule.create(100, name)
    got = tsch.DiffusionSchedule.create(100, name)
    for field in ("betas", "alphas_cumprod", "posterior_log_variance_clipped",
                  "posterior_mean_coef1", "posterior_mean_coef2", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.loss_weight("pred_v", True).numpy(),
                               np.asarray(want.loss_weight("pred_v", True)), rtol=1e-6)
    t = np.array([0, 5, 99])
    np.testing.assert_array_equal(
        tsch.extract(got.betas, torch.from_numpy(t), 3).shape, (3, 1, 1))


def _unet_inputs(hw, mc_tok=64, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(1, 2, hw, hw, 6).astype(np.float32), np.array([5]),
            rs.randn(1, 4, mc_tok).astype(np.float32))


def test_video_unet_plain_matches_jax():
    kw = dict(in_channels=6, model_channels=32, out_channels=3, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(16)
    jm = jvu.VideoUNet(**kw)
    params = random_params(jm, x, t, tok)
    want = japply(jm, params, x, t, tok)
    got = _load(tvu.VideoUNet(**kw), params)(_t(x), torch.from_numpy(t), _t(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


@pytest.mark.parametrize("mc,hw,n_k1,n_k2", [(128, 8, 21, 19), (128, 24, 21, 19),
                                              (64, 8, 10, 11)])
def test_video_unet_fused_routing_matches_jax(mc, hw, n_k1, n_k2, monkeypatch):
    """The unpadded fused routing (K1 at every 128-multiple 3x3 conv, incl.
    the split-skip up blocks and the upsample conv; K2 at every temporal
    conv; the statistics chain) against JAX fused=True with the padded
    stream off. 24x24 (576 pixels > 512) engages the banded K1 body on the
    JAX side. At mc 64
    only the 128-channel level routes to the kernels; the 64-channel blocks
    take the fused branches that materialize the norm instead."""
    monkeypatch.setattr(jvu, "PERF_PADDED_STREAM", False)
    kw = dict(in_channels=6, model_channels=mc, out_channels=3, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(hw, seed=hw)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=hw)
    want = japply(jvu.VideoUNet(fused=True, **kw), params, x, t, tok)
    tm = _load(tvu.VideoUNet(fused=True, routing=tvu.ConvRouting(padded_stream=False), **kw),
               params)
    calls = {"k1": 0, "k2": 0}
    orig1, orig2 = tvu.rk.fused_affine_conv3x3, tvu.rk.temporal_conv_fused

    def k1(*a, **k):
        calls["k1"] += 1
        return orig1(*a, **k)

    def k2(*a, **k):
        calls["k2"] += 1
        return orig2(*a, **k)

    monkeypatch.setattr(tvu.rk, "fused_affine_conv3x3", k1)
    monkeypatch.setattr(tvu.rk, "temporal_conv_fused", k2)
    got = tm(_t(x), torch.from_numpy(t), _t(tok))
    # mc 128: K1 at 2 down + 2 mid + 4 up ResBlocks x 2 convs, +1 per split
    # up in_conv, +1 upsample conv; K2 at every pseudo-3D conv but the head
    assert calls == {"k1": n_k1, "k2": n_k2}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


# -- the sampler -----------------------------------------------------------------

SMALL = dict(image_size=(8, 8), sample_per_seq=3, timesteps=4, model_channels=32,
             channel_mult=(1,), num_res_blocks=1, attention_resolutions=(),
             num_head_channels=32, text_dim=64)


def _models(sampling_timesteps, var_temp=1.0, guidance_weight=0.0, seed=0):
    jcfg = jvm.VideoModelConfig(sampling_timesteps=sampling_timesteps, var_temp=var_temp,
                                guidance_weight=guidance_weight, fused=False, **SMALL)
    jm = jvm.VideoPredModel(jcfg)
    f, (h, w) = jcfg.video_future_horizon, jcfg.image_size
    unet = random_params(jm.unet, np.zeros((1, f, h, w, 6), np.float32), np.zeros((1,), np.int32),
                         np.zeros((1, 4, 64), np.float32), seed=seed)
    text = random_params(jm.text_encoder, np.zeros((1, 4), np.int32), np.ones((1, 4), np.int32),
                         seed=seed + 1)
    jm.params = {"unet": unet, "text": text}
    tcfg = tvm.VideoModelConfig(sampling_timesteps=sampling_timesteps, var_temp=var_temp,
                                guidance_weight=guidance_weight, **SMALL)
    tm = tvm.VideoPredModel(tcfg, device="cpu")
    tm.load_state_dict(video_model_from_jax(unet, text))
    return jm, tm


def _chain_inputs(jm, seed=3):
    rs = np.random.RandomState(seed)
    cfg = jm.config
    shape = (2, cfg.video_future_horizon) + tuple(cfg.image_size) + (3,)
    frames = rs.rand(2, *cfg.image_size, 3).astype(np.float32)
    return shape, frames, rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("sampler", ["ancestral_var_temp0", "ddim_eta0"])
def test_short_chain_matches_jax_in_pixels(sampler):
    ddim = sampler.startswith("ddim")
    jm, tm = _models(sampling_timesteps=2 if ddim else 4, var_temp=0.0)
    assert tm.diffusion.is_ddim_sampling == ddim
    shape, frames, x_t = _chain_inputs(jm)
    tasks = ["pick up the bowl", "open-the drawer"]
    te = np.asarray(jm.encode_batch_text(jm.params, tasks))
    te_port = tm.encode_batch_text(tasks).numpy()
    np.testing.assert_allclose(te_port, te, **TOL)
    x_cond = (frames * 2 - 1)[:, None]
    fn = jm.diffusion.ddim_sample if ddim else jm.diffusion.p_sample_loop
    want = fn(jm._model_fn(jm.params["unet"]), jax.random.PRNGKey(0), shape,
              jnp.asarray(x_cond), jnp.asarray(te), init_noise=jnp.asarray(x_t))
    got = tm.sample(frames, tasks, init_noise=_t(x_t))  # clamps to [0, 1]
    np.testing.assert_allclose(got.numpy(), np.clip(np.asarray(want), 0, 1), atol=2e-3)


def test_ancestral_noise_term_matches_q_posterior():
    """One ancestral step with shared noise: mean + exp(log_var / 2) * noise
    * var_temp, with the posterior from the same x0 and x_t."""
    jm, tm = _models(sampling_timesteps=4, var_temp=0.7)
    shape, frames, x_t = _chain_inputs(jm)
    noise = np.random.RandomState(9).randn(*shape).astype(np.float32)
    te = np.random.RandomState(10).randn(2, 5, 64).astype(np.float32)
    x_cond = (frames * 2 - 1)[:, None]
    t = 2
    jd, tvec = jm.diffusion, jnp.full((2,), t, jnp.int32)

    @jax.jit
    def posterior(unet_params, x_t, x_cond, te):
        preds = jd.model_predictions(jm._model_fn(unet_params), x_t, tvec, x_cond, te)
        x0 = jnp.clip(preds.pred_x_start, -1, 1)
        return (x0,) + jd.q_posterior(x0, x_t, tvec)

    x0, mean, log_var = posterior(jm.params["unet"], jnp.asarray(x_t), jnp.asarray(x_cond),
                                  jnp.asarray(te))
    tmean, tlog_var = tm.diffusion.q_posterior(_t(x0), _t(x_t), torch.full((2,), t))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), **TOL)
    np.testing.assert_allclose(tlog_var.numpy(), np.asarray(log_var), **TOL)
    want = np.asarray(mean + jnp.exp(0.5 * log_var) * (jnp.asarray(noise) * 0.7))
    with torch.no_grad():
        got = tm.diffusion.p_step(tm.unet, _t(x_t), t, _t(x_cond), _t(te), _t(noise))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def test_classifier_free_guidance_matches_jax():
    """pred_v with guidance: one batch-doubled forward, the second half with a
    zeroed task embedding, guidance applied in epsilon space."""
    jm, tm = _models(sampling_timesteps=4, guidance_weight=0.7)
    shape, frames, x_t = _chain_inputs(jm)
    te = np.random.RandomState(10).randn(2, 5, 64).astype(np.float32)
    x_cond = (frames * 2 - 1)[:, None]
    t = np.array([3, 1])
    want = jax.jit(lambda p, *a: jm.diffusion.model_predictions(jm._model_fn(p), *a))(
        jm.params["unet"], jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(x_cond),
        jnp.asarray(te))
    with torch.no_grad():
        got = tm.diffusion.model_predictions(tm.unet, _t(x_t), torch.from_numpy(t),
                                             _t(x_cond), _t(te))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3)


def test_sample_u8_truncates():
    v = torch.tensor([0.0, 0.999, 0.5, 1.0, 1.3, -0.2])
    assert tvm.quantize_u8(v).tolist() == [0, 254, 127, 255, 255, 0]


def test_video_model_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvm.VideoPredModel(tvm.VideoModelConfig(**SMALL))
