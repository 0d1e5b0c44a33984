"""The video model's environment families (MW / Thor / Bridge) in the port
against the JAX package, on the CPU.

- The presets equal the JAX package's field by field; the env families'
  action ranges equal its normalizer constants.
- Thor, Bridge and MW-flow at the JAX test's shrunken sizes
  (`tests/test_env_variants.py`), each keeping its trait: Thor 3 res blocks,
  Bridge 3 res blocks at 12x16 (H != W), MW-flow 2 predicted channels on a
  3-channel condition. One set of weights (seeded numpy, through
  `convert/from_jax.py`) and shared x_T: a 2-step DDIM chain equal in
  pixels (atol 2e-3, as `test_torch_video.py::
  test_short_chain_matches_jax_in_pixels`).
- A Thor-structured U-Net (mc 128, 24x24, mult (1, 2), 3 res blocks: four
  up blocks a level) through the port's fused routing (the kernels' plain
  versions on the CPU) against JAX `fused=True` with the shipped flags, the
  same launches per kernel (UNET_TOL).
- Each variant at full width (B=1, F=7, bf16) under each routing of
  `chip_smoke.py`'s model-family phase: the port's launches per kernel on
  the meta device equal the JAX package's from `jax.eval_shape` and the
  counts pinned here (`chip_smoke.VARIANT_FORWARD` holds the card to
  them); every launch plan fits at every call, at B=1 and B=8, as
  `tests/test_torch_conv_plans.py` holds the release calls' plans.
"""

import dataclasses
import functools
import importlib.util
import inspect
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_conv_plans import (  # noqa: E402
    _check_attention_plan, _check_k1_plan, _check_k5_plan, _check_k7_plan, _check_tconv_plan,
)
from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_padded import PACKAGE_KERNELS, _counting, _jax_defaults, _jax_module  # noqa: E402
from test_torch_serving_routes import ROUTES  # noqa: E402
from test_torch_video import UNET_TOL, _load, japply, random_params  # noqa: E402
from v2a_tpu.models import env_variants as jev  # noqa: E402
from v2a_tpu.models import normalizer as jnorm  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu_torch.convert.from_jax import video_model_from_jax  # noqa: E402
from v2a_tpu_torch.models import env_variants as tev  # noqa: E402
from v2a_tpu_torch.models import normalizer as tnorm  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.ops import resblock_kernels as trk  # noqa: E402

VARIANTS = ("thor", "bridge", "mw_flow")
# the JAX test's shrunken sizes, and what each variant keeps of its own
SHRINK = dict(image_size=(16, 16), sample_per_seq=3, model_channels=32, num_res_blocks=1,
              channel_mult=(1, 2), attention_resolutions=(2,), text_dim=64, timesteps=10,
              sampling_timesteps=2)
TRAITS = {"thor": dict(num_res_blocks=3), "bridge": dict(image_size=(12, 16), num_res_blocks=3),
          "mw_flow": {}}


def test_presets_match_jax():
    assert tev.VIDEO_MODEL_VARIANTS.keys() == jev.VIDEO_MODEL_VARIANTS.keys()
    for name, jcfg in jev.VIDEO_MODEL_VARIANTS.items():
        tcfg = tev.VIDEO_MODEL_VARIANTS[name]
        for field in dataclasses.fields(jcfg):
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name), (name, field.name)
    for module in (jev, tev):
        with pytest.raises(KeyError):
            module.video_model_variant("nope")


def test_normalizer_constants_match_jax():
    names = ("LB_ACTION_MIN", "LB_ACTION_MAX", "LB_ACTION_MIN_ORN01", "LB_ACTION_MAX_ORN01",
             "MW_SAWYER_ACTION_MIN", "MW_SAWYER_ACTION_MAX", "THOR_ACTION_MIN_DIM4",
             "THOR_ACTION_MAX_DIM4", "CAL_ACTION_MIN", "CAL_ACTION_MAX", "CAL_ABS_ACTION_MIN",
             "CAL_ABS_ACTION_MAX", "TASK_EMBED_MIN", "TASK_EMBED_MAX", "IMAGE_MIN", "IMAGE_MAX")
    for name in names:
        want, got = getattr(jnorm, name), getattr(tnorm, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def load_pair(jm, tm, seed=0):
    """Seeded numpy weights into a JAX `VideoPredModel` and the port's."""
    cfg = jm.config
    f, (h, w) = cfg.video_future_horizon, cfg.image_size
    cin = cfg.channels + (cfg.cond_channels or cfg.channels)
    unet = random_params(jm.unet, np.zeros((1, f, h, w, cin), np.float32),
                         np.zeros((1,), np.int32), np.zeros((1, 4, cfg.text_dim), np.float32),
                         seed=seed)
    text = random_params(jm.text_encoder, np.zeros((1, 4), np.int32), np.ones((1, 4), np.int32),
                         seed=seed + 1)
    jm.params = {"unet": unet, "text": text}
    tm.load_state_dict(video_model_from_jax(unet, text))


def chain_matches_jax(jm, tm, seed=3):
    """A chain from shared x_T on two tasks, JAX against the port, in pixels
    (atol 2e-3); returns the port's video."""
    cfg = jm.config
    cond_ch = cfg.cond_channels or cfg.channels
    rs = np.random.RandomState(seed)
    shape = (2, cfg.video_future_horizon) + tuple(cfg.image_size) + (cfg.channels,)
    frames = rs.rand(2, *cfg.image_size, cond_ch).astype(np.float32)
    x_t = rs.randn(*shape).astype(np.float32)
    tasks = ["pick up the bowl", "open-the drawer"]
    te = jm.encode_batch_text(jm.params, tasks)
    x_cond = jnp.asarray((frames * 2 - 1)[:, None])
    fn = jm.diffusion.ddim_sample if tm.diffusion.is_ddim_sampling else jm.diffusion.p_sample_loop
    want = jax.jit(lambda p, xc, e, x: fn(jm._model_fn(p), jax.random.PRNGKey(0), shape, xc, e,
                                          init_noise=x))(jm.params["unet"], x_cond, te,
                                                         jnp.asarray(x_t))
    got = tm.sample(frames, tasks, init_noise=torch.from_numpy(x_t))
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.clip(np.asarray(want), 0, 1), atol=2e-3)
    return got


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_chain_matches_jax_in_pixels(name):
    kw = dict(SHRINK, **TRAITS[name])
    jm = jev.video_model_variant(name, fused=False, **kw)
    tm = tev.video_model_variant(name, device="cpu", **kw)
    assert tm.config == dataclasses.replace(tev.VIDEO_MODEL_VARIANTS[name], **kw)
    assert tm.diffusion.is_ddim_sampling and not tm.unet.fused
    load_pair(jm, tm)
    chain_matches_jax(jm, tm)


# K3 at every 24x24 ResBlock conv (2 x 3 down, 2 x 4 up, the up blocks'
# skip folds inside); K5 then K4b for the upsample into it
THOR_SMALL_COUNTS = {"fused_affine_conv3x3": 22, "temporal_conv_fused": 20,
                     "fused_conv_tconv_padded": 14, "temporal_conv_padded": 1,
                     "fused_upconv3x3_padded": 1}


def test_thor_structured_unet_matches_jax_default_routing(monkeypatch):
    """mc 128, mult (1, 2), 3 res blocks, attention at ds 2, 24x24, F=2: the
    24x24 level on the padded stream (K3 in its ResBlock convs, including
    the four two-part up blocks' skip folds; K5 + K4b into it), the 12x12
    level K1 / K2, as the JAX package with its shipped flags."""
    from test_torch_video import _unet_inputs

    _jax_defaults(monkeypatch)
    kw = dict(in_channels=6, model_channels=128, out_channels=3, num_res_blocks=3,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=32,
              task_token_dim=64)
    x, t, tok = _unet_inputs(24, seed=19)
    params = random_params(jvu.VideoUNet(**kw), x, t, tok, seed=19)
    jcalls = _counting(monkeypatch, _jax_module, PACKAGE_KERNELS)
    want = japply(jvu.VideoUNet(fused=True, **kw), params, x, t, tok)
    tcalls = _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS)
    got = _load(tvu.VideoUNet(fused=True, **kw), params)(torch.from_numpy(x),
                                                         torch.from_numpy(t),
                                                         torch.from_numpy(tok))
    assert jcalls == tcalls == THOR_SMALL_COUNTS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


# -- the variants at full width: launches per forward, and the plans ------------------

# chip_smoke.py's model-family routings: (JAX flags, JAX VideoUNet kwargs,
# port kwargs)
FAMILY_ROUTES = {"padded": (dict(), dict(fused=True), dict(fused=True))}
FAMILY_ROUTES.update({r: ROUTES[r] for r in ("padded_k8_k9", "plain_k7", "spatial_k10_k11",
                                             "padded_k12")})
# launches per B=1 forward, per variant and routing (chip_smoke.VARIANT_FORWARD)
VARIANT_COUNTS = {
    # 64^2 and 32^2 padded (C 128 / 256), K1 / K2 at 16^2 (C 512); four up
    # blocks a level
    "thor": {
        "padded": {"fused_affine_conv3x3": 22, "temporal_conv_fused": 21,
                   "fused_conv_tconv_padded": 21, "fused_affine_conv3x3_padded": 7,
                   "temporal_conv_padded": 9, "fused_upconv3x3_padded": 2},
        "padded_k8_k9": {"fused_affine_conv3x3": 22, "temporal_conv_fused": 20,
                         "fused_conv_tconv_padded": 21, "fused_affine_conv3x3_padded": 7,
                         "temporal_conv_padded": 10, "fused_upconv3x3_padded": 2,
                         "fused_downconv3x3_padded": 1, "fused_spatial_attention_padded": 8},
        "plain_k7": {"fused_group_norm_silu": 55},
        "spatial_k10_k11": {"spatial_conv3x3": 60, "temporal_conv_fused_hw": 51},
        "padded_k12": {"fused_affine_conv3x3": 22, "temporal_conv_fused": 21,
                       "fused_conv_tconv_stream": 19, "fused_conv_tconv_padded": 5,
                       "fused_affine_conv3x3_padded": 4, "temporal_conv_padded": 6,
                       "fused_upconv3x3_padded": 2},
    },
    # K1 / K2 at 12x16 (C 640); the 24x32 up level padded from K5's output
    # (C 640 in, 320 out: K4a -> K4b); C 160 / 320 elsewhere to the library
    "bridge": {
        "padded": {"fused_affine_conv3x3": 19, "temporal_conv_fused": 18,
                   "fused_affine_conv3x3_padded": 8, "temporal_conv_padded": 9,
                   "fused_upconv3x3_padded": 1},
        "padded_k8_k9": {"fused_affine_conv3x3": 19, "temporal_conv_fused": 18,
                         "fused_affine_conv3x3_padded": 8, "temporal_conv_padded": 9,
                         "fused_upconv3x3_padded": 1, "fused_spatial_attention_padded": 8},
        "plain_k7": {"fused_group_norm_silu": 55},
        "spatial_k10_k11": {"spatial_conv3x3": 20, "temporal_conv_fused_hw": 19},
        "padded_k12": {"fused_affine_conv3x3": 19, "temporal_conv_fused": 18,
                       "fused_conv_tconv_stream": 4, "fused_affine_conv3x3_padded": 4,
                       "temporal_conv_padded": 5, "fused_upconv3x3_padded": 1},
    },
    # the release U-Net with a 5-channel entry and a 2-channel output: the
    # release counts (neither end conv takes a kernel)
    "mw_flow": {
        "padded": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30,
                   "fused_conv_tconv_padded": 16, "fused_affine_conv3x3_padded": 14,
                   "temporal_conv_padded": 17, "fused_upconv3x3_padded": 3},
        "padded_k8_k9": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 28,
                         "fused_conv_tconv_padded": 16, "fused_affine_conv3x3_padded": 14,
                         "temporal_conv_padded": 19, "fused_upconv3x3_padded": 3,
                         "fused_downconv3x3_padded": 2, "fused_spatial_attention_padded": 11},
        "plain_k7": {"fused_group_norm_silu": 66},
        "spatial_k10_k11": {"spatial_conv3x3": 73, "temporal_conv_fused_hw": 63},
        "padded_k12": {"fused_affine_conv3x3": 31, "temporal_conv_fused": 30,
                       "fused_conv_tconv_stream": 19, "fused_conv_tconv_padded": 5,
                       "fused_affine_conv3x3_padded": 6, "temporal_conv_padded": 9,
                       "fused_upconv3x3_padded": 3},
    },
}


def unet_kw(name):
    """The variant's U-Net arguments at full width."""
    cfg = tev.VIDEO_MODEL_VARIANTS[name]
    return dict(in_channels=cfg.channels + cfg.cond_ch, out_channels=cfg.channels,
                model_channels=cfg.model_channels, channel_mult=cfg.channel_mult,
                num_res_blocks=cfg.num_res_blocks,
                attention_resolutions=cfg.attention_resolutions,
                num_head_channels=cfg.num_head_channels, task_token_dim=cfg.text_dim)


def _meta_forward(name, b, **routing):
    cfg = tev.VIDEO_MODEL_VARIANTS[name]
    kw = unet_kw(name)
    with torch.device("meta"), torch.no_grad():
        out = tvu.VideoUNet(dtype=torch.bfloat16, **kw, **routing)(
            torch.randn((b, cfg.video_future_horizon) + cfg.image_size + (kw["in_channels"],)),
            torch.zeros(b, dtype=torch.long), torch.randn(b, 77, cfg.text_dim))
    assert tuple(out.shape) == (b, cfg.video_future_horizon) + cfg.image_size + (cfg.channels,)


@functools.lru_cache(maxsize=None)
def _jax_args(name):
    cfg = tev.VIDEO_MODEL_VARIANTS[name]
    kw = unet_kw(name)
    x = jnp.zeros((1, cfg.video_future_horizon) + cfg.image_size + (kw["in_channels"],),
                  jnp.bfloat16)
    t, tok = jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, cfg.text_dim))
    params = jax.eval_shape(lambda: jvu.VideoUNet(dtype=jnp.bfloat16, **kw).init(
        jax.random.PRNGKey(0), x, t, tok))
    return params, x, t, tok


# the abstract outputs of the JAX package's kernel wrappers by call signature:
# a wrapper's outputs are a function of its arguments' shapes, dtypes and
# static values, so each signature's pallas_call is traced once for all
# the traces below (half their time); every call is still counted
_JAX_OUTPUTS = {}


def _counting_jax(monkeypatch):
    calls = {}

    def leaf_key(v):
        return ("array", tuple(v.shape), str(v.dtype)) if hasattr(v, "dtype") else repr(v)

    def wrap(name):
        fn = getattr(_jax_module(name), name)

        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            leaves, tree = jax.tree_util.tree_flatten((a, k), is_leaf=lambda v: v is None)
            key = (name, repr(tree), tuple(leaf_key(v) for v in leaves))
            if key not in _JAX_OUTPUTS:
                out = fn(*a, **k)
                outs, out_tree = jax.tree_util.tree_flatten(out)
                _JAX_OUTPUTS[key] = out_tree, [(o.shape, o.dtype) for o in outs]
                return out
            out_tree, outs = _JAX_OUTPUTS[key]
            return jax.tree_util.tree_unflatten(out_tree, [jnp.zeros(s, d) for s, d in outs])
        return counted

    for name in PACKAGE_KERNELS:
        monkeypatch.setattr(_jax_module(name), name, wrap(name))
    return calls


@pytest.mark.parametrize("route", list(FAMILY_ROUTES))
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_counts_match_the_jax_trace(monkeypatch, name, route):
    _jax_defaults(monkeypatch)
    flags, jkw, tkw = FAMILY_ROUTES[route]
    for flag, value in flags.items():
        monkeypatch.setattr(jvu, flag, value)
    jcalls = _counting_jax(monkeypatch)
    jax.eval_shape(jvu.VideoUNet(dtype=jnp.bfloat16, **unet_kw(name), **jkw).apply,
                   *_jax_args(name))
    tcalls = _plans(monkeypatch, name, 1, **tkw)
    assert jcalls == tcalls == VARIANT_COUNTS[name][route]


def _plans(monkeypatch, name, b, **routing):
    """Each kernel's launch plan at every call of one B-sample forward of the
    variant, checked as `tests/test_torch_conv_plans.py` checks the release
    calls' (K3 / K12 as `test_conv_tconv_plan_fits_every_release_call`);
    returns {kernel: number of calls}."""
    calls = {}

    def plan_of(kernel, *a, **k):
        bound = _PLAIN_SIG[kernel].bind(*a, **k).arguments
        calls[kernel] = calls.get(kernel, 0) + 1
        _PLAN_CHECKS[kernel](**bound)

    for kernel in _PLAN_CHECKS:
        module = trk.wrapper_module(kernel)
        plain = getattr(module, kernel + "_plain")

        def wrapped(*a, _kernel=kernel, _plain=plain, **k):
            plan_of(_kernel, *a, **k)
            return _plain(*a, **k)
        monkeypatch.setattr(module, kernel, wrapped)
    _meta_forward(name, b, **routing)
    return calls


def _k3_plan(parts, hw, ring, **_):
    b, f = parts[0][0].shape[:2]
    d = parts[0][1].shape[-1]
    plan = trk.conv_tconv_plan(b, f, hw[0], hw[1], d, ring=ring)
    assert plan.smem <= 227 * 1024 and plan.grid % plan.cluster == 0
    assert plan.cluster == d // (128 if d % 128 == 0 else 64) and plan.stages == 3
    if b == 8:
        assert plan.pixels == 64
    # a CTA per SM where a tile gives one, else the smallest tile (Thor's
    # 32^2 x 256 at B=1: 64 tiles of 16 pixels x a cluster of 2)
    smallest = b * trk._hop_tile(hw[0], hw[1], 16)[2] * plan.cluster
    assert plan.grid >= trk.HOPPER_SMS if smallest >= trk.HOPPER_SMS else plan.pixels == 16


def _spatial(x):
    return int(np.prod(x.shape[1:-1]))


_PLAN_CHECKS = {
    "fused_affine_conv3x3": lambda x, kernel, **_: _check_k1_plan(*x.shape, kernel.shape[-1]),
    "spatial_conv3x3": lambda x, kernel, **_: _check_k1_plan(*x.shape, kernel.shape[-1]),
    "temporal_conv_fused": lambda x, **_: _check_tconv_plan(x.shape[0], x.shape[1],
                                                            _spatial(x[:, 0]), x.shape[-1]),
    "temporal_conv_fused_hw": lambda x, **_: _check_tconv_plan(x.shape[0], x.shape[1],
                                                               _spatial(x[:, 0]), x.shape[-1]),
    "fused_conv_tconv_padded": lambda **k: _k3_plan(ring=False, **k),
    "fused_conv_tconv_stream": lambda **k: _k3_plan(ring=True, **k),
    "fused_affine_conv3x3_padded": lambda parts, hw, **_: _check_k1_plan(
        parts[0][0].shape[0], hw[0], hw[1], sum(trk.widened(p[0].shape[-1]) for p in parts),
        parts[0][1].shape[-1]),
    "temporal_conv_padded": lambda x, hw, **_: _check_tconv_plan(x.shape[0], x.shape[1],
                                                                 hw[0] * hw[1], x.shape[-1]),
    "fused_upconv3x3_padded": lambda x, kernel, hw_lo, **_: _check_k5_plan(
        x.shape[0], hw_lo[0], hw_lo[1], x.shape[-1], kernel.shape[-1]),
    "fused_downconv3x3_padded": lambda x, kernel, hw, **_: _check_k1_plan(
        x.shape[0], hw[0], hw[1], x.shape[-1], kernel.shape[-1], stride=2),
    "fused_spatial_attention_padded": lambda x, hw, num_head_channels, **_: _check_attention_plan(
        x.shape[0], hw[0], hw[1], x.shape[-1], num_head_channels),
    "fused_group_norm_silu": lambda x, **_: _check_k7_plan(x.shape[0], _spatial(x), x.shape[-1]),
}
_PLAIN_SIG = {k: inspect.signature(getattr(trk.wrapper_module(k), k + "_plain"))
              for k in _PLAN_CHECKS}


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_plans_fit_every_call_at_b8(monkeypatch, name):
    """Every routing of the family phase at B=8 (the B=1 forwards are
    checked with the counts): each launch's plan fits, the calls those of
    the pinned counts."""
    for route, (_, _, tkw) in FAMILY_ROUTES.items():
        assert _plans(monkeypatch, name, 8, **tkw) == VARIANT_COUNTS[name][route], route


# launches per B=4 train step through train_fused with K6 as the wgrad (K1's
# forwards and dgrads together; chip_smoke.VARIANT_TRAIN_STEP)
VARIANT_TRAIN_STEP = {"thor": {"fused_affine_conv3x3": 96, "wgrad_conv3x3": 48},
                      "bridge": {"fused_affine_conv3x3": 30, "wgrad_conv3x3": 15}}


@pytest.mark.parametrize("name", list(VARIANT_TRAIN_STEP))
def test_variant_train_step_counts_and_plans(monkeypatch, name):
    """The B=4 train step of `train_fused` with K6, traced on the meta
    device: the launches pinned above; K1's plan at every forward and dgrad
    and K6's `wgrad_plan` at every wgrad fit a CTA, K6's grid with a CTA
    per SM where its tiles allow."""
    calls = _counting(monkeypatch, trk.wrapper_module, PACKAGE_KERNELS, via_plain=True)
    k1, k6 = trk.fused_affine_conv3x3, trk.wgrad_conv3x3

    def conv(x, kernel, *a, **k):
        _check_k1_plan(*x.shape, kernel.shape[-1])
        return k1(x, kernel, *a, **k)

    def wgrad(x, g, *a, **k):
        plan = trk.wgrad_plan(*x.shape, g.shape[-1])
        d = g.shape[-1]
        blocks = (x.shape[-1] // 32) * (d // (128 if d % 128 == 0 else 64))
        assert plan.smem <= trk.HOPPER_SMEM and plan.grid == blocks * plan.chunks
        assert plan.grid >= min(trk.HOPPER_SMS, blocks * plan.tiles)
        return k6(x, g, *a, **k)

    monkeypatch.setattr(trk, "fused_affine_conv3x3", conv)
    monkeypatch.setattr(trk, "wgrad_conv3x3", wgrad)
    cfg, kw = tev.VIDEO_MODEL_VARIANTS[name], unet_kw(name)
    with torch.device("meta"):
        net = tvu.VideoUNet(dtype=torch.bfloat16, train_fused=True, wgrad_kernel=True, **kw)
        y = net(torch.randn((4, 7) + cfg.image_size + (kw["in_channels"],)),
                torch.zeros(4, dtype=torch.long), torch.randn(4, 77, cfg.text_dim))
        y.float().square().mean().backward()
    assert calls == VARIANT_TRAIN_STEP[name]


def test_chip_smoke_holds_the_card_to_these_counts():
    """`chip_smoke.py` phase 11 gates the card on the counts pinned here."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.VARIANT_FORWARD == VARIANT_COUNTS
    assert chip_smoke.VARIANT_TRAIN_STEP == VARIANT_TRAIN_STEP
    assert chip_smoke.FAMILY_ROUTINGS == tuple(FAMILY_ROUTES)
