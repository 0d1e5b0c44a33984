"""The port's reference-checkpoint path against the JAX package's, on the CPU.

Reference checkpoints come from the port's synthetic writer
(`convert/torch_import.py::synthetic_video_checkpoint` /
`synthetic_policy_checkpoint`, numpy `Generator(seed)` values in the
reference's key layout). The same dicts go through the JAX converter
(`v2a_tpu/convert/torch_import.py`, then `convert/from_jax.py`) and the
port's; the results must be equal exactly (a transpose is not rounding),
and forwards on the converted weights agree within the stated tolerances.
"""

import dataclasses
import functools
import importlib.util
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu.convert import torch_import as jti  # noqa: E402
from v2a_tpu.models import clip_text as jclip  # noqa: E402
from v2a_tpu.models import policy as jpolicy  # noqa: E402
from v2a_tpu.models import video_model as jvm  # noqa: E402
from v2a_tpu.models import video_unet as jvu  # noqa: E402
from v2a_tpu_torch.convert import from_jax  # noqa: E402
from v2a_tpu_torch.convert import torch_import as tti  # noqa: E402
from v2a_tpu_torch.models import clip_text as tclip  # noqa: E402
from v2a_tpu_torch.models import policy as tpolicy  # noqa: E402
from v2a_tpu_torch.models import video_model as tvm  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_torch_video.py's
UNET_TOL = dict(atol=5e-4, rtol=1e-3)  # the JAX package's fused-vs-plain tolerance

# the small schema: model_channels 32, mult (1, 2), 1 res block, attention
# at ds 2, 32-wide heads, with task_attnpool (the writer always writes it)
SMALL_VIDEO = dict(image_size=(16, 16), sample_per_seq=3, timesteps=10, sampling_timesteps=3,
                   model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                   attention_resolutions=(2,), num_head_channels=32, text_dim=64)
# the release parameter schema (`lb_video_model_utils.py:33-39`); the tree
# does not depend on the image size or the frame count
RELEASE_VIDEO = dict(image_size=(32, 32), sample_per_seq=3)
# tests/test_torch_policy.py's small policy (the ResNet-18 layout, narrow)
SMALL_POLICY = dict(image_size=(64, 64), down_dims=(32, 64, 128),
                    vision_stage_features=(16, 32, 64, 128))


def _arch(cfg):
    return dict(channel_mult=tuple(cfg.channel_mult), num_res_blocks=cfg.num_res_blocks,
                attention_resolutions=tuple(cfg.attention_resolutions))


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_state_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


class _Recorder(dict):
    """A state dict that records which keys a converter read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


# -- layout transforms ----------------------------------------------------------


@pytest.mark.parametrize("name,shape", [
    ("_np", (3, 4)), ("linear_w", (5, 3)), ("conv2d_w", (4, 3, 3, 3)),
    ("conv1d_w", (4, 3, 5)), ("conv1x1_to_dense", (6, 3, 1)),
    ("convtranspose1d_w", (6, 5, 4)),
])
def test_layout_transforms_match_jax(name, shape):
    w = np.random.default_rng(0).standard_normal(shape, dtype=np.float32)
    for x in (w, torch.from_numpy(w)):
        got, want = getattr(tti, name)(x), getattr(jti, name)(x)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- the video U-Net at the small schema ------------------------------------------


@pytest.fixture(scope="module")
def small_video():
    cfg = tvm.VideoModelConfig(**SMALL_VIDEO)
    ckpt = tti.synthetic_video_checkpoint(cfg, seed=3)
    jtree = jti.convert_video_unet(jti.extract_unet_state(ckpt), **_arch(cfg))
    ttree = tti.convert_video_unet(tti.extract_unet_state(ckpt), **_arch(cfg))
    return cfg, ckpt, jtree, ttree


def test_video_unet_conversion_matches_jax(small_video):
    """The port's converter gives the JAX converter's tree leaf for leaf, and
    the JAX tree through `video_model_from_jax` the port's state dict; every
    key the writer wrote is read."""
    cfg, ckpt, jtree, ttree = small_video
    _assert_trees_equal(ttree, jtree)
    sd = _Recorder(tti.extract_unet_state(ckpt))
    jti.convert_video_unet(sd, **_arch(cfg))
    assert sd.read == set(sd)
    text = {"params": {}}
    want = {k[len("unet."):]: v for k, v in from_jax.video_model_from_jax(jtree, text).items()}
    _assert_state_equal(from_jax.video_tree(ttree), want)
    unet = tvm.VideoPredModel(cfg, device="cpu").unet
    unet.load_state_dict(want, strict=True)


def test_video_unet_forward_on_converted_weights_matches_jax(small_video):
    cfg, _, jtree, ttree = small_video
    kw = dict(in_channels=6, out_channels=3, task_token_dim=cfg.text_dim,
              model_channels=cfg.model_channels, num_head_channels=cfg.num_head_channels,
              **_arch(cfg))
    rs = np.random.RandomState(1)
    x = rs.randn(1, 2, 16, 16, 6).astype(np.float32)
    t = np.array([5])
    tok = rs.randn(1, 4, cfg.text_dim).astype(np.float32)
    want = jax.jit(jvu.VideoUNet(fused=False, **kw).apply)(jtree, x, t, tok)
    net = tvu.VideoUNet(**kw).eval().requires_grad_(False)
    net.load_state_dict(from_jax.video_tree(ttree), strict=True)
    got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


# -- the release schema, without allocating it ------------------------------------


def _broadcast(keys):
    return {k: np.broadcast_to(np.float32(0), shape) for k, (shape, _) in keys.items()}


def _meta_tensor(a):
    return torch.empty(np.shape(a), device="meta")


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _leaves(tree).items()}


def test_release_video_schema_agrees(monkeypatch):
    """The writer's keys and shapes, the JAX converter's tree (against
    `jax.eval_shape` of the JAX model's init) and the port's `meta`-device
    `VideoNets.unet` agree at the release schema; the JAX converter reads
    every key the writer writes."""
    cfg = tvm.VideoModelConfig(**RELEASE_VIDEO)
    sd = _Recorder(_broadcast(tti.reference_video_keys(cfg)))
    jtree = jti.convert_video_unet(sd, **_arch(cfg))
    assert sd.read == set(sd)
    want = jax.eval_shape(jvm.VideoPredModel(jvm.VideoModelConfig(**RELEASE_VIDEO)).init,
                          jax.random.PRNGKey(0))["unet"]
    assert _shapes(jtree) == _shapes(want)
    assert _shapes(tti.convert_video_unet(sd, **_arch(cfg))) == _shapes(jtree)
    monkeypatch.setattr(from_jax, "_tensor", _meta_tensor)
    got = {k: tuple(v.shape) for k, v in from_jax.video_model_from_jax(jtree, {}).items()}
    with torch.device("meta"):
        nets = tvm.VideoNets(tvu.VideoUNet(task_token_dim=cfg.text_dim, **_arch(cfg)),
                             tclip.ClipTextEncoder(width=cfg.text_dim))
    assert got == {k: tuple(v.shape) for k, v in nets.state_dict().items()
                   if k.startswith("unet.")}


def test_release_policy_schema_agrees(monkeypatch):
    """The same for the policy: the writer, the JAX converter (against the
    JAX `DiffusionPolicy`'s init shapes) and the port's `meta` `PolicyNets`."""
    cfg = tpolicy.PolicyConfig()
    sd = _Recorder(_broadcast(tti.reference_policy_keys(cfg)))
    jtree = jti.convert_policy(sd, cfg.obs_keys, cfg.down_dims)
    # `model.*` is read through a sub-dict
    assert sd.read == {k for k in sd if not k.startswith("model.")}
    unet_sd = _Recorder({k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")})
    jti.convert_unet1d(unet_sd, cfg.down_dims)
    assert unet_sd.read == set(unet_sd)
    jp = jpolicy.DiffusionPolicy.create(jpolicy.PolicyConfig())
    want = jax.eval_shape(jp.init, jax.random.PRNGKey(0))
    assert _shapes(jtree) == _shapes(want)
    monkeypatch.setattr(from_jax, "_tensor", _meta_tensor)
    got = {k: tuple(v.shape) for k, v in from_jax.policy_from_jax(jtree).items()}
    with torch.device("meta"):
        nets = tpolicy.PolicyNets(cfg)
    assert got == {k: tuple(v.shape) for k, v in nets.state_dict().items()}


# -- extracting the state dicts ---------------------------------------------------


def _t(*shape):
    return torch.zeros(shape)


VIDEO_DICTS = {
    "trainer": {"ema": {"ema_model.model.unet.input_blocks.0.w": _t(1),
                        "ema_model.model.unet.out.0.weight": _t(2),
                        "ema_model.other": _t(3)}, "step": 5},
    "unet_rooted": {"input_blocks.0.w": _t(1), "out.0.weight": _t(2)},
    "unet_rooted_in_ema": {"ema": {"input_blocks.0.w": _t(1), "time_embed.0.weight": _t(2)}},
    "missing": {"ema": {"model.x": _t(1)}},
}
POLICY_DICTS = {
    "trainer": {"ema": {"ema_model.model.a": _t(1), "other": _t(2)},
                "gcp_model": {"model.a": _t(3)}},
    "ema_without_prefix": {"ema": {"model.a": _t(1)}, "gcp_model": {"model.b": _t(2)}},
    "gcp_only": {"gcp_model": {"model.a": _t(1)}},
    "bare": {"model.a": _t(1), "obs_encoder.b": _t(2)},
}


def _same_result(fn_port, fn_jax, *args, **kw):
    try:
        want = fn_jax(*args, **kw)
    except KeyError:
        with pytest.raises(KeyError):
            fn_port(*args, **kw)
        return
    got = fn_port(*args, **kw)
    assert got.keys() == want.keys() and all(got[k] is want[k] for k in want)


@pytest.mark.parametrize("case", sorted(VIDEO_DICTS))
def test_extract_unet_state_matches_jax(case):
    _same_result(tti.extract_unet_state, jti.extract_unet_state, VIDEO_DICTS[case])


@pytest.mark.parametrize("use_ema", [True, False])
@pytest.mark.parametrize("case", sorted(POLICY_DICTS))
def test_extract_policy_state_matches_jax(case, use_ema):
    _same_result(tti.extract_policy_state, jti.extract_policy_state, POLICY_DICTS[case],
                 use_ema=use_ema)


# -- the CLIP text tower and the tokenizer ----------------------------------------


def test_clip_text_conversion_matches_jax():
    transformers = pytest.importorskip("transformers")
    ccfg = transformers.CLIPTextConfig(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                                       num_attention_heads=2, intermediate_size=128,
                                       max_position_embeddings=77)
    torch.manual_seed(0)
    sd = transformers.CLIPTextModel(ccfg).eval().state_dict()
    jtree = jti.convert_clip_text(sd, layers=2)
    ttree = tti.convert_clip_text(sd, layers=2)
    _assert_trees_equal(ttree, jtree)
    tm = tclip.ClipTextEncoder(vocab_size=1000, width=64, layers=2, heads=2, mlp_dim=128)
    tm.load_state_dict(from_jax.video_tree(ttree), strict=True)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 1000, (2, 9))
    mask = np.ones((2, 9), np.int64)
    mask[1, 6:] = 0
    jm = jclip.ClipTextEncoder(vocab_size=1000, width=64, layers=2, heads=2, mlp_dim=128)
    want = np.asarray(jax.jit(jm.apply)(jtree, jnp.asarray(ids, jnp.int32),
                                        jnp.asarray(mask, jnp.int32)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    # padding positions are garbage in both; compare the valid tokens
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1, :6], want[1, :6], **TOL)


def test_clip_tokenizer_wrapper_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("transformers")
    path = tti.write_synthetic_tokenizer(str(tmp_path / "tok"))
    tasks = tclip.sanitize_task_strings(["pick_up the-black bowl", "open the drawer"])
    tw, jw = tclip.ClipTokenizerWrapper(path), jclip.ClipTokenizerWrapper(path)
    assert tw.is_real and jw.is_real
    (ids, mask), (jids, jmask) = tw(tasks), jw(tasks)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    assert ids.shape[1] > 10 and mask[1].sum() < mask[0].sum()
    # without a path: the hash tokenizer, as the JAX wrapper
    plain = tclip.ClipTokenizerWrapper()
    assert not plain.is_real
    for a, b in zip(plain(tasks), jclip.ClipTokenizerWrapper()(tasks)):
        np.testing.assert_array_equal(a, b)
    # a path given without transformers raises, never the hash tokenizer
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        tclip.ClipTokenizerWrapper(path)


# -- the policy ----------------------------------------------------------------


@pytest.fixture(scope="module")
def small_policy(tmp_path_factory):
    cfg = tpolicy.PolicyConfig(**SMALL_POLICY)
    ckpt = tti.synthetic_policy_checkpoint(cfg, seed=4)
    path = str(tmp_path_factory.mktemp("policy") / "model-1.pt")
    torch.save(ckpt, path)
    return cfg, ckpt, path


@pytest.mark.parametrize("use_ema", [True, False])
def test_policy_conversion_matches_jax(small_policy, tmp_path, use_ema):
    cfg, ckpt, path = small_policy
    jtree = jti.convert_policy(jti.extract_policy_state(ckpt, use_ema), cfg.obs_keys,
                               cfg.down_dims)
    _assert_trees_equal(tti.convert_policy(tti.extract_policy_state(ckpt, use_ema),
                                           cfg.obs_keys, cfg.down_dims), jtree)
    out = str(tmp_path / "policy.pt")
    got = tti.convert_policy_checkpoint(path, out, cfg, use_ema=use_ema)
    _assert_state_equal(got, from_jax.policy_from_jax(jtree))
    _assert_state_equal(torch.load(out, weights_only=True), got)
    tpolicy.DiffusionPolicy.create(cfg, device="cpu").load_state_dict(got)


def test_converted_policy_predicts_as_jax(small_policy, tmp_path):
    """DDIM-8 from the same initial trajectory on the converted weights."""
    cfg, ckpt, path = small_policy
    jtree = jti.convert_policy(jti.extract_policy_state(ckpt), cfg.obs_keys, cfg.down_dims)
    jp = jpolicy.DiffusionPolicy.create(jpolicy.PolicyConfig(**SMALL_POLICY))
    tp = tpolicy.DiffusionPolicy.create(cfg, device="cpu")
    tp.load_state_dict(tti.convert_policy_checkpoint(path, str(tmp_path / "p.pt"), cfg))
    rs = np.random.RandomState(5)
    obs = {k: rs.rand(1, 64, 64, 3).astype(np.float32) for k in cfg.obs_keys}
    rng = jax.random.PRNGKey(11)
    want = jax.jit(jp.predict_action)(jtree, rng, {k: jnp.asarray(v) for k, v in obs.items()})
    _, init_rng = jax.random.split(rng)
    traj0 = np.array(jax.random.normal(init_rng, (1, 16, 7), dtype=jnp.float32))
    got = tp.predict_action({k: torch.from_numpy(v) for k, v in obs.items()},
                            init_noise=torch.from_numpy(traj0))
    np.testing.assert_allclose(got["action_pred"].numpy(), np.asarray(want["action_pred"]),
                               **TOL)


# -- load_converted, make_video_model and the entry points ---------------------------


@pytest.fixture(scope="module")
def small_files(tmp_path_factory, small_video):
    """A synthetic reference `.pt` and the port's converted file of it."""
    cfg, ckpt, jtree, _ = small_video
    d = tmp_path_factory.mktemp("video")
    pt, out = str(d / "model-7.pt"), str(d / "torch-model-7.pt")
    torch.save(ckpt, pt)
    params = tti.convert_video_checkpoint(pt, out, cfg)
    _assert_state_equal(params["unet"], from_jax.video_tree(jtree))
    return cfg, pt, out, jtree


def test_load_converted_refuses_text_weights_with_hash_tokenizer(small_files, tmp_path,
                                                                 monkeypatch):
    """The counterpart of `tests/test_convert.py:254`: a file with text
    weights and the hash tokenizer is refused; a U-Net-only file keeps the
    text tower of `init(seed)` and the hash tokenizer; the parameters keep
    init's dtype (float32) under a bfloat16 config; the load is strict."""
    cfg, _, out, jtree = small_files
    seeded = tvm.VideoPredModel(cfg, device="cpu").init(5)
    with_text = str(tmp_path / "with_text.pt")
    tti.save_video_params({"unet": from_jax.video_tree(jtree),
                           "text": seeded.nets.text.state_dict()}, with_text)
    with pytest.raises(RuntimeError, match="tokenizer"):
        tvm.VideoPredModel(cfg, device="cpu").load_converted(with_text)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    model = tvm.VideoPredModel(bf16, device="cpu").load_converted(out, seed=5)
    assert not model.tokenizer.is_real
    _assert_state_equal(model.nets.text.state_dict(), seeded.nets.text.state_dict())
    _assert_state_equal(model.nets.unet.state_dict(), from_jax.video_tree(jtree))
    # text weights with the bundled real tokenizer load
    tok = tti.write_synthetic_tokenizer(str(tmp_path / "tokenizer"))
    if importlib.util.find_spec("transformers") is not None:
        loaded = tvm.VideoPredModel(cfg, device="cpu").load_converted(with_text, tok)
        assert loaded.tokenizer.is_real
        _assert_state_equal(loaded.nets.text.state_dict(), seeded.nets.text.state_dict())
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        tvm.VideoPredModel(cfg, device="cpu").load_converted(with_text, tok)
    # a file of another architecture fails in the strict load
    other = dataclasses.replace(cfg, attention_resolutions=())
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tvm.VideoPredModel(other, device="cpu").load_converted(out)
    with pytest.raises(FileNotFoundError):
        tvm.VideoPredModel(cfg, device="cpu").load_converted(str(tmp_path / "none.pt"))


@pytest.mark.parametrize("present", ["torch", "jax_only", "neither"])
def test_make_video_model_branches(small_files, tmp_path, present):
    from v2a_tpu_torch.config.experiment import ExperimentConfig
    from v2a_tpu_torch.train import build as tbuild

    cfg, _, out, jtree = small_files
    exp = ExperimentConfig(video=cfg, device="cpu", seed=2, video_ckpt_dir=str(tmp_path),
                           video_ckpt_milestone=7)
    if present == "torch":
        (tmp_path / "torch-model-7.pt").write_bytes(open(out, "rb").read())
        model = tbuild.make_video_model(exp)
        _assert_state_equal(model.nets.unet.state_dict(), from_jax.video_tree(jtree))
        seeded = tvm.VideoPredModel(cfg, device="cpu").init(2)
        _assert_state_equal(model.nets.text.state_dict(), seeded.nets.text.state_dict())
    elif present == "jax_only":
        (tmp_path / "jax-model-7.msgpack").write_bytes(b"")
        with pytest.raises(FileNotFoundError, match="v2a_tpu_torch.scripts.convert_ckpt"):
            tbuild.make_video_model(exp)
    else:
        model = tbuild.make_video_model(exp)
        _assert_state_equal(model.nets.state_dict(),
                            tvm.VideoPredModel(cfg, device="cpu").init(2).nets.state_dict())


def test_convert_ckpt_and_sample_video_entry_points(small_files, small_policy, tmp_path,
                                                   monkeypatch, capsys):
    """`convert_ckpt.main` on the synthetic `.pt` (the video and the policy),
    then `sample_video.main --ckpt --device cpu`: `videos.npy` equals the
    video sampled from the source weights (the JAX converter's tree) with
    the same seed. The release config is patched to the small schema."""
    from v2a_tpu_torch.scripts import convert_ckpt, sample_video

    cfg, pt, _, jtree = small_files
    small = functools.partial(tvm.VideoModelConfig, **{
        k: v for k, v in SMALL_VIDEO.items() if k != "sampling_timesteps"})
    monkeypatch.setattr(tti, "VideoModelConfig", small)
    monkeypatch.setattr(sample_video, "VideoModelConfig", small)
    out = str(tmp_path / "ckpt" / "torch-model-7.pt")
    n = convert_ckpt.main(["--kind", "video", "--pt", pt, "--out", out])
    assert f"[convert] video: {n:,} params -> {out}" in capsys.readouterr().out
    assert n == sum(int(np.prod(np.shape(v))) for v in _leaves(jtree).values())
    videos = sample_video.main(["--ckpt", out, "--device", "cpu", "--steps", "3", "--n", "2",
                                "--seed", "4", "--out", str(tmp_path / "s")])
    np.testing.assert_array_equal(np.load(tmp_path / "s" / "videos.npy"), videos)
    src = tvm.VideoPredModel(dataclasses.replace(cfg, sampling_timesteps=3),
                             device="cpu").init(0)
    src.nets.unet.load_state_dict(from_jax.video_tree(jtree), strict=True)
    h, w = cfg.image_size
    frame = np.broadcast_to(sample_video.synthetic_frame(h, w).astype(np.float32) / 255.0,
                            (2, h, w, 3)).copy()
    want = src.sample_u8(frame, ["a robot arm completes the task"] * 2,
                         generator=torch.Generator().manual_seed(4)).numpy()
    assert videos.shape == (2, 2, h, w, 3)
    np.testing.assert_array_equal(videos, want)

    pcfg, pckpt, ppt = small_policy
    monkeypatch.setattr(tti, "PolicyConfig", functools.partial(tpolicy.PolicyConfig,
                                                               **SMALL_POLICY))
    pout = str(tmp_path / "policy-1.pt")
    n = convert_ckpt.main(["--kind", "policy", "--pt", ppt, "--out", pout, "--ema", "0"])
    assert f"[convert] policy: {n:,} params -> {pout}" in capsys.readouterr().out
    jtree = jti.convert_policy(jti.extract_policy_state(pckpt, False), pcfg.obs_keys,
                               pcfg.down_dims)
    _assert_state_equal(torch.load(pout, weights_only=True), from_jax.policy_from_jax(jtree))
