"""The guided-diffusion CLIs and their support (`v2a_tpu_torch/guided/`,
`v2a_tpu_torch/scripts/guided/`) against the JAX package, on the CPU.

`load_data` batches bit-equal to the JAX package's (labels,
`deterministic`, `low_res`, `area_downsample`); the defaults dicts and
every CLI's flags equal (the port adds `--device`); the builders' nets
load the JAX trees strictly; the train loop's timesteps and weights at one
seed, its Adam / AdamW / anneal / EMA updates on fixed gradients against
optax, microbatch accumulation; the seven CLIs end to end with `--device
cpu` at `tests/test_guided_scripts.py`'s tiny flags, and each raises
without a card when `--device cpu` is not given.
"""

import argparse
import os

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_guided_scripts import MODEL_FLAGS, TRAIN_FLAGS, _load_cli  # noqa: E402
from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_video import random_params  # noqa: E402
from v2a_tpu.guided import image_data as jdata  # noqa: E402
from v2a_tpu.guided import script_util as jsu  # noqa: E402
from v2a_tpu.guided import train_loop as jtl  # noqa: E402
from v2a_tpu.ops import resample as jres  # noqa: E402
from v2a_tpu_torch.convert.from_jax import image_net_from_jax  # noqa: E402
from v2a_tpu_torch.guided import image_data as tdata  # noqa: E402
from v2a_tpu_torch.guided import script_util as tsu  # noqa: E402
from v2a_tpu_torch.guided import train_loop as ttl  # noqa: E402
from v2a_tpu_torch.ops import resample as tres  # noqa: E402
from v2a_tpu_torch.scripts.guided import _common  # noqa: E402
from v2a_tpu_torch.scripts.guided import (  # noqa: E402
    classifier_sample,
    classifier_train,
    image_nll,
    image_sample,
    image_train,
    super_res_sample,
    super_res_train,
)

CLIS = ("image_train", "image_sample", "image_nll", "super_res_train", "super_res_sample",
        "classifier_train", "classifier_sample")
PORT_CLIS = dict(image_train=image_train, image_sample=image_sample, image_nll=image_nll,
                 super_res_train=super_res_train, super_res_sample=super_res_sample,
                 classifier_train=classifier_train, classifier_sample=classifier_sample)
CPU = ["--device", "cpu"]
SR_FLAGS = ["--large_size", "16", "--small_size", "8", "--num_channels", "8",
            "--num_res_blocks", "1", "--attention_resolutions", "8",
            "--num_head_channels", "4", "--diffusion_steps", "10", "--noise_schedule", "cosine"]
CLS_FLAGS = ["--image_size", "16", "--classifier_width", "8", "--classifier_depth", "1",
             "--classifier_attention_resolutions", "8", "--diffusion_steps", "10",
             "--noise_schedule", "cosine"]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """8 tiny npy images, 2 classes from the filename prefix (those of
    `tests/test_guided_scripts.py`), and 3 more of other shapes and types
    (a 20x24 crop, a grey 2-D image, a float one-channel 32^2) in a
    sub-directory."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(8):
        cls = "cat" if i % 2 else "dog"
        np.save(d / f"{cls}_{i}.npy", rng.integers(0, 255, (16, 16, 3), np.uint8))
    (d / "more").mkdir()
    np.save(d / "more" / "bird_0.npy", rng.integers(0, 255, (20, 24, 3), np.uint8))
    np.save(d / "more" / "bird_1.npy", rng.integers(0, 255, (16, 16), np.uint8))
    np.save(d / "more" / "cat_9.npy", rng.uniform(0, 255, (32, 32, 1)).astype(np.float32))
    return str(d)


def _flat_dir(image_dir, tmp_path):
    """The 8 images of one shape only, for the CLIs."""
    d = tmp_path / "flat"
    d.mkdir()
    for name in os.listdir(image_dir):
        if name.endswith(".npy"):
            os.symlink(os.path.join(image_dir, name), d / name)
    return str(d)


@pytest.mark.parametrize("kw", [dict(class_cond=True, deterministic=True),
                                dict(class_cond=True, seed=3),
                                dict(class_cond=False, low_res=8, seed=1)],
                         ids=["deterministic", "shuffled", "low_res"])
def test_load_data_batches_bit_equal(image_dir, kw):
    assert tdata.list_image_files(image_dir) == jdata.list_image_files(image_dir)
    got = tdata.load_data(data_dir=image_dir, batch_size=3, image_size=16, **kw)
    want = jdata.load_data(data_dir=image_dir, batch_size=3, image_size=16, **kw)
    for _ in range(5):  # past two passes over the 11 files
        (x, xkw), (jx, jxkw) = next(got), next(want)
        assert x.dtype == jx.dtype and x.shape == (3, 16, 16, 3)
        np.testing.assert_array_equal(x, jx)
        assert set(xkw) == set(jxkw)
        for k in xkw:
            np.testing.assert_array_equal(xkw[k], jxkw[k])
    big = np.random.default_rng(2).standard_normal((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdata.area_downsample(big, 4), jdata.area_downsample(big, 4))
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="not a multiple"):
            mod.area_downsample(big, 3)
        with pytest.raises(ValueError, match="unspecified"):
            next(mod.load_data(data_dir="", batch_size=1, image_size=16))


def test_defaults_match():
    for name in ("diffusion_defaults", "model_defaults", "model_and_diffusion_defaults",
                 "classifier_defaults", "classifier_and_diffusion_defaults",
                 "sr_model_and_diffusion_defaults"):
        assert getattr(tsu, name)() == getattr(jsu, name)(), name
    assert tsu.NUM_CLASSES == jsu.NUM_CLASSES
    for size in (512, 256, 128, 64, 32, 16):
        assert tsu._default_channel_mult(size) == jsu._default_channel_mult(size)
    assert tsu._attention_ds(64, "32,16,8") == jsu._attention_ds(64, "32,16,8") == (2, 4, 8)
    assert _common.TRAIN_DEFAULTS == _load_cli("_common").TRAIN_DEFAULTS
    for name in ("image_sample", "image_nll", "super_res_sample", "classifier_train",
                 "classifier_sample"):
        jmod, tmod = _load_cli(name), PORT_CLIS[name]
        names = [n for n in dir(jmod) if n.endswith("_DEFAULTS") and n != "TRAIN_DEFAULTS"]
        assert names and all(getattr(tmod, n) == getattr(jmod, n) for n in names), name


class _Stop(Exception):
    pass


def _captured_parser(monkeypatch, module, main, argv):
    """The parser `main` builds, taken before it parses."""
    seen = []
    real = module.parser_from_defaults

    def capture(*dicts):
        parser = real(*dicts)
        seen.append(parser)
        real_parse = parser.parse_args

        def parse(args=None, namespace=None):
            seen.append(real_parse(args, namespace))
            raise _Stop

        parser.parse_args = parse
        return parser

    monkeypatch.setattr(module, "parser_from_defaults", capture)
    with pytest.raises(_Stop):
        main(argv)
    return seen


def _flags(parser):
    return {a.dest: (a.option_strings, a.default) for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", CLIS)
def test_cli_parsers_match_jax(name, monkeypatch):
    jmod = _load_cli(name)
    argv = ["--seed", "3", "--use_fp16", "True", "--batch_size", "2"]
    jparser, jargs = _captured_parser(monkeypatch, jmod, jmod.main, argv)
    tparser, targs = _captured_parser(monkeypatch, _common, PORT_CLIS[name].main, argv)
    want, got = _flags(jparser), _flags(tparser)
    assert got.pop("device") == (["--device"], None)
    assert got == want
    assert {k: v for k, v in vars(targs).items() if k != "device"} == vars(jargs)
    for flag in ("--dropout", "--use_new_attention_order", "--num_heads"):
        for parser in (jparser, tparser):  # the class's parse, not the capture
            with pytest.raises(SystemExit):
                argparse.ArgumentParser.parse_args(parser, [flag, "1"])


@pytest.mark.parametrize("name", CLIS)
def test_clis_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT_CLIS[name].main([])


def _strict_load(jnet, tnet, *args):
    tnet.load_state_dict(image_net_from_jax(random_params(jnet, *args)), strict=True)


def test_built_nets_load_the_jax_trees():
    flags = dict(tsu.model_and_diffusion_defaults(), image_size=16, num_channels=8,
                 num_res_blocks=1, attention_resolutions="8", num_head_channels=4,
                 class_cond=True, learn_sigma=True, resblock_updown=True,
                 timestep_respacing="ddim5", diffusion_steps=10)
    x, t, y = np.zeros((1, 16, 16, 3), np.float32), np.zeros(1, np.int32), np.zeros(1, np.int32)
    jm, jd = jsu.create_model_and_diffusion(**flags)
    tm, td = tsu.create_model_and_diffusion(**flags, device="cpu")
    _strict_load(jm, tm, x, t, y)
    assert tm.dtype == torch.float32 and td.var_type == jd.var_type == "learned_range"
    np.testing.assert_array_equal(td.timestep_map.numpy(), np.asarray(jd.timestep_map))
    np.testing.assert_array_equal(td.betas.numpy(), np.asarray(jd.betas))
    sr = dict(flags, large_size=16, small_size=8, use_fp16=True)
    del sr["image_size"]
    jm, _ = jsu.sr_create_model_and_diffusion(**sr)
    tm, _ = tsu.sr_create_model_and_diffusion(**sr, device="cpu")
    _strict_load(jm, tm, np.zeros((1, 16, 16, 6), np.float32), t, y)
    assert tm.dtype == torch.bfloat16 and tm.in_conv.kernel.dtype == torch.float32
    cls = dict(tsu.classifier_and_diffusion_defaults(), image_size=16, classifier_width=8,
               classifier_depth=1, classifier_attention_resolutions="8")
    for pool in ("attention", "adaptive", "spatial"):
        jc, _ = jsu.create_classifier_and_diffusion(**dict(cls, classifier_pool=pool))
        tc, _ = tsu.create_classifier_and_diffusion(**dict(cls, classifier_pool=pool),
                                                    device="cpu")
        _strict_load(jc, tc, x, t)


class _Scale(nn.Module):
    """A one-parameter model: w * x_t."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(0.5))

    def forward(self, x, t, **kw):
        return self.w * x


def _batches(n=16):
    rs = np.random.RandomState(0)
    while True:
        yield (rs.rand(n, 4, 4, 3) * 2 - 1).astype(np.float32), {}


@pytest.mark.parametrize("sampler", ["uniform", "loss-second-moment"])
def test_train_loop_draws_the_jax_timesteps(sampler):
    diff_kw = dict(steps=10, noise_schedule="cosine")
    jd, td = jsu.create_gaussian_diffusion(**diff_kw), tsu.create_gaussian_diffusion(
        **diff_kw, device="cpu")
    jloop = jtl.GuidedTrainLoop(
        model_fn=lambda p, x, t, **kw: p["w"] * x, diffusion=jd,
        params={"w": jnp.asarray(0.5)}, data=_batches(), batch_size=16, seed=4,
        schedule_sampler=jres.create_named_schedule_sampler(sampler, 10))
    tloop = ttl.GuidedTrainLoop(
        model=_Scale(), diffusion=td, data=_batches(), batch_size=16, seed=4,
        schedule_sampler=tres.create_named_schedule_sampler(sampler, 10))
    draws = []
    for loop in (jloop, tloop):
        real, seen = loop.sampler.sample, []
        loop.sampler.sample = lambda b, rng, real=real, seen=seen: seen.append(real(b, rng)) \
            or seen[-1]
        for _ in range(3):
            loop.run_step(*next(loop.data))
        draws.append(seen)
    for (t, w), (jt, jw) in zip(*draws[::-1]):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(w, jw)
    assert tloop.step == jloop.step == 3


@pytest.mark.parametrize("weight_decay,anneal", [(0.0, 0), (0.05, 5)], ids=["adam", "adamw"])
def test_optimizer_anneal_and_emas_match_optax(weight_decay, anneal):
    rs = np.random.RandomState(1)
    w0 = rs.randn(3, 4).astype(np.float32)
    grads = [rs.randn(3, 4).astype(np.float32) for _ in range(3)]
    kw = dict(data=None, batch_size=1, lr=1e-2, ema_rate="0.5,0.9",
              weight_decay=weight_decay, lr_anneal_steps=anneal)
    jloop = jtl.GuidedTrainLoop(model_fn=None, diffusion=jsu.create_gaussian_diffusion(
        steps=10, noise_schedule="cosine"),
                                params={"w": jnp.asarray(w0)}, **kw)
    net = nn.Module()
    net.w = nn.Parameter(torch.from_numpy(w0.copy()))
    tloop = ttl.GuidedTrainLoop(model=net, diffusion=tsu.create_gaussian_diffusion(
        steps=10, noise_schedule="cosine", device="cpu"), **kw)
    params, opt_state, emas = jloop.params, jloop.opt_state, jloop.ema_params
    for g in grads:
        updates, opt_state = jloop.tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = optax.apply_updates(params, updates)
        emas = [jax.tree_util.tree_map(lambda e, p, r=r: e * r + p * (1.0 - r), e, params)
                for r, e in zip(jloop.ema_rates, emas)]
        net.w.grad = torch.from_numpy(g)
        tloop.apply_gradients()
        np.testing.assert_allclose(net.w.detach().numpy(), np.asarray(params["w"]),
                                   rtol=1e-6, atol=1e-7)
        for i, e in enumerate(emas):
            np.testing.assert_allclose(tloop.ema_state_dict(i)["w"].numpy(), np.asarray(e["w"]),
                                       rtol=1e-6, atol=1e-7)
    assert not np.allclose(net.w.detach().numpy(), w0)


def test_microbatches_accumulate_the_full_batch_gradient():
    flags = dict(tsu.model_and_diffusion_defaults(), image_size=16, num_channels=8,
                 num_res_blocks=1, attention_resolutions="8", num_head_channels=4,
                 learn_sigma=True, channel_mult="1", diffusion_steps=10,
                 noise_schedule="cosine")
    model, diffusion = tsu.create_model_and_diffusion(**flags, device="cpu")
    _common.init_or_restore(model, "")
    with torch.no_grad():  # every parameter drawn, the zero-initialized too
        for i, p in enumerate(model.parameters()):
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(i)))
    real = diffusion.training_losses
    # noise as a function of the image: a microbatch draws what the full batch does
    diffusion.training_losses = lambda fn, gen, x, t, model_kwargs=None: real(
        fn, gen, x, t, model_kwargs, noise=torch.sin(3.0 * x))
    x = torch.from_numpy(next(_batches(4))[0].repeat(4, 1).repeat(4, 2))
    t, w = torch.tensor([0, 3, 9, 5]), torch.tensor([1.0, 0.5, 2.0, 1.5])
    grads, losses = [], []
    for micro in (-1, 2, 1):
        loop = ttl.GuidedTrainLoop(model=model, diffusion=diffusion, data=None, batch_size=4,
                                   microbatch=micro)
        loss, per_sample = loop.compute_gradients(x, t, w, {})
        grads.append([p.grad.clone() for p in model.parameters()])
        losses.append((float(loss), per_sample))
    for other, (loss, per) in zip(grads[1:], losses[1:]):
        for g, g0 in zip(other, grads[0]):
            torch.testing.assert_close(g, g0, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(per, losses[0][1])
        assert loss == pytest.approx(losses[0][0], rel=1e-6)
    assert any(bool(g.abs().sum() > 0) for g in grads[0])


def _restored(monkeypatch, module):
    """Copies of the state `module.init_or_restore` hands back."""
    seen = []
    real = module.init_or_restore

    def wrap(model, path, *a, **k):
        out = real(model, path, *a, **k)
        seen.append({n: v.clone() for n, v in out.state_dict().items()})
        return out

    monkeypatch.setattr(module, "init_or_restore", wrap)
    return seen


def test_image_train_resume_sample_and_nll(image_dir, tmp_path, monkeypatch, capsys):
    data = _flat_dir(image_dir, tmp_path)
    out = str(tmp_path / "out")
    image_train.main(MODEL_FLAGS + TRAIN_FLAGS + CPU + [
        "--data_dir", data, "--class_cond", "True", "--out_dir", out, "--ema_rate", "0.5,0.9"])
    ckpt = os.path.join(out, "model000002.pt")
    saved = torch.load(ckpt)
    for rate in ("0.5", "0.9"):
        ema = torch.load(os.path.join(out, f"ema_{rate}_000002.pt"))
        assert set(ema) == set(saved) and not all(torch.equal(ema[k], saved[k]) for k in saved)
    restored = _restored(monkeypatch, image_train)
    loop = image_train.main(MODEL_FLAGS + TRAIN_FLAGS + CPU + [
        "--data_dir", data, "--class_cond", "True", "--out_dir", out,
        "--resume_checkpoint", ckpt])
    assert loop.step == 2 and all(torch.equal(restored[0][k], saved[k]) for k in saved)

    path = image_sample.main(MODEL_FLAGS + CPU + [
        "--model_path", ckpt, "--class_cond", "True", "--num_samples", "4",
        "--batch_size", "4", "--timestep_respacing", "5", "--out_dir", out])
    assert path == os.path.join(out, "samples_4x16x16x3.npz")
    with np.load(path) as obj:
        arr, labels = obj["arr_0"], obj["arr_1"]
    assert arr.dtype == np.uint8 and arr.shape == (4, 16, 16, 3)
    assert labels.shape == (4,) and 0 <= labels.min() and labels.max() < tsu.NUM_CLASSES

    capsys.readouterr()
    bpd = image_nll.main(MODEL_FLAGS + CPU + [
        "--data_dir", data, "--num_samples", "2", "--batch_size", "2", "--out_dir", out,
        "--model_path", ckpt, "--class_cond", "True"])
    assert "bpd=" in capsys.readouterr().out and np.isfinite(bpd)
    for term in ("vb", "mse", "xstart_mse"):
        with np.load(os.path.join(out, f"{term}_terms.npz")) as obj:
            assert obj["arr_0"].shape == (10,) and np.isfinite(obj["arr_0"]).all()


def test_image_train_microbatch_and_learn_sigma(image_dir, tmp_path):
    out = str(tmp_path / "out")
    loop = image_train.main(MODEL_FLAGS + TRAIN_FLAGS + CPU + [
        "--data_dir", _flat_dir(image_dir, tmp_path), "--out_dir", out,
        "--microbatch", "2", "--learn_sigma", "True",
        "--schedule_sampler", "loss-second-moment"])
    assert loop.step == 2 and os.path.exists(os.path.join(out, "model000002.pt"))
    assert isinstance(loop.sampler, tres.LossSecondMomentResampler)
    assert loop.sampler._loss_counts.sum() == 8  # both steps' per-sample losses


def test_super_res_train_and_sample(image_dir, tmp_path):
    out = str(tmp_path / "out")
    super_res_train.main(SR_FLAGS + TRAIN_FLAGS + CPU + [
        "--data_dir", _flat_dir(image_dir, tmp_path), "--out_dir", out])
    ckpt = os.path.join(out, "model000002.pt")
    base = np.random.default_rng(0).integers(0, 255, (3, 8, 8, 3), np.uint8)
    base_path = str(tmp_path / "base.npz")
    np.savez(base_path, base)
    path = super_res_sample.main(SR_FLAGS + CPU + [
        "--model_path", ckpt, "--base_samples", base_path, "--num_samples", "3",
        "--batch_size", "2", "--timestep_respacing", "5", "--out_dir", out])
    with np.load(path) as obj:
        assert obj["arr_0"].shape == (3, 16, 16, 3) and obj["arr_0"].dtype == np.uint8


def test_classifier_train_and_guided_sample(image_dir, tmp_path, monkeypatch):
    out = str(tmp_path / "out")
    cls_ckpt = classifier_train.main(CLS_FLAGS + CPU + [
        "--data_dir", _flat_dir(image_dir, tmp_path), "--batch_size", "4",
        "--log_interval", "1", "--save_interval", "0", "--max_steps", "2", "--out_dir", out])
    assert cls_ckpt == os.path.join(out, "classifier000002.pt")
    grads = []
    real = classifier_sample.make_cond_fn

    def recording(classifier, scale):
        fn = real(classifier, scale)
        assert not any(p.requires_grad for p in classifier.parameters())
        return lambda x, t, y=None: grads.append(fn(x, t, y)) or grads[-1]

    monkeypatch.setattr(classifier_sample, "make_cond_fn", recording)
    path = classifier_sample.main(CLS_FLAGS + CPU + [
        "--num_channels", "8", "--num_res_blocks", "1", "--attention_resolutions", "8",
        "--num_head_channels", "4", "--classifier_path", cls_ckpt,
        "--classifier_scale", "2.0", "--num_samples", "2", "--batch_size", "2",
        "--timestep_respacing", "5", "--out_dir", out, "--use_ddim", "True"])
    assert len(grads) == 5 and bool(torch.isfinite(grads[0]).all()) and grads[0].abs().max() > 0
    with np.load(path) as obj:
        assert obj["arr_0"].shape == (2, 16, 16, 3) and obj["arr_1"].shape == (2,)
