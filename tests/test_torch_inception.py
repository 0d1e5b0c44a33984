"""The port's Inception trunk (`ops/inception.py`, `ops/resize.py`,
`convert/from_jax.py::inception_from_jax`) against the JAX package, on the
CPU in float32.

The spec, the synthetic weights and the BatchNorm folding are copies:
equal bit for bit. The `.npz` layout (`name/leaf`) passes between the
packages, and a torch `.pt` state dict loads (`weights_only`) to the JAX
package's tree. The resize agrees with `jax.image.resize(..., "bilinear")`
within 2e-5, growing and shrinking (anti-aliased). The pooled and sFID
features of one forward per package (N=2, synthetic weights, module
scoped) agree within 1e-4 of the features' std, the logits and Inception
Score within 1e-3 relative. The evaluator CLI with `--inception` on npz
batches of 8 (reference) and 10 (sample: IS takes 10 splits) images at
40^2: the JAX CLI's keys in its order, its precision / recall, and its
FID, sFID and IS within 1e-3 relative (`--batch 2` at the fixture's
size: the eager JAX forward compiles its ops once).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_fid import batches, load_jax_cli, one_blas_thread, run_cli  # noqa: E402, F401
from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu.ops import fid as jfid  # noqa: E402
from v2a_tpu.ops import inception as jinc  # noqa: E402
from v2a_tpu_torch.convert.from_jax import inception_from_jax  # noqa: E402
from v2a_tpu_torch.ops import fid as tfid  # noqa: E402
from v2a_tpu_torch.ops import inception as tinc  # noqa: E402
from v2a_tpu_torch.ops.resize import resize_bilinear  # noqa: E402
from v2a_tpu_torch.scripts import evaluate_samples as tcli  # noqa: E402

FEATURE_TOL = 1e-4  # of the features' std
RESIZE_TOL = 2e-5
N_CLASSES = 10
CLI_RTOL = 1e-3


def _params():
    """Synthetic folded weights with a 10-class fc head."""
    params = jinc.convert_inception_state_dict(jinc.synthetic_state_dict(0))
    rs = np.random.RandomState(1)
    params["fc"] = {"kernel": (rs.randn(2048, N_CLASSES) * 0.02).astype(np.float32),
                    "bias": (rs.randn(N_CLASSES) * 0.1).astype(np.float32)}
    return params


@pytest.fixture(scope="module")
def forwards():
    """(params, images, JAX (pooled, spatial), port (pooled, spatial)): one
    forward per package of two 40x40 images."""
    params = _params()
    imgs = np.random.RandomState(2).rand(2, 40, 40, 3).astype(np.float32)
    jp, js = jinc.inception_forward(params, imgs, return_spatial=True)
    model = tinc.inception_model(params, "cpu")
    tp, ts = tinc.inception_forward(model, imgs, return_spatial=True)
    return params, imgs, (np.asarray(jp), np.asarray(js)), (tp.numpy(), ts.numpy())


def test_spec_matches_jax():
    assert tinc.all_conv_specs() == [tinc.ConvSpec(*s.__dict__.values())
                                     for s in jinc.all_conv_specs()]
    assert [(b[1:]) for b in tinc.BLOCKS] == [(b[1:]) for b in jinc.BLOCKS]
    assert [b[0].__name__ for b in tinc.BLOCKS] == [b[0].__name__ for b in jinc.BLOCKS]
    assert (tinc.BN_EPS, tinc.FEATURE_DIM) == (jinc.BN_EPS, jinc.FEATURE_DIM)


def test_synthetic_state_dict_matches_jax():
    got, want = tinc.synthetic_state_dict(3), jinc.synthetic_state_dict(3)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_conversion_matches_jax():
    """`convert_inception_state_dict` of torch tensors with an fc head (the
    AuxLogits ignored): the JAX package's tree bit for bit."""
    sd = {k: torch.from_numpy(v) for k, v in jinc.synthetic_state_dict(1).items()}
    sd["fc.weight"] = torch.randn(7, 2048)
    sd["fc.bias"] = torch.randn(7)
    sd["AuxLogits.fc.weight"] = torch.randn(7, 768)
    got, want = tinc.convert_inception_state_dict(sd), jinc.convert_inception_state_dict(sd)
    assert got.keys() == want.keys() and got["fc"]["kernel"].shape == (2048, 7)
    for name in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf], want[name][leaf], err_msg=name)
    missing = dict(sd)
    missing.pop("Mixed_6e.branch_pool.bn.running_var")
    with pytest.raises(KeyError, match="running_var"):
        tinc.convert_inception_state_dict(missing)


def test_fold_bn_matches_jax_and_torch_batchnorm():
    """The fold against the JAX package's (bit-equal) and against a torch
    BasicConv2d (conv without bias, BatchNorm2d(eps=1e-3) in eval mode with
    moved running statistics, ReLU) replayed by the port's folded conv."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(3, 8, 3, stride=2, bias=False)
    bn = torch.nn.BatchNorm2d(8, eps=tinc.BN_EPS)
    net = torch.nn.Sequential(conv, bn, torch.nn.ReLU())
    with torch.no_grad():
        for _ in range(3):
            net(torch.randn(4, 3, 17, 17))
    net.eval()
    args = [t.detach().numpy() for t in (conv.weight, bn.weight, bn.bias, bn.running_mean,
                                         bn.running_var)]
    got, want = tinc.fold_bn(*args), jinc.fold_bn(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    folded = tinc._FoldedConv(tinc.ConvSpec("x", 3, 8, (3, 3), 2))
    sd = inception_from_jax({"x": {"kernel": got[0], "bias": got[1]}})
    folded.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    x = torch.randn(2, 3, 17, 17)
    with torch.no_grad():
        np.testing.assert_allclose(folded(x).numpy(), net(x).numpy(), atol=1e-5)


def test_npz_and_pt_files_pass_between_packages(tmp_path):
    """A `.npz` saved by either package loads in the other to the same
    tree; a torch `.pt` state dict loads (`weights_only=True`) to the JAX
    package's conversion of it."""
    params = _params()
    for saver, loader, name in ((tinc.save_inception_params, jinc.load_inception_params, "t"),
                                (jinc.save_inception_params, tinc.load_inception_params, "j")):
        path = str(tmp_path / f"{name}.npz")
        saver(params, path)
        loaded = loader(path)
        assert loaded.keys() == params.keys()
        for k in params:
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(loaded[k][leaf], params[k][leaf])
    sd = {k: torch.from_numpy(v) for k, v in jinc.synthetic_state_dict(2).items()}
    sd["fc.weight"], sd["fc.bias"] = torch.ones(5, 2048), torch.zeros(5)
    path = str(tmp_path / "w.pt")
    torch.save(sd, path)
    got, want = tinc.load_inception_params(path), jinc.load_inception_params(path)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["Conv2d_1a_3x3"]["kernel"], want["Conv2d_1a_3x3"]["kernel"])
    np.testing.assert_array_equal(got["fc"]["kernel"], want["fc"]["kernel"])


@pytest.mark.parametrize("src,dst", [((64, 64), (299, 299)), ((37, 37), (299, 299)),
                                     ((320, 320), (299, 299)), ((512, 512), (299, 299)),
                                     ((20, 30), (12, 45))],
                         ids=["grow64", "grow37", "shrink320", "shrink512", "mixed"])
def test_resize_matches_jax(src, dst):
    """`resize_bilinear` against `jax.image.resize(..., "bilinear")`
    (anti-aliased when it shrinks), within 2e-5."""
    x = np.random.RandomState(sum(src)).rand(1, *src, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *dst, 3), method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


def test_pooled_features_match_jax(forwards):
    _, _, (jp, _), (tp, _) = forwards
    assert tp.shape == jp.shape == (2, 2048) and tp.dtype == np.float32
    np.testing.assert_allclose(tp, jp, rtol=0, atol=FEATURE_TOL * jp.std())


def test_sfid_features_match_jax(forwards):
    """The first 7 channels of Mixed_6e, flattened in NHWC order."""
    _, _, (_, js), (_, ts) = forwards
    assert ts.shape == js.shape == (2, 17 * 17 * 7)
    np.testing.assert_allclose(ts, js, rtol=0, atol=FEATURE_TOL * js.std())


def test_logits_and_inception_score_match_jax(forwards):
    params, _, (jp, _), (tp, _) = forwards
    np.testing.assert_array_equal(tinc.inception_logits(params, jp),
                                  jinc.inception_logits(params, jp))
    got = tfid.inception_score(tinc.inception_logits(params, tp), splits=1)
    want = jfid.inception_score(jinc.inception_logits(params, jp), splits=1)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    with pytest.raises(KeyError, match="fc head"):
        tinc.inception_logits({k: v for k, v in params.items() if k != "fc"}, tp)


def test_features_fn_and_strict_load(forwards, tmp_path):
    """`inception_features(path, "cpu")` from a saved `.npz` gives the
    forward's pooled features; the model loads its state dict strictly
    (every conv, the fc head)."""
    params, imgs, _, (tp, _) = forwards
    path = str(tmp_path / "w.npz")
    tinc.save_inception_params(params, path)
    feats = tinc.inception_features(path, "cpu")(imgs)
    np.testing.assert_array_equal(feats, tp)
    model = tinc.inception_model(params, "cpu")
    assert len(model.state_dict()) == 2 * len(tinc.all_conv_specs()) + 2
    assert model.fc.weight.shape == (N_CLASSES, 2048)
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="NHWC"):
        tinc.inception_forward(model, imgs[..., :2])


def test_cli_with_inception_matches_jax(forwards, tmp_path, capsys):
    params = forwards[0]
    weights = str(tmp_path / "inception.npz")
    jinc.save_inception_params(params, weights)
    ref, sample = batches(tmp_path, side=40, n_sample=10)
    argv = [ref, sample, "--inception", weights, "--batch", "2"]
    want = run_cli(load_jax_cli().main, argv, capsys)
    got = run_cli(tcli.main, argv + ["--device", "cpu"], capsys)
    assert list(got) == list(want)
    assert got["inception_calibrated"] is True and (got["n_ref"], got["n_sample"]) == (8, 10)
    assert (got["precision"], got["recall"]) == (want["precision"], want["recall"])
    for key in ("fid", "sfid", "inception_score"):
        assert want[key] is not None and np.isfinite(want[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=CLI_RTOL, err_msg=key)
