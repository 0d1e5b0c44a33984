"""The guided image nets (`models/image_unet.py`) in the port against the
JAX package, on the CPU in float32.

Tiny nets (16x16, model channels 8-16, one res block, attention at ds 2,
heads of 4), every parameter drawn from a seed with numpy and carried
across by `convert/from_jax.py::image_net_from_jax` (a strict load):
`ImageUNet` with class conditioning and a learned sigma, with
`resblock_updown` and `use_scale_shift_norm` each on and off (atol 1e-5,
rtol 1e-4), and its bf16 forward as far from float32 as the JAX
package's; `EncoderUNet` under its three pools; `superres_condition` at
2x and 4x, edge pixels included; the gradients of a scalar loss against
`jax.grad`; `use_checkpoint`'s gradients; a fresh net's exact zero; the
`y` / `num_classes` `ValueError`.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_video import japply, random_params  # noqa: E402
from v2a_tpu.models import image_unet as jiu  # noqa: E402
from v2a_tpu_torch.convert.from_jax import image_net_from_jax  # noqa: E402
from v2a_tpu_torch.models import image_unet as tiu  # noqa: E402
from v2a_tpu_torch.models.init import init_params  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
N_CLASSES = 5
UNET = dict(in_channels=3, out_channels=6, num_res_blocks=1, attention_resolutions=(2,),
            num_classes=N_CLASSES, num_head_channels=4)
ENCODER = dict(in_channels=3, model_channels=8, out_channels=N_CLASSES, num_res_blocks=1,
               attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=4)


def _inputs(seed=0, cin=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, 16, 16, cin).astype(np.float32), np.array([3, 7]),
            np.array([1, 4]))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _load(net, params):
    net.load_state_dict(image_net_from_jax(params), strict=True)
    return net


NET8 = dict(UNET, model_channels=8, channel_mult=(1, 2), resblock_updown=True)


@pytest.fixture(scope="module")
def net8():
    """The module's shared tiny net: its keywords, one seeded parameter tree
    and inputs."""
    x, t, y = _inputs(4)
    return NET8, random_params(jiu.ImageUNet(**NET8), x, t, y, seed=6), (x, t, y)


@pytest.mark.parametrize("mc,mult,updown,sss", [(8, (1, 2), True, False),
                                                (16, (1, 1.5), False, True)],
                         ids=["updown", "scale_shift"])
def test_image_unet_matches_jax(mc, mult, updown, sss):
    kw = dict(UNET, model_channels=mc, channel_mult=mult, resblock_updown=updown,
              use_scale_shift_norm=sss)
    x, t, y = _inputs(mc)
    jnet = jiu.ImageUNet(**kw)
    params = random_params(jnet, x, t, y, seed=mc)
    want = japply(jnet, params, x, t, y)
    net = _load(tiu.ImageUNet(**kw), params).eval()
    with torch.no_grad():
        got = net(*_t(x, t, y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16, 16, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pool", tiu.POOLS)
def test_encoder_unet_matches_jax(pool):
    x, t, _ = _inputs(1)
    jnet = jiu.EncoderUNet(pool=pool, **ENCODER)
    params = random_params(jnet, x, t, seed=2)
    want = japply(jnet, params, x, t)
    net = _load(tiu.EncoderUNet(pool=pool, image_size=16, **ENCODER), params)
    with torch.no_grad():
        got = net(*_t(x, t))
    assert tuple(got.shape) == (2, N_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_strays_from_float32_as_far_as_jax(net8):
    """On the same weights, the port's bf16 forward strays from its float32
    forward about as far as the JAX package's bf16 forward from JAX's
    float32 one: the RMS error within 1.5x JAX's. The two bf16 paths round
    at other points; on nets of this shape the port's RMS error ran
    1.0-1.2x JAX's over eight seeds. The yardstick of the card's bf16 gate
    (`chip_smoke.py` phase 12)."""
    kw, params, (x, t, y) = net8
    j32 = np.asarray(japply(jiu.ImageUNet(**kw), params, x, t, y))
    j16 = np.asarray(japply(jiu.ImageUNet(dtype=jnp.bfloat16, **kw), params, x, t, y))
    with torch.no_grad():
        t32 = _load(tiu.ImageUNet(**kw), params)(*_t(x, t, y)).numpy()
        t16 = _load(tiu.ImageUNet(dtype=torch.bfloat16, **kw), params)(*_t(x, t, y)).numpy()
    jerr, terr = (np.sqrt(np.mean((a - b) ** 2)) / b.std() for a, b in ((j16, j32), (t16, t32)))
    assert t16.dtype == np.float32 and 0 < terr <= 1.5 * jerr, (terr, jerr)


def test_superres_condition_matches_jax_resize():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    for small in (8, 4):
        low = rs.randn(2, small, small, 3).astype(np.float32)
        want = np.asarray(jiu.superres_condition(jnp.asarray(x), jnp.asarray(low)))
        got = tiu.superres_condition(*_t(x, low)).numpy()
        assert got.shape == (2, 16, 16, 6)
        # edge rows and columns first: the clamped half-pixel taps
        for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            np.testing.assert_allclose(got[edge], want[edge], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_image_unet_gradients_match_jax(net8):
    kw, params, (x, t, y) = net8
    r = np.random.RandomState(5).randn(2, 16, 16, 6).astype(np.float32)
    jnet = jiu.ImageUNet(**kw)

    def jloss(p, xx):
        return jnp.sum(jnet.apply(p, xx, t, y) * r)

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    net = _load(tiu.ImageUNet(**kw), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    (net(xt, *_t(t, y)) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), atol=1e-5, rtol=1e-4)
    want = image_net_from_jax(jg_p)
    grads = dict(net.named_parameters())
    assert set(grads) == set(want)
    # a bias ahead of a GroupNorm of one channel a group (every group at
    # these widths) has a zero gradient, which float32 gives as the rounding
    # noise of sums of terms as large as the largest gradients
    atol = 2e-6 * max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(), atol=atol, rtol=1e-4,
                                   err_msg=name)


def test_use_checkpoint_gives_the_same_gradients(net8):
    kw, params, inputs = net8
    grads = []
    for ckpt in (False, True):
        net = _load(tiu.ImageUNet(use_checkpoint=ckpt, **kw), params)
        net(*_t(*inputs)).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=1e-5, atol=1e-6)


def test_a_fresh_net_outputs_zero_as_jax():
    """One level, so that flax's init compiles quickly."""
    kw = dict(UNET, model_channels=8, channel_mult=(1,))
    ekw = dict(ENCODER, channel_mult=(1,), pool="adaptive")
    x, t, y = _inputs(8)
    jnet, jenc = jiu.ImageUNet(**kw), jiu.EncoderUNet(**ekw)

    @jax.jit
    def fresh(k):
        return (jnet.apply(jnet.init(k, x, t, y), x, t, y),
                jenc.apply(jenc.init(k, x, t), x, t))

    assert not any(np.asarray(a).any() for a in fresh(jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    net = init_params(tiu.ImageUNet(**kw), gen)
    enc = init_params(tiu.EncoderUNet(**ekw), gen)
    with torch.no_grad():
        assert not net(*_t(x, t, y)).any() and not enc(*_t(x, t)).any()
    # the zero-initialized layers only: everything else is drawn
    drawn = {n for n, p in net.named_parameters() if p.ndim > 1 and p.abs().sum() > 0}
    zero = {n for n, p in net.named_parameters() if p.ndim > 1 and not p.any()}
    assert zero == {n for n in zero if n.endswith(("out_conv.kernel", "proj.weight"))}
    assert drawn and len(zero) == 5 + 1 + 1  # 5 ResBlocks, the middle attention, the out conv


def test_y_iff_num_classes_in_both_packages(net8):
    kw, params, (x, t, y) = net8
    plain = dict(kw, num_classes=None)
    with pytest.raises(ValueError, match="num_classes"):
        jiu.ImageUNet(**plain).apply(params, x, t, y)
    with pytest.raises(ValueError, match="num_classes"):
        jiu.ImageUNet(**kw).apply(params, x, t)
    for net, args in ((tiu.ImageUNet(**plain), _t(x, t, y)), (tiu.ImageUNet(**kw), _t(x, t))):
        with pytest.raises(ValueError, match="num_classes"):
            net(*args)
