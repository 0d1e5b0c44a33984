"""The port's trunk pools (`ops/pool.py`) and the `pool` argument of
`models/vision.py` against the JAX package and torch's `max_pool2d`, on the
CPU (the JAX side in NHWC, the port in NCHW).

- `max_pool_3x3s2` (packed): its forward bit-equal to `F.max_pool2d` and
  to the JAX package's at every size; its gradient bit-equal to the JAX
  package's at even sizes (both sum a position's windows in float32) and
  to `max_pool2d`'s float32 gradient rounded to bf16 at any size (the JAX
  backward drops the last row / column at odd sizes: pinned below); ties to
  the first maximum in row-major order, as `max_pool2d`; -0 / +0, inf and
  extremes exact; float32 and H*W > 2^15 refused.
- `max_pool_3x3s2_maskbwd`: the library forward; its gradient equal to the
  JAX package's and, without ties, to `max_pool2d`'s; at ties it reaches
  every maximum (the JAX package's documented deviation).
- a VisualCore per `pool` against the JAX one with its flag set (float32:
  the mask backward's features and gradients; "packed" applies only in
  bf16, as the JAX rule), and the bf16 packed trunk against the port's
  "max" trunk (forward bit-equal).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_policy import random_params  # noqa: E402
from v2a_tpu.models import vision as jvision  # noqa: E402
from v2a_tpu.ops import pool as jpool  # noqa: E402
from v2a_tpu_torch.convert.from_jax import policy_from_jax  # noqa: E402
from v2a_tpu_torch.models import vision as tvision  # noqa: E402
from v2a_tpu_torch.ops import pool as tpool  # noqa: E402

TRUNK_TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_torch_policy.py's


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


def _grad(fn, x, co):
    """d sum(fn(x) * co) / dx in float32, x (B, C, H, W)."""
    x = x.clone().requires_grad_(True)
    (fn(x).float() * co.float()).sum().backward()
    return x.grad.float()


def _jax_grad(fn, x_nhwc, co_nhwc):
    grad = jax.grad(lambda x: jnp.sum(fn(x).astype(jnp.float32) * co_nhwc))
    return np.asarray(jax.jit(grad)(x_nhwc), np.float32)


def _torch_pool(x):
    return F.max_pool2d(x, 3, 2, 1)


@pytest.mark.parametrize("hw", [(8, 8), (16, 12), (64, 64), (5, 7)])
def test_packed_forward_bit_exact(hw):
    x = torch.randn(2, 8, *hw, generator=torch.Generator().manual_seed(sum(hw))).bfloat16()
    got = tpool.max_pool_3x3s2(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _torch_pool(x))
    want = jax.jit(jpool.max_pool_3x3s2)(jnp.asarray(_nhwc(x), jnp.bfloat16))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))


def test_packed_backward_matches_jax_and_torch():
    """16x16: bit-equal to the JAX gradient; `max_pool2d`'s support, and
    `max_pool2d`'s float32 gradient (on the same values) rounded once to
    bf16, bit for bit (torch's bf16 backward rounds after each add)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 16, 16, generator=gen).bfloat16()
    co = torch.randn(2, 4, 8, 8, generator=gen).bfloat16()
    got = _grad(tpool.max_pool_3x3s2, x, co)
    want = _jax_grad(jpool.max_pool_3x3s2, jnp.asarray(_nhwc(x), jnp.bfloat16),
                     jnp.asarray(_nhwc(co), jnp.float32))
    np.testing.assert_array_equal(_nhwc(got), want)
    assert torch.equal(got != 0, _grad(_torch_pool, x, co) != 0)
    assert torch.equal(got, _grad(_torch_pool, x.float(), co).bfloat16().float())


@pytest.mark.parametrize("hw", [(5, 7), (9, 9)])
def test_packed_backward_at_odd_sizes_is_torch_rule(hw):
    """At odd H / W the gradient is `max_pool2d`'s (same support; its
    float32 gradient rounded to bf16, bit for bit); the JAX backward trims its upsampled grid to H, W before the
    shift and loses the last row's / column's share (pinned: its total is
    smaller)."""
    gen = torch.Generator().manual_seed(hw[0])
    x = torch.randn(1, 3, *hw, generator=gen).bfloat16()
    co = torch.ones(1, 3, (hw[0] + 1) // 2, (hw[1] + 1) // 2).bfloat16()
    got = _grad(tpool.max_pool_3x3s2, x, co)
    assert torch.equal(got != 0, _grad(_torch_pool, x, co) != 0)
    assert torch.equal(got, _grad(_torch_pool, x.float(), co).bfloat16().float())
    assert float(got.sum()) == co.numel()
    jax_g = _jax_grad(jpool.max_pool_3x3s2, jnp.asarray(_nhwc(x), jnp.bfloat16),
                      jnp.asarray(_nhwc(co), jnp.float32))
    assert jax_g.sum() < co.numel()


@pytest.mark.parametrize("hw", [(8, 8), (4, 4)])
def test_packed_ties_go_to_the_first_maximum(hw):
    """Plateaus: each window's gradient to its first (row-major) position,
    as `max_pool2d` and the JAX packed pool route it; at 4x4 that is (0, 0),
    (0, 1), (1, 0), (1, 1)."""
    x = torch.zeros(1, 1, *hw).bfloat16()
    co = torch.ones(1, 1, hw[0] // 2, hw[1] // 2).bfloat16()
    got = _grad(tpool.max_pool_3x3s2, x, co)
    assert torch.equal(got, _grad(_torch_pool, x, co))
    want = _jax_grad(jpool.max_pool_3x3s2, jnp.zeros((1, *hw, 1), jnp.bfloat16),
                     jnp.ones((1, hw[0] // 2, hw[1] // 2, 1), jnp.float32))
    np.testing.assert_array_equal(_nhwc(got), want)
    if hw == (4, 4):
        assert sorted(map(tuple, torch.nonzero(got[0, 0]).tolist())) == [
            (0, 0), (0, 1), (1, 0), (1, 1)]


def test_packed_negative_zero_and_extremes():
    vals = np.array([[-0.0, 0.0, -1e30, 1e30], [3.14, -3.14, 1e-30, -1e-30],
                     [np.inf, -np.inf, 2.0, -2.0], [0.5, -0.5, 64.0, -64.0]], np.float32)
    x = torch.from_numpy(np.tile(vals[None, None], (1, 2, 2, 2))).bfloat16()
    got = tpool.max_pool_3x3s2(x)
    assert torch.equal(got.view(torch.int16), _torch_pool(x).view(torch.int16))


def test_packed_refuses_what_does_not_pack():
    with pytest.raises(ValueError, match="bf16"):
        tpool.max_pool_3x3s2(torch.ones(1, 1, 8, 8))
    with pytest.raises(ValueError, match="2\\^15"):
        tpool.max_pool_3x3s2(torch.ones(1, 1, 182, 182).bfloat16())


def test_maskbwd_matches_jax_and_torch():
    """The library forward; the gradient equal to the JAX mask backward's,
    and without ties (distinct float32 values) to `max_pool2d`'s."""
    x = torch.from_numpy(np.random.RandomState(1).permutation(16 * 16 * 4).reshape(
        1, 4, 16, 16).astype(np.float32))
    co = torch.arange(4 * 8 * 8, dtype=torch.float32).reshape(1, 4, 8, 8)
    assert torch.equal(tpool.max_pool_3x3s2_maskbwd(x), _torch_pool(x))
    got = _grad(tpool.max_pool_3x3s2_maskbwd, x, co)
    np.testing.assert_array_equal(got.numpy(), _grad(_torch_pool, x, co).numpy())
    want = _jax_grad(jpool.max_pool_3x3s2_maskbwd, jnp.asarray(_nhwc(x)),
                     jnp.asarray(_nhwc(co)))
    np.testing.assert_array_equal(_nhwc(got), want)


def test_maskbwd_routes_to_every_tie():
    """The JAX package's documented deviation: on a plateau every position
    of a window receives its gradient (a total above the window count),
    equal to the JAX mask backward's; bf16 in, bf16 out."""
    x = torch.zeros(1, 1, 4, 4).bfloat16()
    co = torch.ones(1, 1, 2, 2).bfloat16()
    got = _grad(tpool.max_pool_3x3s2_maskbwd, x, co)
    assert (got > 0).all() and float(got.sum()) > 4.0
    want = _jax_grad(jpool.max_pool_3x3s2_maskbwd, jnp.zeros((1, 4, 4, 1), jnp.bfloat16),
                     jnp.ones((1, 2, 2, 1), jnp.float32))
    np.testing.assert_array_equal(_nhwc(got), want)


# -- the trunk's `pool` argument -----------------------------------------------------

CORE = dict(feature_dimension=16, num_kp=8, stage_sizes=(1, 1),
            stage_features=(16, 32))


@pytest.fixture(scope="module")
def core_params():
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    params = random_params(jvision.VisualCore(**CORE), jnp.asarray(x), seed=4)
    return x, params


def _port_core(params, pool, dtype=torch.float32):
    core = tvision.VisualCore(**CORE, dtype=dtype, pool=pool)
    core.load_state_dict(policy_from_jax(params))
    return core


@pytest.mark.parametrize("pool,flag", [("mask_bwd", "V2A_POOL_MASK_BWD"),
                                       ("packed", "V2A_PACKED_POOL")])
def test_visual_core_pool_matches_jax_flag(monkeypatch, core_params, pool, flag):
    """float32 VisualCore features and parameter gradients of sum(y^2)
    against the JAX VisualCore with the pool's flag set (packed in float32:
    the library pool on both sides, the JAX rule)."""
    x, params = core_params
    monkeypatch.setenv(flag, "1")
    jm = jvision.VisualCore(**CORE)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) ** 2)))(params)
    core = _port_core(params, pool)
    got = (core(torch.from_numpy(x)) ** 2).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    gwant = policy_from_jax(jgrads)
    for name, p in core.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gwant[name].numpy(), err_msg=name,
                                   **TRUNK_TOL)


def test_bf16_packed_trunk_against_max(core_params):
    """A bf16 trunk: "packed" gives the "max" trunk's features bit for bit
    (the pool is exact); the input gradients share their support."""
    x, params = core_params
    outs = {}
    for pool in ("max", "packed"):
        core = _port_core(params, pool, torch.bfloat16)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = core(xt)
        y.float().square().sum().backward()
        outs[pool] = (y, xt.grad)
    assert torch.equal(outs["packed"][0], outs["max"][0])
    assert torch.equal(outs["packed"][1] != 0, outs["max"][1] != 0)
    with pytest.raises(ValueError, match="pool"):
        tvision.ResNet18Conv(pool="avg")
