"""The port's policy side against the JAX package, on the CPU in float32:
the observation encoder, the action U-Net, both schedulers' steps, the
normalizers, and `predict_action` from a shared initial trajectory.

Weights: the JAX parameter tree with seeded numpy values, carried into the
port by `convert/from_jax.py::policy_from_jax`.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu.models import normalizer as jnorm  # noqa: E402
from v2a_tpu.models import policy as jpolicy  # noqa: E402
from v2a_tpu.ops import action_scheduler as jsched  # noqa: E402
from v2a_tpu_torch.convert.from_jax import policy_from_jax  # noqa: E402
from v2a_tpu_torch.models import normalizer as tnorm  # noqa: E402
from v2a_tpu_torch.models import policy as tpolicy  # noqa: E402
from v2a_tpu_torch.ops import action_scheduler as tsched  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-4)
SMALL = dict(image_size=(64, 64), down_dims=(32, 64, 128),
             vision_stage_features=(16, 32, 64, 128))


def random_params(module, *args, seed=0):
    """A flax module's parameter tree, filled with seeded numpy values."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rs = np.random.RandomState(seed)

    def fill(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == "scale":
            return (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rs.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rs.randn(*shape) / math.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def policies():
    cfg = jpolicy.PolicyConfig(**SMALL)
    jp = jpolicy.DiffusionPolicy.create(cfg)
    h, w = cfg.image_size
    params = random_params(
        jp.nets, {k: jnp.zeros((1, h, w, 3)) for k in cfg.obs_keys},
        jnp.zeros((1, cfg.horizon, cfg.action_dim)), jnp.zeros((1,), jnp.int32))
    tp = tpolicy.DiffusionPolicy.create(tpolicy.PolicyConfig(**SMALL), device="cpu")
    tp.load_state_dict(policy_from_jax(params))
    rs = np.random.RandomState(5)
    obs = {k: rs.rand(2, h, w, 3).astype(np.float32) for k in cfg.obs_keys}
    return jp, params, tp, obs


def _tobs(obs):
    return {k: torch.from_numpy(v) for k, v in obs.items()}


def test_obs_encoder_matches_jax(policies):
    jp, params, tp, obs = policies
    want = jax.jit(jp.encode_obs)(params, {k: jnp.asarray(v) for k, v in obs.items()})
    got = tp.encode_obs(_tobs(obs))
    assert got.shape == (2, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_action_unet_matches_jax(policies):
    jp, params, tp, _ = policies
    rs = np.random.RandomState(6)
    traj = rs.randn(2, 16, 7).astype(np.float32)
    cond = rs.randn(2, 128).astype(np.float32)
    t = np.array([3, 71])
    want = jax.jit(lambda p, *a: jp.nets.apply(p, *a, method=jpolicy.PolicyNets.denoise))(
        params, traj, t, cond)
    with torch.no_grad():
        got = tp.nets.unet(torch.from_numpy(traj), torch.from_numpy(t), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,prev_t", [(84, 72), (12, 0), (0, -12)])
def test_scheduler_steps_match_jax(t, prev_t):
    rs = np.random.RandomState(t + 1)
    out, sample, noise = (rs.randn(2, 16, 7).astype(np.float32) for _ in range(3))
    jd, td = jsched.DDPMScheduler.create(), tsched.DDPMScheduler.create()
    want = jd.step(jnp.asarray(out), t, prev_t, jnp.asarray(sample), jnp.asarray(noise), 0.8)
    got = td.step(torch.from_numpy(out), t, prev_t, torch.from_numpy(sample),
                  torch.from_numpy(noise), 0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ji, ti = jsched.DDIMScheduler.create(), tsched.DDIMScheduler.create()
    want = ji.step(jnp.asarray(out), t, prev_t, jnp.asarray(sample))
    got = ti.step(torch.from_numpy(out), t, prev_t, torch.from_numpy(sample))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(ti.timesteps(8), np.asarray(ji.timesteps(8)))


def test_normalizers_match_jax():
    x = np.random.RandomState(7).randn(3, 7).astype(np.float32) * 0.2
    for orn01 in (False, True):
        jn, tn = jnorm.lb_action_normalizer(orn01), tnorm.lb_action_normalizer(orn01)
        np.testing.assert_allclose(tn.normalize(torch.from_numpy(x)).numpy(),
                                   np.asarray(jn.normalize(jnp.asarray(x))), **TOL)
        np.testing.assert_allclose(tn.unnormalize(torch.from_numpy(x * 8)).numpy(),
                                   np.asarray(jn.unnormalize(jnp.asarray(x * 8))), **TOL)


def test_predict_action_matches_jax(policies):
    """DDIM-8 from the initial trajectory JAX draws (`policy.py:272-273`)."""
    jp, params, tp, obs = policies
    rng = jax.random.PRNGKey(11)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    want = jax.jit(jp.predict_action)(params, rng, jobs)
    _, init_rng = jax.random.split(rng)
    traj0 = np.array(jax.random.normal(init_rng, (2, 16, 7), dtype=jnp.float32))
    got = tp.predict_action(_tobs(obs), init_noise=torch.from_numpy(traj0))
    assert got["action"].shape == (2, 8, 7)
    assert (np.abs(np.asarray(want["action_pred"])) < 1).mean() > 0.5  # not all clamped
    np.testing.assert_allclose(got["action_pred"].numpy(), np.asarray(want["action_pred"]),
                               atol=1e-3)
    np.testing.assert_allclose(got["action"].numpy(), np.asarray(want["action"]), atol=1e-3)


def test_policy_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpolicy.DiffusionPolicy.create(tpolicy.PolicyConfig(**SMALL))


def test_predict_action_ddpm_matches_jax(policies):
    """The DDPM branch, made deterministic with ddpm_var_temp 0."""
    _, params, _, obs = policies
    kw = dict(SMALL, num_inference_steps=10, ddpm_var_temp=0.0)
    jp = jpolicy.DiffusionPolicy.create(jpolicy.PolicyConfig(**kw))
    tp = tpolicy.DiffusionPolicy.create(tpolicy.PolicyConfig(**kw), device="cpu")
    tp.load_state_dict(policy_from_jax(params))
    rng = jax.random.PRNGKey(12)
    want = jax.jit(lambda p, r, o: jp.predict_action(p, r, o, use_ddim=False))(
        params, rng, {k: jnp.asarray(v) for k, v in obs.items()})
    _, init_rng = jax.random.split(rng)
    traj0 = np.array(jax.random.normal(init_rng, (2, 16, 7), dtype=jnp.float32))
    got = tp.predict_action(_tobs(obs), use_ddim=False, init_noise=torch.from_numpy(traj0))
    np.testing.assert_allclose(got["action_pred"].numpy(), np.asarray(want["action_pred"]),
                               atol=1e-3)
