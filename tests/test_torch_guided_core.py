"""The guided-diffusion core (`ops/guided_diffusion_core.py`) in the port
against the JAX package, on the CPU in float32.

One analytic toy model, channels-last in both packages (the toy of
`tests/test_guided_diffusion_core.py`), so no network is compiled. The
schedules, `space_timesteps` and every coefficient table are equal;
`p_mean_variance` for 3 mean types x 4 variance types, `condition_mean` /
`condition_score`, `p_sample` / `ddim_sample` with one explicit noise, the
VLB terms and every loss type match at atol 1e-5 (relative 1e-5 on the
losses in bits); a respaced DDIM chain from one initial noise at atol
1e-4.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from v2a_tpu.ops import guided_diffusion_core as jgd  # noqa: E402
from v2a_tpu_torch.ops import guided_diffusion_core as tgd  # noqa: E402

B, H, W, C = 2, 6, 6, 4
T_STEPS = 20
TOL = dict(atol=1e-5, rtol=1e-5)
MEANS = ("eps", "xstart", "xprev")
VARS = ("fixed_small", "fixed_large", "learned", "learned_range")
TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
          "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
          "fixed_large_variance", "log_betas")


def _toy(xp, learned):
    """The analytic model of `tests/test_guided_diffusion_core.py`,
    channels-last, in numpy-like `xp` (jnp or torch)."""
    cat = jnp.concatenate if xp is jnp else torch.cat

    def fn(x, t, **kw):
        tt = t.reshape(-1, 1, 1, 1)
        tt = tt.astype(jnp.float32) if xp is jnp else tt.float()
        mean = 0.1 * x * xp.cos(0.05 * tt) + 0.01 * tt / T_STEPS
        if not learned:
            return mean
        return cat([mean, xp.tanh(0.5 * x) * 0.3], -1)

    return fn


def _pair(mean_type="eps", var_type="learned_range", loss_type="mse", spacing=None):
    betas = jgd.named_beta_schedule("cosine", T_STEPS)
    if spacing is None:
        return (jgd.GuidedDiffusion.create(betas, mean_type, var_type, loss_type),
                tgd.GuidedDiffusion.create(betas, mean_type, var_type, loss_type, device="cpu"))
    use = jgd.space_timesteps(T_STEPS, spacing)
    return (jgd.spaced_diffusion(use, betas, mean_type, var_type, loss_type),
            tgd.spaced_diffusion(use, betas, mean_type, var_type, loss_type, device="cpu"))


def _data(seed):
    rs = np.random.RandomState(seed)
    return ((rs.rand(B, H, W, C) * 2 - 1).astype(np.float32),
            rs.randn(B, H, W, C).astype(np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _ts(*vals):
    return jnp.asarray(vals, jnp.int32), torch.tensor(vals)


def test_schedules_space_timesteps_and_tables_match():
    for name in ("linear", "cosine"):
        np.testing.assert_array_equal(tgd.named_beta_schedule(name, 50),
                                      jgd.named_beta_schedule(name, 50))
    for spec in ("ddim5", "ddim7", "10,5", "3", [10, 15, 20]):
        n = 300 if isinstance(spec, list) else T_STEPS
        assert tgd.space_timesteps(n, spec) == jgd.space_timesteps(n, spec)
    for mod in (jgd, tgd):
        with pytest.raises(ValueError, match="integer stride"):
            mod.space_timesteps(T_STEPS, "ddim6")
        with pytest.raises(ValueError, match="cannot divide"):
            mod.space_timesteps(10, [20])
    for spacing in (None, "ddim5", "10,5"):
        jd, td = _pair("eps", "fixed_large", "rescaled_mse", spacing)
        td = td.to("cpu")
        assert td.num_timesteps == jd.num_timesteps
        assert td.original_num_steps == jd.original_num_steps == T_STEPS
        for name in TABLES:
            np.testing.assert_array_equal(getattr(td, name).numpy(),
                                          np.asarray(getattr(jd, name)), err_msg=name)
        if spacing:
            np.testing.assert_array_equal(td.timestep_map.numpy(), np.asarray(jd.timestep_map))
        else:
            assert td.timestep_map is None and jd.timestep_map is None
    jd, td = _pair(spacing="ddim5")
    for rescale in (False, True):
        jd = jgd.GuidedDiffusion.create(np.asarray(jd.betas), rescale_timesteps=rescale,
                                        timestep_map=np.asarray(jd.timestep_map),
                                        original_num_steps=T_STEPS)
        td = tgd.GuidedDiffusion.create(td.betas.numpy(), rescale_timesteps=rescale,
                                        timestep_map=td.timestep_map.numpy(),
                                        original_num_steps=T_STEPS, device="cpu")
        jt, tt = _ts(0, 3, 4)
        np.testing.assert_array_equal(td._model_t(tt).numpy(), np.asarray(jd._model_t(jt)))


@pytest.mark.parametrize("mean_type", MEANS)
@pytest.mark.parametrize("var_type", VARS)
def test_p_mean_variance_matches_jax(mean_type, var_type):
    jd, td = _pair(mean_type, var_type)
    learned = var_type.startswith("learned")
    x, _ = _data(0)
    for t in ((0, 7), (T_STEPS - 1, 3)):
        jt, tt = _ts(*t)
        for clip in (True, False):
            want = jd.p_mean_variance(_toy(jnp, learned), jnp.asarray(x), jt, clip)
            got = td.p_mean_variance(_toy(torch, learned), torch.from_numpy(x), tt, clip)
            for key in ("mean", "variance", "log_variance", "pred_xstart"):
                assert tuple(got[key].shape) == (B, H, W, C)
                _close(got[key], want[key])


def _cond_fn(xp):
    def cond_fn(x, t, y=None):
        tt = t.reshape(-1, 1, 1, 1)
        tt = tt.astype(jnp.float32) if xp is jnp else tt.float()
        return -0.2 * x * (1.0 + tt / T_STEPS) + 0.01 * y.reshape(-1, 1, 1, 1)
    return cond_fn


def test_condition_mean_and_score_match_jax():
    """On a respaced process: `cond_fn` gets the model's timestep."""
    jd, td = _pair("eps", "learned_range", spacing="10")
    x, _ = _data(1)
    jt, tt = _ts(9, 2)
    y = np.array([1.0, -2.0], np.float32)
    jkw, tkw = {"y": jnp.asarray(y)}, {"y": torch.from_numpy(y)}
    jout = jd.p_mean_variance(_toy(jnp, True), jnp.asarray(x), jt, model_kwargs=jkw)
    tout = td.p_mean_variance(_toy(torch, True), torch.from_numpy(x), tt, model_kwargs=tkw)
    _close(td.condition_mean(_cond_fn(torch), tout, torch.from_numpy(x), tt, tkw),
           jd.condition_mean(_cond_fn(jnp), jout, jnp.asarray(x), jt, jkw))
    want = jd.condition_score(_cond_fn(jnp), jout, jnp.asarray(x), jt, jkw)
    got = td.condition_score(_cond_fn(torch), tout, torch.from_numpy(x), tt, tkw)
    for key in ("mean", "pred_xstart", "variance"):
        _close(got[key], want[key])
    seen = []
    td.condition_mean(lambda x, t, **kw: seen.append(t) or x, tout, torch.from_numpy(x), tt)
    assert seen[0].tolist() == td.timestep_map[tt].tolist() != tt.tolist()


@pytest.mark.parametrize("step", ["p_sample", "ddim_sample"])
def test_sample_steps_match_jax_with_one_noise(step):
    jd, td = _pair("eps", "learned_range")
    x, _ = _data(2)
    key = jax.random.PRNGKey(4)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))  # what JAX's step draws
    extra = {"eta": 0.5} if step == "ddim_sample" else {}
    for t in ((0, 5), (T_STEPS - 1, 11)):
        jt, tt = _ts(*t)
        for cond in (False, True):
            jkw = {"y": jnp.ones(B)} if cond else None
            tkw = {"y": torch.ones(B)} if cond else None
            want = getattr(jd, step)(_toy(jnp, True), key, jnp.asarray(x), jt,
                                     cond_fn=_cond_fn(jnp) if cond else None,
                                     model_kwargs=jkw, **extra)
            got = getattr(td, step)(_toy(torch, True), None, torch.from_numpy(x), tt,
                                    cond_fn=_cond_fn(torch) if cond else None,
                                    model_kwargs=tkw, noise=torch.from_numpy(noise), **extra)
            _close(got["sample"], want["sample"])
            _close(got["pred_xstart"], want["pred_xstart"])


def test_ddim_loop_matches_jax_on_a_respaced_process():
    jd, td = _pair("eps", "learned_range", spacing="10")
    assert td.num_timesteps == 10
    _, x_t = _data(3)
    calls = []

    def toy(x, t, **kw):
        calls.append(int(t[0]))
        return _toy(torch, True)(x, t)

    want = jd.ddim_sample_loop(_toy(jnp, True), jax.random.PRNGKey(0), x_t.shape,
                               noise=jnp.asarray(x_t), eta=0.0)
    got = td.ddim_sample_loop(toy, torch.Generator().manual_seed(0), x_t.shape,
                              noise=torch.from_numpy(x_t), eta=0.0)
    _close(got, want, atol=1e-4, rtol=0)
    assert calls == td.timestep_map.tolist()[::-1]  # the base process's timesteps
    gen = torch.Generator().manual_seed(5)
    a = td.p_sample_loop(_toy(torch, True), gen, x_t.shape)
    b = td.p_sample_loop(_toy(torch, True), torch.Generator().manual_seed(5), x_t.shape)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


@pytest.mark.parametrize("loss_type", ["mse", "rescaled_mse", "kl", "rescaled_kl"])
@pytest.mark.parametrize("var_type", ["learned_range", "fixed_small"])
def test_vb_terms_and_training_losses_match_jax(loss_type, var_type):
    jd, td = _pair("eps", var_type, loss_type)
    learned = var_type == "learned_range"
    x0, noise = _data(4)
    jt, tt = _ts(0, T_STEPS // 2)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jxt = jd.q_sample(jx, jt, jnp.asarray(noise))
    txt = td.q_sample(tx, tt, torch.from_numpy(noise))
    _close(txt, jxt)
    for clip in (False, True):
        want = jd.vb_terms_bpd(_toy(jnp, learned), jx, jxt, jt, clip)
        got = td.vb_terms_bpd(_toy(torch, learned), tx, txt, tt, clip)
        _close(got["output"], want["output"])
        _close(got["pred_xstart"], want["pred_xstart"])
    want = jd.training_losses(_toy(jnp, learned), jax.random.PRNGKey(0), jx, jt,
                              noise=jnp.asarray(noise))
    got = td.training_losses(_toy(torch, learned), None, tx, tt, noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])


def test_vb_gradient_to_the_mean_half_is_zero_in_both():
    jd, td = _pair("eps", "learned_range", "mse")
    x0, noise = _data(5)
    out = np.random.RandomState(6).randn(B, H, W, 2 * C).astype(np.float32) * 0.3
    jt, tt = _ts(0, 9)

    def jvb(o):
        return jd.training_losses(lambda *a, **k: o, None, jnp.asarray(x0), jt,
                                  noise=jnp.asarray(noise))["vb"].sum()

    jg = np.asarray(jax.grad(jvb)(jnp.asarray(out)))
    o = torch.from_numpy(out).requires_grad_(True)
    td.training_losses(lambda *a, **k: o, None, torch.from_numpy(x0), tt,
                       noise=torch.from_numpy(noise))["vb"].sum().backward()
    tg = o.grad.numpy()
    for g in (jg, tg):
        assert not g[..., :C].any() and np.abs(g[..., C:]).max() > 0
    np.testing.assert_allclose(tg, jg, atol=1e-6, rtol=1e-4)


def test_prior_and_bpd_loop():
    jd, td = _pair("eps", "learned_range", "rescaled_mse")
    x0, _ = _data(7)
    _close(td.prior_bpd(torch.from_numpy(x0)), jd.prior_bpd(jnp.asarray(x0)))
    out = td.calc_bpd_loop(_toy(torch, True), torch.Generator().manual_seed(2),
                           torch.from_numpy(x0))
    for key in ("vb", "xstart_mse", "mse"):
        assert tuple(out[key].shape) == (B, T_STEPS)
        assert bool(torch.isfinite(out[key]).all())
    torch.testing.assert_close(out["total_bpd"], out["vb"].sum(1) + out["prior_bpd"])
    # terms in reversed-t order: the last column is t = 0, the decoder NLL
    gen = torch.Generator().manual_seed(2)
    noises = [torch.randn(x0.shape, generator=gen) for _ in range(T_STEPS)]
    t0 = torch.zeros(B, dtype=torch.int64)
    xt = td.q_sample(torch.from_numpy(x0), t0, noises[-1])
    last = td.vb_terms_bpd(_toy(torch, True), torch.from_numpy(x0), xt, t0)["output"]
    torch.testing.assert_close(out["vb"][:, -1], last)
