"""The policy train step against the JAX package, on the CPU in float32:
`DiffusionPolicy.loss` and its gradients with the JAX draws handed in,
`fused_clip_adamw` leaf for leaf with the clip engaged and not, and three
steps of `make_train_step` with `accumulate` 1 and 2.

Weights: the JAX parameter tree with seeded numpy values, carried into the
port by `convert/from_jax.py::policy_from_jax`; the port is handed the
timesteps and noise that the JAX loss draws from its key.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_policy import random_params  # noqa: E402
from v2a_tpu.models import policy as jpolicy  # noqa: E402
from v2a_tpu.train import train_state as jts  # noqa: E402
from v2a_tpu_torch.convert.from_jax import policy_from_jax  # noqa: E402
from v2a_tpu_torch.models import policy as tpolicy  # noqa: E402
from v2a_tpu_torch.train import train_state as tts  # noqa: E402

# a small policy: the release structure with one block per vision stage
SMALL = dict(image_size=(64, 64), down_dims=(32, 64), vision_stage_sizes=(1, 1, 1, 1),
             vision_stage_features=(16, 32, 64, 128))
# float32 forwards and backwards of the two frameworks: the video U-Net's
# gradient tolerance (tests/test_torch_train.py)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
B = 4


@pytest.fixture(scope="module")
def setup():
    """(JAX policy, its params, the port policy with those weights, a batch)."""
    cfg = jpolicy.PolicyConfig(**SMALL)
    jp = jpolicy.DiffusionPolicy.create(cfg)
    h, w = cfg.image_size
    params = random_params(
        jp.nets, {k: jnp.zeros((1, h, w, 3)) for k in cfg.obs_keys},
        jnp.zeros((1, cfg.horizon, cfg.action_dim)), jnp.zeros((1,), jnp.int32), seed=50)
    tp = tpolicy.DiffusionPolicy.create(tpolicy.PolicyConfig(**SMALL), device="cpu")
    tp.load_state_dict(policy_from_jax(params))
    rs = np.random.RandomState(51)
    batch = {"obs": {k: rs.rand(B, h, w, 3).astype(np.float32) for k in cfg.obs_keys},
             "action": (0.5 * rs.randn(B, cfg.horizon, cfg.action_dim)).astype(np.float32)}
    return jp, params, tp, batch


def _draws(rng, b, shape):
    """The timesteps and noise `v2a_tpu/models/policy.py:244-246` draws from
    `rng`."""
    t_rng, noise_rng = jax.random.split(rng)
    t = np.asarray(jax.random.randint(t_rng, (b,), 0, 100))
    return t, np.asarray(jax.random.normal(noise_rng, (b,) + shape, dtype=jnp.float32))


def _tbatch(batch):
    return {"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()},
            "action": torch.from_numpy(batch["action"])}


def _jbatch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _injected(tp):
    """The port's loss with the JAX draws carried in the batch."""
    return lambda b, gen: tp.loss(b, gen, timesteps=b["t"], noise=b["noise"])


def test_policy_loss_and_grads_match_jax(setup):
    """Loss (rtol 1e-5) and every parameter gradient (GRAD_TOL) of the
    denoising loss with the JAX timesteps and noise."""
    jp, params, tp, batch = setup
    rng = jax.random.PRNGKey(52)
    want, jg = jax.jit(jax.value_and_grad(jp.loss))(params, rng, _jbatch(batch))
    t, noise = _draws(rng, B, (16, 7))
    nets = tpolicy.PolicyNets(tp.config)
    nets.load_state_dict(tp.nets.state_dict())
    port = tpolicy.DiffusionPolicy(tp.config, nets, tp.ddpm, tp.ddim, tp.action_norm,
                                   tp.image_norm, tp.device)
    loss = port.loss(_tbatch(batch), timesteps=torch.from_numpy(t),
                     noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    jg = policy_from_jax(jg)
    got = {k: p.grad for k, p in nets.named_parameters()}
    assert got.keys() == jg.keys()
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("clip", [1e3, 0.05], ids=["clip_not_engaged", "clip_engaged"])
def test_fused_clip_adamw_matches_jax(clip):
    """Two updates of random float32 leaves, leaf for leaf: the updates and
    both moments within rtol 1e-6 (float32 arithmetic in the same order;
    the global norm sums the leaves in another order)."""
    rs = np.random.RandomState(53)
    shapes = [(3, 5), (7,), (2, 3, 4), (11,)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(0.1 * rs.randn(*s)).astype(np.float32) for s in shapes] for _ in range(2)]
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads[0]))
    assert (norm > clip) == (clip < 1)
    jtx = jts.fused_clip_adamw(jts.OptimizerConfig(grad_clip=clip))
    ttx = tts.fused_clip_adamw(tts.OptimizerConfig(grad_clip=clip))
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(2):
        jupd, jstate = jtx.update([jnp.asarray(g) for g in grads[step]], jstate, jp)
        tupd, tstate = ttx.update([torch.from_numpy(g) for g in grads[step]], tstate, tp)
        assert tstate.count == int(jstate.count) == step + 1
        for i in range(len(shapes)):
            for got, want in ((tupd[i], jupd[i]), (tstate.mu[i], jstate.mu[i]),
                              (tstate.nu[i], jstate.nu[i])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)
        jp = [p + u for p, u in zip(jp, jupd)]
        tp = [p + u for p, u in zip(tp, tupd)]


@pytest.mark.parametrize("accumulate,clip", [(1, 10.0), (2, 1.0)],
                         ids=["accumulate1_clip_not_engaged", "accumulate2_clip_engaged"])
def test_train_steps_match_jax(setup, accumulate, clip):
    """Three steps of the port's `make_train_step(policy.loss,
    fused_clip_adamw(cfg), EMAConfig())` against the JAX package's, from the
    same weights, batch, timesteps and noise (global gradient norms 4.8-7.2:
    clip 10 never engages, the release clip 1.0 engages at every step):

    - the loss and the global gradient norm at each step, rtol 1e-4;
    - each step's parameter update on the well-determined elements (|g| >=
      1e-4 at every step so far, g read back from the JAX first moment, and
      an update of at least lr / 10, i.e. not a residue of gradients that
      cancel in the moment) within rtol 2e-2 plus two float32 ulps of the
      weight: Adam divides by the gradient's own scale, so the float32
      gradient differences of the two frameworks' convolutions (up to a few
      1e-4 relative) come back amplified where the moments cancel; at least
      half of the elements are well determined at each step;
    - every parameter and EMA element within 2 * lr, since Adam moves an
      element by about lr whatever the size of its gradient, so a
      near-zero gradient of either sign moves it by +-lr
      (tests/test_torch_train.py::test_trainer_steps_match_jax);
    - the port's EMA is ema_decay(step) * ema + (1 - decay) * params of its
      own weights, with the JAX package's decay, within two float32 ulps of
      the larger of the two terms (the sum may cancel)."""
    jp, params, tp, batch = setup
    lr = 1e-4
    jtx = jts.fused_clip_adamw(jts.OptimizerConfig(lr=lr, grad_clip=clip))
    jstep = jax.jit(jts.make_train_step(jp.loss, jtx, jts.EMAConfig(), accumulate))
    jstate = jts.TrainState.create(params, jtx)
    nets = tpolicy.PolicyNets(tp.config).requires_grad_(True)
    nets.load_state_dict(tp.nets.state_dict())
    port = tpolicy.DiffusionPolicy(tp.config, nets, tp.ddpm, tp.ddim, tp.action_norm,
                                   tp.image_norm, tp.device)
    ttx = tts.fused_clip_adamw(tts.OptimizerConfig(lr=lr, grad_clip=clip))
    tstate = tts.PolicyTrainState(nets, ttx)
    tstep = tts.make_train_step(_injected(port), ttx, tts.EMAConfig(), accumulate)
    mb = B // accumulate
    split = jax.tree_util.tree_map(lambda a: a.reshape((accumulate, mb) + a.shape[1:]), batch)
    rng, sure, clipped, mu_prev = jax.random.PRNGKey(54), None, [], None
    for step in range(3):
        rng, sub = jax.random.split(rng)
        subs = [sub] if accumulate == 1 else list(jax.random.split(sub, accumulate))
        draws = [_draws(r, mb, (16, 7)) for r in subs]
        tb = _tbatch(batch if accumulate == 1 else split)
        tb["t"] = torch.from_numpy(np.stack([d[0] for d in draws]))
        tb["noise"] = torch.from_numpy(np.stack([d[1] for d in draws]))
        if accumulate == 1:
            tb["t"], tb["noise"] = tb["t"][0], tb["noise"][0]
        jbefore = policy_from_jax(jstate.params)
        before = {k: v.clone() for k, v in nets.state_dict().items()}
        ema_before = [e.clone() for e in tstate.ema_params]
        jstate, jloss, jnorm = jstep(jstate, sub, _jbatch(batch if accumulate == 1 else split))
        out = tstep(tstate, tb)
        np.testing.assert_allclose(out.loss.item(), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(out.grad_norm.item(), float(jnorm), rtol=1e-4)
        clipped.append(bool(float(jnorm) > clip))
        # this step's gradient from the JAX first moment
        scale = clip / max(float(jnorm), clip)
        mu = policy_from_jax(jstate.opt_state.mu)
        g = {k: (np.asarray(m) - (0 if mu_prev is None else 0.95 * np.asarray(mu_prev[k])))
             / (0.05 * scale) for k, m in mu.items()}
        mu_prev = mu
        big = {k: np.abs(v) >= 1e-4 for k, v in g.items()}
        sure = big if sure is None else {k: sure[k] & big[k] for k in big}
        want, wema = policy_from_jax(jstate.params), policy_from_jax(jstate.ema_params)
        got = nets.state_dict()
        gema = dict(zip(tstate.names, tstate.ema_params))
        n_det = n_all = 0
        for k in want:
            jb = np.asarray(jbefore[k])
            upd, jupd = (got[k] - before[k]).numpy(), np.asarray(want[k]) - jb
            m = sure[k] & (np.abs(jupd) >= 0.1 * lr)
            n_det, n_all = n_det + int(m.sum()), n_all + m.size
            ulp = np.spacing(np.abs(jb[m]).astype(np.float32))
            bad = np.abs(upd[m] - jupd[m]) > 2e-2 * np.abs(jupd[m]) + 2 * ulp
            assert not bad.any(), (k, upd[m][bad][:4], jupd[m][bad][:4])
            for name, g_, w_ in (("params", got, want), ("ema", gema, wema)):
                np.testing.assert_allclose(g_[k].numpy(), np.asarray(w_[k]), rtol=0,
                                           atol=2 * lr, err_msg=f"{name} {k}")
        assert n_det > 0.5 * n_all, (n_det, n_all)
        decay = float(jts.ema_decay(jnp.asarray(step + 1), jts.EMAConfig()))
        for e, e0, p in zip(tstate.ema_params, ema_before, tstate.params):
            kept, taken = (decay * e0).numpy(), ((1 - decay) * p.detach()).numpy()
            ulp = np.spacing(np.maximum(np.abs(kept), np.abs(taken)))
            assert np.all(np.abs(e.numpy() - (kept + taken)) <= 2 * ulp)
    assert clipped == ([True] * 3 if clip <= 1 else [False] * 3)
    assert tstate.step == int(jstate.step) == 3
