"""The transformer action denoiser (`models/transformer_policy.py`) in the
port against the JAX package, on the CPU in float32.

One set of seeded numpy weights (`random_params`, position embeddings
included) through `convert/from_jax.py::transformer_from_jax`, loaded
strictly; the same inputs to both: every mode of the module (time token as
memory or BERT-style, with and without observation tokens from a 2-D
`global_cond` over `n_obs_steps`, causal with the shifted memory mask, the
Mish MLP or encoder layers over the memory), atol 2e-5 / rtol 1e-5; and the
causal mask blocking the future: the outputs before the last step do not
move when the last input does.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_video import japply, random_params  # noqa: E402
from v2a_tpu.models import transformer_policy as jtp  # noqa: E402
from v2a_tpu_torch.convert.from_jax import transformer_from_jax  # noqa: E402
from v2a_tpu_torch.models import transformer_policy as ttp  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-5)
BASE = dict(input_dim=7, output_dim=7, horizon=8, n_layer=2, n_head=2, n_emb=64)
MODES = {
    "time_cond_obs_mlp": dict(cond_dim=32, n_obs_steps=2),
    "time_cond_no_obs": dict(),
    "bert_causal": dict(time_as_cond=False, causal_attn=True),
    "causal_obs_encoder": dict(cond_dim=32, n_obs_steps=2, causal_attn=True, n_cond_layers=2),
}


def _pair(seed, **kw):
    jnet = jtp.TransformerForDiffusion(**BASE, **kw)
    rs = np.random.RandomState(seed)
    x = rs.randn(3, 8, 7).astype(np.float32)
    t = np.array([0, 4, 9])
    cond = rs.randn(3, 2 * 32).astype(np.float32) if kw.get("cond_dim") else None
    args = (x, t) + ((cond,) if cond is not None else ())
    params = random_params(jnet, *args, seed=seed)
    net = ttp.TransformerForDiffusion(**BASE, **kw)
    net.load_state_dict(transformer_from_jax(params), strict=True)
    return jnet, params, net.eval().requires_grad_(False), args


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("mode", list(MODES))
def test_transformer_matches_jax(mode):
    jnet, params, net, args = _pair(11, **MODES[mode])
    want = japply(jnet, params, *args)
    got = net(*_torch(args))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 8, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a scalar timestep broadcasts over the batch, as in the JAX module
    want0 = japply(jnet, params, args[0], np.asarray(4), *args[2:])
    got0 = net(_torch(args[:1])[0], torch.tensor(4), *_torch(args[2:]))
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), **TOL)


@pytest.mark.parametrize("mode", ["bert_causal", "causal_obs_encoder"])
def test_causal_mask_blocks_the_future(mode):
    _, _, net, args = _pair(13, **MODES[mode])
    x, rest = _torch(args)[0], _torch(args)[1:]
    out0 = net(x, *rest)
    x2 = x.clone()
    x2[:, -1] += 10.0
    out1 = net(x2, *rest)
    torch.testing.assert_close(out0[:, :-1], out1[:, :-1], atol=1e-5, rtol=0)
    assert (out0[:, -1] - out1[:, -1]).abs().max() > 1e-4


def test_obs_conditioning_needs_its_input():
    _, _, net, args = _pair(17, **MODES["time_cond_obs_mlp"])
    with pytest.raises(ValueError, match="cond_dim"):
        net(*_torch(args[:2]))
