"""The port's mesh (`v2a_tpu_torch/parallel/`) against the JAX package's, on
the CPU.

- The tp rule against JAX's `tp_leaf_spec` at release width: the JAX
  parameter trees of the video model (U-Net and text tower) and the policy
  from `jax.eval_shape`, each leaf replaced by a marker array (zero strides
  but along the trailing dim, its values saying whether JAX shards it),
  mapped through `convert/from_jax.py`: the port shards the same leaves,
  on the dim the marker's stride lands on.
- The single-process cases of `tests/test_parallel_tp.py:22-53`.
- `LossSecondMomentResampler.merge` against JAX's.
- gloo worlds of spawned ranks (`tests/torch_mesh_ranks.py`, one spawn a
  test, a file store under `tmp_path`): the policy step on (dp=2, tp=2)
  against the single-process step and JAX's step on the conftest's virtual
  mesh; the video trainer's dp=2 step against the single-process step and
  JAX's, the sampler histories equal on every rank, and a tp=2 trainer's
  checkpoint loaded bit-equal without a mesh; `shard_for_mesh` + `sample`;
  one online cycle on the fake env; `dryrun_multichip(4)`.

Tolerances are stated in each test.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_online import SMALL_TRUNK, SMOKE  # noqa: E402
from test_torch_policy import random_params  # noqa: E402
from test_torch_policy_train import _draws  # noqa: E402
from test_torch_train import _batch, _jax_noise, _models  # noqa: E402
from v2a_tpu.models import policy as jpolicy  # noqa: E402
from v2a_tpu.models import video_model as jvm  # noqa: E402
from v2a_tpu.ops import resample as jrs  # noqa: E402
from v2a_tpu.parallel import mesh as jmesh  # noqa: E402
from v2a_tpu.parallel import sharding as jsharding  # noqa: E402
from v2a_tpu.train import train_state as jts  # noqa: E402
from v2a_tpu.train import video_trainer as jvt  # noqa: E402
from v2a_tpu_torch.config import load_config_module  # noqa: E402
from v2a_tpu_torch.convert import from_jax  # noqa: E402
from v2a_tpu_torch.models import clip_text as tclip  # noqa: E402
from v2a_tpu_torch.models import policy as tpolicy  # noqa: E402
from v2a_tpu_torch.models import video_model as tvm  # noqa: E402
from v2a_tpu_torch.models import video_unet as tvu  # noqa: E402
from v2a_tpu_torch.ops import resample as trs  # noqa: E402
from v2a_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from v2a_tpu_torch.parallel import multihost as tmh  # noqa: E402
from v2a_tpu_torch.parallel import sharding as tsh  # noqa: E402
from v2a_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from v2a_tpu_torch.train import train_state as tts  # noqa: E402
from v2a_tpu_torch.train import video_trainer as tvt  # noqa: E402

# the fake smoke config's policy with the small trunk (tests/test_torch_online.py)
POLICY_SMALL = dict(image_size=(32, 32), down_dims=(32, 64), **SMALL_TRUNK)
CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
               "LOCAL_WORLD_SIZE")


def _stub_mesh(**shape):
    """What `tp_leaf_spec` reads of a mesh, without a process group."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _spawn(fn, name, world, tmp_path, *args):
    """Start `fn` on `world` gloo ranks on a thread (the test computes its
    references meanwhile); the returned call joins them and loads what each
    rank saved as `name`."""
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    failed = []

    def run():
        try:
            tmh.spawn_ranks(fn, world, str(tmp_path / "store"), args=(str(out), *args))
        except BaseException as exc:  # re-raised by the join
            failed.append(exc)

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if failed:
            raise failed[0]
        return [torch.load(out / f"{name}-{r}.pt", weights_only=False) for r in range(world)]

    return join


# -- the tp rule at release width ---------------------------------------------

def _marked(shapes, jax_mesh):
    """Each leaf a float32 view of its shape, strides zero but along the
    trailing dim, every value 1 where JAX's rule shards the leaf, else -1."""
    def mark(s):
        shape = tuple(s.shape)
        if not shape:
            return np.zeros((), np.float32)
        flag = 1.0 if "tp" in str(jsharding.tp_leaf_spec(s, jax_mesh)) else -1.0
        base = np.full(shape[-1], flag, np.float32)
        strides = (0,) * (len(shape) - 1) + (4,)
        return np.lib.stride_tricks.as_strided(base, shape, strides)

    return jax.tree_util.tree_map(mark, shapes)


def _jax_dims(monkeypatch, convert, tree):
    """{port name: (JAX shards it, the port dim of JAX's trailing dim)}."""
    got = {}

    def record(a):
        dims = [i for i, st in enumerate(a.strides) if st != 0]
        t = torch.empty(a.shape, device="meta")
        t.jax = (bool(a.ndim and a.flat[0] > 0), dims[0] if dims else None)
        return t

    monkeypatch.setattr(from_jax, "_tensor", record)
    for name, t in convert(tree).items():
        got[name] = t.jax
    return got


@pytest.mark.parametrize("family", ["video", "policy"])
def test_tp_rule_matches_jax_at_release_width(monkeypatch, family):
    """At tp=2, min_size 256 (both trainers' rule): the port shards exactly
    the leaves JAX shards, each on the torch dim that holds JAX's trailing
    dim (the video U-Net's and text tower's Linear weights on dim 0, their
    HWIO conv kernels on dim 3; the policy's convs on dim 0, its transposed
    up-convs on dim 1)."""
    jax_mesh = jmesh.make_mesh(("dp", "tp"), (4, 2))
    if family == "video":
        shapes = jax.eval_shape(jvm.VideoPredModel(jvm.VideoModelConfig()).init,
                                jax.random.PRNGKey(0))
        marked = _marked(shapes, jax_mesh)
        want = _jax_dims(monkeypatch, lambda m: from_jax.video_model_from_jax(
            m["unet"], m["text"]), marked)
        cfg = tvm.VideoModelConfig()
        with torch.device("meta"):
            net = tvm.VideoNets(tvu.VideoUNet(), tclip.ClipTextEncoder(
                width=cfg.text_dim, mlp_dim=cfg.text_dim * 4))
    else:
        jp = jpolicy.DiffusionPolicy.create(jpolicy.PolicyConfig())
        marked = _marked(jax.eval_shape(jp.init, jax.random.PRNGKey(0)), jax_mesh)
        want = _jax_dims(monkeypatch, from_jax.policy_from_jax, marked)
        with torch.device("meta"):
            net = tpolicy.PolicyNets(tpolicy.PolicyConfig())
    mesh = _stub_mesh(dp=4, tp=2)
    dims = tsh.tp_dims(net)
    got = {k: tsh.tp_leaf_spec(p, mesh, dim=dims[k]) for k, p in net.named_parameters()}
    assert got.keys() == want.keys()
    sharded = {k for k, (s, _) in want.items() if s}
    assert sharded == {k for k, d in got.items() if d is not None}
    assert len(sharded) > 50
    for k in sharded:
        assert got[k] == want[k][1], k
    if family == "video":
        assert got["unet.time_dense0.weight"] == 0 and got["unet.in_conv.spatial_conv.kernel"] is None
        assert got["unet.down_res_2.in_conv.spatial_conv.kernel"] == 3


# -- single-process cases (tests/test_parallel_tp.py:22-53) -------------------

def test_tp_leaf_spec_rules():
    """The JAX test's cases on a stub (dp=2, tp=4) mesh: a wide trailing
    dim shards, a narrow or indivisible one does not, no tp axis shards
    nothing; `dim` names the JAX trailing dim's place in torch's layout."""
    mesh = _stub_mesh(dp=2, tp=4)
    assert tsh.tp_leaf_spec(torch.zeros(16, 512), mesh) == 1
    assert tsh.tp_leaf_spec(torch.zeros(16, 64), mesh) is None
    assert tsh.tp_leaf_spec(torch.zeros(16, 258), mesh) is None
    assert tsh.tp_leaf_spec(torch.zeros(512, 16), mesh, dim=0) == 0
    assert tsh.tp_leaf_spec(torch.zeros(512), mesh) == 0
    assert tsh.tp_leaf_spec(torch.zeros(16, 512), _stub_mesh(dp=8)) is None


def test_make_mesh_shapes_must_fit_the_world(monkeypatch):
    """A shape whose product is not the world (one process here) raises, as
    does a shape that does not name its axes; a mesh is a `Mesh`."""
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="#ranks 1"):
        tmesh.make_mesh(("dp", "tp"), (2, 4), device="cpu")
    with pytest.raises(ValueError, match="does not name"):
        tmesh.make_mesh(("dp", "tp"), (1,), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tmesh.check_mesh(jax_mesh_of_one())
    assert not dist.is_initialized()


def jax_mesh_of_one():
    return jmesh.make_mesh(("dp",), (1,), devices=jax.devices()[:1])


def test_one_rank_meshes_and_dp_axes(monkeypatch):
    """In one process `make_mesh` starts a one-rank gloo group: the (dp,
    tp) mesh's dp axes, the hybrid mesh's axes and shape, and a mesh with
    no dp axis raising (`dp_axis_names`), as the JAX tests check them."""
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    try:
        mesh = tmesh.make_mesh(("dp", "tp"), (1, 1), device="cpu")
        assert mesh.axis_names == ("dp", "tp") and mesh.shape == {"dp": 1, "tp": 1}
        assert tsh.dp_axis_names(mesh) == ("dp",)
        assert tsh.batch_sharding(mesh) == tsh.RowShard(0, 1)
        assert tmesh.local_batch_multiple(mesh) == 1
        hybrid = tmh.make_hybrid_mesh(device="cpu")
        assert hybrid.axis_names == ("dp_dcn", "dp_ici")
        assert hybrid.shape == {"dp_dcn": 1, "dp_ici": 1}
        assert tsh.dp_axis_names(hybrid) == ("dp_dcn", "dp_ici")
        assert hybrid.size(("dp_dcn", "dp_ici")) == 1
        with pytest.raises(ValueError, match="no dp axis"):
            tsh.dp_axis_names(tmesh.make_mesh(("tp",), device="cpu"))
        rows = tsh.shard_batch({"a": np.arange(4), "n": 3}, mesh)
        assert torch.equal(rows["a"], torch.arange(4)) and rows["n"] == 3
        same = tsh.replicate({"w": np.ones(3, np.float32), "s": "x"}, mesh)
        assert torch.equal(same["w"], torch.ones(3)) and same["s"] == "x"
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_single_process(monkeypatch):
    """No cluster environment: `False`, and no process group; a partial one
    (torchrun's variables half set) raises."""
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert tmh.initialize_distributed() is False
    assert not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="incomplete cluster environment"):
        tmh.initialize_distributed(device="cpu")
    with pytest.raises(ValueError, match="go together"):
        tmh.initialize_distributed("localhost:1", 2)


def test_merge_matches_jax():
    """The same (t, loss) pairs folded by `update_with_losses` and `merge`
    (the other ranks' rows): the same history and weights as JAX's."""
    js, ts = jrs.LossSecondMomentResampler(6, 3), trs.LossSecondMomentResampler(6, 3)
    rs = np.random.RandomState(4)
    for _ in range(12):
        t, loss = rs.randint(0, 6, 4), rs.rand(4)
        for s in (js, ts):
            s.update_with_losses(t[:2], loss[:2])
            s.merge(t[2:], loss[2:])
    assert ts._warmed_up() and js._warmed_up()
    np.testing.assert_array_equal(ts._loss_history, js._loss_history)
    np.testing.assert_array_equal(ts.weights(), js.weights())


# -- gloo worlds --------------------------------------------------------------

def test_policy_step_on_a_dp_tp_mesh(tmp_path):
    """One policy step on (dp=2, tp=2), leaves of 64 and more sharded (the
    JAX test's `tp_min_size=64`), the JAX draws handed in (rows of the
    global batch of 8):

    - every rank holds the same loss, grad norm, parameters and EMA;
    - against the port's single-process step on the global batch: loss and
      grad norm rtol 1e-5; parameters and EMA within 2 * lr, and all but
      0.1% of their elements within 1e-3 * lr + 1e-7 (Adam divides a
      gradient by its own size, so where it is near zero the float32
      difference of the dp mean and the one-batch mean is amplified);
    - against JAX's step with its state sharded on the virtual (2, 2) mesh:
      loss and grad norm rtol 1e-4, parameters and EMA within 2 * lr (Adam
      moves an element by about lr whatever its gradient,
      `tests/test_torch_policy_train.py`);
    - the port shards as many leaves as JAX places sharded; a sharded leaf's moments
      take 1/tp of its elements on a rank, and its parameter holds none
      outside the step."""
    lr, clip, b, min_size = 1e-4, 1.0, 8, 64
    cfg = jpolicy.PolicyConfig(**POLICY_SMALL)
    jp = jpolicy.DiffusionPolicy.create(cfg)
    h, w = cfg.image_size
    params = random_params(
        jp.nets, {k: jnp.zeros((1, h, w, 3)) for k in cfg.obs_keys},
        jnp.zeros((1, cfg.horizon, cfg.action_dim)), jnp.zeros((1,), jnp.int32), seed=60)
    rs = np.random.RandomState(61)
    batch = {"obs": {k: rs.rand(b, h, w, 3).astype(np.float32) for k in cfg.obs_keys},
             "action": (0.5 * rs.randn(b, cfg.horizon, cfg.action_dim)).astype(np.float32)}
    sub = jax.random.PRNGKey(62)
    t, noise = _draws(sub, b, (cfg.horizon, cfg.action_dim))
    weights = {k: v.numpy() for k, v in from_jax.policy_from_jax(params).items()}
    join = _spawn(ranks.policy_step, "policy", 4, tmp_path, POLICY_SMALL, weights, batch, t,
                  noise, lr, clip, min_size)
    jtx = jts.fused_clip_adamw(jts.OptimizerConfig(lr=lr, grad_clip=clip))
    jstep = jax.jit(jts.make_train_step(jp.loss, jtx, jts.EMAConfig()))
    jax_mesh = jmesh.make_mesh(("dp", "tp"), (2, 2), devices=jax.devices()[:4])
    jstate = jsharding.shard_train_state(jts.TrainState.create(params, jtx), jax_mesh,
                                         min_size=min_size)
    n_jax_sharded = sum("tp" in str(x.sharding.spec)
                        for x in jax.tree_util.tree_leaves(jstate.params))
    jstate, jloss, jnorm = jstep(jstate, sub, jsharding.shard_batch(
        jax.tree_util.tree_map(jnp.asarray, batch), jax_mesh))

    single = tpolicy.DiffusionPolicy.create(tpolicy.PolicyConfig(**POLICY_SMALL),
                                            device="cpu").load_state_dict(weights)
    single.nets.requires_grad_(True)
    ttx = tts.fused_clip_adamw(tts.OptimizerConfig(lr=lr, grad_clip=clip))
    sstate = tts.PolicyTrainState(single.nets, ttx)
    tb = {"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()},
          "action": torch.from_numpy(batch["action"])}
    sout = tts.make_train_step(lambda bb, g: single.loss(
        bb, g, timesteps=torch.from_numpy(t), noise=torch.from_numpy(noise)), ttx,
        tts.EMAConfig())(sstate, tb)
    sparams = single.nets.state_dict()
    sema = dict(zip(sstate.names, sstate.ema_params))

    got = join()
    r0 = got[0]
    for r in got[1:]:
        assert (r["loss"], r["grad_norm"]) == (r0["loss"], r0["grad_norm"])
        assert all(torch.equal(r["params"][k], r0["params"][k]) for k in r0["params"])
        assert all(torch.equal(r["ema"][k], r0["ema"][k]) for k in r0["ema"])
    np.testing.assert_allclose(r0["loss"], sout.loss.item(), rtol=1e-5)
    np.testing.assert_allclose(r0["grad_norm"], sout.grad_norm.item(), rtol=1e-5)
    np.testing.assert_allclose(r0["loss"], float(jloss), rtol=1e-4)
    np.testing.assert_allclose(r0["grad_norm"], float(jnorm), rtol=1e-4)
    jparams = from_jax.policy_from_jax(jstate.params)
    jema = from_jax.policy_from_jax(jstate.ema_params)
    n_off = n_all = 0
    for k in sparams:
        for mine, one, jx in ((r0["params"][k], sparams[k], jparams[k]),
                              (r0["ema"][k], sema[k], jema[k])):
            diff = (mine - one.detach()).abs()
            n_off, n_all = n_off + int((diff > 1e-3 * lr + 1e-7).sum()), n_all + diff.numel()
            for want in (one.detach(), jx):
                np.testing.assert_allclose(mine.numpy(), want.numpy(), rtol=0, atol=2 * lr,
                                           err_msg=k)
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
    assert len(r0["sharded"]) == n_jax_sharded > 0
    assert all(local * 2 == full for local, full in r0["moments"].values())
    assert r0["released"] == r0["sharded"]


VIDEO_TRAIN = dict(batch_size=2, lr=1e-4, schedule_sampler="loss-second-moment",
                   n_train_steps=2, save_freq=10 ** 9, log_freq=10 ** 9)
# a U-Net with leaves of 256 (the trainers' `min_size`): the tp mesh's model
WIDE = dict(image_size=(8, 8), sample_per_seq=3, timesteps=4, sampling_timesteps=4,
            model_channels=64, channel_mult=(1, 4), num_res_blocks=1,
            attention_resolutions=(), num_head_channels=32, text_dim=64)


def test_video_trainer_on_a_dp_mesh(tmp_path):
    """`VideoModelTrainer` on two gloo ranks.

    dp=2, `tests/test_torch_train.py`'s small model, one step on a
    handed-in global batch of 2 and the JAX noise: the loss and the
    per-sample losses rtol 1e-5 of the port's single-process step and rtol
    1e-4 / atol 1e-6 of JAX's step on a dp=2 virtual mesh; the gradients
    (the dp mean, the clip not engaged) of the single-process step's within
    rtol 1e-4 plus 1e-5 of the leaf's largest gradient plus 1e-8 (two rows
    summed apart against together: float32 sum order; this model's
    time-embedding gradients are all below 1e-8, the residue of cancelling
    sums); parameters and EMA within 2 * lr of both (Adam moves an element
    by about lr whatever its gradient, so where that is residue the
    update's sign is the noise's). Then `train(3)` with the
    loss-second-moment sampler on seeded clips: the sampler's history
    bit-equal on both ranks and rtol 1e-5 of the single-process run's, the
    parameters within 2 * lr.

    tp=2 (`WIDE`, leaves of 256 sharded): `train(1)`, then its checkpoint
    (written by rank 0) loads into a trainer without a mesh bit-equal to
    the state the ranks gathered (parameters, moments, EMA, step), the
    gathered parameters are the same on both ranks, and the mesh trainer
    reloads its own slices bit-equal."""
    jm, tm = _models()
    rs = np.random.RandomState(9)
    video, x_cond, te = _batch(rs)
    t, wts = np.array([3, 1]), np.array([0.5, 2.0], np.float32)
    sub = jax.random.PRNGKey(11)
    noise = _jax_noise(sub, video.shape)
    x_cond_n = (x_cond * 2 - 1)[:, None]
    args = (video, x_cond_n, te, t, wts)
    weights = {k: v.clone() for k, v in tm.nets.state_dict().items()}
    join = _spawn(ranks.video_trainer, "video", 2, tmp_path, dataclasses.asdict(tm.config),
                  weights, args, noise, VIDEO_TRAIN, WIDE)

    jax_mesh = jmesh.make_mesh(("dp",), (2,), devices=jax.devices()[:2])
    jt = jvt.VideoModelTrainer(jm, None, jvt.VideoTrainerConfig(batch_size=2, lr=1e-4),
                               workdir=str(tmp_path / "jax"), mesh=jax_mesh)
    jargs = jsharding.shard_batch(tuple(jnp.asarray(a) for a in args), jax_mesh)
    jt.state, jloss, jps = jt._train_step(jt.state, sub, *jargs)

    st = tvt.VideoModelTrainer(tm, ranks.Clips(), tvt.VideoTrainerConfig(**VIDEO_TRAIN),
                               workdir=str(tmp_path / "single"), seed=0)
    sloss, sps = st.train_step(*(torch.from_numpy(a) for a in args), noise=torch.from_numpy(noise))
    sfirst = {k: v.clone() for k, v in st.train_unet.state_dict().items()}
    sgrads = {k: p.grad.clone() for k, p in st.train_unet.named_parameters()}
    sema = {k: v.clone() for k, v in st.state.ema.items()}
    st.train(2)
    st.close()

    got = join()
    lr = VIDEO_TRAIN["lr"]
    first = got[0]["first"]
    np.testing.assert_allclose(first["loss"], sloss.item(), rtol=1e-5)
    np.testing.assert_allclose(first["per_sample"].numpy(), sps.numpy(), rtol=1e-5)
    np.testing.assert_allclose(first["loss"], float(jloss), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(first["per_sample"].numpy(), np.asarray(jps), rtol=1e-4,
                               atol=1e-6)
    jparams = from_jax.video_tree(jt.state.params, "")
    jema = from_jax.video_tree(jt.state.ema_params, "")
    for k in sfirst:
        want = sgrads[k].numpy()
        np.testing.assert_allclose(first["grads"][k].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()) + 1e-8, err_msg=k)
        for mine, one, jx in ((first["params"][k], sfirst[k], jparams[k]),
                              (first["ema"][k], sema[k], jema[k])):
            for want in (one, jx):
                np.testing.assert_allclose(mine.numpy(), want.numpy(), rtol=0, atol=2 * lr,
                                           err_msg=k)
    runs = [g["run"] for g in got]
    assert np.array_equal(runs[0]["history"], runs[1]["history"])
    assert np.array_equal(runs[0]["counts"], runs[1]["counts"])
    assert np.array_equal(runs[0]["counts"], st.sampler._loss_counts)
    np.testing.assert_allclose(runs[0]["history"], st.sampler._loss_history, rtol=1e-5)
    for k, v in st.train_unet.state_dict().items():
        np.testing.assert_allclose(runs[0]["params"][k].numpy(), v.numpy(), rtol=0,
                                   atol=2 * lr, err_msg=k)

    assert got[0]["wide_sharded"] > 0 and all(g["reloaded"] for g in got)
    saved = torch.load(tmp_path / "out" / "b_state.pt", weights_only=False)
    assert all(torch.equal(v, got[1]["wide_params"][k]) for k, v in saved["params"].items())
    model = tvm.VideoPredModel(tvm.VideoModelConfig(**WIDE), device="cpu").init(1)
    plain = tvt.VideoModelTrainer(model, None, tvt.VideoTrainerConfig(**VIDEO_TRAIN),
                                  workdir=str(tmp_path / "out" / "b"))
    plain.load()
    loaded = plain.state.state_dict(plain.train_unet)
    assert loaded["step"] == saved["step"] == 1
    for part in ("params", "ema_params"):
        assert all(torch.equal(loaded[part][k], v) for k, v in saved[part].items()), part
    sa, sb = loaded["opt_state"]["state"], saved["opt_state"]["state"]
    assert sa.keys() == sb.keys() and all(
        torch.equal(sa[i][k], sb[i][k]) for i in sb for k in sb[i])
    plain.close()


def test_sample_on_a_mesh(tmp_path):
    """`shard_for_mesh` then `sample` (B=2, the 4-step ancestral chain, one
    generator seed) on two gloo ranks: on a dp=2 mesh each rank denoises its
    row of the global draws and returns the whole batch, within 1e-5 of the
    single-process sample (a batch of 1 against 2 rounds differently on the
    CPU); on a (1, 2) tp mesh the wide leaves are stored sharded (released
    outside the chain) and the sample is bit-equal to the single process's."""
    small = dict(WIDE, model_channels=32, channel_mult=(1,))
    rs = np.random.RandomState(12)
    x = rs.rand(2, 8, 8, 3).astype(np.float32)
    tasks = ["push the button", "open the drawer"]
    join = _spawn(ranks.sampler, "sampler", 2, tmp_path, small, WIDE, x, tasks)
    want = {}
    for name, kw in (("dp", small), ("tp", WIDE)):
        model = tvm.VideoPredModel(tvm.VideoModelConfig(**kw), device="cpu").init(3)
        want[name] = model.sample(torch.from_numpy(x), tasks,
                                  generator=torch.Generator().manual_seed(5))
    got = join()
    for r in got:
        assert r["dp"]["n_sharded"] == 0 and r["tp"]["n_sharded"] > 0 and r["tp"]["released"]
        np.testing.assert_allclose(r["dp"]["video"].numpy(), want["dp"].numpy(), rtol=0,
                                   atol=1e-5)
        assert torch.equal(r["tp"]["video"], want["tp"])
    assert torch.equal(got[0]["dp"]["video"], got[1]["dp"]["video"])


def test_online_cycle_keeps_equal_buffers(tmp_path):
    """`build_experiment` with `mesh_axes=("auto_dp",)` on two gloo ranks
    (the fake smoke config, the small trunk, a batch of 8 split 4 + 4):
    six steps with one guided cycle (step 5) leave the same buffers on both ranks
    (the cycle's digest check passed; equal digests), and a buffer changed
    on one rank makes the check raise on both."""
    exp = load_config_module(SMOKE).replace(device="cpu", mesh_axes=("auto_dp",))
    exp = exp.replace(policy=dataclasses.replace(exp.policy, **SMALL_TRUNK),
                      trainer=dataclasses.replace(exp.trainer, n_train_steps=6,
                                                  video_explo_freq=5))
    got = _spawn(ranks.online_cycle, "online", 2, tmp_path, exp)()
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["rollouts"] == got[1]["rollouts"] == 2
    assert got[0]["raised"] and got[1]["raised"]


def test_dryrun_multichip():
    """Four gloo ranks as (dp=2, tp=2): the policy step and the dp-split
    DDIM chain hold against one process (the dry run's own tolerances)."""
    dryrun_multichip(4)
