"""The port's online loop against the JAX package's, on the CPU.

- `GuidedRolloutExecutor.execute` with one numpy policy and one generator,
  the grasp injection triggered: episodes and generator states equal;
- `IterTypeScheduler` and `ExploreThrottle` over a few hundred steps;
- the slice as a whole: the JAX and the port `OnlineTrainer` on the
  `fake_smoke` config with the scripted oracle video model, one policy
  carried across by `train_state_from_jax`, and the executor's policy
  replaced on both sides by one numpy stub: `live_rand_explore` and one
  `video_guided_explore` fill equal buffers, the first `sample_from_bufs`
  batch is equal, and `to_device_batch` gives the JAX batch within 1e-6;
  the JAX side runs no train step or DDIM program;
- the eval protocol: the JAX and the port `Evaluator` on one fake world
  with one numpy policy and the oracle video model: equal successes, rates,
  episode frames, guidance videos and result files;
- the experiment configs: each of the port's config files loads to the JAX
  tree field by field, `parse_cli` / `apply_overrides` on one argv give
  equal trees, and the snapshot round-trips;
- the port alone: `scripts/train.main` on `fake_smoke` (`--device cpu`),
  resumed into a fresh trainer; `scripts/eval.main` on its workdir; the
  prefetcher flushed around buffer mutations; the options not ported yet
  (the mesh, a converted checkpoint) raising `NotImplementedError`, and
  `from_h5` with a missing file raising the JAX ingestion's error.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import one_torch_thread  # noqa: E402, F401 (autouse)
from test_torch_policy import random_params  # noqa: E402
from v2a_tpu import config as jconfig  # noqa: E402
from v2a_tpu.data import h5_ingest as jh5  # noqa: E402
from v2a_tpu.config import load_config_module as jload_config  # noqa: E402
from v2a_tpu.eval import harness as jharness  # noqa: E402
from v2a_tpu.envs import fake as jfake  # noqa: E402
from v2a_tpu.envs import fake_oracle as joracle  # noqa: E402
from v2a_tpu.models import policy as jpolicy  # noqa: E402
from v2a_tpu.train import build as jbuild  # noqa: E402
from v2a_tpu.train import explore as jexplore  # noqa: E402
from v2a_tpu.train import trainer as jtrainer  # noqa: E402
from v2a_tpu_torch import config as tconfig  # noqa: E402
from v2a_tpu_torch.config import load_config_module, load_snapshot  # noqa: E402
from v2a_tpu_torch.convert.from_jax import policy_from_jax, train_state_from_jax  # noqa: E402
from v2a_tpu_torch.envs import fake as tfake  # noqa: E402
from v2a_tpu_torch.envs import fake_oracle as toracle  # noqa: E402
from v2a_tpu_torch.eval import harness as tharness  # noqa: E402
from v2a_tpu_torch.parallel.prefetch import PrefetchIterator  # noqa: E402
from v2a_tpu_torch.scripts import eval as eval_script  # noqa: E402
from v2a_tpu_torch.scripts import train as train_script  # noqa: E402
from v2a_tpu_torch.train import build as tbuild  # noqa: E402
from v2a_tpu_torch.train import explore as texplore  # noqa: E402
from v2a_tpu_torch.train import trainer as ttrainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "v2a_tpu_torch", "config", "fake", "fake_smoke.py")
JAX_SMOKE = os.path.join(ROOT, "v2a_tpu", "config", "fake", "fake_smoke.py")
# fake_smoke with the learning gate's vision trunk (`fake_learn.py`): the
# release trunk's four stages of up to 512 channels take most of these
# tests' CPU time otherwise
SMALL_TRUNK = dict(vision_stage_sizes=(1, 1), vision_stage_features=(32, 64))


def _chaser(n_acts):
    """A deterministic numpy policy: steps toward the goal frame's end
    effector as the fake world decodes it, gripper per the oracle rule."""

    def policy_fn(img_obs01, img_goal01):
        obs = joracle.decode_frame(np.asarray(img_obs01)[0])
        goal = joracle.decode_frame(np.asarray(img_goal01)[0])
        act = joracle.oracle_action(obs["ee_pos"], goal["ee_pos"], 0.05, 0.02)
        return np.repeat(act[None], n_acts, axis=0)

    return policy_fn


def _equal_results(a, b):
    for f in ("imgs", "acts", "pred_video"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.is_success, a.n_env_steps) == (b.is_success, b.n_env_steps)


@pytest.mark.parametrize("act_down_val", [-0.9, None], ids=["fixed", "per_task_table"])
def test_guided_rollout_matches_jax(act_down_val):
    """Both executors chase the oracle's guidance video in the learn-gate
    world with one numpy policy and generators from one seed: the episodes,
    the grasp injection (16 down + 8 close actions), success and the
    generators' next draws agree."""
    env_kw = dict(num_tasks=2, img_hw=(32, 32), step_scale=0.05, grasp_radius=0.15,
                  obj_window_xy=0.12)
    cfg_kw = dict(n_acts_per_pred=4, n_preds_betw_vframes=(1, 3), act_down_val=act_down_val,
                  grasp_z_diff_limit=0.42, grasp_abs_z_limit=0.7)
    sides = []
    for fake, oracle, explore in ((jfake, joracle, jexplore), (tfake, toracle, texplore)):
        envs = fake.FakeEnvList(**env_kw)
        rng = np.random.default_rng(9)
        ex = explore.GuidedRolloutExecutor(envs, _chaser(4), explore.ExploreConfig(**cfg_kw), rng)
        vm = oracle.FakeOracleVideoModel(envs.task_to_task_idx, horizon=7)
        results = []
        for task in envs.task_list:
            idx = envs.seed_sets[task][0]
            envs.init_1_given_env(task, idx, e_seed=77 + len(results))
            start = envs.render_an_env(task, "agent", idx)
            video = vm.sample_u8(None, start[None].astype(np.float32) / 255.0, [task])[0]
            results.append(ex.execute(task, "agent", idx, start, video))
            envs.close_1_given_env(task, idx)
        sides.append((results, rng.integers(1 << 30)))
    for a, b in zip(sides[0][0], sides[1][0]):
        _equal_results(a, b)
        # the injected down actions are the only rows with the gripper at 0
        assert (b.acts[:, 6] == 0).sum() == 16, "the grasp injection did not fire once"
    assert sides[0][1] == sides[1][1]


def test_schedulers_match_jax():
    """The iteration scheduler and the explore throttle step by step over
    300 steps under several cycle settings (growing buffers for the
    throttle)."""
    settings = [
        dict(init_rand_steps=5, rand_cycle_steps=2, vid_cycle_steps=3),
        dict(init_rand_steps=0, rand_cycle_steps=0, vid_cycle_steps=4),
        dict(init_rand_steps=10, rand_cycle_steps=7, vid_cycle_steps=0),
        dict(noExp_start_buf_len_rand=3, noExp_start_buf_len_vid=20, Exp_noExp_rand=(5, 3),
             Exp_noExp_vid=(4, 6)),
        dict(enable_noExp=False, noExp_start_buf_len_rand=0),
    ]
    for kw in settings:
        jc, tc = jtrainer.TrainerConfig(**kw), ttrainer.TrainerConfig(**kw)
        js, ts = jtrainer.IterTypeScheduler(jc), ttrainer.IterTypeScheduler(tc)
        jt, tt = jtrainer.ExploreThrottle(jc), ttrainer.ExploreThrottle(tc)
        for step in range(300):
            assert ts.update(step) == js.update(step), (kw, step)
            ts.count()
            js.count()
            jt.update(step // 4, step // 6)
            tt.update(step // 4, step // 6)
            assert vars(ts) == {**vars(js), "cfg": tc}
            assert vars(tt) == {**vars(jt), "cfg": tc}


def _goal_chaser(n_acts):
    """A deterministic numpy eval policy: steps toward the goal frame's end
    effector with the goal frame's gripper."""

    def policy_fn(img_obs01, img_goal01):
        obs = joracle.decode_frame(np.asarray(img_obs01)[0])
        goal = joracle.decode_frame(np.asarray(img_goal01)[0])
        act = joracle.oracle_action(obs["ee_pos"], goal["ee_pos"], 0.05, 0.0)
        act[6] = 0.98 if goal["gripper_closed"] else -0.98
        return np.repeat(act[None], n_acts, axis=0)

    return policy_fn


@pytest.mark.parametrize("video_dtype,act_max,succeeds",
                         [("uint8", 1.0, True), ("float", 0.5, False)])
def test_evaluator_matches_jax(video_dtype, act_max, succeeds, tmp_path):
    """Both `Evaluator`s run the protocol over two tasks x two seeds in the
    learn-gate world with one numpy policy and the oracle video model
    (uint8 videos, or float ones quantized by the harness), with receding-
    horizon replanning and a task limited to one prediction; with full-range
    actions every episode stops at its success, clipped to half the range
    none succeeds: equal successes and rates, every episode's frames and
    guidance videos equal, and result files of one name and content apart
    from the run times."""
    env_kw = dict(num_tasks=2, img_hw=(32, 32), step_scale=0.05, grasp_radius=0.15,
                  obj_window_xy=0.12)
    sides = []
    for name, fake, oracle, harness in (("jax", jfake, joracle, jharness),
                                        ("port", tfake, toracle, tharness)):
        envs = fake.FakeEnvList(**env_kw)
        vm = oracle.FakeOracleVideoModel(envs.task_to_task_idx, horizon=5)
        if video_dtype == "uint8":
            video_fn = lambda img01, task, vm=vm: vm.sample_u8(None, img01[None], [task])[0]  # noqa: E731
        else:
            video_fn = lambda img01, task, vm=vm: vm.sample(None, img01[None], [task])[0]  # noqa: E731
        ecfg = harness.EvalConfig(n_seeds=2, eval_n_preds_betw_vframes=2, num_vid_pred_per_ep=3,
                                  use_vid_first_n_frames=2, n_acts_per_pred=4,
                                  act_min=-act_max, act_max=act_max, vis=False,
                                  one_video_pred_tasks=(envs.task_list[1],))
        ev = harness.Evaluator(envs, _goal_chaser(4), video_fn, vm.video_future_horizon, ecfg)
        episodes = []
        eval_1_env = ev.eval_1_env

        def spy(*a, eval_1_env=eval_1_env, episodes=episodes):
            res = eval_1_env(*a)
            episodes.append(res)
            return res

        ev.eval_1_env = spy
        result = ev.run_evals()
        path = harness.save_result_json(result, str(tmp_path / name), epoch=2000,
                                        num_vid_pred_per_ep=3, eval_seed=1)
        with open(path) as fh:
            saved = json.load(fh)
        sides.append((result, episodes, os.path.basename(path), saved))
    (jr, jeps, jname, jsaved), (tr, teps, tname, tsaved) = sides
    assert len(teps) == len(jeps) == tr["num_evals"] == 4
    assert tr["is_sucs_all"] == [succeeds] * 4 and tr["seeds"] == [100, 101]
    timing = ("run_times_all", "run_times_per_tk")
    assert {k: v for k, v in tr.items() if k not in timing} == {
        k: v for k, v in jr.items() if k not in timing}
    for a, b in zip(jeps, teps):
        assert a.is_suc == b.is_suc
        np.testing.assert_array_equal(b.imgs, a.imgs)
        assert len(b.pred_videos) == len(a.pred_videos) >= 1
        for va, vb in zip(a.pred_videos, b.pred_videos):
            assert vb.dtype == np.uint8
            np.testing.assert_array_equal(vb, va)
    # the task with one prediction per episode got one; without a success
    # the other replanned to the end
    assert [len(e.pred_videos) for e in teps[2:]] == [1, 1]
    if not succeeds:
        assert [len(e.pred_videos) for e in teps[:2]] == [3, 3]
        assert all(len(e.imgs) == 1 + 4 * 2 * 9 for e in teps[:2])
    assert tname == jname
    assert {k: v for k, v in tsaved.items() if k not in timing} == {
        k: v for k, v in jsaved.items() if k not in timing}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and k != "act_down_val_range_per_tk":
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# fields of one tree only: the port's routing switches (the JAX package's
# environment flags) and device; the video backbone and `cond_channels` are
# in both trees
JAX_ONLY = set()
PORT_ONLY = {"device", "video.attn_kernel", "video.downconv", "video.entry_pad",
             "video.mega_kernel", "video.padded_stream", "video.pallas_spatial",
             "video.spatial2_max_s", "video.spatial2_min_ch", "video.stream_kernel",
             "video.tconv_hw", "video.upconv", "video.train_dgrad_kernel",
             "video.wgrad_min_s", "video.train_tconv_dot", "policy.vision_pool"}


def _assert_same_tree(jcfg, tcfg):
    """The two experiment trees agree on every shared field. The config
    files keep the release model (the U-Net backbone, `cond_channels` =
    `channels`), the port's own fields are at their defaults, and the JAX
    `moment_dtype=None` resolves to the port's dtype."""
    j, t = _flat(jcfg.to_dict()), _flat(tcfg.to_dict())
    assert set(j) - set(t) == JAX_ONLY and set(t) - set(j) == PORT_ONLY
    assert (j["video.backbone"], j["video.cond_channels"]) == ("unet", None)
    defaults = _flat(tconfig.ExperimentConfig().to_dict())
    assert {k: t[k] for k in PORT_ONLY} == {k: defaults[k] for k in PORT_ONLY}
    assert jcfg.opt.resolved_moment_dtype().name == t.pop("opt.moment_dtype")
    j.pop("opt.moment_dtype")
    for k in set(j) & set(t):
        assert t[k] == j[k] and type(t[k]) is type(j[k]), k


@pytest.mark.parametrize("name", ["libero/lb_tk8_65to72.py", "libero/lb_tk8_luotest.py",
                                  "fake/fake_smoke.py", "fake/fake_learn.py"])
def test_config_files_match_jax(name, tmp_path):
    """Each of the port's copied config files loads to the JAX tree field by
    field; its experiment name is the JAX one; its snapshot round-trips
    (tuples, the per-task grasp table's int keys)."""
    jcfg = jload_config(os.path.join(ROOT, "v2a_tpu", "config", name))
    tcfg = load_config_module(os.path.join(ROOT, "v2a_tpu_torch", "config", name))
    _assert_same_tree(jcfg, tcfg)
    assert tconfig.generate_exp_name(tcfg) == jconfig.generate_exp_name(jcfg)
    path = tconfig.save_snapshot(tcfg.replace(device="cpu"), str(tmp_path))
    assert load_snapshot(str(tmp_path)) == load_snapshot(path) == tcfg.replace(device="cpu")


def test_cli_overrides_match_jax():
    """`parse_cli` and `apply_overrides` on one argv give equal overrides
    and equal trees on both sides (ints, floats, bools, tuples, nested
    tuples, strings, an Optional left at None), and reject the same bad
    input."""
    argv = ["--trainer.n_train_steps", "20", "--seed", "3", "--opt.lr", "3e-4",
            "--eval.is_stop_at_suc", "false", "--policy.vision_stage_features", "(32, 64)",
            "--explore.n_preds_betw_vframes", "(2, 3)", "--explore.act_down_val", "-0.5",
            "--exp_name", "x", "--trainer.prefetch_depth", "0", "--video.sampling_timesteps", "4"]
    got = []
    for side, load in (("v2a_tpu", jload_config), ("v2a_tpu_torch", load_config_module)):
        path = os.path.join(ROOT, side, "config", "fake", "fake_smoke.py")
        cfg_path, kv = (jconfig if side == "v2a_tpu" else tconfig).parse_cli(
            ["--config", path] + argv)
        assert cfg_path == path
        apply = (jconfig if side == "v2a_tpu" else tconfig).apply_overrides
        got.append((kv, apply(load(path), kv)))
    (jkv, jcfg), (tkv, tcfg) = got
    assert tkv == jkv
    _assert_same_tree(jcfg, tcfg)
    assert tcfg.eval.is_stop_at_suc is False and tcfg.explore.n_preds_betw_vframes == (2, 3)
    base = load_config_module(SMOKE)
    for mod in (jconfig, tconfig):
        with pytest.raises(KeyError):
            mod.apply_overrides(base if mod is tconfig else jload_config(JAX_SMOKE),
                                {"trainer.no_such_key": "1"})
        with pytest.raises(ValueError):
            mod.apply_overrides(base if mod is tconfig else jload_config(JAX_SMOKE),
                                {"eval.vis": "maybe"})
        for bad in (["--seed"], ["seed", "1"]):
            with pytest.raises(ValueError):
                mod.parse_cli(bad)
    assert tconfig.apply_overrides(base, {"device": "cpu"}).device == "cpu"


def _stub(img_obs01, img_goal01):
    """The executor's policy on both sides of the whole-slice test: a
    deterministic function of the two frames."""
    d = np.asarray(img_goal01, np.float64).mean() - np.asarray(img_obs01, np.float64).mean()
    base = np.array([np.sin(7 * d), np.cos(5 * d), -0.5, 0, 0, 0, 0.3], np.float32)
    return np.stack([base * (1 - 0.1 * i) for i in range(4)]).astype(np.float32)


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    """The JAX and the port trainer on fake_smoke with the oracle video
    model and one policy, after `live_rand_explore(2)` and one
    `video_guided_explore`; the port's start frames and video-model inputs
    recorded."""
    tmp = tmp_path_factory.mktemp("slice")
    jcfg = jload_config(JAX_SMOKE)
    jcfg = jcfg.replace(video_model_kind="oracle", seed=3,
                        policy=dataclasses.replace(jcfg.policy, **SMALL_TRUNK))
    tcfg = load_config_module(SMOKE)
    tcfg = tcfg.replace(video_model_kind="oracle", seed=3, device="cpu",
                        policy=dataclasses.replace(tcfg.policy, **SMALL_TRUNK))

    def init(self, rng):  # seeded numpy weights: flax's eager init takes long here
        h, w = self.config.image_size
        return random_params(
            self.nets, {k: jnp.zeros((1, h, w, 3)) for k in self.config.obs_keys},
            jnp.zeros((1, self.config.horizon, self.config.action_dim)),
            jnp.zeros((1,), jnp.int32), seed=12)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpolicy.DiffusionPolicy, "init", init)
        jt, *_ = jbuild.build_experiment(jcfg, str(tmp / "jax"), snapshot=False)
    tt, *_ = tbuild.build_experiment(tcfg, str(tmp / "port"), snapshot=False)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    tt.start_from(train_state_from_jax(to_np(jt.state.params), to_np(jt.state.ema_params),
                                       jt.state.step))
    seen = {"cond": [], "starts": []}
    sample_u8, execute = tt.video_model.sample_u8, tt.executor.execute

    def spy_sample(gen, imgs01, tasks):
        seen["cond"].append(np.asarray(imgs01).copy())
        return sample_u8(gen, imgs01, tasks)

    def spy_execute(task, cam, env_idx, img_start, video):
        seen["starts"].append(np.asarray(img_start).copy())
        return execute(task, cam, env_idx, img_start, video)

    tt.video_model.sample_u8, tt.executor.execute = spy_sample, spy_execute
    for t in (jt, tt):
        t.executor.policy_fn = _stub
        t.live_rand_explore(2)
        t.video_guided_explore()
    return jt, tt, seen


def test_slice_buffers_and_first_batch_match_jax(slice_pair):
    jt, tt, seen = slice_pair
    for name in ("envBuf_rand", "envBuf_vid"):
        jb, tb = getattr(jt, name), getattr(tt, name)
        assert len(tb) == len(jb) > 0 and tb.backend == "native"
        assert tb.cnt_all_history_episodes == jb.cnt_all_history_episodes
        for a, b in zip(jb.export_episodes(), tb.export_episodes()):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}.{k}")
    assert tt._counters() == jt._counters()
    assert tt.cnt_vid_rollouts == len(tt.envs.task_list)
    jb, tb = jt.sample_from_bufs(), tt.sample_from_bufs()
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)
    assert tt.np_rng.integers(1 << 30) == jt.np_rng.integers(1 << 30)
    jd, td = jt.to_device_batch(jb), tt.to_device_batch(tb)
    for k in jd["obs"]:
        assert td["obs"][k].dtype == torch.float32 and td["obs"][k].device.type == "cpu"
        np.testing.assert_allclose(td["obs"][k].numpy(), np.asarray(jd["obs"][k]),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(td["action"].numpy(), np.asarray(jd["action"]), atol=1e-6, rtol=0)
    # the rollouts reopened each env at the seed of the frame the video was
    # conditioned on (one batched call for all tasks)
    assert len(seen["cond"]) == 1
    np.testing.assert_array_equal(
        np.stack(seen["starts"]), np.round(seen["cond"][0] * 255.0).astype(np.uint8))


def test_slice_weights_are_the_jax_trees(slice_pair):
    jt, tt, _ = slice_pair
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    for module, tree in ((tt.policy.nets, jt.state.params),
                         (tt.ema_policy.nets, jt.state.ema_params)):
        want = policy_from_jax(to_np(tree))
        got = module.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert tt.step == int(jt.state.step) == 0
    # the EMA module is the train state's EMA, updated in place
    ema = dict(tt.ema_policy.nets.named_parameters())
    assert all(e is ema[k] for e, k in zip(tt.state.ema_params, tt.state.names))


def test_prefetch_flushed_around_buffer_mutations(slice_pair):
    """The prefetcher is stopped before exploration mutates the buffers and
    restarted for the train step; flushed on exit (`tests/test_trainer.py`'s
    rule). Runs the port trainer of the whole-slice test on: a live random
    round at step 5, a guided cycle at step 6."""
    _, tt, _ = slice_pair
    tt.cfg = dataclasses.replace(tt.cfg, rand_explo_freq=5, rand_explo_type="live")
    assert tt.cfg.prefetch_depth > 0
    states = {"explore": [], "rand": []}
    orig_explore, orig_rand = tt.video_guided_explore, tt.live_rand_explore

    def spy_explore(*a, **k):
        states["explore"].append(tt._prefetch is None)
        return orig_explore(*a, **k)

    def spy_rand(*a, **k):
        states["rand"].append(tt._prefetch is None)
        return orig_rand(*a, **k)

    tt.video_guided_explore, tt.live_rand_explore = spy_explore, spy_rand
    n_vid = len(tt.envBuf_vid)
    tt.train(7)
    assert tt.step == 7
    assert states == {"explore": [True], "rand": [True]}
    assert len(tt.envBuf_vid) == n_vid + len(tt.envs.task_list)
    assert tt._prefetch is None


def test_prefetch_iterator_error_propagation():
    def boom():
        raise RuntimeError("sample failed")

    with PrefetchIterator(boom, depth=2) as it:
        with pytest.raises(RuntimeError, match="sample failed"):
            next(it)


def test_train_and_eval_entry_points(tmp_path):
    """`scripts/train.main` on fake_smoke on the CPU: both buffers filled,
    finite losses, checkpoints; `load` into a fresh trainer gives equal
    weights, EMA, optimizer state, step and counters; `scripts/eval.main`
    writes its result JSON. Without `--device cpu` and without a card the
    entry point raises."""
    argv = ["--config", SMOKE, "--device", "cpu", "--trainer.n_train_steps", "20",
            "--logbase", str(tmp_path / "logs"),
            "--policy.vision_stage_sizes", str(SMALL_TRUNK["vision_stage_sizes"]),
            "--policy.vision_stage_features", str(SMALL_TRUNK["vision_stage_features"])]
    trainer = train_script.main(argv)
    assert trainer.step == 20
    assert len(trainer.envBuf_rand) > 0 and len(trainer.envBuf_vid) > 0
    with open(os.path.join(trainer.workdir, "metrics.jsonl")) as fh:
        losses = [r["train/loss"] for r in map(json.loads, fh) if "train/loss" in r]
    assert len(losses) >= 4 and np.all(np.isfinite(losses))

    cfg = load_snapshot(trainer.workdir)
    assert cfg.device == "cpu" and cfg.policy.vision_stage_features == (32, 64)
    fresh, *_ = tbuild.build_experiment(cfg, trainer.workdir, with_video_model=False,
                                        snapshot=False)
    fresh.load()
    a, b = trainer.state_dict(), fresh.state_dict()
    assert a["step"] == b["step"] == 20
    for part in ("params", "ema_params"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 20
    for part in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a["opt_state"][part], b["opt_state"][part]))
    assert fresh._counters() == trainer._counters()

    path = eval_script.main(["--workdir", trainer.workdir, "--n_seeds", "1", "--vis", "0"])
    with open(path) as fh:
        result = json.load(fh)
    assert result["num_evals"] == len(trainer.envs.task_list) and result["epoch"] == 20
    assert 0.0 <= result["suc_rate"] <= 1.0

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_script.main(argv[:2] + argv[4:])


def test_left_out_options_raise(tmp_path, monkeypatch):
    """The mesh is ported: a mesh object of the wrong type raises
    `TypeError`, a config whose mesh does not fit the world (one process
    here) raises `ValueError`, and `mesh_axes=("dp",)` builds a trainer on a
    one-rank mesh (`tests/test_torch_parallel.py` runs it on two ranks). A
    video checkpoint directory that holds only the JAX package's converted
    msgpack raises and names the port's converter. `from_h5` with a missing
    file raises where the JAX trainer does, when the first fill opens it:
    the JAX ingestion's error (`FileNotFoundError` from h5py, `ImportError`
    without it)."""
    cfg = ttrainer.TrainerConfig()
    with pytest.raises(TypeError, match="Mesh"):
        ttrainer.OnlineTrainer(None, None, cfg, str(tmp_path), mesh=object())
    missing = str(tmp_path / "missing.hdf5")
    with pytest.raises(Exception) as jax_err:
        jh5.add_episodes_to_buffer(missing, None, ["t"], 0, 1, None, None)
    assert jax_err.type in (FileNotFoundError, ImportError)
    exp = load_config_module(SMOKE).replace(device="cpu")
    exp = exp.replace(trainer=dataclasses.replace(exp.trainer, randsam_path=missing,
                                                  rand_explo_type="from_h5"),
                      policy=dataclasses.replace(exp.policy, **SMALL_TRUNK))
    trainer, *_ = tbuild.build_experiment(exp, str(tmp_path / "h5"), with_video_model=False,
                                          snapshot=False)
    with pytest.raises(jax_err.type):
        trainer.train(1)
    assert trainer.step == 0 and len(trainer.envBuf_rand) == 0
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="#ranks 1"):
        tbuild.build_experiment(exp.replace(mesh_axes=("dp", "tp"), mesh_shape=(2, 2)),
                                str(tmp_path), with_video_model=False, snapshot=False)
    try:
        meshed, *_ = tbuild.build_experiment(exp.replace(mesh_axes=("dp",)), str(tmp_path),
                                             with_video_model=False, snapshot=False)
        assert meshed.mesh.shape == {"dp": 1} and meshed.state.shards is not None
    finally:
        torch.distributed.destroy_process_group()
    ckdir = tmp_path / "ckpt"
    ckdir.mkdir()
    (ckdir / f"jax-model-{exp.video_ckpt_milestone}.msgpack").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="v2a_tpu_torch.scripts.convert_ckpt"):
        tbuild.make_video_model(exp.replace(video_ckpt_dir=str(ckdir)))


def test_device_quantize_matches_host():
    """`sample_u8`'s quantization on the device truncates as the host's
    `(x * 255).astype(np.uint8)` and the JAX package's `_quantize_u8` do,
    and clamps out-of-range values."""
    from v2a_tpu.models.video_model import _quantize_u8
    from v2a_tpu_torch.models.video_model import quantize_u8

    x = np.random.default_rng(0).random((2, 3, 8, 8, 3)).astype(np.float32)
    got = quantize_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, (x * 255).astype(np.uint8))
    np.testing.assert_array_equal(got, np.asarray(_quantize_u8(x)))
    bad = np.array([-0.5, 1.5, 1.0, 0.0, 0.999], np.float32)
    np.testing.assert_array_equal(quantize_u8(torch.from_numpy(bad)).numpy(),
                                  np.asarray(_quantize_u8(bad)))
