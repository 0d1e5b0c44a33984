"""The port's online-loop concurrency, on the CPU, without flax.

- the env worker pool (`envs/subproc.py`): a round trip equal to the fake
  world in process, errors raised in a worker surface without a respawn, a
  killed worker is respawned and its journal replayed to the serial run's
  state, importing the module leaves torch out, and a worker does not
  re-run the parent's main module;
- `BatchedGuidedRolloutExecutor.execute_all` against the JAX package's, each
  on its own pool of 2, one numpy batch policy, the grasp injection fired:
  equal episodes, policy calls and batch sizes;
- `ParallelEvaluator.run_evals` against the JAX package's (equal result
  dicts but the run times), and the port's `_run_wave` frame for frame
  against its serial `Evaluator.eval_1_env`;
- `VideoPredModel.sample_u8_stream` bit-equal to `sample_u8` on a small
  U-Net under both samplers, and its pump counts;
- the port's trainer: three pipelined cycles (the goal videos as streams)
  commit the serial cycles' episodes; a pool smaller than the task list
  rotates over every task; `train()` with `pipeline_explore` and
  `overlap_explore` on a pool; an overlapped cycle's failure surfacing at
  the join with its finished episodes committed; the JAX loop's prefetcher
  flush at a random round that adds nothing.

The JAX package's `envs/subproc.py`, `train/explore_batched.py` and
`eval/parallel.py` import neither jax nor flax, so this file also runs on
a machine without flax.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from v2a_tpu.envs import fake_oracle as joracle
from v2a_tpu.envs import subproc as jsubproc
from v2a_tpu.eval import harness as jharness
from v2a_tpu.eval import parallel as jparallel
from v2a_tpu.train import explore as jexplore
from v2a_tpu.train import explore_batched as jbatched
from v2a_tpu_torch.config import load_config_module
from v2a_tpu_torch.envs import fake as tfake
from v2a_tpu_torch.envs import fake_oracle as toracle
from v2a_tpu_torch.envs import subproc as tsubproc
from v2a_tpu_torch.eval import harness as tharness
from v2a_tpu_torch.eval import parallel as tparallel
from v2a_tpu_torch.models.policy import DiffusionPolicy
from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
from v2a_tpu_torch.train import build as tbuild
from v2a_tpu_torch.train import explore as texplore
from v2a_tpu_torch.train import explore_batched as tbatched
from v2a_tpu_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "v2a_tpu_torch", "config", "fake", "fake_smoke.py")
SMALL_TRUNK = dict(vision_stage_sizes=(1, 1), vision_stage_features=(32, 64))
# the learn-gate world (`fake-2tk-learn-v0`'s kwargs): the chaser reaches
# its object, so the grasp heuristic fires and episodes succeed
WORLD = dict(step_scale=0.05, grasp_radius=0.15, obj_window_xy=0.12)
ENV = "fake-2tk-small-v0"
EXPLORE = dict(n_acts_per_pred=4, n_preds_betw_vframes=(1, 3), act_down_val=-0.9,
               grasp_z_diff_limit=0.42, grasp_abs_z_limit=0.7)


@pytest.fixture(scope="module")
def pools():
    """One pool of 2 workers of the learn-gate world per package."""
    with tsubproc.EnvWorkerPool(ENV, 2, **WORLD) as tp, \
            jsubproc.EnvWorkerPool(ENV, 2, **WORLD) as jp:
        yield tp, jp


def _chase(obs01, goal01, gripper_from_goal):
    """A deterministic numpy policy row: steps toward the goal frame's end
    effector as the fake world decodes it; a zero row (a finished env's
    padding) gets zero actions."""
    if not np.any(obs01):
        return np.zeros((4, 7), np.float32)
    obs = joracle.decode_frame(obs01)
    goal = joracle.decode_frame(goal01)
    act = joracle.oracle_action(obs["ee_pos"], goal["ee_pos"], 0.05,
                                0.0 if gripper_from_goal else 0.02)
    if gripper_from_goal:
        act[6] = 0.98 if goal["gripper_closed"] else -0.98
    return np.repeat(act[None], 4, axis=0).astype(np.float32)


def _batch_policy(log, gripper_from_goal=False):
    def fn(obs01, goal01):
        log.append(obs01.shape[0])
        return np.stack([_chase(o, g, gripper_from_goal) for o, g in zip(obs01, goal01)])

    return fn


def _serial_policy(img_obs01, img_goal01):
    return _chase(np.asarray(img_obs01)[0], np.asarray(img_goal01)[0], True)


def test_pool_round_trip(pools):
    """init / render / step_k (with the grasp observables) / close through
    the pool equal the same calls on the fake world in process."""
    pool, _ = pools
    tasks = pool.task_list
    assert tasks == tfake.FakeEnvList(num_tasks=2, img_hw=(32, 32)).task_list
    acts = np.tile(np.array([0.3, -0.2, 0.1, 0, 0, 0, -1], np.float32), (4, 1))
    pool.map([(i, "init_1_given_env", (tasks[i], 10000), {"e_seed": 5 + i}) for i in range(2)])
    imgs = pool.map([(i, "render_an_env", (tasks[i], "agent", 10000), {}) for i in range(2)])
    out = pool.map([(i, "step_k", (tasks[i], 10000, acts, "agent"), {"grasp_cam": "gripper"})
                    for i in range(2)])
    pool.map([(i, "close_1_given_env", (tasks[i], 10000), {}) for i in range(2)])
    envs = tfake.FakeEnvList(num_tasks=2, img_hw=(32, 32), **WORLD)
    for i, task in enumerate(tasks):
        envs.init_1_given_env(task, 10000, e_seed=5 + i)
        np.testing.assert_array_equal(imgs[i], envs.render_an_env(task, "agent", 10000))
        frames = []
        for a in acts:
            envs.step_an_env(task, 10000, a)
            frames.append(envs.render_an_env(task, "agent", 10000))
        np.testing.assert_array_equal(out[i]["imgs"], np.stack(frames))
        _, depth = envs.render_an_env_with_depth(task, "gripper", 10000)
        np.testing.assert_array_equal(out[i]["depth"], depth)
        np.testing.assert_array_equal(
            out[i]["ee_pos"], envs.get_an_env_obs(task, 10000)["robot0_eef_pos"])
        envs.close_1_given_env(task, 10000)
    assert out[0]["imgs"].dtype == np.uint8 and out[0]["done"] in (True, False)


def test_pool_errors_surface_without_respawn(pools):
    """An exception inside a live worker comes back as `RuntimeError` and
    burns no respawn: the same process answers afterwards."""
    pool, _ = pools
    pid = pool.workers[0]._proc.pid
    with pytest.raises(RuntimeError, match="env worker failed"):
        pool.map([(0, "no_such_method", (), {})])
    with pytest.raises(RuntimeError, match="env worker failed"):
        pool.workers[0].call("step_an_env", "no-such-task", 0, np.zeros(7))
    assert pool.workers[0].alive and pool.workers[0]._proc.pid == pid
    assert pool.map([(0, "task_list", (), {})])[0] == pool.task_list


def test_killed_worker_is_respawned_and_replayed():
    """Kill a worker mid-episode: the pool respawns it, replays the
    seed-pinned init and the steps, and retries the chunk in flight; the
    frames equal a serial run of the fake world at the same seed."""
    acts1 = np.tile(np.array([0.3, 0.1, 0, 0, 0, 0, -1], np.float32), (3, 1))
    acts2 = np.tile(np.array([-0.2, 0.4, 0, 0, 0, 0, -1], np.float32), (3, 1))
    with tsubproc.EnvWorkerPool(ENV, n_workers=1) as pool:
        task = pool.task_list[0]
        pool.map([(0, "init_1_given_env", (task, 10000), {"is_rand": True})])
        seed = pool.workers[0]._journal[0][2]["e_seed"]
        r1 = pool.map([(0, "step_k", (task, 10000, acts1, "agent"), {})])[0]
        pid = pool.workers[0]._proc.pid
        pool.workers[0]._proc.kill()
        r2 = pool.map([(0, "step_k", (task, 10000, acts2, "agent"), {})])[0]
        assert pool.workers[0]._proc.pid != pid
        assert [m for m, _, _ in pool.workers[0]._journal] == ["init_1_given_env", "step_k",
                                                               "step_k"]
    envs = tfake.FakeEnvList(num_tasks=2, img_hw=(32, 32))
    envs.init_1_given_env(task, 10000, e_seed=seed)
    for a in acts1:
        envs.step_an_env(task, 10000, a)
    np.testing.assert_array_equal(r1["imgs"][-1], envs.render_an_env(task, "agent", 10000))
    imgs2 = []
    for a in acts2:
        envs.step_an_env(task, 10000, a)
        imgs2.append(envs.render_an_env(task, "agent", 10000))
    np.testing.assert_array_equal(r2["imgs"], np.stack(imgs2))


def test_subproc_import_leaves_torch_out():
    """A worker imports `envs/subproc.py` and the env registry only: neither
    brings in torch, so no worker can touch the card."""
    code = ("import sys; import v2a_tpu_torch.envs.subproc, v2a_tpu_torch.envs.registration; "
            "sys.exit('torch' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    assert subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT).returncode == 0


_MAIN_SCRIPT = """
with open({log!r}, "a") as f:  # one line each time this module runs
    f.write(__name__ + "\\n")
from v2a_tpu_torch.envs.subproc import EnvWorkerPool

if __name__ == "__main__":
    with EnvWorkerPool("fake-2tk-small-v0", 2) as pool:
        pool.workers[1].respawn()
        calls = [(i, "task_list", (), {{}}) for i in range(2)]
        assert pool.map(calls) == [pool.task_list] * 2  # worker 1 respawned
"""


def test_workers_do_not_rerun_the_main_module(tmp_path):
    """`spawn` would re-run the parent's main module in every worker (the
    entry points import torch at their top level); the pool hides it, so
    a script that builds a pool, and respawns a worker, runs once."""
    log, script = tmp_path / "runs.txt", tmp_path / "main.py"
    script.write_text(_MAIN_SCRIPT.format(log=str(log)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    assert subprocess.run([sys.executable, str(script)], env=env, cwd=ROOT).returncode == 0
    assert log.read_text().split() == ["__main__"]


def _open(pool, assignments, seeds):
    pool.map([(i, "init_1_given_env", (t, e), {"e_seed": s})
              for i, ((t, e), s) in enumerate(zip(assignments, seeds))])
    return pool.map([(i, "render_an_env", (t, "agent", e), {})
                     for i, (t, e) in enumerate(assignments)])


def _close(pool, assignments):
    pool.map([(i, "close_1_given_env", (t, e), {}) for i, (t, e) in enumerate(assignments)])


def test_execute_all_matches_jax(pools):
    """Both batched executors chase the oracle's goal videos on their own
    pool of 2 with one numpy batch policy and the same env and rollout
    seeds: equal episodes, one B=2 policy call per round on both sides,
    and the grasp injection fired."""
    sides = []
    for pool, explore, batched, oracle in ((pools[1], jexplore, jbatched, joracle),
                                           (pools[0], texplore, tbatched, toracle)):
        tasks = pool.task_list
        assignments = [(t, 10000) for t in tasks]
        vm = oracle.FakeOracleVideoModel({t: i for i, t in enumerate(tasks)}, horizon=5)
        log = []
        ex = batched.BatchedGuidedRolloutExecutor(
            pool, _batch_policy(log), explore.ExploreConfig(**EXPLORE),
            {t: i for i, t in enumerate(tasks)})
        results = []
        for rnd in range(2):
            starts = _open(pool, assignments, [31 + rnd, 47 + rnd])
            videos = vm.sample_u8(None, np.stack(starts).astype(np.float32) / 255.0, tasks)
            results += ex.execute_all(assignments, "agent", starts, list(videos),
                                      seeds=[5 + rnd, 9 + rnd])
            _close(pool, assignments)
        sides.append((results, log))
    (jres, jlog), (tres, tlog) = sides
    assert tlog == jlog and set(tlog) == {2} and len(tlog) > 4
    for a, b in zip(jres, tres):
        for f in ("imgs", "acts", "pred_video"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        assert (b.is_success, b.n_env_steps) == (a.is_success, a.n_env_steps)
        assert len(b.imgs) == len(b.acts) + 1
    # the injected down actions are the only rows with the gripper at 0
    assert sum(int((r.acts[:, 6] == 0).sum()) for r in tres) > 0, "no grasp injection"


EVAL = dict(n_seeds=2, eval_n_preds_betw_vframes=2, num_vid_pred_per_ep=3,
            use_vid_first_n_frames=2, n_acts_per_pred=4, vis=False)


def _video_batch(vm):
    return lambda imgs01, tasks: vm.sample_u8(None, imgs01, list(tasks))


def test_parallel_eval_matches_jax(pools):
    """Both `ParallelEvaluator`s run the protocol over two tasks x two
    seeds on their own pool of 2 with one numpy batch policy and the oracle
    video model: equal result dicts but the run times, every policy call
    padded to the pool size."""
    got = []
    for pool, harness, parallel, oracle in ((pools[1], jharness, jparallel, joracle),
                                            (pools[0], tharness, tparallel, toracle)):
        vm = oracle.FakeOracleVideoModel({t: i for i, t in enumerate(pool.task_list)},
                                         horizon=5)
        log = []
        ev = parallel.ParallelEvaluator(pool, _batch_policy(log, True), _video_batch(vm),
                                        vm.video_future_horizon, harness.EvalConfig(**EVAL))
        got.append((ev.run_evals(), log))
    (jr, jlog), (tr, tlog) = got
    timing = ("run_times_all", "run_times_per_tk")
    assert {k: v for k, v in tr.items() if k not in timing} == {
        k: v for k, v in jr.items() if k not in timing}
    assert tr["num_evals"] == 4 and len(tr["run_times_all"]) == 4
    assert tlog == jlog and set(tlog) == {2}


def test_run_wave_matches_serial_evaluator(pools):
    """The port's `_run_wave` over two episodes equals the port's serial
    `Evaluator.eval_1_env` at the same env seeds frame for frame: success,
    every frame and every goal video."""
    pool, _ = pools
    tasks = pool.task_list
    vm = toracle.FakeOracleVideoModel({t: i for i, t in enumerate(tasks)}, horizon=5)
    cfg = tharness.EvalConfig(**EVAL)
    par = tparallel.ParallelEvaluator(pool, _batch_policy([], True), _video_batch(vm),
                                      vm.video_future_horizon, cfg)
    wave = par._run_wave([(tasks[0], 10000, 100), (tasks[1], 10000, 101)], "agent")
    envs = tfake.FakeEnvList(num_tasks=2, img_hw=(32, 32), **WORLD)
    serial = tharness.Evaluator(envs, _serial_policy, vm.video_fn, vm.video_future_horizon, cfg)
    for (task, seed), got in zip(((tasks[0], 100), (tasks[1], 101)), wave):
        envs.init_1_given_env(task, 10000, e_seed=seed)
        ref = serial.eval_1_env(task, "agent", 10000)
        envs.close_1_given_env(task, 10000)
        assert got.is_suc == ref.is_suc
        np.testing.assert_array_equal(got.imgs, ref.imgs)
        assert len(got.pred_videos) == len(ref.pred_videos) >= 1
        for a, b in zip(got.pred_videos, ref.pred_videos):
            np.testing.assert_array_equal(a, b)
    assert any(r.is_suc for r in wave)


@pytest.fixture(scope="module")
def small_video_model():
    cfg = VideoModelConfig(image_size=(16, 16), sample_per_seq=3, timesteps=8,
                           sampling_timesteps=8, model_channels=32, channel_mult=(1, 2),
                           num_res_blocks=1, attention_resolutions=(2,), num_head_channels=16,
                           text_dim=32)
    return VideoPredModel(cfg, device="cpu").init(0)


@pytest.mark.parametrize("sampling_timesteps,n_chunks", [(8, 3), (4, 2)],
                         ids=["ancestral", "ddim"])
def test_sample_u8_stream_is_sample_u8(small_video_model, sampling_timesteps, n_chunks):
    """The chunked chain equals `sample_u8` bit for bit under both samplers
    (8 of 8 steps: ancestral; 4 of 8: DDIM), pumped one chunk at a time
    with grad mode on in the caller, and the pump counts hold."""
    base = small_video_model
    model = VideoPredModel(dataclasses.replace(base.config, sampling_timesteps=sampling_timesteps),
                           device="cpu")
    model.nets.load_state_dict(base.nets.state_dict())
    assert model.diffusion.is_ddim_sampling == (sampling_timesteps < 8)
    imgs01 = np.random.default_rng(sampling_timesteps).random((2, 16, 16, 3), np.float32)
    tasks = ["task a", "task b"]
    ref = model.sample_u8(imgs01, tasks, generator=torch.Generator().manual_seed(7))
    stream = model.sample_u8_stream(imgs01, tasks, generator=torch.Generator().manual_seed(7),
                                    n_chunks=n_chunks)
    assert stream.chunks_left == n_chunks
    with torch.enable_grad():
        assert stream.pump(1) is True
    assert stream.chunks_left == n_chunks - 1
    out = stream.result_u8()
    assert stream.chunks_left == 0 and stream.pump(1) is False
    assert out.dtype == torch.uint8 and out.shape == ref.shape == (2, 2, 16, 16, 3)
    assert not out.requires_grad
    assert torch.equal(out, ref)
    # the finished chain is kept: a second read runs no step again
    assert stream.result() is stream.result() and torch.equal(stream.result_u8(), out)


def _smoke_trainer(tmp_path, pool=None, oracle=False, **trainer_kw):
    """A port trainer on fake_smoke (small vision trunk), optionally on a
    pool, with the diffusion video model (a 2-step DDIM chain) or the
    oracle."""
    cfg = load_config_module(SMOKE)
    cfg = cfg.replace(device="cpu", seed=3,
                      video_model_kind="oracle" if oracle else "diffusion",
                      policy=dataclasses.replace(cfg.policy, **SMALL_TRUNK),
                      video=dataclasses.replace(cfg.video, sampling_timesteps=2),
                      trainer=dataclasses.replace(cfg.trainer, **trainer_kw))
    trainer, _, env_list, video_model = tbuild.build_experiment(cfg, str(tmp_path),
                                                                snapshot=False)
    if pool is None:
        return trainer
    return ttrainer.OnlineTrainer(
        trainer.policy, env_list, cfg.trainer, str(tmp_path / "pool"),
        video_model=trainer.video_model, explore_config=cfg.explore, seed=cfg.seed,
        env_pool=pool)


def _numpy_predictions(img_obs01, img_goal01):
    """Stands in for the EMA policy's DDIM call behind `_ema_policy_fn`
    (which still pumps the prefetched stream after it)."""
    return np.stack([_chase(o, g, False) for o, g in zip(img_obs01, img_goal01)])


def test_pipelined_cycles_equal_serial(tmp_path):
    """Three back-to-back cycles with the diffusion video model, pipelined
    (each cycle's goal videos a stream started in the cycle before, pumped
    behind its policy calls) and serial: the same episodes and counters.
    Prefetching moves only when frames are rendered and chains run; the env
    seeds and the per-cycle video generators are the serial ones."""
    records = []
    for pipeline in (False, True):
        trainer = _smoke_trainer(tmp_path / str(pipeline), pipeline_explore=pipeline,
                                 pipeline_video_chunks=3)
        trainer._predict_actions = _numpy_predictions
        pumps = []
        if pipeline:
            pump = trainer._pump_video_prefetch
            trainer._pump_video_prefetch = lambda: (pumps.append(1), pump())
        for _ in range(3):
            trainer.video_guided_explore()
        trainer.envs.check_no_envs_exist()
        records.append((trainer.envBuf_vid.export_episodes(), trainer._counters(), pumps))
    (serial, s_counters, _), (piped, p_counters, pumps) = records
    assert len(serial) == len(piped) == 6 and s_counters == p_counters
    assert len(pumps) > 0
    for a, b in zip(serial, piped):
        for k in ("imgs", "acts", "task", "is_success"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_pool_rotation_covers_every_task(tmp_path):
    """With 2 workers and 4 tasks, two pool cycles explore every task once,
    one B=2 policy call per round."""
    cfg = load_config_module(SMOKE)
    cfg = cfg.replace(device="cpu", video_model_kind="oracle",
                      policy=dataclasses.replace(cfg.policy, **SMALL_TRUNK))
    envs = tfake.FakeEnvList(num_tasks=4, img_hw=(32, 32))
    policy = DiffusionPolicy.create(cfg.policy, device="cpu")
    vm = toracle.FakeOracleVideoModel(envs.task_to_task_idx, horizon=3)
    with tsubproc.EnvWorkerPool("fake-8tk-v0", 2, num_tasks=4, img_hw=(32, 32)) as pool:
        trainer = ttrainer.OnlineTrainer(policy, envs, cfg.trainer, str(tmp_path), video_model=vm,
                                         explore_config=cfg.explore, seed=0, env_pool=pool)
        log = []
        trainer._batched_executor.policy_fn = _batch_policy(log)
        for _ in range(2):
            trainer.video_guided_explore()
    assert trainer.cnt_vid_rout_per_tk == {t: 1 for t in envs.task_list}
    assert set(log) == {2} and trainer._pool_task_offset == 0


def test_train_pipelined_and_overlapped_on_a_pool(tmp_path):
    """`train()` with `pipeline_explore` and `overlap_explore` on a pool of
    2 and the diffusion video model (its chain as a `VideoSampleStream`):
    the cycles of steps 2 and 4 commit their episodes, the worker thread
    is joined, no env is left open in the workers, and the next cycle's
    stream is prefetched and pumped."""
    with tsubproc.EnvWorkerPool("fake-2tk-v0", 2) as pool:
        trainer = _smoke_trainer(tmp_path, pool, pipeline_explore=True, overlap_explore=True,
                                 pipeline_video_chunks=3, init_rand_steps=1,
                                 video_explo_freq=2)
        spawned = []
        spawn = trainer._spawn_explore

        def spy():
            spawned.append(trainer.step)
            spawn()

        trainer._spawn_explore = spy
        trainer.train(5)
        assert trainer.step == 5 and spawned == [2, 4]
        assert trainer._explore_thread is None and trainer._explore_snapshot is None
        assert trainer.cnt_vid_rollouts == len(trainer.envBuf_vid) == 4
        assert sorted(trainer.cnt_vid_rout_per_tk.values()) == [2, 2]
        # the third cycle's chain was started in the second and pumped to
        # its end behind that cycle's policy calls
        stash = trainer._video_prefetch
        assert stash is not None and stash.videos.chunks_left == 0
        assert stash.videos_u8().shape == (2, 3, 32, 32, 3)
        for w in pool.workers:
            assert w._journal == []
        # every worker can open its task's env: none is left open
        pool.map([(i, "check_no_envs_exist", (), {}) for i in range(2)])
    trainer.envs.check_no_envs_exist()


def test_overlapped_failure_surfaces_at_join(tmp_path):
    """A cycle that fails on the worker thread after its first episode:
    the error surfaces at the join as `ExploreCycleError`, and the finished
    episode is committed first."""
    trainer = _smoke_trainer(tmp_path, oracle=True, overlap_explore=True)
    execute = trainer.executor.execute
    calls = []

    def flaky(*a, **k):
        calls.append(a[0])
        if len(calls) == 2:
            raise ValueError("env blew up")
        return execute(*a, **k)

    trainer.executor.execute = flaky
    trainer._spawn_explore()
    with pytest.raises(ttrainer.ExploreCycleError, match="env blew up") as info:
        trainer._join_explore()
    assert len(info.value.outcomes) == 1
    assert trainer.cnt_vid_rollouts == len(trainer.envBuf_vid) == 1
    assert trainer.cnt_vid_rout_per_tk[calls[0]] == 1
    assert trainer._explore_thread is None
    trainer.envs.check_no_envs_exist()


def test_random_round_without_h5_flushes_prefetch(tmp_path):
    """With `rand_explo_type='from_h5'` and no H5 file a random round adds
    nothing, and the loop still joins and flushes the prefetcher, as the
    JAX loop does: the prefetcher starts at step 0 and again after step 5's
    round, each start drawing its seed from the trainer's generator."""
    trainer = _smoke_trainer(tmp_path, oracle=True, rand_explo_type="from_h5",
                             rand_explo_freq=5, video_explo_freq=1000)
    starts = []
    start = trainer._start_prefetch

    def spy():
        if trainer._prefetch is None:
            starts.append(trainer.step)
        start()

    trainer._start_prefetch = spy
    trainer.train(7)
    assert starts == [0, 5]
    assert len(trainer.envBuf_vid) == 0
