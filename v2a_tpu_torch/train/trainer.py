"""The online trainer: replay-driven policy training interleaved with
video-guided exploration.

Counterpart of `v2a_tpu/train/trainer.py` (the reference's
`LB_Online_Trainer_V7`, `diffuser/libero/lb_online_trainer_v7.py:29-1347`),
with its concurrency:

- the policy train step of `train/train_state.py` fed by a host->card
  prefetcher (`parallel/prefetch.py`): batches are sampled from the replay
  buffers on a worker thread, copied to the card as uint8 from pinned
  memory on a side stream and scaled there;
- the host-side iteration and exploration schedulers with the reference's
  semantics (rand-bias/vid-bias cycling `:942-970`, explore/no-explore
  throttling `:432-468`);
- `GuidedRolloutExecutor` for the exploration control flow
  (`train/explore.py`), acting with the EMA policy: one EMA module beside
  the trained one, updated in place by the train step;
- checkpoints with milestone bucketing (`train/checkpoint.py`);
- with an `env_pool` (`envs/subproc.py`), lock-step batched rollouts
  (`train/explore_batched.py`): one B=N DDIM prediction per round for all
  the pool's envs;
- `pipeline_explore`: the next cycle's goal videos are started at the top
  of this one as a `VideoSampleStream` whose chunks are pumped behind the
  rollouts' policy calls;
- `overlap_explore`: the cycle runs on a worker thread while training goes
  on, acting with a snapshot of the EMA policy; its episodes are committed
  by the main thread at the join.

Random streams: host draws keep the JAX package's seeds and generators
(`np.random.default_rng(seed)`, shared with the executor). Device draws come
from `torch.Generator`s on the policy's device: one for the train step, one
for the policy's DDIM predictions, and one per guidance-video call, seeded
by (seed, cycle counter), the counterpart of `fold_in(_video_key_base,
idx)`. An overlapped cycle draws from its own streams: a private
prediction generator seeded by (seed, spawn counter) and a numpy generator
seeded by one draw from the trainer's, as the JAX trainer seeds it.

Both threads of an overlapped cycle launch on the default stream: on the
card the overlap is of host work (env steps, the policy's launch overhead),
not of kernels.

The random buffer: with `rand_explo_type="from_h5"` and a `randsam_path`
it is filled from the H5 file (`data/h5_ingest.py`, `ingest_h5`: the first
`num_init_rand_ep_per_tk` episodes a task, then a circular sweep over the
file's `h5_total_num_ep_per_task`), else by the live sampler.

Not ported yet (raises `NotImplementedError`; ROADMAP.md, Queue 1): `mesh`.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from v2a_tpu_torch.data.replay_buffer import ReplayBuffer, merge_batches
from v2a_tpu_torch.envs.base import EnvList
from v2a_tpu_torch.models.policy import DiffusionPolicy
from v2a_tpu_torch.parallel.prefetch import PinnedCopier, PrefetchIterator
from v2a_tpu_torch.train import checkpoint as ckpt
from v2a_tpu_torch.train.explore import ExploreConfig, GuidedRolloutExecutor
from v2a_tpu_torch.train.metrics import MetricsLogger, Timer, per_task_metric_names
from v2a_tpu_torch.train.train_state import (
    AdamState,
    EMAConfig,
    OptimizerConfig,
    PolicyTrainState,
    fused_clip_adamw,
    make_train_step,
)

OBS_KEYS = {"img_obs_1": "img_obs", "img_goal_1": "img_goal"}


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The `trainer_dict` surface of the release config
    (`config/libero/lb_tk8_65to72.py:70-133`) plus loop-level knobs: the
    fields of `v2a_tpu/train/trainer.py::TrainerConfig`."""

    # buffers
    num_init_rand_ep_per_tk: int = 50
    max_episodes_rand: int = 1200
    max_episodes_vid: int = 600
    max_len_uB: int = 700
    min_len_uB: int = 30
    model_act_horizon: int = 16

    # iteration scheduler
    init_rand_steps: int = 10000
    rand_cycle_steps: int = 100
    vid_cycle_steps: int = 400

    # exploration cadence
    video_explo_freq: int = 200
    rand_explo_freq: int = 500
    rand_explo_num_ep_per_tk: int = 2

    # buffer sampling
    buf_sample_batch_size: int = 64
    buf_sample_method: str = "rand_prob"
    buf_sample_randBuf_prob: float = 0.3
    buf_sample_ratio_rand: Tuple[float, float] = (0.75, 0.25)
    buf_sample_ratio_vid: Tuple[float, float] = (0.25, 0.75)

    # explore/no-explore throttle
    enable_noExp: bool = True
    noExp_start_buf_len_rand: int = 500
    noExp_start_buf_len_vid: int = 500
    Exp_noExp_rand: Tuple[int, int] = (1000, 1000)
    Exp_noExp_vid: Tuple[int, int] = (1000, 1000)

    # training budget / cadence
    n_train_steps: int = 200_000
    gradient_accumulate_every: int = 1
    save_freq: int = 1000
    log_freq: int = 100
    n_saves: int = 5
    label_freq: Optional[int] = None  # default: n_train_steps // n_saves

    # data
    randsam_path: str = ""
    h5_total_num_ep_per_task: int = 500
    is_stop_at_suc: bool = False
    # 'from_h5' streams pre-generated episodes from `randsam_path`; 'live'
    # runs the random-action sampler in the simulator. Without a randsam_path
    # the initial fill is live either way.
    rand_explo_type: str = "from_h5"
    live_rand_ep_len: int = 120
    # debug image dumps every N steps (0 = off)
    debug_img_freq: int = 0
    # host->card prefetch depth: batch t+1 is sampled and copied while step t
    # runs; 0 = synchronous. Flushed around every buffer mutation.
    prefetch_depth: int = 2
    # also checkpoint the replay buffers
    checkpoint_buffers: bool = False
    # Pipeline the exploration cycle: render the NEXT cycle's start frames
    # at the top of the current cycle and start its goal-video chain in
    # chunks pumped behind this cycle's policy calls, so the card works
    # through the chain while the host steps the envs (the reference is
    # serial, `lb_online_trainer_v7.py:871-938`). Sound because the video
    # model is frozen: videos depend only on (start frame, task, generator),
    # and the start frame is pinned by the recorded env seed the rollout
    # reopens with.
    pipeline_explore: bool = False
    # denoise-chain chunks per prefetched video (more chunks = finer
    # interleaving with the policy calls, more launches from the host)
    pipeline_video_chunks: int = 20
    # run video-guided exploration on a worker thread while training goes
    # on, committing episodes and counters at a main-thread join. Deviation
    # from the reference's interleaved loop (`lb_online_trainer_v7.py:
    # 504-507`): train steps taken while a cycle is in flight sample the
    # pre-explore buffers, and the explorer acts with the EMA policy
    # snapshotted at spawn time. Default off = the reference's interleaving.
    overlap_explore: bool = False

    def resolved_label_freq(self) -> int:
        return self.label_freq or max(int(self.n_train_steps // self.n_saves), 1)


@dataclasses.dataclass
class _ExploreSnapshot:
    """Self-contained policy and randomness for one overlapped explore cycle.

    The EMA policy is a deep copy: the train step updates the live EMA
    module in place, and the worker must act with the spawn-time weights.
    The generator and `np_rng` are consumed by the worker thread only; the
    trainer's own streams stay the main thread's for the whole cycle."""

    ema_policy: DiffusionPolicy
    generator: torch.Generator
    np_rng: np.random.Generator


@dataclasses.dataclass
class _VideoPrefetchState:
    """Next cycle's exploration inputs, prepared ahead of time
    (`pipeline_explore`): pinned env seeds + start frames + the goal videos
    as an incrementally pumped chain (`VideoSampleStream`) or a host array
    for video models without the stream API."""

    assignments: list  # [(task, env_idx)]
    seeds: list  # env seed per assignment (reopen pins the scene)
    start_imgs: list  # uint8 start frames rendered at those seeds
    videos: Any  # VideoSampleStream-like | ndarray

    def pump(self, k: int = 1) -> None:
        if hasattr(self.videos, "pump"):
            self.videos.pump(k)

    def videos_u8(self) -> np.ndarray:
        """The videos on the host (a stream's result is read back here)."""
        if hasattr(self.videos, "result_u8"):
            return self.videos.result_u8().cpu().numpy()
        return np.asarray(self.videos)


class ExploreCycleError(RuntimeError):
    """An exploration cycle failed mid-way. Episodes that completed BEFORE
    the failure ride along in `.outcomes` so callers can commit them
    instead of losing finished rollouts."""

    def __init__(self, cause: BaseException, outcomes):
        super().__init__(f"exploration cycle failed: {cause!r}")
        self.outcomes = outcomes


class IterTypeScheduler:
    """rand-bias/vid-bias two-phase cycle (`update_iter_type`
    `lb_online_trainer_v7.py:942-970`)."""

    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        self.iter_type = "rand-bias"
        self.rand_iter_cnt = 0
        self.vid_iter_cnt = 0

    def update(self, step: int) -> str:
        cfg = self.cfg
        if step < cfg.init_rand_steps:
            self.iter_type = "rand-bias"
        elif step == cfg.init_rand_steps:
            self.rand_iter_cnt = 0
        elif self.rand_iter_cnt == cfg.rand_cycle_steps:
            self.rand_iter_cnt = 0
            self.iter_type = "vid-bias"
        elif self.vid_iter_cnt == cfg.vid_cycle_steps:
            self.vid_iter_cnt = 0
            self.iter_type = "rand-bias"
        if cfg.vid_cycle_steps == 0:
            self.iter_type = "rand-bias"
        elif cfg.rand_cycle_steps == 0:
            self.iter_type = "vid-bias"
        return self.iter_type

    def count(self):
        if self.iter_type == "rand-bias":
            self.rand_iter_cnt += 1
        else:
            self.vid_iter_cnt += 1


class ExploreThrottle:
    """Explore/no-explore alternation per buffer once it is warm
    (`update_explo_type` `lb_online_trainer_v7.py:432-468`), bounding the
    env-step budget."""

    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        self.explo_type_rand = "explo"
        self.explo_type_vid = "explo"
        self.cnt_exp_rand = self.cnt_no_exp_rand = 0
        self.cnt_exp_vid = self.cnt_no_exp_vid = 0

    def update(self, len_rand: int, len_vid: int):
        cfg = self.cfg
        if not cfg.enable_noExp:
            return
        if len_rand >= cfg.noExp_start_buf_len_rand:
            if self.explo_type_rand == "no-explo":
                self.cnt_no_exp_rand += 1
            else:
                self.cnt_exp_rand += 1
        if self.cnt_exp_rand == cfg.Exp_noExp_rand[0]:
            self.cnt_exp_rand = 0
            self.explo_type_rand = "no-explo"
        if self.cnt_no_exp_rand == cfg.Exp_noExp_rand[1]:
            self.cnt_no_exp_rand = 0
            self.explo_type_rand = "explo"

        if len_vid >= cfg.noExp_start_buf_len_vid:
            if self.explo_type_vid == "no-explo":
                self.cnt_no_exp_vid += 1
            else:
                self.cnt_exp_vid += 1
            if self.cnt_exp_vid == cfg.Exp_noExp_vid[0]:
                self.cnt_exp_vid = 0
                self.explo_type_vid = "no-explo"
            if self.cnt_no_exp_vid == cfg.Exp_noExp_vid[1]:
                self.cnt_no_exp_vid = 0
                self.explo_type_vid = "explo"


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1)")


class OnlineTrainer:
    """Owns the buffers, schedulers, train state, and the env list.

    `video_model` is an object with `.sample_u8(generator, imgs01, tasks) ->
    (B, F, H, W, 3) uint8` (host arrays; `train/build.py::_VideoSampleAdapter`
    wraps the port's `VideoPredModel`), and optionally `.sample_u8_stream(
    generator, imgs01, tasks, n_chunks)` for `pipeline_explore`. The policy
    is initialized from `seed` here, as the JAX trainer initializes its
    parameters; `start_from` replaces them. `env_pool` (an
    `envs/subproc.py::EnvWorkerPool`) runs the rollouts in its workers; the
    caller closes it. `act_min` / `act_max` bound the H5 file's actions
    (-1 / 1 by default)."""

    def __init__(
        self,
        policy: DiffusionPolicy,
        env_list: EnvList,
        config: TrainerConfig,
        workdir: str,
        video_model=None,
        explore_config: Optional[ExploreConfig] = None,
        opt_config: Optional[OptimizerConfig] = None,
        ema_config: Optional[EMAConfig] = None,
        seed: int = 0,
        act_min: Optional[np.ndarray] = None,
        act_max: Optional[np.ndarray] = None,
        mesh=None,
        env_pool=None,
    ):
        if mesh is not None:
            raise _not_ported("the mesh (data/tensor-parallel) trainer")
        self.policy = policy
        self.device = policy.device
        self.envs = env_list
        self.cfg = config
        self.video_model = video_model
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)

        self.envBuf_rand = ReplayBuffer(
            config.max_episodes_rand, config.max_len_uB, config.min_len_uB,
            sample_act_seq_len=config.model_act_horizon,
        )
        self.envBuf_vid = ReplayBuffer(
            config.max_episodes_vid, config.max_len_uB, config.min_len_uB,
            sample_act_seq_len=config.model_act_horizon,
        )

        self.iter_sched = IterTypeScheduler(config)
        self.throttle = ExploreThrottle(config)
        self.metrics = MetricsLogger(workdir)
        self.metrics.init_per_task_metrics(env_list.task_list)
        self.np_rng = np.random.default_rng(seed)
        train_seed, predict_seed, self._video_seed, self._explore_seed = (
            int(s) for s in np.random.SeedSequence(seed).generate_state(4)
        )
        self._train_gen = torch.Generator(device=self.device).manual_seed(train_seed)
        self._predict_gen = torch.Generator(device=self.device).manual_seed(predict_seed)
        self._video_idx = 0
        self._explore_idx = 0

        # the trained policy and its EMA twin: the train step updates both in
        # place; exploration and eval act with the twin
        policy.init(seed)
        policy.nets.requires_grad_(True)
        self.ema_policy = dataclasses.replace(
            policy, nets=copy.deepcopy(policy.nets).requires_grad_(False)
        )
        self.tx = fused_clip_adamw(opt_config or OptimizerConfig())
        self.state = PolicyTrainState(policy.nets, self.tx, ema_module=self.ema_policy.nets)
        self._train_step = make_train_step(
            policy.loss, self.tx, ema_config or EMAConfig(),
            accumulate=config.gradient_accumulate_every,
        )
        self._copier = PinnedCopier(
            self.device, n_slots=config.prefetch_depth + 2, transform=_scale_images
        )

        self.explore_cfg = explore_config or ExploreConfig(
            n_acts_per_pred=policy.config.n_action_steps,
            is_stop_at_suc=config.is_stop_at_suc,
        )
        self.executor = GuidedRolloutExecutor(
            env_list, self._ema_policy_fn, self.explore_cfg, self.np_rng
        )
        self.env_pool = env_pool
        self._batched_executor = None
        self._pool_task_offset = 0
        if env_pool is not None:
            from v2a_tpu_torch.train.explore_batched import BatchedGuidedRolloutExecutor

            self._batched_executor = BatchedGuidedRolloutExecutor(
                env_pool, self._ema_policy_fn_batch, self.explore_cfg,
                env_list.task_to_task_idx, policy.config.action_dim,
            )

        a_dim = policy.config.action_dim
        self.act_min = act_min if act_min is not None else np.full(a_dim, -1.0, np.float32)
        self.act_max = act_max if act_max is not None else np.full(a_dim, 1.0, np.float32)

        # host-side counters (checkpointed; `lb_online_trainer_v7.py:367-385`)
        self.num_steps_in_env = 0
        self.cnt_explore_suc = 0
        self.cnt_vid_rollouts = 0
        self.cnt_vid_rout_per_tk = {tk: 0 for tk in env_list.task_list}
        self.cnt_explo_suc_per_tk = {tk: 0 for tk in env_list.task_list}
        self.h5_randsam_start_idx = 0
        self.is_all_randsam_visited = False
        # (pred_video, rollout imgs) of the latest guided episode, for the
        # debug composite
        self._last_rollout = None
        self._prefetch: Optional[PrefetchIterator] = None
        # pipelined-exploration prefetch (cfg.pipeline_explore)
        self._video_prefetch: Optional[_VideoPrefetchState] = None
        # overlapped-exploration state (cfg.overlap_explore)
        self._explore_thread: Optional[threading.Thread] = None
        self._explore_outcome: Optional[dict] = None
        self._explore_snapshot: Optional[_ExploreSnapshot] = None

    # -- policy ------------------------------------------------------------

    @torch.no_grad()
    def start_from(self, weights) -> None:
        """Start from given policy weights: `weights` has `params` and
        `ema_params` (state dicts of `PolicyNets`) and `step`, as
        `convert/from_jax.py::train_state_from_jax` returns them. The
        optimizer state stays as it is."""
        self.policy.nets.load_state_dict(
            {k: torch.as_tensor(v) for k, v in weights["params"].items()})
        self.ema_policy.nets.load_state_dict(
            {k: torch.as_tensor(v) for k, v in weights["ema_params"].items()})
        self.state.step = int(weights["step"])

    def _on_explore_worker(self) -> bool:
        """True iff the caller IS the overlapped-exploration worker thread.
        Dispatching on thread identity (not snapshot presence) keeps the
        worker's private streams the worker's: a main-thread caller while a
        cycle is in flight uses the live EMA policy and the main streams."""
        return (
            self._explore_thread is not None
            and threading.current_thread() is self._explore_thread
        )

    def _predict_actions(self, img_obs01: np.ndarray, img_goal01: np.ndarray):
        """One DDIM prediction of the EMA policy, actions read back to the
        host: on the overlapped worker thread the spawn-time snapshot and
        its private generator, else the live EMA policy and the main
        prediction generator."""
        if self._on_explore_worker():
            snap = self._explore_snapshot
            policy, gen = snap.ema_policy, snap.generator
        else:
            policy, gen = self.ema_policy, self._predict_gen
        obs = {
            "img_obs_1": torch.as_tensor(img_obs01, device=self.device),
            "img_goal_1": torch.as_tensor(img_goal01, device=self.device),
        }
        out = policy.predict_action(obs, use_ddim=True, generator=gen)
        return out["action"].float().cpu().numpy()

    def _ema_policy_fn(self, img_obs01: np.ndarray, img_goal01: np.ndarray):
        """Predict `n_action_steps` actions from the EMA weights, DDIM;
        (1, H, W, 3) float01 frames -> (n_action_steps, Da) on the host."""
        act = self._predict_actions(img_obs01, img_goal01)[0]
        # pipelined exploration: one prefetched-video chunk goes in behind
        # the policy call, after its actions are read back, so it runs while
        # the host steps the envs and never delays this call's result
        self._pump_video_prefetch()
        return act

    def _ema_policy_fn_batch(self, img_obs01: np.ndarray, img_goal01: np.ndarray):
        """Batched variant: (N,H,W,3)x2 -> (N, n_action_steps, Da), one
        DDIM chain for all parallel rollouts."""
        act = self._predict_actions(img_obs01, img_goal01)
        self._pump_video_prefetch()
        return act

    # -- data -------------------------------------------------------------

    @property
    def step(self) -> int:
        return int(self.state.step)

    def ingest_h5(self, start: int, end: int):
        """Episodes [start, end) of every task from `randsam_path` into the
        random buffer; their env steps count until the whole file has been
        visited once (`v2a_tpu/train/trainer.py:466-478`)."""
        if not self.cfg.randsam_path:
            return
        from v2a_tpu_torch.data.h5_ingest import add_episodes_to_buffer

        steps = add_episodes_to_buffer(
            self.cfg.randsam_path, self.envBuf_rand, self.envs.task_list,
            start, end, self.act_min, self.act_max,
            cam=self.envs.camera_list[0],
            env_idx_per_task={tk: self.envs.seed_sets[tk][0] for tk in self.envs.task_list},
            count_env_steps=not self.is_all_randsam_visited,
        )
        self.num_steps_in_env += steps

    def live_rand_explore(self, n_ep_per_task: int):
        """Collect random-action episodes directly in the envs (the 'live'
        alternative to HDF5 ingestion; sampler semantics from
        `environment/libero/lb_data/lb_randsam_utils.py:5-167`)."""
        from v2a_tpu_torch.envs.randsam import RandSamConfig, rand_sample_1_ep

        rcfg = RandSamConfig(rand_ep_len=self.cfg.live_rand_ep_len)
        cam = self.envs.camera_list[0]
        for task in self.envs.task_list:
            env_idx = self.envs.seed_sets[task][0]
            for _ in range(n_ep_per_task):
                self.envs.init_1_given_env(task, env_idx, is_rand=True)
                imgs, acts, _ = rand_sample_1_ep(
                    self.envs, task, env_idx, rcfg, self.np_rng, cam
                )
                self.envs.close_1_given_env(task, env_idx)
                self.envBuf_rand.add_episode(task, cam, env_idx, imgs, acts)
                self.num_steps_in_env += len(acts)

    def sample_from_bufs(self, np_rng=None) -> Dict[str, np.ndarray]:
        """Mixed-buffer sampling (`sample_from_bufs`
        `lb_online_trainer_v7.py:787-851`). `np_rng` overrides the trainer's
        generator (the prefetch worker thread passes its own)."""
        cfg = self.cfg
        rng = np_rng if np_rng is not None else self.np_rng
        bs = cfg.buf_sample_batch_size
        if len(self.envBuf_vid) == 0:
            return self.envBuf_rand.sample_batch(bs, rng)
        if len(self.envBuf_rand) == 0:
            return self.envBuf_vid.sample_batch(bs, rng)

        if cfg.buf_sample_method == "rand_prob":
            probs = rng.uniform(size=bs)
            n_rands = int((probs < cfg.buf_sample_randBuf_prob).sum())
        elif cfg.buf_sample_method == "iter_bias_fix":
            ratio = (
                cfg.buf_sample_ratio_rand
                if self.iter_sched.iter_type == "rand-bias"
                else cfg.buf_sample_ratio_vid
            )
            n_rands = int(round(bs * ratio[0]))
        else:
            raise NotImplementedError(cfg.buf_sample_method)
        n_vids = bs - n_rands
        parts = []
        if n_rands:
            parts.append(self.envBuf_rand.sample_batch(n_rands, rng))
        if n_vids:
            parts.append(self.envBuf_vid.sample_batch(n_vids, rng))
        return merge_batches(parts) if len(parts) > 1 else parts[0]

    def to_device_batch(self, host_batch: Dict[str, np.ndarray]):
        """uint8 images -> [0,1] float on the device; the layout consumed by
        `policy.loss` (`to_batch_dict` `lb_online_trainer_v7.py:1296-1310`).
        The images travel as uint8 and are scaled on the device."""
        return _as_batch(self._copier.take(self._copier.put(_host_arrays(host_batch))))

    # -- exploration ------------------------------------------------------

    def _sample_videos_u8(self, generator, start_imgs_u8, tasks):
        """Batched guidance-video sampling, quantized to uint8 on the device
        by the port's video model (`sample_u8`)."""
        imgs01 = np.stack(start_imgs_u8).astype(np.float32) / 255.0
        return self.video_model.sample_u8(generator, imgs01, tasks)

    def _next_video_generator(self) -> torch.Generator:
        """The generator for one guidance-video call: seeded by (seed, cycle
        counter), independent of every other stream. Consumed by whichever
        thread runs the cycle: at most one cycle (and one prefetch) is in
        flight."""
        seed = int(np.random.SeedSequence([self._video_seed, self._video_idx])
                   .generate_state(1)[0])
        self._video_idx += 1
        return torch.Generator(device=self.device).manual_seed(seed)

    def _next_parallel_assignments(self):
        """Rotate the task window across cycles so every task gets explored
        even when the pool is smaller than the task list. Advances the
        rotation: call once per (pre)planned cycle."""
        tasks = self.envs.task_list
        n = len(self.env_pool)
        offset = self._pool_task_offset
        assignments = []
        for i in range(n):
            task = tasks[(offset + i) % len(tasks)]
            assignments.append((task, self.envs.seed_sets[task][0]))
        self._pool_task_offset = (offset + n) % len(tasks)
        return assignments

    # -- pipelined exploration (cfg.pipeline_explore) -----------------------

    def _take_video_prefetch(self) -> Optional[_VideoPrefetchState]:
        stash, self._video_prefetch = self._video_prefetch, None
        return stash

    def _pump_video_prefetch(self) -> None:
        stash = self._video_prefetch
        if stash is not None:
            stash.pump(1)

    def _dispatch_videos(self, start_imgs_u8, tasks):
        """Start one guidance-video chain WITHOUT reading it back: a chunked
        stream when the model has `sample_u8_stream` (pumped at each rollout
        policy call), else one eager call."""
        generator = self._next_video_generator()
        vm = self.video_model
        if hasattr(vm, "sample_u8_stream"):
            imgs01 = np.stack(start_imgs_u8).astype(np.float32) / 255.0
            return vm.sample_u8_stream(
                generator, imgs01, list(tasks), n_chunks=self.cfg.pipeline_video_chunks,
            )
        return self._sample_videos_u8(generator, start_imgs_u8, tasks)

    def _prefetch_videos(self, assignments) -> _VideoPrefetchState:
        """Render start frames (serial env path) at freshly drawn seeds and
        start the guidance-video chain for those frames."""
        cam = self.envs.camera_list[0]
        seeds, start_imgs = [], []
        for task, env_idx in assignments:
            self.envs.init_1_given_env(task, env_idx, is_rand=True)
            seeds.append(self.envs.actual_env_seeds[(task, env_idx)])
            start_imgs.append(self.envs.render_an_env(task, cam, env_idx))
            self.envs.close_1_given_env(task, env_idx)
        videos = self._dispatch_videos(start_imgs, [a[0] for a in assignments])
        return _VideoPrefetchState(list(assignments), seeds, start_imgs, videos)

    def _prefetch_videos_pool(self, assignments) -> _VideoPrefetchState:
        """Pool variant of `_prefetch_videos`: render in the workers, then
        CLOSE the envs (they reopen at the pinned seeds at rollout time, so
        the envs stay free between cycles)."""
        pool = self.env_pool
        cam = self.envs.camera_list[0]
        pool.map([
            (i, "init_1_given_env", (task, env_idx), {"is_rand": True})
            for i, (task, env_idx) in enumerate(assignments)
        ])
        seed_dicts = pool.map([
            (i, "attr:actual_env_seeds", (), {})
            for i, _ in enumerate(assignments)
        ])
        seeds = [
            seed_dicts[i][(task, env_idx)]
            for i, (task, env_idx) in enumerate(assignments)
        ]
        start_imgs = pool.map([
            (i, "render_an_env", (task, cam, env_idx), {})
            for i, (task, env_idx) in enumerate(assignments)
        ])
        pool.map([
            (i, "close_1_given_env", (task, env_idx), {})
            for i, (task, env_idx) in enumerate(assignments)
        ])
        videos = self._dispatch_videos(start_imgs, [a[0] for a in assignments])
        return _VideoPrefetchState(list(assignments), seeds, start_imgs, videos)

    def video_guided_explore(self):
        """One exploration cycle over all tasks
        (`video_guided_explore` `lb_online_trainer_v7.py:859-938`):
        rollouts followed by an immediate commit, the reference's
        synchronous interleaving (`:504-507`). On a mid-cycle failure the
        episodes that did finish are committed before the error surfaces."""
        try:
            outcomes = self._explore_rollouts()
        except ExploreCycleError as exc:
            self._commit_explore(exc.outcomes)
            raise
        self._commit_explore(outcomes)

    def _explore_rollouts(self):
        """Run one exploration cycle and return ``[(task, env_idx, result)]``
        WITHOUT changing buffers or counters (`_commit_explore` does), so
        `overlap_explore` can run it on a worker thread while training keeps
        sampling the pre-explore buffers."""
        if self.video_model is None:
            raise RuntimeError("no video model attached")
        if self._batched_executor is not None:
            return self._explore_rollouts_parallel()
        self.envs.check_no_envs_exist()
        cam = self.envs.camera_list[0]
        assignments = [
            (task, self.envs.seed_sets[task][0])
            for task in self.envs.task_list
        ]

        if self.cfg.pipeline_explore:
            # this cycle's inputs were prepared last cycle and its chain ran
            # behind that cycle's policy calls: launch any chunks left,
            # prepare the NEXT cycle's inputs, then read this cycle's videos
            stash = self._take_video_prefetch()
            if stash is None:
                stash = self._prefetch_videos(assignments)
            stash.pump(10**9)
            self._video_prefetch = self._prefetch_videos(assignments)
            metas = stash.assignments
            seeds = list(stash.seeds)
            videos_u8 = stash.videos_u8()
        else:
            # one batched goal-video call for all tasks' start frames (the
            # reference loops bs=1, `:871-877`)
            start_imgs, seeds = [], []
            metas = assignments
            for task, env_idx in metas:
                self.envs.init_1_given_env(task, env_idx, is_rand=True)
                seeds.append(self.envs.actual_env_seeds[(task, env_idx)])
                start_imgs.append(self.envs.render_an_env(task, cam, env_idx))
                self.envs.close_1_given_env(task, env_idx)
            videos_u8 = np.asarray(self._sample_videos_u8(
                self._next_video_generator(), np.stack(start_imgs), [m[0] for m in metas]
            ))

        # an overlapped cycle gives the executor a private numpy stream so
        # the trainer's generator stays the main thread's
        old_ex_rng = None
        if self._on_explore_worker():
            old_ex_rng, self.executor.rng = self.executor.rng, self._explore_snapshot.np_rng
        outcomes = []
        try:
            for (task, env_idx), video, seed in zip(metas, videos_u8, seeds):
                # Re-create the env with the SAME seed that produced the
                # frame the guidance video was conditioned on: the scene
                # (object placement) depends on the seed, and a fresh one
                # would make the policy chase goals from another scene than
                # the one it acts in (`lb_online_trainer_v7.py:877-919` keeps
                # one env alive). The seed was captured at render time: with
                # pipeline_explore another consumer (live rand) may have
                # re-seeded this env since.
                self.envs.init_1_given_env(task, env_idx, e_seed=seed)
                try:
                    img_start = self.envs.render_an_env(task, cam, env_idx)
                    result = self.executor.execute(task, cam, env_idx, img_start, video)
                finally:
                    # a mid-rollout failure must not leak the env
                    self.envs.close_1_given_env(task, env_idx)
                outcomes.append((task, env_idx, result))
        except Exception as exc:
            # completed rollouts ride along so callers can commit them
            raise ExploreCycleError(exc, outcomes) from exc
        finally:
            if old_ex_rng is not None:
                self.executor.rng = old_ex_rng
        return outcomes

    def _explore_rollouts_parallel(self):
        """Pool-parallel exploration: every worker owns one task's env; ONE
        batched goal-video call, then lock-step rollouts with batched policy
        predictions (`train/explore_batched.py`)."""
        pool = self.env_pool
        cam = self.envs.camera_list[0]

        if self.cfg.pipeline_explore:
            stash = self._take_video_prefetch()
            if stash is None:
                stash = self._prefetch_videos_pool(self._next_parallel_assignments())
            stash.pump(10**9)
            self._video_prefetch = self._prefetch_videos_pool(self._next_parallel_assignments())
            assignments = stash.assignments
            start_imgs = stash.start_imgs
            videos_u8 = stash.videos_u8()
            # reopen at the pinned seeds: same scene as the rendered frame
            pool.map([
                (i, "init_1_given_env", (task, env_idx), {"e_seed": stash.seeds[i]})
                for i, (task, env_idx) in enumerate(assignments)
            ])
        else:
            assignments = self._next_parallel_assignments()
            # concurrent env init + start-frame render in the workers
            pool.map([
                (i, "init_1_given_env", (task, env_idx), {"is_rand": True})
                for i, (task, env_idx) in enumerate(assignments)
            ])
            start_imgs = pool.map([
                (i, "render_an_env", (task, cam, env_idx), {})
                for i, (task, env_idx) in enumerate(assignments)
            ])
            videos_u8 = np.asarray(self._sample_videos_u8(
                self._next_video_generator(), np.stack(start_imgs), [a[0] for a in assignments]
            ))

        seed_rng = self._explore_snapshot.np_rng if self._on_explore_worker() else self.np_rng
        seeds = [int(seed_rng.integers(0, 2**31 - 1)) for _ in range(len(assignments))]
        results = self._batched_executor.execute_all(
            assignments, cam, start_imgs, list(videos_u8), seeds
        )
        pool.map([
            (i, "close_1_given_env", (task, env_idx), {})
            for i, (task, env_idx) in enumerate(assignments)
        ])
        return [
            (task, env_idx, result)
            for (task, env_idx), result in zip(assignments, results)
        ]

    def _commit_explore(self, outcomes):
        """Apply an exploration cycle's side effects: buffer appends,
        counters, the debug composite (`lb_online_trainer_v7.py:919-938`).
        MAIN THREAD ONLY: the one place exploration touches state shared
        with the train loop."""
        cam = self.envs.camera_list[0]
        for task, env_idx, result in outcomes:
            self._last_rollout = (result.pred_video, result.imgs)
            self.envBuf_vid.add_episode(
                task, cam, env_idx, result.imgs, result.acts,
                is_success=result.is_success,
            )
            self.num_steps_in_env += result.n_env_steps
            self.cnt_vid_rollouts += 1
            self.cnt_vid_rout_per_tk[task] += 1
            if result.is_success:
                self.cnt_explore_suc += 1
                self.cnt_explo_suc_per_tk[task] += 1

    # -- overlapped exploration (cfg.overlap_explore) ----------------------

    def _next_explore_generator(self) -> torch.Generator:
        """The private prediction generator of one overlapped cycle: seeded
        by (seed, spawn counter), so the main prediction stream is
        untouched."""
        seed = int(np.random.SeedSequence([self._explore_seed, self._explore_idx])
                   .generate_state(1)[0])
        self._explore_idx += 1
        return torch.Generator(device=self.device).manual_seed(seed)

    def _spawn_explore(self):
        """Start one exploration cycle on a worker thread.

        The worker acts with the EMA policy snapshotted NOW (a deep copy:
        the train step updates the live EMA module in place) and private
        random streams; its launches interleave with the train steps' on the
        card's default stream. Episodes are committed by the main thread at
        `_join_explore`."""
        assert self._explore_thread is None, "explore cycle already in flight"
        self._explore_snapshot = _ExploreSnapshot(
            ema_policy=dataclasses.replace(
                self.ema_policy, nets=copy.deepcopy(self.ema_policy.nets)),
            generator=self._next_explore_generator(),
            np_rng=np.random.default_rng(int(self.np_rng.integers(0, 2**63 - 1))),
        )
        outcome: dict = {}
        self._explore_outcome = outcome

        def work():
            try:
                outcome["res"] = self._explore_rollouts()
            except BaseException as exc:  # surfaced at the join barrier
                outcome["err"] = exc

        self._explore_thread = threading.Thread(target=work, name="v2a-explore", daemon=True)
        self._explore_thread.start()

    def _join_explore(self):
        """Barrier: wait for an in-flight overlapped cycle and commit its
        episodes. Flushes the prefetcher first so training only samples
        post-commit buffers (the synchronous path's contract). No-op when
        nothing is in flight."""
        if self._explore_thread is None:
            return
        self._explore_thread.join()
        outcome = self._explore_outcome
        self._explore_thread = None
        self._explore_outcome = None
        self._explore_snapshot = None
        if "err" in outcome:
            err = outcome["err"]
            if isinstance(err, ExploreCycleError) and err.outcomes:
                self._flush_prefetch()
                self._commit_explore(err.outcomes)
            raise err
        self._flush_prefetch()
        self._commit_explore(outcome["res"])

    # -- debug artifacts ---------------------------------------------------

    def dump_debug_images(self, n: int = 8):
        """Periodic visual artifacts: buffer start/goal pairs and the latest
        exploration pred-video-vs-rollout composite
        (`lb_online_trainer_v7.py:541-583, 1266-1284`). Written under
        workdir/debug/."""
        from v2a_tpu_torch.data.img_utils import save_episode_png

        out_dir = os.path.join(self.workdir, "debug")
        for name, buf in (("rand", self.envBuf_rand), ("vid", self.envBuf_vid)):
            if len(buf) == 0:
                continue
            batch = buf.sample_batch(n, self.np_rng)
            pairs = np.concatenate(
                [batch["img_obs"], batch["img_goal"]], axis=1
            )  # stack obs over goal vertically
            save_episode_png(
                os.path.join(out_dir, f"buf_{name}_step{self.step}.png"),
                pairs,
            )
        if self._last_rollout is not None:
            pred, rollout = self._last_rollout
            # guidance frames on top, evenly-spaced executed frames below
            idxs = np.linspace(0, len(rollout) - 1, len(pred)).astype(int)
            composite = np.concatenate([pred, rollout[idxs]], axis=1)
            save_episode_png(
                os.path.join(out_dir, f"rollout_step{self.step}.png"),
                composite, max_frames=len(pred),
            )

    # -- checkpointing ----------------------------------------------------

    def _counters(self) -> dict:
        return dict(
            num_steps_in_env=self.num_steps_in_env,
            cnt_explore_suc=self.cnt_explore_suc,
            cnt_vid_rollouts=self.cnt_vid_rollouts,
            cnt_vid_rout_per_tk=self.cnt_vid_rout_per_tk,
            cnt_explo_suc_per_tk=self.cnt_explo_suc_per_tk,
            h5_randsam_start_idx=self.h5_randsam_start_idx,
            is_all_randsam_visited=self.is_all_randsam_visited,
        )

    def state_dict(self) -> dict:
        """The JAX `TrainState`'s fields: step, params, opt_state (count
        and the Adam moments in parameter order), ema_params."""
        opt = self.state.opt_state
        return dict(
            step=self.step,
            params=self.policy.nets.state_dict(),
            opt_state=dict(count=opt.count, mu=list(opt.mu), nu=list(opt.nu)),
            ema_params=self.ema_policy.nets.state_dict(),
        )

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restores `state_dict()`'s fields in place."""
        self.policy.nets.load_state_dict(state["params"])
        self.ema_policy.nets.load_state_dict(state["ema_params"])
        opt = self.state.opt_state
        for dst, src in zip(opt.mu + opt.nu, state["opt_state"]["mu"] + state["opt_state"]["nu"]):
            dst.copy_(src)
        self.state.opt_state = AdamState(int(state["opt_state"]["count"]), opt.mu, opt.nu)
        self.state.step = int(state["step"])

    def save(self, label: Optional[int] = None):
        # a checkpoint taken while an overlapped cycle is in flight would
        # leave out that cycle's episodes and counters: join first
        self._join_explore()
        label = label if label is not None else (
            self.step // self.cfg.resolved_label_freq()
            * self.cfg.resolved_label_freq()
        )
        ckpt.save_checkpoint(
            self.workdir, label, self.state_dict(), extra=self._counters(),
            n_saves=self.cfg.n_saves,
        )
        if self.cfg.checkpoint_buffers:
            self.envBuf_rand.save(os.path.join(self.workdir, "buf_rand.npz"))
            self.envBuf_vid.save(os.path.join(self.workdir, "buf_vid.npz"))

    def load(self, label: Optional[int] = None):
        # a stash prepared before the restore pins seeds and frames of the
        # aborted run; drop it so the next cycle renders anew
        self._video_prefetch = None
        state, extra = ckpt.restore_checkpoint(self.workdir, label, map_location=self.device)
        self.load_state_dict(state)
        for key in (
            "num_steps_in_env", "cnt_explore_suc", "cnt_vid_rollouts",
            "h5_randsam_start_idx", "is_all_randsam_visited",
        ):
            if key in extra:
                setattr(self, key, extra[key])
        for key in ("cnt_vid_rout_per_tk", "cnt_explo_suc_per_tk"):
            if key in extra:
                getattr(self, key).update(extra[key])
        if self.cfg.checkpoint_buffers:
            for name, buf in (
                ("buf_rand.npz", self.envBuf_rand),
                ("buf_vid.npz", self.envBuf_vid),
            ):
                path = os.path.join(self.workdir, name)
                if os.path.exists(path) and len(buf) == 0:
                    buf.load(path)

    # -- the loop ---------------------------------------------------------

    def _sample_host_arrays(self, np_rng=None) -> Dict[str, np.ndarray]:
        """One batch's host arrays; with gradient accumulation, the
        micro-batches stacked on a leading axis."""
        ga = self.cfg.gradient_accumulate_every
        if ga == 1:
            return _host_arrays(self.sample_from_bufs(np_rng))
        micro = [_host_arrays(self.sample_from_bufs(np_rng)) for _ in range(ga)]
        return {k: np.stack([m[k] for m in micro]) for k in micro[0]}

    def _start_prefetch(self):
        if self.cfg.prefetch_depth > 0 and self._prefetch is None:
            # dedicated generator: the worker thread must not share the
            # trainer's numpy generator with the main thread
            pf_rng = np.random.default_rng(
                int(self.np_rng.integers(0, 2**63 - 1))
            )
            self._prefetch = PrefetchIterator(
                lambda: self._sample_host_arrays(pf_rng), place_fn=self._copier.put,
                depth=self.cfg.prefetch_depth,
            )

    def _flush_prefetch(self):
        """Stop and drain in-flight batches; call before mutating buffers."""
        if self._prefetch is not None:
            self._prefetch.stop()
            self._prefetch = None

    def _next_batch(self):
        if self.cfg.prefetch_depth > 0:
            self._start_prefetch()
            staged = next(self._prefetch)
        else:
            staged = self._copier.put(self._sample_host_arrays())
        return _as_batch(self._copier.take(staged))

    def train(self, n_steps: Optional[int] = None):
        cfg = self.cfg
        n_steps = n_steps or cfg.n_train_steps
        timer = Timer()

        if len(self.envBuf_rand) == 0:
            if cfg.randsam_path and cfg.rand_explo_type == "from_h5":
                self.ingest_h5(0, cfg.num_init_rand_ep_per_tk)
                self.h5_randsam_start_idx = cfg.num_init_rand_ep_per_tk
            else:
                self.live_rand_explore(max(cfg.num_init_rand_ep_per_tk // 25, 1))

        try:
            self._train_loop(cfg, n_steps, timer)
        finally:
            try:
                # commit (or surface the error of) any in-flight overlapped
                # cycle so its episodes are not lost on exit
                self._join_explore()
            finally:
                self._flush_prefetch()

    def _train_loop(self, cfg, n_steps, timer):
        while self.step < n_steps:
            step = self.step
            self.iter_sched.update(step)
            self.throttle.update(len(self.envBuf_rand), len(self.envBuf_vid))

            do_vid_explore = (
                self.video_model is not None
                and step > cfg.init_rand_steps
                and step % cfg.video_explo_freq == 0
                and self.throttle.explo_type_vid == "explo"
            )
            do_rand_explore = (
                step > cfg.init_rand_steps
                and step % cfg.rand_explo_freq == 0
                and self.throttle.explo_type_rand == "explo"
            )
            # overlapped exploration: commit a finished cycle promptly so
            # training sees fresh episodes at the earliest safe point
            if (self._explore_thread is not None
                    and not self._explore_thread.is_alive()):
                self._join_explore()

            # live rand exploration shares the envs with the explore worker,
            # so a video cycle must not overlap it this step
            overlap_vid = (
                cfg.overlap_explore
                and do_vid_explore
                and not (do_rand_explore and cfg.rand_explo_type == "live")
            )

            if (do_vid_explore and not overlap_vid) or do_rand_explore:
                # exploration and ingestion mutate the buffers: join any
                # in-flight cycle and drop prefetched batches so training
                # only sees post-mutation data (with 'from_h5' and no H5 file
                # the round adds nothing, and the JAX loop flushes all the
                # same)
                self._join_explore()
                self._flush_prefetch()

            if do_vid_explore:
                if overlap_vid:
                    self._join_explore()  # at most one cycle in flight
                    self._spawn_explore()
                else:
                    self.video_guided_explore()

            if do_rand_explore:
                if cfg.randsam_path and cfg.rand_explo_type == "from_h5":
                    # circular sweep over the per-task H5 episodes
                    st = self.h5_randsam_start_idx % cfg.h5_total_num_ep_per_task
                    n_add = min(cfg.h5_total_num_ep_per_task - st,
                                cfg.rand_explo_num_ep_per_tk)
                    self.ingest_h5(st, st + n_add)
                    self.h5_randsam_start_idx += n_add
                    if self.h5_randsam_start_idx >= cfg.h5_total_num_ep_per_task:
                        self.is_all_randsam_visited = True
                elif cfg.rand_explo_type == "live":
                    self.live_rand_explore(cfg.rand_explo_num_ep_per_tk)

            self.iter_sched.count()

            out = self._train_step(self.state, self._next_batch(), self._train_gen)
            new_step = self.step

            if new_step % cfg.save_freq == 0 or new_step == 1:
                self.save()

            if cfg.debug_img_freq and new_step % cfg.debug_img_freq == 0:
                self.dump_debug_images()

            if new_step % cfg.log_freq == 0 or new_step == 1:
                metrics = {
                    "train/loss": float(out.loss),
                    "train/grad_norm": float(out.grad_norm),
                    "train/num_steps_in_env": self.num_steps_in_env,
                    "train/cnt_explore_suc": self.cnt_explore_suc,
                    "buf/len_envBuf_rand": len(self.envBuf_rand),
                    "buf/len_envBuf_vid": len(self.envBuf_vid),
                    "explo/cnt_vid_rollouts": self.cnt_vid_rollouts,
                    "time/step_interval": timer(),
                }
                for tk in self.cnt_vid_rout_per_tk:
                    roll_key, suc_key = per_task_metric_names(tk)
                    metrics[roll_key] = self.cnt_vid_rout_per_tk[tk]
                    metrics[suc_key] = self.cnt_explo_suc_per_tk[tk]
                self.metrics.log(metrics, new_step)


def _host_arrays(host_batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The arrays of a sampled batch that go to the device."""
    out = {k: host_batch[src] for k, src in OBS_KEYS.items()}
    out["action"] = host_batch["action"]
    return out


def _scale_images(t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """uint8 images -> float32 [0, 1], on the device they were copied to."""
    return {k: (v.float() / 255.0 if k in OBS_KEYS else v) for k, v in t.items()}


def _as_batch(t: Dict[str, torch.Tensor]) -> dict:
    return {"obs": {k: t[k] for k in OBS_KEYS}, "action": t["action"]}
