"""`kind: video_train`: `VideoModelTrainer.train` over seeded synthetic clips.

The clips are held in host memory, their batches handed out by a dataset
with the `sample_batch(batch, rng)` interface; the dataset ends the call
when the window closes. Afterwards the first steps' losses, the first
gradient and the parameters' and the EMA's change are held against the
reference's.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import cells, roofline
from port_bench.reference import diffusion as ref_diffusion
from port_bench.reference import nets as ref_nets


class WindowClosed(Exception):
    """Raised by the dataset when the step it would feed is not to run."""


class SyntheticClips:
    """Seeded uint8 clips (a first frame and F frames) and task strings in
    host memory, behind the `sample_batch(batch, rng)` interface of the
    trainer's datasets. Rows go out in a permutation drawn from `rng`, so
    every row of a pass over the pool differs. `allow(n)` lets n more
    batches out; `until(t)` lets batches out until the host clock passes t;
    past either, `sample_batch` raises `WindowClosed`."""

    def __init__(self, traffic: dict, model: dict, seed: int):
        rng = np.random.default_rng(seed)
        (h, w), f, c = model["image_size"], model["sample_per_seq"], model["channels"]
        n = traffic["pool"]
        self.clips = rng.integers(0, 256, size=(n, f, h, w, c), dtype=np.uint8)
        self.tasks = [traffic["tasks"][i] for i in rng.integers(len(traffic["tasks"]), size=n)]
        self._order: List[int] = []
        self.handed_out: List[float] = []  # host clock of each batch handed out
        self._left: Optional[int] = None
        self._deadline: Optional[float] = None

    def __len__(self):
        return len(self.clips)

    def allow(self, n: int) -> None:
        self._left, self._deadline = n, None

    def until(self, deadline: float) -> None:
        self._left, self._deadline = None, deadline

    def sample_batch(self, batch: int, rng: np.random.Generator):
        if self._left is not None:
            if self._left <= 0:
                raise WindowClosed
            self._left -= 1
        if self._deadline is not None and time.perf_counter() >= self._deadline:
            raise WindowClosed
        self.handed_out.append(time.perf_counter())
        if len(self._order) < batch:
            self._order += rng.permutation(len(self.clips)).tolist()
        idx, self._order = self._order[:batch], self._order[batch:]
        clips = self.clips[idx].astype(np.float32) / 255.0
        return clips[:, 0], clips[:, 1:], [self.tasks[i] for i in idx]


class Driver:
    """The video-model trainer's steps (`kind: video_train`)."""

    def __init__(self, cell, seed: int, device, tracer):
        self.seed, self.device, self.tracer = seed, torch.device(device), tracer
        self.model_cfg, self.traffic = cell.config["model"], cell.traffic
        self.trainer_cfg = cell.config["trainer"]
        self.workdir = None

    def setup(self) -> None:
        from v2a_tpu_torch.train.video_trainer import VideoModelTrainer, VideoTrainerConfig

        m, tr = self.model_cfg, self.traffic
        self.model = cells.build_model(m, cells.sub_seed(self.seed, cells.WEIGHTS), self.device)
        self.dataset = SyntheticClips(tr, m, cells.sub_seed(self.seed, cells.INPUTS))
        cfg = VideoTrainerConfig(batch_size=tr["batch"], **self.trainer_cfg)
        self.workdir = tempfile.mkdtemp(prefix="port_bench_train_")
        self.trainer = trainer = VideoModelTrainer(self.model, self.dataset, cfg,
                                                   workdir=self.workdir,
                                                   seed=cells.sub_seed(self.seed, cells.TRAIN))
        # the first steps, through the window's own call and feed; the
        # reference follows the first `check.steps`
        n_check = tr["check"]["steps"]
        self.losses: List[torch.Tensor] = []
        orig = trainer.train_step

        def recorded(*a, **k):
            loss, per_sample = orig(*a, **k)
            self.losses.append(loss.detach().clone())
            return loss, per_sample

        trainer.train_step = recorded
        params = dict(trainer.train_unet.named_parameters())
        for i in range(max(tr["setup_steps"], n_check)):
            self._steps(1)
            if i == 0:
                opt = trainer.state.optimizer
                self.first_m = {k: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                                .detach().clone() for k, p in params.items()}
            if i == n_check - 1:
                self.params_after = {k: p.detach().clone() for k, p in params.items()}
                self.ema_after = {k: v.detach().clone() for k, v in trainer.state.ema.items()}
        del trainer.train_step
        self.losses = self.losses[:n_check]
        if self.tracer.enabled:  # spans around the step's parts, by name
            for obj, name in ((trainer, "apply_gradients"), (trainer, "loss_and_grads"),
                              (self.dataset, "sample_batch")):
                setattr(obj, name, self._traced(getattr(obj, name), name))
        cells.sync(self.device)

    def _traced(self, fn, name: str):
        def traced(*a, **k):
            with self.tracer.span(name):
                return fn(*a, **k)
        return traced

    def _steps(self, n: Optional[int] = None, deadline: Optional[float] = None) -> None:
        if n is not None:
            self.dataset.allow(n)
        else:
            self.dataset.until(deadline)
        try:
            self.trainer.train()
        except WindowClosed:
            pass

    def window(self, seconds: float) -> dict:
        b = self.traffic["batch"]
        step0 = self.trainer.step
        t0 = time.perf_counter()
        self._steps(deadline=t0 + seconds)
        cells.sync(self.device)
        window_s = time.perf_counter() - t0
        steps = self.trainer.step - step0
        gaps = np.diff(self.dataset.handed_out[-steps:]) * 1e3 if steps > 1 else np.zeros(1)
        self.counts = dict(steps=steps, batch=b, window_s=window_s,
                           unet_flops=roofline.unet_forward_total(self.model_cfg, b),
                           step_ms_min_median_p90_max=[float(np.min(gaps)), float(np.median(gaps)),
                                                       float(np.percentile(gaps, 90)),
                                                       float(np.max(gaps))])
        self.attempted = steps
        return {"video_train_samples_per_s": b * steps / window_s}

    def free_program(self) -> None:
        self.trainer.close()
        del self.trainer, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.workdir, ignore_errors=True)

    def reference_steps(self, precision: str = "float32", half_batch: bool = False):
        """The reference's first `check.steps`: (losses, clipped first
        gradients, parameters after, EMA after, first gradients unclipped),
        as plain float32 PyTorch from the seed's weights and inputs."""
        m, tr, tc, dev = self.model_cfg, self.traffic, self.trainer_cfg, self.device
        nets = cells.reference_nets(m, cells.sub_seed(self.seed, cells.WEIGHTS), dev)
        nets.requires_grad_(False)
        unet = nets.unet.requires_grad_(True)
        params = dict(unet.named_parameters())
        opt = ref_diffusion.ClippedAdam(params, tc["lr"], tc["b1"], tc["b2"], tc["grad_clip"])
        sched = ref_diffusion.Schedule(m["timesteps"], dev)
        q, fp32 = ref_nets.Precision(precision), ref_nets.Precision("float32")
        data = SyntheticClips(tr, m, cells.sub_seed(self.seed, cells.INPUTS))
        rng = np.random.default_rng(cells.sub_seed(self.seed, cells.TRAIN))
        gen = torch.Generator(device=dev).manual_seed(cells.sub_seed(self.seed, cells.TRAIN))
        b, rows = tr["batch"], tr["reference_rows"]
        losses, first = [], None
        with cells.no_tf32():
            for step in range(tr["check"]["steps"]):
                x_cond, video, tasks = data.sample_batch(b, rng)
                t = torch.as_tensor(ref_diffusion.uniform_timesteps(rng, b, m["timesteps"]),
                                    dtype=torch.long, device=dev)
                with torch.no_grad():
                    emb = nets.text.encode(tasks, fp32)
                video = torch.as_tensor(video, device=dev)
                noise = torch.randn(tuple(video.shape), generator=gen, device=dev,
                                    dtype=torch.float32)
                cond = (torch.as_tensor(x_cond, device=dev) * 2.0 - 1.0)[:, None]
                cond = cond.expand(video.shape[:-1] + (cond.shape[-1],))
                used = b // 2 if half_batch else b
                for p in params.values():
                    p.grad = None
                total = 0.0
                for r in range(0, used, rows):
                    s = slice(r, min(r + rows, used))
                    x_in = torch.cat([sched.noisy(video[s], t[s], noise[s]), cond[s]], -1)
                    out = unet(x_in, t[s], emb[s], q)
                    loss = sched.weighted_losses(out, video[s], t[s], noise[s]).sum() / used
                    loss.backward()
                    total += float(loss.detach())
                losses.append(total)
                grads = {k: p.grad for k, p in params.items()}
                clipped = opt.step(params, grads)
                if step == 0:
                    first = ({k: g.clone() for k, g in clipped.items()},
                             {k: g.clone() for k, g in grads.items()})
        return losses, first[0], {k: p.detach() for k, p in params.items()}, opt.ema, first[1]

    def check(self, precision: str = "float32", half_batch: bool = False) -> Dict[str, float]:
        """Each of the first steps' loss; the first gradient as Adam got it
        (its first moment over 1 - b1); the parameters' change and the EMA's
        after those steps; each by the worst leaf's gap of norms against the
        reference's. With another `precision` or `half_batch` the reference
        so computed stands in the program's place (the control, and the fault
        of half the batch)."""
        ref_loss, ref_g, ref_p, ref_ema, raw = self.reference_steps()
        if precision == "float32" and not half_batch:
            b1 = self.trainer_cfg["b1"]
            loss = [float(x) for x in self.losses]
            g = {k: v / (1.0 - b1) for k, v in self.first_m.items()}
            p, ema = self.params_after, self.ema_after
        else:
            loss, g, p, ema, _ = self.reference_steps(precision, half_batch)
        theta0 = cells.make_weights(self.model_cfg, cells.sub_seed(self.seed, cells.WEIGHTS),
                                    self.device)
        theta0 = {k[len("unet."):]: v for k, v in theta0.items() if k.startswith("unet.")}
        # leaves whose reference gradient is nought to rounding (a key's bias
        # under softmax, a bias that a GroupNorm takes out) move under Adam
        # by round-off alone: out of the changes, where their RMS gradient is
        # under a thousandth of the median leaf's. A fused attention
        # projection counts as its q, k and v parts.
        with torch.device("meta"):
            split = ref_nets.VideoUNet(self.model_cfg).split_leaves
        rms = {k: float(v.norm()) / math.sqrt(v.numel()) for k, v in split(raw).items()}
        median = float(np.median(list(rms.values())))
        keep = [k for k, r in rms.items() if r >= 1e-3 * median]

        def change(d):
            parts = split({k: d[k] - theta0[k] for k in theta0})
            return {k: parts[k] for k in keep}

        self.notes = {"left_out": {k: r / median for k, r in rms.items() if k not in keep}}
        return dict(
            loss_gap=max(abs(a - r) / abs(r) for a, r in zip(loss, ref_loss)),
            grad_norm_gap=cells.norm_gap(g, ref_g),
            update_norm_gap=cells.norm_gap(change(p), change(ref_p)),
            ema_norm_gap=cells.norm_gap(change(ema), change(ref_ema)),
        )
