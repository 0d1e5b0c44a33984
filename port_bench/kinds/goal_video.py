"""`kind: goal_video`: one closed-loop client of the served goal-video call.

Each request is a batch of first frames and task strings (a pool drawn from
the seed, sent in turn) that runs `VideoPredModel.sample_u8_stream` in
full: the stream's constructor (tokenize, text tower, x_T), every
denoising step, the finish, the uint8 quantisation and the copy of the
video to the host. Afterwards the text tower's and the U-Net's outputs,
x_T, the checked steps and the finish are held against the reference.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import cells, roofline
from port_bench.reference import diffusion as ref_diffusion
from port_bench.reference import nets as ref_nets


class ChainRecord:
    """What one request's chain left for the check: per recorded step the
    U-Net's input state and output, the generator's state before each
    checked step's noise, the task embedding, the video."""

    def __init__(self, index: int, steps: List[int]):
        self.index, self.checked = index, steps
        self.x: Dict[int, torch.Tensor] = {}
        self.v: Dict[int, torch.Tensor] = {}
        self.gen: Dict[int, torch.Tensor] = {}
        self.gen_before: Optional[torch.Tensor] = None
        self.task_embed: Optional[torch.Tensor] = None
        self.video: Optional[torch.Tensor] = None

    def complete(self) -> bool:
        """Every state, output and generator state the check reads is here."""
        need_x = set(self.checked) | {t - 1 for t in self.checked if t > 0}
        return (self.gen_before is not None and self.task_embed is not None
                and need_x <= set(self.x) and set(self.checked) <= set(self.v)
                and {t for t in self.checked if t > 0} <= set(self.gen))


class Driver:
    """The closed-loop goal-video client (`kind: goal_video`)."""

    def __init__(self, cell, seed: int, device, tracer):
        self.seed, self.device, self.tracer = seed, torch.device(device), tracer
        self.model_cfg, self.traffic = cell.config["model"], cell.traffic
        self.records: List[ChainRecord] = []
        self._current = None  # (record, step) of the step being launched
        self._spans = []

    # set-up
    def setup(self) -> None:
        tr, m = self.traffic, self.model_cfg
        self.model = cells.build_model(m, cells.sub_seed(self.seed, cells.WEIGHTS), self.device)
        rng = np.random.default_rng(cells.sub_seed(self.seed, cells.INPUTS))
        (h, w), b, c = m["image_size"], tr["batch"], m.get("cond_channels") or m["channels"]
        self.pool = []
        for _ in range(tr["pool"]):
            tasks = [tr["tasks"][i] for i in rng.integers(len(tr["tasks"]), size=b)]
            frames = rng.integers(0, 256, size=(b, h, w, c), dtype=np.uint8)
            self.pool.append((frames.astype(np.float32) / 255.0, tasks))
        self.steps = self.model.diffusion.sample_steps()
        self.check_rng = np.random.default_rng(cells.sub_seed(self.seed, cells.CHECK))
        self._warm_up()
        self.model.unet.register_forward_pre_hook(self._pre_hook)
        self.model.unet.register_forward_hook(self._post_hook)

    def _warm_up(self) -> None:
        """The request's shapes once, through the served call: the stream's
        constructor (text tower, x_T), one denoising step, then the finish,
        the quantisation and the copy on a state of the chain's shape."""
        from v2a_tpu_torch.models.video_model import quantize_u8

        x01, tasks = self.pool[0]
        gen = torch.Generator(device=self.device).manual_seed(0)
        stream = self.model.sample_u8_stream(x01, tasks, gen, len(self.steps))
        stream.pump(1)
        m = self.model_cfg
        shape = (len(tasks), m["sample_per_seq"] - 1, *m["image_size"], m["channels"])
        with torch.no_grad():
            img = torch.zeros(shape, device=self.device)
            quantize_u8(self.model.diffusion.sample_finish(img)).cpu()
        cells.sync(self.device)

    # recording, by hooks on the U-Net
    def _pre_hook(self, module, args):
        if self.tracer.on:
            span = self.tracer.span("unet")
            span.__enter__()
            self._spans.append(span)
        if self._current is None:
            return
        rec, t = self._current
        if t - 1 in rec.checked and t - 1 > 0:  # step t - 1's noise is the next draw
            rec.gen[t - 1] = self._gen.get_state()
        if t in rec.checked or t + 1 in rec.checked:
            rec.x[t] = args[0][..., :self.model_cfg["channels"]].clone()
        if rec.task_embed is None:
            rec.task_embed = args[2]

    def _post_hook(self, module, args, output):
        if self._current is not None:
            rec, t = self._current
            if t in rec.checked:
                rec.v[t] = output
        if self._spans:
            self._spans.pop().__exit__(None, None, None)

    def _checked_steps(self) -> List[int]:
        """The first and the last step and `check.steps` - 2 more, drawn."""
        inner = self.steps[1:-1]
        k = max(0, min(self.traffic["check"]["steps"] - 2, len(inner)))
        picks = self.check_rng.choice(len(inner), size=k, replace=False) if k else []
        return sorted({self.steps[0], self.steps[-1]} | {inner[i] for i in picks})

    # the window
    def window(self, seconds: float, requests: Optional[int] = None) -> dict:
        """Requests back to back for `seconds`, the last one cut where the
        window closes; or, with `requests`, exactly that many whole ones."""
        model, tracer, dev = self.model, self.tracer, self.device
        self._gen = gen = torch.Generator(device=dev).manual_seed(
            cells.sub_seed(self.seed, cells.STREAM))
        n_steps = len(self.steps)
        b, f = self.traffic["batch"], self.model_cfg["sample_per_seq"] - 1
        completed, partial, launched_total, k = 0, 0.0, 0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            x01, tasks = self.pool[k % len(self.pool)]
            rec = ChainRecord(k, self._checked_steps())
            self.records.append(rec)
            rec.gen_before = gen.get_state()
            with tracer.synced_span("request_host.open", dev):
                stream = model.sample_u8_stream(x01, tasks, gen, n_steps)
            rec.gen[self.steps[0]] = gen.get_state()
            launched = 0
            for t in self.steps:
                self._current = (rec, t)
                stream.pump(1)
                launched += 1
                if (requests is None and launched < n_steps
                        and time.perf_counter() >= deadline):
                    break
            self._current = None
            launched_total += launched
            if launched < n_steps:
                partial = launched / n_steps
                break
            with tracer.synced_span("request_host.close", dev):
                rec.video = stream.result_u8().cpu()
            completed += 1
            k += 1
            if (completed == requests if requests is not None
                    else time.perf_counter() >= deadline):
                break
        cells.sync(dev)
        window_s = time.perf_counter() - t0
        self.counts = dict(requests=completed, partial=partial, forwards=launched_total,
                           batch=b, window_s=window_s,
                           unet_flops=roofline.unet_forward_total(self.model_cfg, b))
        frames = b * f * (completed + partial)
        self.attempted = completed + (1 if partial else 0)
        return {"goal_frames_per_s": frames / window_s}

    # the check
    def free_program(self) -> None:
        """The model goes; the records of the chains stay for the check."""
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self, precision: str = "float32") -> Dict[str, float]:
        """The numbers that decide `correct`, over `check.requests` finished
        requests drawn from the seed: the text tower's and the U-Net's
        outputs against the reference's on the chain's own states, x_T
        against the seed's draw, and each checked step and the finish,
        quantisation included, against the reference's step from the
        program's state and output with the same noise. With another
        `precision` the reference at that precision stands in the
        program's place (the control), and only the first two are read."""
        m, dev = self.model_cfg, self.device
        done = [r for r in self.records if r.video is not None]
        if not done or any(not r.complete() for r in done):
            return {"finished_requests": float(len(done)), "records_complete": 0.0}
        pick = self.check_rng.choice(len(done), size=min(len(done), self.traffic["check"]
                                                          ["requests"]), replace=False)
        nets = cells.reference_nets(m, cells.sub_seed(self.seed, cells.WEIGHTS), dev)
        sched = ref_diffusion.Schedule(m["timesteps"], dev)
        fp32, control = ref_nets.Precision("float32"), precision != "float32"
        q = ref_nets.Precision(precision)
        rows, first = self.traffic["reference_rows"], self.steps[0]
        out = dict(text_rel_err=0.0, unet_rel_err=0.0)
        if not control:
            out.update(xT_maxdiff=0.0, sampler_maxdiff=0.0, video_u8_maxdiff=0.0)
        gen = torch.Generator(device=dev)

        def unet(x_in, tt, emb, prec):
            return torch.cat([nets.unet(x_in[r:r + rows], tt[r:r + rows], emb[r:r + rows], prec)
                              for r in range(0, x_in.shape[0], rows)])

        with cells.no_tf32():
            for i in sorted(pick):
                rec = done[i]
                x01, tasks = self.pool[rec.index % len(self.pool)]
                emb_ref = nets.text.encode(tasks, fp32)
                emb = nets.text.encode(tasks, q) if control else rec.task_embed
                out["text_rel_err"] = max(out["text_rel_err"], cells.rel_rows(emb, emb_ref))
                cond = (torch.as_tensor(x01, device=dev) * 2.0 - 1.0)[:, None]
                if not control:
                    gen.set_state(rec.gen_before)
                    x_T = torch.randn(tuple(rec.x[first].shape), generator=gen, device=dev,
                                      dtype=torch.float32)
                    out["xT_maxdiff"] = max(out["xT_maxdiff"],
                                            float((x_T - rec.x[first]).abs().max()))
                for t in rec.checked:
                    x = rec.x[t]
                    x_in = torch.cat([x, cond.expand(x.shape[:-1] + (cond.shape[-1],))], -1)
                    tt = torch.full((x.shape[0],), t, dtype=torch.long, device=dev)
                    v_ref = unet(x_in, tt, emb_ref, fp32)
                    v = unet(x_in, tt, emb, q) if control else rec.v[t]
                    out["unet_rel_err"] = max(out["unet_rel_err"], cells.rel_rows(v, v_ref))
                    if control:
                        continue
                    noise = None
                    if t > 0:
                        gen.set_state(rec.gen[t])
                        noise = torch.randn(tuple(x.shape), generator=gen, device=dev,
                                            dtype=torch.float32)
                    nxt = sched.ancestral_step(x, t, v, noise)
                    if t > 0:
                        out["sampler_maxdiff"] = max(out["sampler_maxdiff"],
                                                     float((nxt - rec.x[t - 1]).abs().max()))
                    else:
                        u8 = sched.finish_u8(nxt).cpu()
                        diff = float((u8.int() - rec.video.int()).abs().max())
                        out["video_u8_maxdiff"] = max(out["video_u8_maxdiff"], diff)
        return out
