"""Frozen video-prediction model: CLIP text encode -> diffusion sample.

Counterpart of `v2a_tpu/models/video_model.py` (the reference's
`Video_PredModel`, `diffuser/models/video_model.py:9-85`). Videos are
(B, F, H, W, channels) channels-last; the conditioning frame (cond_channels)
is tiled over F on the channel axis. The sampler runs on the card by
default; `device="cpu"` is for tests. `loss` is the training objective;
`train/video_trainer.py` trains the U-Net. `sample_u8_stream` is `sample_u8` cut into chunks of the
denoising chain that a caller dispatches one at a time (`VideoSampleStream`).
`load_converted` reads a reference checkpoint converted by
`scripts/convert_ckpt.py`. `cond_channels` gives the conditioning frame
its own channel count (the flow variants of `models/env_variants.py`);
`backbone="xattn"` builds `models/video_unet_xattn.py` in place of the
U-Net. `shard_for_mesh` spreads the frozen sampler over a mesh
(`parallel/`): wide leaves stored tp-sharded and made whole for each chain,
the batch split over the dp ranks, every rank returning the whole video.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import List, Optional, Tuple

import torch
from torch import nn

from v2a_tpu_torch.device import DeviceLike, dtype_of, resolve_device
from v2a_tpu_torch.models.clip_text import (
    ClipTextEncoder, ClipTokenizerWrapper, sanitize_task_strings,
)
from v2a_tpu_torch.models.init import init_params
from v2a_tpu_torch.models.video_unet import ConvRouting, VideoUNet
from v2a_tpu_torch.models.video_unet_xattn import VideoUNetXAttn
from v2a_tpu_torch.ops.gaussian_diffusion import GaussianDiffusion
from v2a_tpu_torch.ops.schedules import DiffusionSchedule


def quantize_u8(x01: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> uint8, truncating like numpy's astype."""
    return (x01.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class VideoModelConfig:
    """`lb_get_video_model_gcp_v2` + the `vid_diffusion` config
    (`config/libero/lb_tk8_65to72.py:40-62`); the release run uses
    dtype 'bfloat16'."""

    image_size: Tuple[int, int] = (128, 128)
    sample_per_seq: int = 8  # frames incl. the conditioning frame
    channels: int = 3
    timesteps: int = 100
    sampling_timesteps: int = 100
    objective: str = "pred_v"
    beta_schedule: str = "cosine"
    loss_type: str = "l2"
    min_snr_loss_weight: bool = True
    guidance_weight: float = 0.0
    var_temp: float = 1.0
    model_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4, 5)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 16)
    num_head_channels: int = 32
    text_dim: int = 512
    dtype: str = "float32"
    # conditioning-frame channels where they differ from the predicted ones
    # (the MW flow variants: 2-channel flow on an rgb frame); None = channels
    cond_channels: Optional[int] = None
    # 'unet' = `VideoUNet` (Perceiver-pooled additive text conditioning, the
    # release model); 'xattn' = `VideoUNetXAttn` (cross-attention
    # conditioning). The routing fields below apply to 'unet' only.
    backbone: str = "unet"
    # fused kernel routing; None = on when the device is cuda
    fused: Optional[bool] = None
    # with `fused`: the padded-stream routing (K3 / K4 / K5 at the levels
    # with H*W > 512), the JAX package's default; False = K1 / K2 only
    padded_stream: bool = True
    # with `fused` and the padded stream: the downsamples into a padded level
    # through K8 (the JAX package's V2A_DOWNCONV=1)
    downconv: bool = False
    # with `fused`: the attention blocks through K9 (V2A_PALLAS_ATTN=1)
    attn_kernel: bool = False
    # without `fused`: the GroupNorms through K7 (the JAX config field)
    use_pallas_gn: bool = False
    # with `fused`, the conv switches of `video_unet.ConvRouting`: the K1
    # gate's bounds (V2A_SPATIAL2_MIN_CH, 0 = off and no padded stream;
    # V2A_SPATIAL2_MAX_S), the convs it leaves through K10
    # (PERF_PALLAS_SPATIAL), the temporal convs through K11 (PERF_TCONV_HW),
    # the padded convs without a skip fold through K12 (V2A_STREAM_KERNEL=1),
    # K3 where the JAX rule admits it (False: K4a then K4b there,
    # V2A_MEGA_KERNEL=0), K5 for the upsample convs into a padded level
    # (False: nearest-2x, pad, the padded conv; V2A_UPCONV=0) and the entry
    # conv on the padded stream (V2A_ENTRY_PAD=1)
    spatial2_min_ch: int = 128
    spatial2_max_s: int = 16384
    pallas_spatial: bool = False
    tconv_hw: bool = False
    stream_kernel: bool = False
    mega_kernel: bool = True
    upconv: bool = True
    entry_pad: bool = False
    # the train_fused routing's switches (`video_unet.ConvRouting`): the
    # dgrad through K1 (False: the library's; PERF_TRAIN_DGRAD_PALLAS), K6
    # only where H*W >= wgrad_min_s (PERF_TRAIN_WGRAD_MIN_S), the temporal
    # convs as tap products (PERF_TRAIN_TCONV_DOT)
    train_dgrad_kernel: bool = True
    wgrad_min_s: int = 0
    train_tconv_dot: bool = False

    def conv_routing(self) -> ConvRouting:
        """The U-Net's `ConvRouting` of these fields (the perf lab's
        switches at their defaults)."""
        return ConvRouting(
            padded_stream=self.padded_stream, downconv=self.downconv,
            attn_kernel=self.attn_kernel, use_pallas_gn=self.use_pallas_gn,
            spatial2_min_ch=self.spatial2_min_ch, spatial2_max_s=self.spatial2_max_s,
            pallas_spatial=self.pallas_spatial, tconv_hw=self.tconv_hw,
            stream_kernel=self.stream_kernel, mega_kernel=self.mega_kernel, upconv=self.upconv,
            entry_pad=self.entry_pad, train_dgrad_kernel=self.train_dgrad_kernel,
            wgrad_min_s=self.wgrad_min_s, train_tconv_dot=self.train_tconv_dot)

    @property
    def video_future_horizon(self) -> int:
        return self.sample_per_seq - 1

    @property
    def cond_ch(self) -> int:
        return self.channels if self.cond_channels is None else self.cond_channels


class VideoNets(nn.Module):
    """The two networks under one state dict: `unet.*` and `text.*`."""

    def __init__(self, unet: nn.Module, text: ClipTextEncoder):
        super().__init__()
        self.unet = unet
        self.text = text


class VideoPredModel:
    """U-Net + text tower with the diffusion sampler."""

    def __init__(self, config: Optional[VideoModelConfig] = None,
                 tokenizer: Optional[ClipTokenizerWrapper] = None, device: DeviceLike = None):
        self.config = cfg = config or VideoModelConfig()
        if cfg.backbone not in ("unet", "xattn"):
            raise ValueError(f"unknown backbone {cfg.backbone!r}")
        self.device = resolve_device(device)
        dt = dtype_of(cfg.dtype)
        fused = cfg.fused if cfg.fused is not None else self.device.type == "cuda"
        unet = self.build_unet(fused=fused)
        text = ClipTextEncoder(width=cfg.text_dim, mlp_dim=cfg.text_dim * 4, dtype=dt)
        self.nets = VideoNets(unet, text).to(self.device).eval().requires_grad_(False)
        self._loss_unet: Optional[VideoUNet] = None
        self._mesh = self._shards = None
        self._whole_users = 0
        self.tokenizer = tokenizer or ClipTokenizerWrapper()
        self.diffusion = GaussianDiffusion(
            schedule=DiffusionSchedule.create(cfg.timesteps, cfg.beta_schedule,
                                              device=self.device),
            objective=cfg.objective,
            sampling_timesteps=cfg.sampling_timesteps,
            guidance_weight=cfg.guidance_weight,
            var_temp=cfg.var_temp,
            loss_type=cfg.loss_type,
            min_snr_loss_weight=cfg.min_snr_loss_weight,
        )

    @property
    def unet(self) -> nn.Module:
        return self.nets.unet

    def build_unet(self, fused: bool = False, train_fused: bool = False,
                   wgrad_kernel: bool = False,
                   routing: Optional[ConvRouting] = None, use_checkpoint: bool = False,
                   remat_policy: str = "blocks") -> nn.Module:
        """A new network of this config's backbone with the given routing
        (`routing`: the U-Net's `ConvRouting`, the config's `conv_routing()`
        by default; parameters uninitialized, on the current default
        device); every routing takes the same state dict. The routing
        applies to the U-Net only: the xattn backbone has none, as the JAX
        package passes it none (`v2a_tpu/models/video_model.py:129-140`).
        `use_checkpoint` / `remat_policy`: the training recomputation of
        either backbone (the xattn backbone's is per block)."""
        cfg = self.config
        if cfg.backbone == "xattn":
            return VideoUNetXAttn(
                in_channels=cfg.channels + cfg.cond_ch, out_channels=cfg.channels,
                block_out_channels=tuple(cfg.model_channels * m for m in cfg.channel_mult),
                layers_per_block=cfg.num_res_blocks, context_dim=cfg.text_dim,
                dtype=dtype_of(cfg.dtype), use_checkpoint=use_checkpoint)
        return VideoUNet(
            in_channels=cfg.channels + cfg.cond_ch, model_channels=cfg.model_channels,
            out_channels=cfg.channels, num_res_blocks=cfg.num_res_blocks,
            attention_resolutions=cfg.attention_resolutions, channel_mult=cfg.channel_mult,
            num_head_channels=cfg.num_head_channels, task_token_dim=cfg.text_dim,
            dtype=dtype_of(cfg.dtype), fused=fused, train_fused=train_fused,
            wgrad_kernel=wgrad_kernel,
            routing=cfg.conv_routing() if routing is None else routing,
            use_checkpoint=use_checkpoint, remat_policy=remat_policy,
        )

    @property
    def loss_unet(self) -> nn.Module:
        """The U-Net `loss` evaluates: the non-fused routing on the frozen
        weights, as the JAX package's `_model_fn(for_training=True)` clones
        the U-Net with `fused=False`. Built once, on the meta device, then
        given `unet`'s own Parameter objects (shared, never copied); `unet`
        itself when that is already non-fused (and for the xattn backbone)."""
        if not getattr(self.unet, "fused", False):
            return self.unet
        if self._loss_unet is None:
            with torch.device("meta"):
                net = self.build_unet(fused=False)
            modules = dict(self.unet.named_modules())
            for name, mod in net.named_modules():
                for pname, p in modules[name].named_parameters(recurse=False):
                    setattr(mod, pname, p)
            self._loss_unet = net.eval()
        return self._loss_unet

    def init(self, seed: int = 0) -> "VideoPredModel":
        """Random weights from one seeded generator on the model's device."""
        init_params(self.nets, torch.Generator(device=self.device).manual_seed(seed))
        return self

    def param_count(self) -> int:
        """Parameters of the U-Net and the text tower."""
        return sum(p.numel() for p in self.nets.parameters())

    def load_state_dict(self, state_dict) -> "VideoPredModel":
        """Weights as `convert/from_jax.py::video_model_from_jax` returns them."""
        sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        self.nets.load_state_dict(sd, strict=True)
        return self

    def load_converted(self, path: str, tokenizer_dir: Optional[str] = None,
                       seed: int = 0) -> "VideoPredModel":
        """Load a converted reference checkpoint (`torch-model-*.pt`, written
        by `scripts/convert_ckpt.py`), refusing the combination that would
        fail silently: real CLIP text weights need the real BPE tokenizer
        (the hash tokenizer maps words to unrelated ids, and the
        conditioning would be garbage with no error). `convert_ckpt --clip`
        bundles the tokenizer assets under `<out_dir>/tokenizer/`. A U-Net
        only file keeps the text tower of `init(seed)`, which only the
        equally hermetic hash tokenizer is consistent with. The load is
        strict, and the parameters keep their dtype (float32, as `init`
        leaves them; the config's dtype is the compute dtype): each tensor
        is read on the host and copied once into the model's parameter on
        its device."""
        from v2a_tpu_torch.convert.torch_import import load_video_params

        params = load_video_params(path)
        if tokenizer_dir and os.path.isdir(tokenizer_dir):
            self.tokenizer = ClipTokenizerWrapper(local_path=tokenizer_dir)
        if "text" in params and not self.tokenizer.is_real:
            raise RuntimeError(
                f"{path} holds converted CLIP text weights but only the hash tokenizer is "
                "available — refusing (the text conditioning would be garbage). Bundle the "
                "tokenizer assets (convert_ckpt --clip writes <out>/tokenizer/) or pass "
                "tokenizer_dir.")
        if "text" not in params:
            self.init(seed)
            params = dict(params, text=self.nets.text.state_dict())
        self.nets.load_state_dict(
            {f"{part}.{k}": v for part, sd in params.items() for k, v in sd.items()}, strict=True)
        return self

    def shard_for_mesh(self, mesh) -> None:
        """Distribute the frozen sampler over a mesh (`parallel.make_mesh`):
        wide leaves of both networks are stored tp-sharded (the JAX rule,
        `parallel/sharding.py`) and gathered whole for each chain, so the
        kernels see whole weights; `sample()` splits the batch over the dp
        axes and returns the whole batch on every rank. Call after
        `init()` / `load_converted()`."""
        from v2a_tpu_torch.parallel.mesh import check_mesh
        from v2a_tpu_torch.parallel.sharding import shard_train_state

        self._mesh = check_mesh(mesh)
        self._shards = shard_train_state(self.nets, mesh)

    @contextlib.contextmanager
    def whole(self):
        """The networks' parameters whole inside the block (nested blocks
        share one gather; a no-op unless `shard_for_mesh` was called)."""
        if self._shards is None:
            yield
            return
        if self._whole_users == 0:
            self._shards.gather()
        self._whole_users += 1
        try:
            yield
        finally:
            self._whole_users -= 1
            if self._whole_users == 0:
                self._shards.release()

    @torch.no_grad()
    def encode_batch_text(self, tasks: List[str]) -> torch.Tensor:
        """CLIP last hidden state of the sanitized task strings (float32)."""
        ids, mask = self.tokenizer(sanitize_task_strings(list(tasks)))
        return self.nets.text(torch.as_tensor(ids, device=self.device),
                              torch.as_tensor(mask, device=self.device))

    def sample(self, x_conds, tasks: List[str], generator: Optional[torch.Generator] = None,
               init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_conds float [0, 1] (B, H, W, cond_ch); returns (B, F, H, W,
        channels) in [0, 1]: the whole chain in one chunk. `init_noise`
        overrides x_T (reproducible sampling, tests)."""
        return VideoSampleStream(self, x_conds, tasks, generator, 1, init_noise).result()

    def loss(self, video01: torch.Tensor, x_cond01: torch.Tensor, task_embed: torch.Tensor,
             t: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The denoising loss (`goal_diffusion.py:690-733`) of target frames
        video01 (B, F, H, W, channels) in [0, 1] given x_cond01 (B, H, W,
        cond_ch), the value through `loss_unet`: the frozen weights on the
        non-fused routing, as the JAX package's `_model_fn(for_training=True)` (the
        fused routing would round as its kernels do, a different function).
        Gradients come from a trainable U-Net of `build_unet(fused=False)`,
        as `VideoModelTrainer` builds."""
        x_cond_n = (x_cond01 * 2.0 - 1.0)[:, None]
        return self.diffusion.p_losses(self.loss_unet, video01, x_cond_n, task_embed, t=t,
                                       generator=generator, noise=noise)

    def sample_u8(self, x_conds, tasks: List[str],
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`sample()` quantized to uint8 on the device (truncating)."""
        return quantize_u8(self.sample(x_conds, tasks, generator))

    def sample_u8_stream(self, x_conds, tasks: List[str],
                         generator: Optional[torch.Generator], n_chunks: int,
                         ) -> "VideoSampleStream":
        """An incrementally dispatched `sample_u8`: the denoising chain cut
        into `n_chunks` contiguous slices of its steps that the caller pumps
        one at a time (`VideoSampleStream.pump`), so one card interleaves
        them with other work (the rollouts' policy calls, the trainer's
        `pipeline_explore`). `sample` runs the same chain in one chunk, so
        the stream computes `sample_u8` bit for bit as long as nothing else
        draws from `generator` meanwhile."""
        return VideoSampleStream(self, x_conds, tasks, generator, n_chunks)


class VideoSampleStream:
    """One goal-video sampling chain, dispatched chunk by chunk: the only
    loop over the denoising steps (`VideoPredModel.sample` runs it in one
    chunk). On a mesh (`VideoPredModel.shard_for_mesh`) the weights stay
    whole from the constructor to `result()`, this rank denoises its dp
    rows (its rows of every global draw) and `result()` all-gathers them.

    Counterpart of `v2a_tpu/models/video_model.py::VideoSampleStream`. The
    constructor encodes the tasks and draws x_T (or takes `init_noise`); no
    denoising step is launched until `pump()`. `result()` pumps any
    remaining chunks and returns the [0, 1] video on the model's device,
    `result_u8()` the same quantized."""

    def __init__(self, model: VideoPredModel, x_conds, tasks, generator, n_chunks: int,
                 init_noise: Optional[torch.Tensor] = None):
        cfg = model.config
        x = torch.as_tensor(x_conds, dtype=torch.float32, device=model.device)
        if x.shape[0] != len(tasks):
            raise ValueError("batch size mismatch between frames and tasks")
        self._model = model
        self._generator = generator
        self._shard = None
        if model._mesh is not None:
            from v2a_tpu_torch.parallel.sharding import batch_sharding

            self._shard = batch_sharding(model._mesh)
            rows = self._shard.rows(x.shape[0])
            x, tasks = x[rows], list(tasks)[rows]
            if init_noise is not None:
                init_noise = torch.as_tensor(init_noise)[rows]
        self._whole = model.whole()
        self._whole.__enter__()
        with torch.no_grad():
            self._task_embed = model.encode_batch_text(list(tasks))
            self._x_cond_n = (x * 2.0 - 1.0)[:, None]
            if init_noise is None:
                h, w = cfg.image_size
                shape = (x.shape[0], cfg.video_future_horizon, h, w, cfg.channels)
                init_noise = model.diffusion._randn(shape, generator, model.device,
                                                    self._shard)
            self._img = init_noise
        self._steps = model.diffusion.sample_steps()
        n_steps = len(self._steps)
        k = max(1, -(-n_steps // max(n_chunks, 1)))  # ceil
        self._bounds = [(a, min(a + k, n_steps)) for a in range(0, n_steps, k)]
        self._next = 0
        self._result = None

    @property
    def chunks_left(self) -> int:
        return len(self._bounds) - self._next

    def pump(self, k: int = 1) -> bool:
        """Launch up to `k` pending chunks (asynchronous on the card).
        Returns True while work remains. Runs under `no_grad` itself: grad
        mode is per thread, and a caller's thread may have it on."""
        diffusion, unet = self._model.diffusion, self._model.unet
        with torch.no_grad():
            while k > 0 and self._next < len(self._bounds):
                a, b = self._bounds[self._next]
                for step in self._steps[a:b]:
                    self._img = diffusion.sample_step(
                        unet, self._img, step, self._x_cond_n, self._task_embed,
                        self._generator, self._shard)
                self._next += 1
                k -= 1
        return self._next < len(self._bounds)

    def result(self) -> torch.Tensor:
        """Finish the chain; returns the (B, F, H, W, channels) video in [0,
        1] on the model's device."""
        if self._result is None:
            while self.pump(1):
                pass
            with torch.no_grad():
                self._result = self._model.diffusion.sample_finish(self._img)
            self._whole.__exit__(None, None, None)
            if self._shard is not None:
                from v2a_tpu_torch.parallel.sharding import all_gather_rows

                self._result = all_gather_rows(self._result, self._model._mesh)
            # drop chain state so buffers free as soon as callers let go
            self._img = self._task_embed = self._x_cond_n = None
        return self._result

    def result_u8(self) -> torch.Tensor:
        """`result()` quantized to uint8 on the device (truncating)."""
        return quantize_u8(self.result())
