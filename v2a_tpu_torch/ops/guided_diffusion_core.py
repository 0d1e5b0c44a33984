"""Full guided-diffusion core: learned-variance posteriors, VLB losses, and
spaced-timestep (respaced) processes.

Counterpart of `v2a_tpu/ops/guided_diffusion_core.py` (the vendored OpenAI
guided-diffusion `gaussian_diffusion.py:101-908`, `losses.py:1-77`,
`respace.py:7-128`): ModelVarType.LEARNED / LEARNED_RANGE, KL / NLL VLB
terms, `training_losses` with the frozen-mean vb term, `calc_bpd_loop`, and
`SpacedDiffusion`'s beta re-derivation and timestep remapping.

- The coefficient tables are computed in float64 numpy, as the JAX package
  does (a copy of its numpy code), and kept as float32 tensors on one
  device (`GuidedDiffusion.to`).
- Activations are channels-last: a learned-variance model emits 2*C on the
  trailing axis and is split there.
- The sampling loops are Python loops over the reversed timestep table.
  Every draw comes from an explicit `torch.Generator`; each step also takes
  an explicit `noise`, and each loop an initial one.
- Every clamp of the JAX code is kept: `discretized_gaussian_log_likelihood`
  clamps before each `log`, since `torch.where` evaluates both branches.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Set, Union

import numpy as np
import torch

from v2a_tpu_torch.device import DeviceLike, resolve_device

ModelFn = Callable[..., torch.Tensor]
_LOG2 = float(np.log(2.0))


# -- beta schedules (`gaussian_diffusion.py:18-64`) ---------------------------


def betas_for_alpha_bar(num_steps: int, alpha_bar, max_beta: float = 0.999):
    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_steps, dtype=np.float64
        )
    if name == "cosine":
        return betas_for_alpha_bar(
            num_steps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {name}")


# -- likelihood helpers (`losses.py:13-77`) -----------------------------------


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians, in nats (`losses.py:13-40`); any argument
    may be a Python number."""
    ref = next(a for a in (mean1, logvar1, mean2, logvar2) if isinstance(a, torch.Tensor))
    mean1, logvar1, mean2, logvar2 = (
        a if isinstance(a, torch.Tensor) else torch.tensor(a, dtype=ref.dtype, device=ref.device)
        for a in (mean1, logvar1, mean2, logvar2)
    )
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    return 0.5 * (
        1.0 + torch.tanh(float(np.sqrt(2.0 / np.pi)) * (x + 0.044715 * torch.pow(x, 3)))
    )


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized onto the 255-bucket pixel
    grid (`losses.py:50-77`); x in [-1, 1]."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered_x + 1.0 / 255.0)
    cdf_plus = approx_standard_normal_cdf(plus_in)
    min_in = inv_stdv * (centered_x - 1.0 / 255.0)
    cdf_min = approx_standard_normal_cdf(min_in)
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    return torch.where(
        x < -0.999,
        log_cdf_plus,
        torch.where(
            x > 0.999,
            log_one_minus_cdf_min,
            torch.log(torch.clamp(cdf_delta, min=1e-12)),
        ),
    )


def mean_flat(x):
    return torch.mean(x, dim=tuple(range(1, x.ndim)))


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] broadcast to an ndim tensor (`gaussian_diffusion.py:895-908`)."""
    return arr[t].reshape(t.shape[0], *([1] * (ndim - 1))).float()


def _nonzero(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return (t != 0).float().reshape(-1, *([1] * (ndim - 1)))


def _randn(shape, generator, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)


# -- the process --------------------------------------------------------------

_TABLES = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
    "fixed_large_variance", "log_betas", "timestep_map",
)


class GuidedDiffusion:
    """`GaussianDiffusion` (`gaussian_diffusion.py:101-908`): float32
    coefficient tables on one device and the process's methods.

    mean_type: 'eps' | 'xstart' | 'xprev' (ModelMeanType)
    var_type: 'fixed_small' | 'fixed_large' | 'learned' | 'learned_range'
    loss_type: 'mse' | 'rescaled_mse' | 'kl' | 'rescaled_kl'
    timestep_map: the respacing map from this process's t to the base
    process's t fed to the model (None: the identity)."""

    def __init__(self, tables: Dict[str, Optional[torch.Tensor]], mean_type: str,
                 var_type: str, loss_type: str, rescale_timesteps: bool,
                 original_num_steps: int):
        for name in _TABLES:
            setattr(self, name, tables[name])
        self.mean_type, self.var_type, self.loss_type = mean_type, var_type, loss_type
        self.rescale_timesteps = rescale_timesteps
        self.original_num_steps = original_num_steps

    @classmethod
    def create(
        cls,
        betas: Union[np.ndarray, Sequence[float]],
        mean_type: str = "eps",
        var_type: str = "fixed_small",
        loss_type: str = "mse",
        rescale_timesteps: bool = False,
        timestep_map: Optional[Sequence[int]] = None,
        original_num_steps: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "GuidedDiffusion":
        if mean_type not in ("eps", "xstart", "xprev"):
            raise ValueError(mean_type)
        if var_type not in (
            "fixed_small", "fixed_large", "learned", "learned_range"
        ):
            raise ValueError(var_type)
        if loss_type not in ("mse", "rescaled_mse", "kl", "rescaled_kl"):
            raise ValueError(loss_type)
        dev = resolve_device(device)
        betas = np.asarray(betas, dtype=np.float64)
        if not (betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        post_logvar = np.log(np.append(post_var[1], post_var[1:]))
        fixed_large = np.append(post_var[1], betas[1:])

        def f32(a):
            return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

        tables = dict(
            betas=f32(betas),
            timestep_map=(
                torch.tensor(np.asarray(timestep_map), dtype=torch.int64, device=dev)
                if timestep_map is not None else None
            ),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            alphas_cumprod_next=f32(acp_next),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(post_logvar),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            fixed_large_variance=f32(fixed_large),
            log_betas=f32(np.log(betas)),
        )
        return cls(tables, mean_type, var_type, loss_type, rescale_timesteps,
                   original_num_steps or len(betas))

    def to(self, device: DeviceLike) -> "GuidedDiffusion":
        """The same process with its tables on `device`."""
        dev = resolve_device(device)
        tables = {n: None if getattr(self, n) is None else getattr(self, n).to(dev)
                  for n in _TABLES}
        return GuidedDiffusion(tables, self.mean_type, self.var_type, self.loss_type,
                               self.rescale_timesteps, self.original_num_steps)

    @property
    def device(self) -> torch.device:
        return self.betas.device

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def _model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Timestep actually fed to the model: respacing map then the
        original-paper rescale (`respace.py:117-128`,
        `gaussian_diffusion.py:354-357`)."""
        if self.timestep_map is not None:
            t = self.timestep_map[t]
        if self.rescale_timesteps:
            return t.float() * (1000.0 / self.original_num_steps)
        return t

    # -- q --------------------------------------------------------------

    def q_mean_variance(self, x_start, t):
        nd = x_start.ndim
        mean = _extract(self.sqrt_alphas_cumprod, t, nd) * x_start
        variance = _extract(1.0 - self.alphas_cumprod, t, nd)
        log_variance = _extract(self.log_one_minus_alphas_cumprod, t, nd)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        nd = x_start.ndim
        return (
            _extract(self.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise
        )

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.ndim
        mean = (
            _extract(self.posterior_mean_coef1, t, nd) * x_start
            + _extract(self.posterior_mean_coef2, t, nd) * x_t
        )
        var = _extract(self.posterior_variance, t, nd)
        logvar = _extract(self.posterior_log_variance_clipped, t, nd)
        return mean, var, logvar

    # -- p --------------------------------------------------------------

    def predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps
        )

    def predict_xstart_from_xprev(self, x_t, t, xprev):
        nd = x_t.ndim
        return (
            _extract(1.0 / self.posterior_mean_coef1, t, nd) * xprev
            - _extract(
                self.posterior_mean_coef2 / self.posterior_mean_coef1, t, nd
            ) * x_t
        )

    def predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.ndim
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
        ) / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd)

    def p_mean_variance(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        t: torch.Tensor,
        clip_denoised: bool = True,
        denoised_fn=None,
        model_kwargs: Optional[dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """`gaussian_diffusion.py:232-330`. Learned-variance models emit
        2*C on the TRAILING (channels-last) axis."""
        model_kwargs = model_kwargs or {}
        nd = x.ndim
        c = x.shape[-1]
        model_output = model_fn(x, self._model_t(t), **model_kwargs)

        if self.var_type in ("learned", "learned_range"):
            if tuple(model_output.shape) != tuple(x.shape[:-1]) + (2 * c,):
                raise ValueError(f"model output {tuple(model_output.shape)} is not 2C "
                                 f"on the trailing axis of {tuple(x.shape)}")
            model_output, model_var_values = torch.chunk(model_output, 2, dim=-1)
            if self.var_type == "learned":
                model_log_variance = model_var_values
                model_variance = torch.exp(model_log_variance)
            else:
                min_log = _extract(self.posterior_log_variance_clipped, t, nd)
                max_log = _extract(self.log_betas, t, nd)
                frac = (model_var_values + 1) / 2
                model_log_variance = frac * max_log + (1 - frac) * min_log
                model_variance = torch.exp(model_log_variance)
        else:
            table, log_table = {
                "fixed_large": (
                    self.fixed_large_variance,
                    torch.log(self.fixed_large_variance),
                ),
                "fixed_small": (
                    self.posterior_variance,
                    self.posterior_log_variance_clipped,
                ),
            }[self.var_type]
            model_variance = _extract(table, t, nd).expand(x.shape)
            model_log_variance = _extract(log_table, t, nd).expand(x.shape)

        def process_xstart(xs):
            if denoised_fn is not None:
                xs = denoised_fn(xs)
            if clip_denoised:
                xs = torch.clamp(xs, -1.0, 1.0)
            return xs

        if self.mean_type == "xprev":
            pred_xstart = process_xstart(
                self.predict_xstart_from_xprev(x, t, model_output)
            )
            model_mean = model_output
        else:
            if self.mean_type == "xstart":
                pred_xstart = process_xstart(model_output)
            else:
                pred_xstart = process_xstart(
                    self.predict_xstart_from_eps(x, t, model_output)
                )
            model_mean, _, _ = self.q_posterior_mean_variance(
                pred_xstart, x, t
            )
        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    def condition_mean(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """`cond_fn` gets the model's timestep (after respacing)."""
        gradient = cond_fn(x, self._model_t(t), **(model_kwargs or {}))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        nd = x.ndim
        alpha_bar = _extract(self.alphas_cumprod, t, nd)
        eps = self.predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(
            x, self._model_t(t), **(model_kwargs or {})
        )
        out = dict(p_mean_var)
        out["pred_xstart"] = self.predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(
            out["pred_xstart"], x, t
        )
        return out

    # -- ancestral sampling ----------------------------------------------

    def p_sample(
        self, model_fn, generator, x, t, clip_denoised=True, denoised_fn=None,
        cond_fn=None, model_kwargs=None, noise=None,
    ):
        """One ancestral step; `noise` (else drawn from `generator`)."""
        out = self.p_mean_variance(
            model_fn, x, t, clip_denoised, denoised_fn, model_kwargs
        )
        if cond_fn is not None:
            out["mean"] = self.condition_mean(
                cond_fn, out, x, t, model_kwargs
            )
        if noise is None:
            noise = _randn(x.shape, generator, x.device)
        sample = out["mean"] + _nonzero(t, x.ndim) * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def _loop(self, step, generator, shape, noise):
        img = noise if noise is not None else _randn(shape, generator, self.device)
        for ti in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((shape[0],), ti, dtype=torch.int64, device=img.device)
            img = step(img, t)["sample"]
        return img

    def p_sample_loop(
        self, model_fn, generator, shape, noise=None, clip_denoised=True,
        denoised_fn=None, cond_fn=None, model_kwargs=None,
    ):
        """`p_sample_loop_progressive` (`gaussian_diffusion.py:488-530`):
        one step per entry of the reversed timestep table."""
        return self._loop(
            lambda img, t: self.p_sample(model_fn, generator, img, t, clip_denoised,
                                         denoised_fn, cond_fn, model_kwargs),
            generator, shape, noise)

    # -- DDIM -------------------------------------------------------------

    def ddim_sample(
        self, model_fn, generator, x, t, clip_denoised=True, denoised_fn=None,
        cond_fn=None, model_kwargs=None, eta=0.0, noise=None,
    ):
        """`gaussian_diffusion.py:560-625`."""
        out = self.p_mean_variance(
            model_fn, x, t, clip_denoised, denoised_fn, model_kwargs
        )
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs)
        nd = x.ndim
        eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = _extract(self.alphas_cumprod, t, nd)
        alpha_bar_prev = _extract(self.alphas_cumprod_prev, t, nd)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        if noise is None:
            noise = _randn(x.shape, generator, x.device)
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
            + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps
        )
        sample = mean_pred + _nonzero(t, nd) * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(
        self, model_fn, generator, shape, noise=None, clip_denoised=True,
        denoised_fn=None, cond_fn=None, model_kwargs=None, eta=0.0,
    ):
        return self._loop(
            lambda img, t: self.ddim_sample(model_fn, generator, img, t, clip_denoised,
                                            denoised_fn, cond_fn, model_kwargs, eta),
            generator, shape, noise)

    # -- VLB --------------------------------------------------------------

    def vb_terms_bpd(
        self, model_fn, x_start, x_t, t, clip_denoised=True, model_kwargs=None
    ):
        """KL(q(x_{t-1}|x_t,x_0) || p(x_{t-1}|x_t)) in bits, decoder NLL at
        t=0 (`_vb_terms_bpd` `gaussian_diffusion.py:709-741`)."""
        true_mean, _, true_logvar = self.q_posterior_mean_variance(
            x_start, x_t, t
        )
        out = self.p_mean_variance(
            model_fn, x_t, t, clip_denoised, None, model_kwargs
        )
        kl = normal_kl(true_mean, true_logvar, out["mean"], out["log_variance"])
        kl = mean_flat(kl) / _LOG2
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
        )
        decoder_nll = mean_flat(decoder_nll) / _LOG2
        output = torch.where(t == 0, decoder_nll, kl)
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def training_losses(
        self, model_fn, generator, x_start, t, model_kwargs=None, noise=None
    ) -> Dict[str, torch.Tensor]:
        """`gaussian_diffusion.py:743-808`, with the LEARNED_RANGE frozen-
        mean vb term (the mean half detached)."""
        model_kwargs = model_kwargs or {}
        if noise is None:
            noise = _randn(x_start.shape, generator, x_start.device)
        x_t = self.q_sample(x_start, t, noise)
        terms: Dict[str, torch.Tensor] = {}

        if self.loss_type in ("kl", "rescaled_kl"):
            terms["loss"] = self.vb_terms_bpd(
                model_fn, x_start, x_t, t, clip_denoised=False,
                model_kwargs=model_kwargs,
            )["output"]
            if self.loss_type == "rescaled_kl":
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = model_fn(x_t, self._model_t(t), **model_kwargs)
        if self.var_type in ("learned", "learned_range"):
            c = x_t.shape[-1]
            if tuple(model_output.shape) != tuple(x_t.shape[:-1]) + (2 * c,):
                raise ValueError(f"model output {tuple(model_output.shape)} is not 2C "
                                 f"on the trailing axis of {tuple(x_t.shape)}")
            model_output, model_var_values = torch.chunk(model_output, 2, dim=-1)
            frozen_out = torch.cat([model_output.detach(), model_var_values], dim=-1)
            terms["vb"] = self.vb_terms_bpd(
                lambda *args, **kw: frozen_out,
                x_start, x_t, t, clip_denoised=False,
            )["output"]
            if self.loss_type == "rescaled_mse":
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

        if self.mean_type == "xprev":
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.mean_type == "xstart":
            target = x_start
        else:
            target = noise
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = (
            terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        )
        return terms

    def prior_bpd(self, x_start):
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.int64,
                       device=x_start.device)
        qt_mean, _, qt_logvar = self.q_mean_variance(x_start, t)
        kl = normal_kl(qt_mean, qt_logvar, 0.0, 0.0)
        return mean_flat(kl) / _LOG2

    def calc_bpd_loop(
        self, model_fn, generator, x_start, clip_denoised=True, model_kwargs=None
    ):
        """Full VLB sweep (`gaussian_diffusion.py:828-877`): the terms are
        (B, T) in reversed-t order, as the reference stacks them."""
        b = x_start.shape[0]
        vb, xstart_mse, mse = [], [], []
        for ti in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((b,), ti, dtype=torch.int64, device=x_start.device)
            noise = _randn(x_start.shape, generator, x_start.device)
            x_t = self.q_sample(x_start, t, noise)
            out = self.vb_terms_bpd(
                model_fn, x_start, x_t, t, clip_denoised, model_kwargs
            )
            eps = self.predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((eps - noise) ** 2))
        vb = torch.stack(vb, dim=1)
        prior = self.prior_bpd(x_start)
        return {
            "total_bpd": vb.sum(dim=1) + prior,
            "prior_bpd": prior,
            "vb": vb,
            "xstart_mse": torch.stack(xstart_mse, dim=1),
            "mse": torch.stack(mse, dim=1),
        }


# -- respacing (`respace.py:7-128`) -------------------------------------------


def space_timesteps(num_timesteps: int, section_counts) -> Set[int]:
    """`respace.py:7-61`, incl. the "ddimN" fixed-stride special case."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an "
                "integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}"
            )
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken = []
        for _ in range(section_count):
            taken.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken
        start_idx += size
    return set(all_steps)


def spaced_diffusion(
    use_timesteps,
    betas,
    mean_type: str = "eps",
    var_type: str = "fixed_small",
    loss_type: str = "mse",
    rescale_timesteps: bool = False,
    device: DeviceLike = None,
) -> GuidedDiffusion:
    """`SpacedDiffusion` (`respace.py:64-111`): re-derive betas over the
    retained timesteps; the returned process feeds the model ORIGINAL
    timesteps via its timestep_map."""
    use_timesteps = set(int(t) for t in use_timesteps)
    betas = np.asarray(betas, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - betas)
    last_alpha_cumprod = 1.0
    new_betas = []
    timestep_map = []
    for i, acp in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - acp / last_alpha_cumprod)
            last_alpha_cumprod = acp
            timestep_map.append(i)
    return GuidedDiffusion.create(
        np.array(new_betas),
        mean_type=mean_type,
        var_type=var_type,
        loss_type=loss_type,
        rescale_timesteps=rescale_timesteps,
        timestep_map=timestep_map,
        original_num_steps=len(betas),
        device=device,
    )
