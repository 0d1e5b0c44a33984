"""Fréchet distance (FID-style) sample-quality metrics.

Counterpart of `v2a_tpu/ops/fid.py` (the reference evaluator's FID / sFID /
IS / precision / recall, `guided_diffusion/evaluations/evaluator.py`). The
metrics are numpy in float64, copied from the JAX package line for line
(:20-115), so both packages give the same number for the same features.
They take any `features_fn(images01) -> (N, D)`: the Inception trunk of
`ops/inception.py`, or the random conv trunk below when no Inception
weights are at hand.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from v2a_tpu_torch.device import DeviceLike, resolve_device


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    """FID = |mu1-mu2|^2 + Tr(s1 + s2 - 2 (s1 s2)^(1/2)); the cross term as
    sqrtm(s1^(1/2) s2 s1^(1/2)), so only PSD square roots are needed."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    cross = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * cross))


def fid(real_images01: np.ndarray, fake_images01: np.ndarray,
        features_fn: Callable[[np.ndarray], np.ndarray], batch: int = 64) -> float:
    def extract(imgs):
        outs = []
        for i in range(0, len(imgs), batch):
            outs.append(np.asarray(features_fn(imgs[i : i + batch])))
        return np.concatenate(outs)

    mu1, s1 = feature_stats(extract(real_images01))
    mu2, s2 = feature_stats(extract(fake_images01))
    return frechet_distance(mu1, s1, mu2, s2)


def inception_score(logits: np.ndarray, splits: int = 10,
                    eps: float = 1e-12) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over classifier logits."""
    logits = np.asarray(logits, np.float64)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    scores = []
    for part in np.array_split(probs, splits):
        marginal = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + eps) - np.log(marginal + eps))).sum(axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def pairwise_sq_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared L2 distances, the reference `DistanceBlock` semantics
    (`evaluator.py:330-360`)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = (a * a).sum(1)[:, None] - 2.0 * a @ b.T + (b * b).sum(1)[None, :]
    return np.maximum(d, 0.0)


def manifold_radii(feats: np.ndarray, nhood_size: int = 3) -> np.ndarray:
    """Each point's squared distance to its k-th nearest neighbour
    (`evaluator.py:249-281`; the point itself is rank 0)."""
    d = pairwise_sq_distances(feats, feats)
    part = np.partition(d, nhood_size, axis=1)
    return part[:, nhood_size]


def precision_recall(ref_feats: np.ndarray, sample_feats: np.ndarray,
                     nhood_size: int = 3) -> Tuple[float, float]:
    """Improved precision / recall (`evaluator.py:194-202,326-345`): the
    share of samples inside some reference hypersphere, and of references
    inside some sample hypersphere."""
    radii_ref = manifold_radii(ref_feats, nhood_size)
    radii_sample = manifold_radii(sample_feats, nhood_size)
    d = pairwise_sq_distances(sample_feats, ref_feats)
    precision = float(np.mean(np.any(d <= radii_ref[None, :], axis=1)))
    recall = float(np.mean(np.any(d.T <= radii_sample[None, :], axis=1)))
    return precision, recall


# -- the random conv trunk ------------------------------------------------------


def random_conv_params(seed: int = 0, widths: Sequence[int] = (64, 128, 256, 512),
                       feature_dim: int = 768) -> Tuple[List[np.ndarray], np.ndarray]:
    """He-init weights of the trunk's shapes and scales (kernels HWIO
    (3, 3, C_in, C_out) with std sqrt(2 / (9 C_in)); the head (C, D) with
    std sqrt(1 / C)), float32, from numpy's generator seeded by `seed`.

    The JAX package draws the same shapes and scales from `jax.random`
    (`v2a_tpu/ops/fid.py:139-152`), which the port cannot run: for one seed
    the two packages' trunks differ, and so do their FID numbers. Both are
    relative numbers only (`inception_calibrated: false`). Arrays drawn the
    JAX way can be handed to `random_conv_features(params=...)`."""
    rng = np.random.default_rng(seed)
    kernels, cin = [], 3
    for w in widths:
        kernels.append((rng.standard_normal((3, 3, cin, w)) * np.sqrt(2.0 / (9 * cin)))
                       .astype(np.float32))
        cin = w
    head = (rng.standard_normal((cin, feature_dim)) * np.sqrt(1.0 / cin)).astype(np.float32)
    return kernels, head


def _same_pad(n: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis: (0, 1) at stride 2 on an even side,
    (1, 1) on an odd one (`padding=1` would be wrong on even sides)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def random_conv_features(seed: int = 0, widths: Sequence[int] = (64, 128, 256, 512),
                         feature_dim: int = 768, dtype: Optional[torch.dtype] = None,
                         params: Optional[Tuple[Sequence[np.ndarray], np.ndarray]] = None,
                         device: DeviceLike = None):
    """Fixed-seed random conv feature extractor (the JAX package's
    `random_conv_features`, :118-172): four stride-2 3x3 "SAME" convs with
    ReLU, a mean over H and W, a linear head. Random conv features give a
    reproducible Fréchet metric for *relative* comparisons of image
    distributions; the numbers are not ImageNet-Inception FIDs, and the
    port's weights (`random_conv_params`, numpy's generator) are not the
    JAX package's, so its numbers differ from the JAX package's for the
    same seed. `params` = (kernels HWIO, head) replaces the drawn weights.

    Returns `features_fn(images01_nhwc_uint8_or_float) -> (N, feature_dim)`
    numpy float32, computed on `device` (the card unless `device="cpu"`)."""
    dev = resolve_device(device)
    dtype = dtype or torch.float32
    kernels, head = params if params is not None else random_conv_params(seed, widths,
                                                                         feature_dim)
    weights = [torch.as_tensor(np.asarray(k, np.float32), device=dev).permute(3, 2, 0, 1)
               .to(dtype) for k in kernels]  # HWIO -> OIHW
    head_t = torch.as_tensor(np.asarray(head, np.float32), device=dev).to(dtype)

    @torch.no_grad()
    def features_fn(images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images), device=dev)
        if x.dtype == torch.uint8:
            x = x.to(dtype) / 255.0
        x = (x.to(dtype) * 2.0 - 1.0).permute(0, 3, 1, 2)
        for w in weights:
            ph, pw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.relu(F.conv2d(F.pad(x, (*pw, *ph)), w, stride=2))
        return (x.mean(dim=(2, 3)) @ head_t).float().cpu().numpy()

    return features_fn
