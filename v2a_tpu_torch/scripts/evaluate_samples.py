"""Sample-quality evaluator CLI: Inception Score, FID, sFID, precision and
recall of a sample batch against a reference batch.

    python -m v2a_tpu_torch.scripts.evaluate_samples ref_batch.npz sample_batch.npz \\
        [--inception inception_v3.pt|.npz] [--nhood 3] [--batch 64] [--device cpu]

Counterpart of `scripts/evaluate_samples.py` (the reference evaluator's
`main()`, `guided_diffusion/evaluations/evaluator.py`): the same
arguments plus `--device` (the card unless `--device cpu`; without a card
it raises), and one JSON line with the same keys in the same order.
Batches are npz files with the images under `arr_0` (N, H, W, 3), uint8
or float in [0, 1]: what the guided samplers write
(`scripts/guided/image_sample.py`). With `--inception` (an offline
torchvision `inception_v3` state dict, or a converted `.npz`) FID / sFID /
IS are Inception-calibrated; without it the random conv trunk
(`ops/fid.py::random_conv_features`) gives relative numbers only (its
weights are the port's own draw, not the JAX package's) and IS is null.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from v2a_tpu_torch.device import resolve_device
from v2a_tpu_torch.ops import fid as fid_mod


def load_batch(path: str) -> np.ndarray:
    with np.load(path) as z:
        arr = z["arr_0"] if "arr_0" in z.files else z[z.files[0]]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"{path}: expected (N, H, W, 3), got {arr.shape}")
    return arr


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("ref_batch")
    ap.add_argument("sample_batch")
    ap.add_argument("--inception", default=None,
                    help="offline inception_v3 weights (.pt/.pth/.npz)")
    ap.add_argument("--nhood", type=int, default=3,
                    help="precision/recall neighborhood size (ref default)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ref = load_batch(args.ref_batch)
    sample = load_batch(args.sample_batch)

    if args.inception:
        from v2a_tpu_torch.ops.inception import (
            inception_forward, inception_logits, inception_model, load_inception_params,
        )

        params = load_inception_params(args.inception)
        model = inception_model(params, device)

        def extract(imgs):
            pooled, spatial = [], []
            for i in range(0, len(imgs), args.batch):
                p, s = inception_forward(model, imgs[i:i + args.batch], return_spatial=True)
                pooled.append(p.cpu().numpy())
                spatial.append(s.cpu().numpy())
            return np.concatenate(pooled), np.concatenate(spatial)

        ref_pool, ref_sp = extract(ref)
        s_pool, s_sp = extract(sample)
        is_mean = is_std = None
        if "fc" in params:
            is_mean, is_std = fid_mod.inception_score(inception_logits(params, s_pool))
            # keep the JSON valid if degenerate features overflow the
            # classifier head (synthetic weights can; real ones do not)
            if not (np.isfinite(is_mean) and np.isfinite(is_std)):
                is_mean = is_std = None
        calibrated = True
    else:
        features_fn = fid_mod.random_conv_features(device=device)

        def extract_pool(imgs):
            return np.concatenate([features_fn(imgs[i:i + args.batch])
                                   for i in range(0, len(imgs), args.batch)])

        ref_pool, s_pool = extract_pool(ref), extract_pool(sample)
        ref_sp = s_sp = None
        is_mean = is_std = None
        calibrated = False

    fid_v = fid_mod.frechet_distance(*fid_mod.feature_stats(ref_pool),
                                     *fid_mod.feature_stats(s_pool))
    sfid_v = None
    if ref_sp is not None:
        sfid_v = fid_mod.frechet_distance(*fid_mod.feature_stats(ref_sp),
                                          *fid_mod.feature_stats(s_sp))
    precision, recall = fid_mod.precision_recall(ref_pool, s_pool, nhood_size=args.nhood)

    # the reference evaluator's metric names, in its order
    result = {
        "inception_score": is_mean,
        "inception_score_std": is_std,
        "fid": round(float(fid_v), 6),
        "sfid": round(float(sfid_v), 6) if sfid_v is not None else None,
        "precision": round(precision, 6),
        "recall": round(recall, 6),
        "inception_calibrated": calibrated,
        "n_ref": len(ref), "n_sample": len(sample),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
