"""InceptionV3 (pool3, 2048-d) feature trunk for Inception-calibrated FID.

Counterpart of `v2a_tpu/ops/inception.py`. A torchvision-format
`inception_v3` state dict from an offline file has every BatchNorm folded
into its conv (`convert_inception_state_dict`, float64, inference only);
the folded params tree ({name: {kernel HWIO, bias}}, the `fc` head
optional) is the JAX package's, so `.npz` files written by either package
load in the other. `InceptionV3` runs it as conv + bias + ReLU in NCHW
(cuDNN on the card, where the JAX package has `lax.conv`: no Pallas kernel
is involved); `inception_features(path)` yields a `features_fn(images01) ->
(N, 2048)` for `ops/fid.py::fid`.

Preprocessing follows the pytorch-fid convention: NHWC images in [0, 1],
bilinear-resized to 299x299 (anti-aliased when shrinking, as
`jax.image.resize`: `ops/resize.py`), scaled to [-1, 1].

The spec below (`ConvSpec`, the five block builders, `STEM`, `BLOCKS`) is
copied from the JAX module (:31-146): the converter, the module and the
synthetic-weight generator all walk it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2a_tpu_torch.device import DeviceLike, resolve_device
from v2a_tpu_torch.ops.resize import resize_bilinear

BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm2d(eps=0.001)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str          # torchvision module path, e.g. "Mixed_5b.branch1x1"
    cin: int
    cout: int
    khw: Tuple[int, int]
    stride: int = 1
    pad: Tuple[int, int] = (0, 0)  # symmetric (ph, pw)


def _conv(name, cin, cout, k, stride=1, pad=0):
    kh, kw = (k, k) if isinstance(k, int) else k
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    return ConvSpec(name, cin, cout, (kh, kw), stride, (ph, pw))


def _inception_a(p: str, cin: int, pool: int) -> List[ConvSpec]:
    return [
        _conv(f"{p}.branch1x1", cin, 64, 1),
        _conv(f"{p}.branch5x5_1", cin, 48, 1),
        _conv(f"{p}.branch5x5_2", 48, 64, 5, pad=2),
        _conv(f"{p}.branch3x3dbl_1", cin, 64, 1),
        _conv(f"{p}.branch3x3dbl_2", 64, 96, 3, pad=1),
        _conv(f"{p}.branch3x3dbl_3", 96, 96, 3, pad=1),
        _conv(f"{p}.branch_pool", cin, pool, 1),
    ]


def _inception_b(p: str, cin: int) -> List[ConvSpec]:
    return [
        _conv(f"{p}.branch3x3", cin, 384, 3, stride=2),
        _conv(f"{p}.branch3x3dbl_1", cin, 64, 1),
        _conv(f"{p}.branch3x3dbl_2", 64, 96, 3, pad=1),
        _conv(f"{p}.branch3x3dbl_3", 96, 96, 3, stride=2),
    ]


def _inception_c(p: str, cin: int, c7: int) -> List[ConvSpec]:
    return [
        _conv(f"{p}.branch1x1", cin, 192, 1),
        _conv(f"{p}.branch7x7_1", cin, c7, 1),
        _conv(f"{p}.branch7x7_2", c7, c7, (1, 7), pad=(0, 3)),
        _conv(f"{p}.branch7x7_3", c7, 192, (7, 1), pad=(3, 0)),
        _conv(f"{p}.branch7x7dbl_1", cin, c7, 1),
        _conv(f"{p}.branch7x7dbl_2", c7, c7, (7, 1), pad=(3, 0)),
        _conv(f"{p}.branch7x7dbl_3", c7, c7, (1, 7), pad=(0, 3)),
        _conv(f"{p}.branch7x7dbl_4", c7, c7, (7, 1), pad=(3, 0)),
        _conv(f"{p}.branch7x7dbl_5", c7, 192, (1, 7), pad=(0, 3)),
        _conv(f"{p}.branch_pool", cin, 192, 1),
    ]


def _inception_d(p: str, cin: int) -> List[ConvSpec]:
    return [
        _conv(f"{p}.branch3x3_1", cin, 192, 1),
        _conv(f"{p}.branch3x3_2", 192, 320, 3, stride=2),
        _conv(f"{p}.branch7x7x3_1", cin, 192, 1),
        _conv(f"{p}.branch7x7x3_2", 192, 192, (1, 7), pad=(0, 3)),
        _conv(f"{p}.branch7x7x3_3", 192, 192, (7, 1), pad=(3, 0)),
        _conv(f"{p}.branch7x7x3_4", 192, 192, 3, stride=2),
    ]


def _inception_e(p: str, cin: int) -> List[ConvSpec]:
    return [
        _conv(f"{p}.branch1x1", cin, 320, 1),
        _conv(f"{p}.branch3x3_1", cin, 384, 1),
        _conv(f"{p}.branch3x3_2a", 384, 384, (1, 3), pad=(0, 1)),
        _conv(f"{p}.branch3x3_2b", 384, 384, (3, 1), pad=(1, 0)),
        _conv(f"{p}.branch3x3dbl_1", cin, 448, 1),
        _conv(f"{p}.branch3x3dbl_2", 448, 384, 3, pad=1),
        _conv(f"{p}.branch3x3dbl_3a", 384, 384, (1, 3), pad=(0, 1)),
        _conv(f"{p}.branch3x3dbl_3b", 384, 384, (3, 1), pad=(1, 0)),
        _conv(f"{p}.branch_pool", cin, 192, 1),
    ]


STEM: List[ConvSpec] = [
    _conv("Conv2d_1a_3x3", 3, 32, 3, stride=2),
    _conv("Conv2d_2a_3x3", 32, 32, 3),
    _conv("Conv2d_2b_3x3", 32, 64, 3, pad=1),
    _conv("Conv2d_3b_1x1", 64, 80, 1),
    _conv("Conv2d_4a_3x3", 80, 192, 3),
]

# (block builder, prefix, in-channels, extra arg, out channels)
BLOCKS = [
    (_inception_a, "Mixed_5b", 192, 32, 256),
    (_inception_a, "Mixed_5c", 256, 64, 288),
    (_inception_a, "Mixed_5d", 288, 64, 288),
    (_inception_b, "Mixed_6a", 288, None, 768),
    (_inception_c, "Mixed_6b", 768, 128, 768),
    (_inception_c, "Mixed_6c", 768, 160, 768),
    (_inception_c, "Mixed_6d", 768, 160, 768),
    (_inception_c, "Mixed_6e", 768, 192, 768),
    (_inception_d, "Mixed_7a", 768, None, 1280),
    (_inception_e, "Mixed_7b", 1280, None, 2048),
    (_inception_e, "Mixed_7c", 2048, None, 2048),
]

FEATURE_DIM = 2048


def all_conv_specs() -> List[ConvSpec]:
    specs = list(STEM)
    for builder, prefix, cin, extra, _cout in BLOCKS:
        specs += builder(prefix, cin) if extra is None else builder(prefix, cin, extra)
    return specs


# -- weight conversion ------------------------------------------------------------


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def fold_bn(conv_w, gamma, beta, mean, var, eps=BN_EPS):
    """Fold an inference BatchNorm into the preceding conv: returns
    (kernel_hwio, bias) float32, folded in float64. conv_w is torch OIHW."""
    conv_w = np.asarray(conv_w, np.float64)
    scale = np.asarray(gamma, np.float64) / np.sqrt(np.asarray(var, np.float64) + eps)
    w = conv_w * scale[:, None, None, None]
    b = np.asarray(beta, np.float64) - np.asarray(mean, np.float64) * scale
    return (np.ascontiguousarray(w.transpose(2, 3, 1, 0)).astype(np.float32),
            b.astype(np.float32))


def convert_inception_state_dict(sd: Dict) -> Dict:
    """torchvision `inception_v3` state dict (tensors or numpy arrays) ->
    {name: {kernel, bias}} with every BasicConv2d's BatchNorm folded in, and
    the `fc` head ({kernel (2048, n_classes), bias}) where the file has one
    (Inception Score needs it); AuxLogits is ignored."""
    def get(k):
        if k not in sd:
            raise KeyError(f"inception state dict missing {k!r}")
        return _numpy(sd[k])

    params = {}
    for spec in all_conv_specs():
        p = spec.name
        kernel, bias = fold_bn(get(f"{p}.conv.weight"), get(f"{p}.bn.weight"),
                               get(f"{p}.bn.bias"), get(f"{p}.bn.running_mean"),
                               get(f"{p}.bn.running_var"))
        want = (*spec.khw, spec.cin, spec.cout)
        if kernel.shape != want:
            raise ValueError(f"{p}: converted kernel shape {kernel.shape} != {want}")
        params[p] = {"kernel": kernel, "bias": bias}
    if "fc.weight" in sd:
        params["fc"] = {"kernel": np.ascontiguousarray(get("fc.weight").T).astype(np.float32),
                        "bias": get("fc.bias").astype(np.float32)}
    return params


def inception_logits(params: Dict, pooled: np.ndarray) -> np.ndarray:
    """Classifier logits from pool3 features (the file must carry the fc
    head)."""
    if "fc" not in params:
        raise KeyError("checkpoint has no fc head; Inception Score needs it")
    return np.asarray(pooled) @ params["fc"]["kernel"] + params["fc"]["bias"]


def load_inception_params(path: str) -> Dict:
    """A torchvision inception_v3 state dict saved with `torch.save`
    (.pt/.pth, loaded with `weights_only=True`), converted; or a converted
    `np.savez` archive (`name/leaf` keys, either package's)."""
    if path.endswith(".npz"):
        params = {}
        with np.load(path) as flat:
            for key in flat.files:
                name, leaf = key.rsplit("/", 1)
                params.setdefault(name, {})[leaf] = flat[key]
        return params
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_inception_state_dict(sd)


def save_inception_params(params: Dict, path: str):
    np.savez(path, **{f"{name}/{leaf}": arr
                      for name, leaves in params.items() for leaf, arr in leaves.items()})


# -- the network --------------------------------------------------------------------


class _FoldedConv(nn.Module):
    """A BasicConv2d with its BatchNorm folded: conv + bias + ReLU."""

    def __init__(self, spec: ConvSpec):
        super().__init__()
        self.stride, self.pad = spec.stride, spec.pad
        self.weight = nn.Parameter(torch.zeros(spec.cout, spec.cin, *spec.khw))
        self.bias = nn.Parameter(torch.zeros(spec.cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(F.conv2d(x, self.weight, self.bias, self.stride, self.pad))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)  # 3x3 stride 2, VALID (:252)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    # AvgPool2d(3, stride=1, padding=1), count_include_pad: the sum over 9 (:261)
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class InceptionV3(nn.Module):
    """The folded torchvision `inception_v3` graph: stem, Mixed_5b..7c,
    global average pool; NCHW inside. Its state dict is
    `convert/from_jax.py::inception_from_jax` of a params tree (keys
    `<torchvision module path>.weight / .bias`, `fc.weight / .bias` with
    `num_classes`)."""

    def __init__(self, num_classes: int = 0):
        super().__init__()
        specs = all_conv_specs()
        for spec in specs:
            parent = self
            *path, leaf = spec.name.split(".")
            for part in path:
                if not hasattr(parent, part):
                    parent.add_module(part, nn.Module())
                parent = getattr(parent, part)
            parent.add_module(leaf, _FoldedConv(spec))
        self._convs = {spec.name: self.get_submodule(spec.name) for spec in specs}
        if num_classes:
            self.fc = nn.Linear(FEATURE_DIM, num_classes)

    def _c(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self._convs[name](x)

    def forward(self, x: torch.Tensor, return_spatial: bool = False):
        """x (N, 3, 299, 299) in [-1, 1] -> pooled (N, 2048) [, the Mixed_6e
        output (N, 768, 17, 17)]."""
        c = self._c
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = c(name, x)
        x = _max_pool(x)
        x = c("Conv2d_4a_3x3", c("Conv2d_3b_1x1", x))
        x = _max_pool(x)
        mixed_6e = None
        for builder, p, _cin, _extra, _cout in BLOCKS:
            if builder is _inception_a:
                parts = [c(f"{p}.branch1x1", x),
                         c(f"{p}.branch5x5_2", c(f"{p}.branch5x5_1", x)),
                         c(f"{p}.branch3x3dbl_3",
                           c(f"{p}.branch3x3dbl_2", c(f"{p}.branch3x3dbl_1", x))),
                         c(f"{p}.branch_pool", _avg_pool(x))]
            elif builder is _inception_b:
                parts = [c(f"{p}.branch3x3", x),
                         c(f"{p}.branch3x3dbl_3",
                           c(f"{p}.branch3x3dbl_2", c(f"{p}.branch3x3dbl_1", x))),
                         _max_pool(x)]
            elif builder is _inception_c:
                b77 = c(f"{p}.branch7x7_3", c(f"{p}.branch7x7_2", c(f"{p}.branch7x7_1", x)))
                d = c(f"{p}.branch7x7dbl_1", x)
                for i in (2, 3, 4, 5):
                    d = c(f"{p}.branch7x7dbl_{i}", d)
                parts = [c(f"{p}.branch1x1", x), b77, d, c(f"{p}.branch_pool", _avg_pool(x))]
            elif builder is _inception_d:
                b33 = c(f"{p}.branch3x3_2", c(f"{p}.branch3x3_1", x))
                b773 = c(f"{p}.branch7x7x3_1", x)
                for i in (2, 3, 4):
                    b773 = c(f"{p}.branch7x7x3_{i}", b773)
                parts = [b33, b773, _max_pool(x)]
            else:  # InceptionE
                b3 = c(f"{p}.branch3x3_1", x)
                bd = c(f"{p}.branch3x3dbl_2", c(f"{p}.branch3x3dbl_1", x))
                parts = [c(f"{p}.branch1x1", x),
                         c(f"{p}.branch3x3_2a", b3), c(f"{p}.branch3x3_2b", b3),
                         c(f"{p}.branch3x3dbl_3a", bd), c(f"{p}.branch3x3dbl_3b", bd),
                         c(f"{p}.branch_pool", _avg_pool(x))]
            x = torch.cat(parts, dim=1)
            if p == "Mixed_6e":
                mixed_6e = x
        pooled = x.mean(dim=(2, 3))
        return (pooled, mixed_6e) if return_spatial else pooled


def inception_model(params: Dict, device: DeviceLike = None) -> InceptionV3:
    """An `InceptionV3` holding a params tree (`load_inception_params`), in
    eval mode without gradients, on `device` (the card unless "cpu")."""
    from v2a_tpu_torch.convert.from_jax import inception_from_jax

    n_classes = params["fc"]["kernel"].shape[1] if "fc" in params else 0
    model = InceptionV3(n_classes)
    model.load_state_dict(inception_from_jax(params), strict=True)
    return model.to(resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def inception_forward(model: InceptionV3, images01, return_spatial: bool = False):
    """NHWC float images in [0, 1] (any H, W; numpy or a tensor) -> (N, 2048)
    pool3 features on the model's device, float32.

    `return_spatial=True` also returns the reference evaluator's sFID
    features (`evaluator.py:590-600`: the first 7 channels of the Mixed_6e
    output), flattened in NHWC order as the JAX package flattens them
    (:355-356): (N, 17*17*7)."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(images01) if not torch.is_tensor(images01) else images01,
                        device=dev).float()
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected NHWC rgb images, got {tuple(x.shape)}")
    if tuple(x.shape[1:3]) != (299, 299):
        x = resize_bilinear(x, (299, 299))
    x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)  # pytorch-fid input convention
    if not return_spatial:
        return model(x)
    pooled, mixed = model(x, return_spatial=True)
    return pooled, mixed.permute(0, 2, 3, 1)[..., :7].reshape(mixed.shape[0], -1)


def inception_features(path: str, device: DeviceLike = None):
    """`features_fn(images01) -> (N, 2048)` numpy from an offline weights
    file, for `ops/fid.py::fid(..., features_fn=...)`."""
    model = inception_model(load_inception_params(path), device)

    def features_fn(images01) -> np.ndarray:
        return inception_forward(model, images01).cpu().numpy()

    return features_fn


# -- synthetic weights (tests / smoke) ------------------------------------------------


def synthetic_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random torchvision-format inception_v3 state dict (the right keys and
    shapes) for the converter and forward without the real weights; the
    JAX package's generator (`v2a_tpu/ops/inception.py:383`), so one seed
    gives both packages the same arrays."""
    rs = np.random.RandomState(seed)
    sd = {}
    for spec in all_conv_specs():
        o, i = spec.cout, spec.cin
        kh, kw = spec.khw
        fan_in = i * kh * kw
        sd[f"{spec.name}.conv.weight"] = (rs.randn(o, i, kh, kw) * np.sqrt(2.0 / fan_in)
                                          ).astype(np.float32)
        sd[f"{spec.name}.bn.weight"] = rs.uniform(0.5, 1.5, o).astype(np.float32)
        sd[f"{spec.name}.bn.bias"] = (rs.randn(o) * 0.1).astype(np.float32)
        sd[f"{spec.name}.bn.running_mean"] = (rs.randn(o) * 0.1).astype(np.float32)
        sd[f"{spec.name}.bn.running_var"] = rs.uniform(0.5, 1.5, o).astype(np.float32)
    return sd
