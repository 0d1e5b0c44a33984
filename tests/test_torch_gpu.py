"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and the wrappers' refusal of what the kernels do not take.

Marked `gpu`; each test decides inside a fixture whether there is a card
and skips without one. This file imports no JAX, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from v2a_tpu_torch.ops import resblock_kernels as rk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within_ulp(got, want, dtype):
    """bf16: both sides sum the same rounded products in float32 in another
    order, so the final rounding may differ by one unit in the last place.
    float32: the sums differ only in order."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.bfloat16:
        tol = want.abs() * 2.0 ** -7 + 1e-3 * want.std()
    else:
        tol = want.abs() * 1e-5 + 1e-5 * want.std()
    return bool((err <= tol).all()), float(err.max() / want.std())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["plain", "affine", "silu"])
@pytest.mark.parametrize("n,h,w,c,d", [(3, 8, 8, 128, 128), (2, 32, 32, 256, 128),
                                       (2, 5, 7, 32, 64)])
def test_affine_conv3x3_kernel_matches_plain(cuda, dtype, mode, n, h, w, c, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, h, w, c, generator=g, device=cuda).to(dtype)
    k = torch.randn(3, 3, c, d, generator=g, device=cuda) / (9 * c) ** 0.5
    bias = torch.randn(d, generator=g, device=cuda) * 0.1
    a = b = None
    if mode != "plain":
        a = 1 + 0.1 * torch.randn(n, c, generator=g, device=cuda)
        b = 0.1 * torch.randn(n, c, generator=g, device=cuda)
    before = rk.launches["fused_affine_conv3x3"]
    got = rk.fused_affine_conv3x3(x, k, bias, a, b, silu=mode == "silu")
    torch.cuda.synchronize()
    assert rk.launches["fused_affine_conv3x3"] == before + 1
    want = rk.fused_affine_conv3x3_plain(x, k, bias, a, b, silu=mode == "silu")
    ok, rel = _within_ulp(got, want, dtype)
    assert ok, f"max err / std {rel}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extras", [(False, False, False), (True, True, True),
                                    (False, True, True), (True, False, False)])
@pytest.mark.parametrize("b,f,s,c", [(2, 7, 64, 128), (1, 3, 1000, 256), (2, 2, 16, 64)])
def test_temporal_conv_kernel_matches_plain(cuda, dtype, extras, b, f, s, c):
    has_emb, has_res, stats = extras
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(b, f, s, c, generator=g, device=cuda).to(dtype)
    k = torch.randn(3, c, c, generator=g, device=cuda) / (3 * c) ** 0.5
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    emb = torch.randn(b, c, generator=g, device=cuda).to(dtype) if has_emb else None
    res = torch.randn(b, f, s, c, generator=g, device=cuda).to(dtype) if has_res else None
    got = rk.temporal_conv_fused(x, k, bias, emb, res, want_stats=stats)
    want = rk.temporal_conv_fused_plain(x, k, bias, emb, res, want_stats=stats)
    torch.cuda.synchronize()
    if stats:
        (got, gst), (want, wst) = got, want
        for i in range(2):  # sum, sum of squares: relative to their scale
            scale = wst[:, :, i].abs().max()
            assert float((gst[:, :, i] - wst[:, :, i]).abs().max() / scale) < 1e-3
    ok, rel = _within_ulp(got, want, dtype)
    assert ok, f"max err / std {rel}"


def test_stats_are_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 4, 4096, 128, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(3, 128, 128, generator=g, device=cuda) / 20
    bias = torch.zeros(128, device=cuda)
    _, s1 = rk.temporal_conv_fused(x, k, bias, want_stats=True)
    _, s2 = rk.temporal_conv_fused(x, k, bias, want_stats=True)
    assert torch.equal(s1, s2)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 4, 4, 48, device=cuda)
    with pytest.raises(ValueError):  # C % 32
        rk.fused_affine_conv3x3(x, torch.zeros(3, 3, 48, 64, device=cuda),
                                torch.zeros(64, device=cuda))
    x = torch.zeros(1, 4, 4, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):  # not contiguous
        rk.fused_affine_conv3x3(x, torch.zeros(3, 3, 64, 64, device=cuda),
                                torch.zeros(64, device=cuda))
    with pytest.raises(TypeError):
        rk.temporal_conv_fused(torch.zeros(1, 2, 4, 64, device=cuda, dtype=torch.float16),
                               torch.zeros(3, 64, 64, device=cuda), torch.zeros(64, device=cuda))


def test_plain_versions_agree_with_numpy(cuda):
    """Anchors the plain versions themselves on the card (TF32 off)."""
    rs = np.random.RandomState(3)
    x = rs.randn(1, 2, 3, 64).astype(np.float32)
    k = rs.randn(3, 64, 64).astype(np.float32) * 0.1
    want = sum(np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))[:, t:t + 2] @ k[t]
               for t in range(3))
    got = rk.temporal_conv_fused_plain(torch.from_numpy(x).to(cuda),
                                       torch.from_numpy(k).to(cuda),
                                       torch.zeros(64, device=cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=1e-4)


def test_fused_unet_matches_plain_on_the_card(cuda):
    """The fused routing (K1/K2 float32 kernels inside the network) against
    the plain path with the same weights, at the JAX package's own
    fused-vs-plain tolerance; the default device resolves to the card."""
    from v2a_tpu_torch.models.video_model import VideoModelConfig, VideoPredModel
    from v2a_tpu_torch.models.video_unet import VideoUNet

    cfg = VideoModelConfig(image_size=(32, 32), sample_per_seq=3, model_channels=128,
                           channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(2,),
                           text_dim=64)
    model = VideoPredModel(cfg).init(0)
    assert model.device.type == "cuda" and model.unet.fused
    plain = VideoUNet(model_channels=128, channel_mult=(1, 2), num_res_blocks=1,
                      attention_resolutions=(2,), task_token_dim=64).to(cuda).eval()
    plain.load_state_dict(model.unet.state_dict())
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 2, 32, 32, 6, generator=g, device=cuda)
    t = torch.tensor([5, 60], device=cuda)
    te = model.encode_batch_text(["open the drawer", "pick up the bowl"])
    before = dict(rk.launches)
    with torch.no_grad():
        got, want = model.unet(x, t, te), plain(x, t, te)
    assert rk.launches["fused_affine_conv3x3"] - before["fused_affine_conv3x3"] == 21
    assert rk.launches["temporal_conv_fused"] - before["temporal_conv_fused"] == 19
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)
