"""The cost model on the CPU: the per-launch operation counts of one fused
forward add up to the configuration's own count of the convolutions that
the routing sends to hand kernels."""

import torch

from port_bench import roofline
from port_bench.trace import record_launches

# every level padded (H*W > 512), so each ResBlock conv, temporal conv and
# skip fold and each upsample conv runs a hand kernel (K3 or K4a + K4b, K5);
# the entry and downsample spatial convs, the out conv and the attention
# stay with the library
MODEL = dict(image_size=[48, 48], sample_per_seq=4, channels=3, model_channels=128,
             channel_mult=[1, 2], num_res_blocks=1, attention_resolutions=[],
             num_head_channels=32, text_dim=64, dtype="float32", fused=True)


def routed(name: str) -> bool:
    """A component of `unet_forward_flops` that the padded routing sends to
    a hand kernel at `MODEL`'s sizes."""
    return not (name in ("entry.spatial", "out.spatial", "out.temporal")
                or name.endswith("downsample.spatial") or "attn" in name.split(".")[-1])


def test_launch_counts_add_up_to_the_model_count():
    from port_bench import cells
    from v2a_tpu_torch.ops import resblock_kernels as rk

    torch.manual_seed(0)
    vm = cells.build_model(dict(MODEL, timesteps=4, sampling_timesteps=4), 5, "cpu")
    assert vm.unet.fused
    b, f = 1, MODEL["sample_per_seq"] - 1
    x = torch.randn(b, f, 48, 48, 6)
    emb = vm.encode_batch_text(["put the bowl on the plate"])
    modules = {n: rk.wrapper_module(n) for n in roofline.SIGNATURES if n in rk.KERNELS}
    calls = []
    with record_launches(modules, calls), torch.no_grad():
        vm.unet(x, torch.tensor([3]), emb)
    tags = {tag for tag, _ in calls}
    assert {"k5", "k2"} <= tags and tags & {"k3", "k4a"}, tags
    launched = sum(roofline.launch_cost(tag, key)[0] for tag, key in calls)
    model = sum(v for name, v in roofline.unet_forward_flops(MODEL, b) if routed(name))
    assert launched == model


def test_release_counts():
    release = dict(image_size=[128, 128], sample_per_seq=8, channels=3, model_channels=128,
                   channel_mult=[1, 2, 3, 4, 5], num_res_blocks=2, attention_resolutions=[8, 16],
                   num_head_channels=32)
    total = roofline.unet_forward_total(release, 8)
    assert 15.0e12 < total < 15.4e12
    assert roofline.unet_forward_total(release, 4) * 2 == total
