"""The served U-Net forwards' model FLOP over the untraced window's length
at the card's bf16 tensor-core peak. The FLOP are the configuration's own
count (`roofline.unet_forward_flops`), the same whatever routing or kernels
compute them; the forwards and the wall are the untraced window's, so the
profiler's own cost is not in it."""

from port_bench import roofline


def read(trace):
    c = trace.untraced
    if not c.get("forwards"):
        return None
    return 100.0 * c["forwards"] * c["unet_flops"] / (c["window_s"] * roofline.PEAK_BF16_FLOPS)
