"""The train steps' model FLOP over the untraced window's length at the
card's bf16 tensor-core peak: three times the forward's own count per step
(forward, data gradient, weight gradient; no recomputation counted). The
steps and the wall are the untraced window's, so the profiler's own cost
is not in it."""

from port_bench import roofline


def read(trace):
    c = trace.untraced
    if not c.get("steps"):
        return None
    flops = 3.0 * c["steps"] * c["unet_flops"]
    return 100.0 * flops / (c["window_s"] * roofline.PEAK_BF16_FLOPS)
