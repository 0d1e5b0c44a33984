"""The hand kernels' share of their roofline over the traced window: the
sum over their launches of the least time the card could take (the larger
of operations over the peak rates and bytes over HBM's, from each launch's
signature, `roofline.launch_bound_s`) over the sum of their device time."""

from port_bench import roofline


def read(trace):
    hand = trace.hand_events()
    if not hand or not trace.calls:
        return None
    device_s = sum(e.end_us - e.start_us for e in hand) / 1e6
    bound_s = sum(roofline.launch_bound_s(tag, key) for tag, key in trace.calls)
    return 100.0 * bound_s / device_s
