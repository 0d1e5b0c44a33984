"""Device ms per train step inside the benchmark's span around
`apply_gradients` (the clip, Adam and the EMA): the union of the device
intervals launched inside each span, averaged over the steps."""


def read(trace):
    per_step = [evs for evs in trace.launched_in("apply_gradients") if evs]
    if not per_step:
        return None
    return 1e3 * sum(trace.busy_s(evs) for evs in per_step) / len(per_step)
