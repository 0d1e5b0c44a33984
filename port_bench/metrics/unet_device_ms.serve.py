"""Device ms per U-Net forward: the union of the device intervals launched
inside the benchmark's span around each call of the served U-Net, summed
and divided by the number of forwards."""


def read(trace):
    per_call = [evs for evs in trace.launched_in("unet") if evs]
    if not per_call:
        return None
    return 1e3 * sum(trace.busy_s(evs) for evs in per_call) / len(per_call)
