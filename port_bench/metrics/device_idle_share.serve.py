"""The share of the traced window's host wall in which no operation ran on
the card: 1 - (union of the device intervals) / (window)."""


def read(trace):
    if not trace.events or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
