"""The share of the steps' device time spent in the rollup's "elementwise
and reductions" and "copies and casts" categories (`trace.category`)."""


def read(trace):
    cats = trace.by_category()
    total = sum(cats.values())
    if total <= 0:
        return None
    part = cats.get("elementwise and reductions", 0.0) + cats.get("copies and casts", 0.0)
    return 100.0 * part / total
