"""The share of the traced window in which no device activity ran:
1 - (the union of the kernels', copies' and memsets' intervals) / the
window, as a percentage."""


def read(run):
    if run.trace is None or not any(r["kind"] == "qa" for r in run.records):
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
