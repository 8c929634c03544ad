"""The share of the traced sub-window in which no operation ran on the
device (the union of kernel, copy and set intervals)."""


def read(ctx):
    trace = ctx["trace"]
    if not trace or trace["busy_s"] <= 0:
        return None
    return {"value": 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])}
