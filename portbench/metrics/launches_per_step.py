"""CUDA kernels launched from the traced steps, per step."""


def read(ctx):
    trace = ctx["trace"]
    if not trace or not trace["launches"]:
        return None
    return {"value": trace["launches"] / trace["steps"]}
