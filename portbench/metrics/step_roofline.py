"""The least time of one step on the card over its kernel-busy time.

The least time is the larger of the analytic FLOPs over the bf16 peak
and the analytic bytes over the HBM bandwidth (``portbench/costs``);
``bound`` says which.  The kernel-busy time is the union of the
intervals of the kernels the traced steps launched, per step."""

from portbench.harness import peaks


def read(ctx):
    trace = ctx["trace"]
    if not trace or trace["kernel_busy_s"] <= 0:
        return None
    costs = ctx["costs"]
    compute = costs["flops"] / peaks.BF16_FLOPS
    memory = costs["bytes"] / peaks.HBM_BYTES
    per_step = trace["kernel_busy_s"] / trace["steps"]
    return {"value": 100.0 * max(compute, memory) / per_step,
            "bound": "compute" if compute >= memory else "memory"}
