"""The whole step's share of the bf16 peak: analytic FLOPs per step
times the traced steps, over the traced sub-window's wall time (epoch
close included), against 989 TFLOP/s.  The card's power limit is
given beside it."""

from portbench.harness import peaks


def read(ctx):
    trace = ctx["trace"]
    if not trace or trace["busy_s"] <= 0:
        return None
    flops = ctx["costs"]["flops"] * trace["steps"]
    return {"value": 100.0 * flops / trace["window_s"] / peaks.BF16_FLOPS,
            "power_limit_w": ctx["power_limit_w"]}
