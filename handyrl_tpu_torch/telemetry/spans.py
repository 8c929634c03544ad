"""Span-family metric helpers.

A copy of the stdlib-only reductions of ``handyrl_tpu.telemetry.spans``;
the spans themselves (trace context, flight recorder) are not ported
yet.
"""


def summarize_lags(lags):
    """Per-epoch policy-version-lag reduction: ``{policy_lag_mean,
    policy_lag_p95, policy_lag_max}`` over the episodes admitted this
    epoch (lag = learner epoch at intake - snapshot epoch that
    generated the episode: the off-policy health signal of an
    IMPALA-style learner)."""
    if not lags:
        return {"policy_lag_mean": 0.0, "policy_lag_p95": 0.0,
                "policy_lag_max": 0.0}
    ordered = sorted(lags)
    p95 = ordered[min(len(ordered) - 1,
                      int(0.95 * (len(ordered) - 1) + 0.5))]
    return {
        "policy_lag_mean": round(sum(ordered) / len(ordered), 4),
        "policy_lag_p95": float(p95),
        "policy_lag_max": float(ordered[-1]),
    }
