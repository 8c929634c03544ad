"""handyrl_tpu_torch.telemetry — the per-epoch metric reductions.

The counterpart of ``handyrl_tpu.telemetry``, so far in part:

  * :func:`.spans.summarize_lags`, the per-epoch policy-version-lag
    reduction (``policy_lag_{mean,p95,max}``);
  * :mod:`.costmodel`, the runtime half of the JAX package's cost
    model: the peak table with the H100's row, ``PerfConfig`` (the
    ``perf`` config keys) and :class:`.costmodel.CostModel`, which
    counts a step's FLOPs with ``torch.utils.flop_counter`` and turns
    an epoch's device-step seconds into ``mfu`` / ``achieved_tflops``
    / ``arithmetic_intensity`` / ``roofline_verdict``.

Spans, the flight recorder, the histogram, the exporters and the status
server are not ported yet.
"""

from .costmodel import CostModel, PerfConfig  # noqa: F401
from .spans import summarize_lags  # noqa: F401
