"""handyrl_tpu_torch.telemetry — tracing, flight recorder, status, perf.

The counterpart of ``handyrl_tpu.telemetry``, with the same public
surface (see :mod:`.spans` for the design notes):

  * spans: ``trace_span`` / ``record_span`` / ``add_event`` /
    ``span_begin`` / ``span_end``, configured per process via
    ``configure_from_args`` (the same args dict every child receives);
  * trace context: ``new_trace`` / ``maybe_trace`` / ``current_trace``
    / ``set_trace`` / ``clear_trace`` and the wire envelope
    ``wrap_trace`` / ``unwrap_trace`` (ridden by
    ``connection.TracedConnection`` and the ``QueueCommunicator``);
  * flight recorder: ``dump`` / ``dump_count`` / ``stall_hook`` /
    ``crash_dump`` / ``install_signal_dump``;
  * exporters: :mod:`.export` (Perfetto ``trace.json``) and
    :mod:`.status` (read-only HTTP snapshot);
  * metrics: ``summarize_lags`` (the per-epoch policy-version-lag
    reduction) and :class:`.histogram.LatencyHistogram` (the mergeable
    log2 latency histogram of the serving tier);
  * perf attribution: :mod:`.costmodel` (the peak table with the
    H100's row, ``PerfConfig``, and ``CostModel``, which counts a
    step's FLOPs with ``FlopCounterMode`` and its unfused bytes with a
    ``TorchDispatchMode``) and :mod:`.attribution` (the per-epoch
    self-time tree and the ``untracked_residual_sec`` wall-time
    reconciliation).

Every module but :mod:`.costmodel` is a stdlib-only copy of its JAX
twin, so span logs, flight records and histograms cross packages.
"""

from .attribution import (  # noqa: F401
    Attributor,
    self_time_tree,
    untracked_residual,
)
from .costmodel import CostModel, PerfConfig  # noqa: F401
from .histogram import LatencyHistogram  # noqa: F401
from .spans import (  # noqa: F401
    TRACE_HEAD,
    add_event,
    clear_trace,
    configure,
    configure_from_args,
    crash_dump,
    current_trace,
    dump,
    dump_count,
    enabled,
    flush,
    install_signal_dump,
    maybe_trace,
    new_trace,
    now,
    payload_trace,
    record_span,
    register_dump_extra,
    ring_snapshot,
    set_trace,
    span_begin,
    span_end,
    stall_hook,
    stats,
    summarize_lags,
    trace_span,
    unwrap_trace,
    wrap_trace,
)
