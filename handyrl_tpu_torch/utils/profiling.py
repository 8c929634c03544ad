"""Lightweight profiling: per-section wall timers + a profiler window.

The counterpart of ``handyrl_tpu.utils.profiling``:

  * ``SectionTimers`` — a copy: near-zero-cost named wall-clock
    sections for the learner hot loop (batch wait vs device step),
    reported per epoch in metrics.jsonl.  Each section also records a
    ``trainer.<name>`` telemetry span, so the trainer's sections land
    on the exported Perfetto timeline as they do in the JAX package;
  * ``TraceWindow`` — captures a ``torch.profiler`` trace of a window
    of update steps into ``profile_dir`` as a Chrome/Perfetto
    ``trace.json`` (CPU and CUDA activity on the card, CPU only on the
    CPU), armed by the ``profile_dir`` config key.
"""

import os
import time
from collections import defaultdict
from contextlib import contextmanager

from ..telemetry import spans as _telemetry


class SectionTimers:
    """Accumulate wall time per named section between snapshots.

    Each timed section ALSO records a telemetry span (``trainer.<name>``
    against the telemetry clock) when telemetry is armed, so the
    trainer's ingest/batch_wait/update sections appear on the exported
    Perfetto timeline without a second set of instrumentation sites."""

    def __init__(self, span_prefix="trainer."):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.span_prefix = span_prefix

    @contextmanager
    def section(self, name):
        t0 = time.perf_counter()
        tel = _telemetry.enabled()
        st0 = _telemetry.span_begin() if tel else 0.0
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            if tel:
                _telemetry.span_end(self.span_prefix + name, st0)

    def snapshot(self, reset=True):
        """{name: {"sec": total, "n": count}}, optionally resetting."""
        out = {
            name: {"sec": round(self.totals[name], 4),
                   "n": self.counts[name]}
            for name in self.totals
        }
        if reset:
            self.totals.clear()
            self.counts.clear()
        return out

    def format(self, snap=None):
        snap = self.snapshot() if snap is None else snap
        return " ".join(
            f"{name}:{v['sec']:.2f}s/{v['n']}"
            for name, v in sorted(snap.items())
        )


class TraceWindow:
    """Capture one ``torch.profiler`` trace over a window of steps.

    ``tick()`` once per update step, on the thread that runs the steps:
    the trace starts at ``start_step`` and stops at ``stop_step`` (after
    the first-call set-up has settled), then is written to
    ``trace_dir/trace-<pid>-<stop_step>.json``.  One-shot; ``close()``
    stops an active window; inactive when ``trace_dir`` is empty.
    ``device`` picks the activities: CPU and CUDA for a CUDA device,
    CPU only otherwise."""

    def __init__(self, trace_dir, start_step=10, stop_step=20,
                 device="cpu"):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self.device = str(device)
        self.step = 0
        self.active = False
        self.done = not trace_dir
        self.path = None
        self._prof = None

    def _activities(self):
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _start(self):
        import torch

        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.start()
        self.active = True

    def _stop(self):
        prof, self._prof = self._prof, None
        self.active = False
        self.done = True
        prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(
            self.trace_dir, f"trace-{os.getpid()}-{self.step}.json")
        prof.export_chrome_trace(self.path)
        print(f"profiler trace written to {self.path}")

    def tick(self):
        if self.done:
            return
        self.step += 1
        if not self.active and self.step >= self.start_step:
            self._start()
        elif self.active and self.step >= self.stop_step:
            self._stop()

    def close(self):
        if self.active:
            self._stop()
