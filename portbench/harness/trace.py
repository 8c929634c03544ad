"""The traced sub-window: ``torch.profiler`` over a run of steps.

``Tracer`` wraps the trainer's ring step, ingest, snapshot, epoch and
epoch loop (instance attributes, from outside) to log when the trainer
thread was in which of them, starts ``torch.profiler`` right before
step ``start`` and stops it after step ``start + steps - 1`` (the stop
waits for the device).  The sub-window is placed over one epoch close.

``summarize`` reduces the profiler's raw events (no chrome trace is
written) to the device's timeline within the sub-window: the union of
the intervals in which an operation ran on the device (busy time), the
kernels launched from the sub-window's steps (launch count and their
union, the kernel-busy time), the device operations that took most
time, and the longest idle gaps, each labelled with what the trainer
thread was doing then: the harness range open at the gap's middle
(``step``, ``ingest``, ``epoch_close``, ``snapshot``, ``loop`` at the
epoch's step cap, ``handoff`` between epochs) and the outermost
operator the thread was in.
"""

import threading
import time
from collections import defaultdict

import torch

COPIES = ("Memcpy", "Memset")        # device events that are no kernel


class Tracer:
    def __init__(self, trainer, start, steps):
        self.trainer = trainer
        self.start, self.stop = start, start + steps
        self.steps = steps
        self.ranges = []                    # [label, start_ns, end_ns]
        self.prof = None
        self.window_ns = None
        self.done = threading.Event()
        for attr, label in (("_replay_ingest", "ingest"),
                            ("snapshot", "snapshot"), ("train", "epoch"),
                            ("_epoch_loop_device", "loop")):
            setattr(trainer, attr, self._ranged(getattr(trainer, attr),
                                                label))
        self._step = trainer._ring_step
        trainer._ring_step = self._ring_step

    def _ranged(self, fn, label):
        def call(*args, **kwargs):
            entry = [label, time.time_ns(), None]   # None: still open
            self.ranges.append(entry)
            try:
                return fn(*args, **kwargs)
            finally:
                entry[2] = time.time_ns()
        return call

    def _ring_step(self):
        i = self.trainer.steps
        if i == self.start - 1:
            # one step ahead: the profiler's own start-up stays out of
            # the sub-window.  Device activity only (kernels, copies and
            # the runtime calls that launch them): recording every
            # operator on the host would double a host-bound step.
            from torch.profiler import ProfilerActivity, profile

            cuda = self.trainer.device.type == "cuda"
            self.prof = profile(activities=[
                ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
            self.prof.start()
        if i == self.start:
            self.window_ns = [time.time_ns(), None]
        out = self._ranged(self._step, "step")()
        if self.window_ns is not None and not self.done.is_set():
            if i == self.stop - 1:
                if self.trainer.device.type == "cuda":
                    torch.cuda.synchronize()
                self.window_ns[1] = time.time_ns()
                self.prof.stop()
                self.done.set()
        return out


def _union(intervals):
    """Merged ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(tracer, cpu_ops, t):
    """What the trainer thread was doing at ``t``: the innermost harness
    range open then, and the outermost host call then recorded."""
    inner = [r for r in list(tracer.ranges)
             if r[1] <= t and (r[2] is None or t <= r[2])]
    names = {r[0] for r in inner}
    if not inner:
        what = "handoff"
    elif names & {"step", "ingest", "snapshot"}:
        what = max(inner, key=lambda r: r[1])[0]
    elif "loop" in names:
        what = "loop"
    else:
        what = "epoch_close"
    ops = [o for o in cpu_ops if o[1] <= t <= o[2]]
    if ops:
        what += ":" + min(ops, key=lambda o: o[1])[0]
    return what


def summarize(tracer):
    """The sub-window's device timeline (seconds) and breakdown."""
    lo, hi = tracer.window_ns
    events = tracer.prof.profiler.kineto_results.events()
    device, launches, cpu_ops = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s, t = max(e.start_ns(), lo), min(e.end_ns(), hi)
            if t > s:
                device.append((name, s, t, e.correlation_id(),
                               not name.startswith(COPIES)))
        elif "Launch" in name:          # a cudaLaunch* or cuLaunch* call
            if lo <= e.start_ns() <= hi:
                launches[e.correlation_id()] = name
        elif (e.end_ns() > lo and e.start_ns() < hi
              and not name.startswith("Activity Buffer")):  # the profiler's
            cpu_ops.append((name, e.start_ns(), e.end_ns()))
    kernels = [d for d in device if d[4] and d[3] in launches]
    busy = _union([(d[1], d[2]) for d in device])
    kernel_busy = _union([(d[1], d[2]) for d in kernels])
    by_name = defaultdict(int)
    for name, s, t, _, _ in device:
        by_name[name] += t - s
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernel_busy_s": sum(e - s for s, e in kernel_busy) / 1e9,
        "launches": len(kernels),
        "launch_calls": len(launches),
        "steps": tracer.steps,
        "device_ops": [[name[:120], ns / 1e9] for name, ns in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[_label(tracer, cpu_ops, s + g // 2), g / 1e9]
                      for g, s in gaps],
    }
