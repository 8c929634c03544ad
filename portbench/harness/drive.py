"""Playing the learner: the ported trainer driven as the learner drives it.

The harness builds the port's ``Trainer`` with the device ring on, runs
``Trainer.run`` on a thread of its own (the learner's trainer thread:
ring warm-up, then ``train()`` epoch after epoch, each the
``_epoch_loop_device`` of ``_ring_step`` calls), hands it episodes
through ``DeviceReplay.offer`` and closes epochs through
``Trainer.update()``, as the learner's server loop does.  It never
calls a part of the step itself.

What it adds to the trainer, all from outside:

  * a mark after every step (a CUDA event on the trainer's stream),
    from which the window's steps and times are read;
  * for the first ``capture`` steps: the rows each drew and the step's
    metrics, and the first step's forward outputs; the comparison with
    the reference reads them once the window has closed;
  * a tap on the trainer's ``SectionTimers`` that keeps their totals
    across the epoch close's reset.

The server loop sleeps on the step marks between its turns: the step
that ends an epoch (or that a wait is for) wakes it, and otherwise it
looks in every :data:`WAKE_S` seconds.  It takes the interpreter lock
from the trainer thread a few times a second, not every few
milliseconds: a host-paced step is the trainer thread's enqueue.
"""

import importlib
import math
import threading
import time
from collections import defaultdict

import torch

WAKE_S = 0.1     # the server loop's longest sleep: a failed trainer shows


class _HostMark:
    """A step mark on the CPU, where a step has ended when it returns."""

    def query(self):
        return True

    def synchronize(self):
        pass


def _mark(device):
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
        return event
    return _HostMark()


class StepMarks:
    """Wraps the trainer's step callable: a mark after each call, and
    the first ``capture`` calls' metrics."""

    def __init__(self, trainer, capture):
        self.fn = trainer._replay_step
        self.device = trainer.device
        self.capture = capture
        self.marks = []
        self.metrics = []
        self.wake = threading.Event()
        self.wake_at = None
        trainer._replay_step = self

    def __call__(self, state):
        out = self.fn(state)
        if len(self.marks) < self.capture:
            self.metrics.append(out)
        self.marks.append(_mark(self.device))
        at = self.wake_at
        if at is not None and len(self.marks) >= at:
            self.wake.set()
        return out

    def wait(self, steps, timeout):
        """Sleep until ``steps`` steps have been called or ``timeout``
        seconds have passed."""
        self.wake.clear()
        self.wake_at = steps
        if len(self.marks) < steps:
            self.wake.wait(timeout)
        self.wake_at = None

    def completed(self, lo):
        """Index of the first mark at or after ``lo`` not yet reached by
        the device, or None if every recorded mark has been."""
        hi = len(self.marks)
        if lo >= hi or self.marks[hi - 1].query():
            return None
        while lo < hi:                      # marks complete in order
            mid = (lo + hi) // 2
            if self.marks[mid].query():
                lo = mid + 1
            else:
                hi = mid
        return lo


class OutputTap:
    """Copies of the net's outputs in the first step: the policy logits
    ``(B, T, A)`` and values ``(B, T)`` the update step's forward
    returned (one call of a feed-forward net, one a time step of a
    recurrent one), read through ``UpdateStep.apply_fn``."""

    def __init__(self, update_step, marks, windows, steps):
        self.update_step = update_step
        self.fn = update_step.apply_fn
        self.marks = marks
        self.shape = (windows, steps)
        self.calls = []
        update_step.apply_fn = self

    def __call__(self, obs, hidden=None):
        if self.marks.marks:                # past the first step
            self.update_step.apply_fn = self.fn
            return self.fn(obs, hidden)
        out = self.fn(obs, hidden)
        self.calls.append({k: out[k].detach().clone()
                           for k in ("policy", "value") if k in out})
        return out

    def outputs(self):
        """The first step's outputs on the host, or None if the net ran
        no forward; as the calls joined them where they are not one
        output a window and step."""
        if not self.calls:
            return None
        B, T = self.shape
        out = {}
        for k in self.calls[0]:
            joined = torch.stack([c[k] for c in self.calls], 1)
            if joined.shape[0] * joined.shape[1] == B * T:
                joined = joined.reshape(B, T, -1)
            out[k] = joined.cpu()
        if "value" in out:
            out["value"] = out["value"][..., 0]
        return out


class DrawTap:
    """Copies of the rows the first ``count`` draws of the ring chose."""

    def __init__(self, replay, count):
        self.replay = replay
        self.count = count
        self.draws = []
        self.orig = replay.draw
        replay.draw = self

    def __call__(self, state, generator, batch_size):
        out = self.orig(state, generator, batch_size)
        self.draws.append(tuple(t.detach().clone() for t in out))
        if len(self.draws) >= self.count:
            del self.replay.draw            # back to the class's method
        return out


class SectionTap:
    """The trainer's section totals across the epoch close's reset."""

    def __init__(self, timers):
        self.timers = timers
        self.base = defaultdict(float)
        self.nbase = defaultdict(int)
        orig = timers.snapshot

        def snapshot(reset=True):
            if reset:
                for k, v in timers.totals.items():
                    self.base[k] += v
                for k, n in timers.counts.items():
                    self.nbase[k] += n
            return orig(reset)

        timers.snapshot = snapshot

    def read(self, name):
        return (self.base[name] + self.timers.totals.get(name, 0.0),
                self.nbase[name] + self.timers.counts.get(name, 0))


def build_trainer(cell, seed, device, init_state):
    """The port's ``Trainer`` for ``cell``, its weights ``init_state``."""
    from handyrl_tpu_torch.learner import Trainer
    from handyrl_tpu_torch.models import TorchModel

    module = new_module(cell).to_empty(device=device)
    module.load_state_dict(init_state)
    args = dict(cell.train_args, seed=int(seed), restart_epoch=0,
                profile_dir="", epochs=-1)
    return Trainer(args, TorchModel(module, device=device), device=device)


def new_module(cell):
    """The configuration's net on the meta device (shapes only)."""
    net = cell.config["net"]
    cls = getattr(importlib.import_module(net["module"]), net["class"])
    with torch.device("meta"):
        return cls(**net["config"])


class Learner:
    """The learner's side of the trainer: episodes in, epochs closed."""

    def __init__(self, trainer, marks, cell, stream=()):
        self.trainer = trainer
        self.marks = marks
        self.replay = trainer.device_replay
        self.epoch_steps = cell.traffic["epoch_steps"]
        self.rate = float(cell.traffic.get("stream_per_step", 0.0))
        self.stream = list(stream)
        self.stream_from = None
        self.offered = 0
        self.next_close = None
        self.records = []
        self.thread = threading.Thread(target=trainer.run, daemon=True,
                                       name="trainer")

    def _check(self):
        if self.trainer.failure is not None:
            raise RuntimeError("the trainer thread failed") \
                from self.trainer.failure
        if not self.thread.is_alive():
            raise RuntimeError("the trainer thread ended")

    def first_steps(self, fill, steps):
        """Set-up: the ring filled with ``fill``, then ``steps`` steps in
        an epoch of their own, closed through ``update()``.  Returns
        the snapshot the close hands over."""
        self.replay.offer(fill)
        self.trainer.updates_cap = steps
        self.thread.start()
        while len(self.marks.marks) < steps:
            self._check()
            self.marks.wait(steps, WAKE_S)
        self.trainer.updates_cap = self.epoch_steps
        snapshot = self._close()
        self.stream_from = self.trainer.steps
        return snapshot

    def _close(self):
        snapshot, steps, record = self.trainer.update()
        if snapshot is None:
            self._check()
            raise RuntimeError("the trainer handed over no snapshot")
        self.records.append(record)
        self.next_close = steps + self.epoch_steps
        return snapshot

    def tick(self):
        """One turn of the server loop: offer the episodes due, close
        the epoch once its steps are in.  Returns the step count at
        which the next turn is due."""
        self._check()
        steps = len(self.marks.marks)
        due_at = self.next_close
        if self.stream:
            due = int(self.rate * (steps - self.stream_from))
            while self.offered < due:
                self.replay.offer(
                    [self.stream[self.offered % len(self.stream)]])
                self.offered += 1
            due_at = min(due_at, self.stream_from + math.ceil(
                (self.offered + 1) / self.rate - 1e-9))
        if steps >= self.next_close:
            self._close()
            due_at = self.next_close
        return due_at

    def run_until(self, done, steps=None, at=None, clock=time.perf_counter):
        """Serve the trainer until ``done()``; the loop wakes at step
        ``steps`` and at the time ``at`` (host clock) if given."""
        while not done():
            due_at = self.tick()
            if steps is not None:
                due_at = min(due_at, steps)
            timeout = WAKE_S if at is None else min(
                WAKE_S, max(0.0, at - clock()))
            self.marks.wait(due_at, timeout)

    def stop(self, timeout=120.0):
        self.trainer.request_shutdown()
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError("the trainer thread did not stop")


def window(learner, marks, first, seconds, probe, clock=time.perf_counter):
    """The measured window: from the device's end of step ``first``
    (0-based) to the end of the first step it finishes after
    ``seconds`` more.  Returns ``(steps, t0, t1, probe() at t0,
    probe() at t1)``, host times."""
    learner.run_until(lambda: len(marks.marks) > first, steps=first + 1)
    marks.marks[first].synchronize()
    t0 = clock()
    opened = probe()
    learner.run_until(lambda: clock() >= t0 + seconds, at=t0 + seconds,
                      clock=clock)
    recorded = len(marks.marks)
    j = marks.completed(first + 1)
    if j is None:       # the device has caught up: the next step ends it
        learner.run_until(lambda: len(marks.marks) > recorded,
                          steps=recorded + 1)
        j = recorded
    marks.marks[j].synchronize()
    t1 = clock()
    return j - first, t0, t1, opened, probe()
