"""Child-process supervision: respawn with backoff, circuit breaker.

A copy of ``handyrl_tpu.resilience.supervisor`` (plain Python, no
framework): the port keeps its own so that it imports nothing of the
JAX package.

The learner-actor split exists so actor failures are survivable
(IMPALA, arXiv:1802.01561).  ``QueueCommunicator`` drops dead peers;
the Supervisor brings crashed children back:

  * every slot holds one child (anything with ``is_alive()`` /
    ``terminate()`` — an ``mp.Process`` in production, a fake in
    tests);
  * a child that exits (or is evicted for missed heartbeats) is
    respawned after a jittered exponential backoff;
  * a slot that fails more than ``max_respawns`` times inside
    ``failure_window`` seconds trips its circuit breaker: the slot is
    marked DEAD and the fleet shrinks instead of restart-storming.

The RNG behind the jitter and the clock behind the schedule are both
injectable (``BackoffPolicy(rng=...)``, ``poll(now=...)``), so tests
replay exact schedules.
"""

import enum
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class BackoffPolicy:
    """Jittered exponential backoff schedule.

    ``delay(attempt)`` grows ``base * factor**attempt`` capped at
    ``cap``, then stretched by up to ``jitter`` of itself (uniform) so
    a fleet of failed slots does not thunder back in lockstep.  The RNG
    is injectable for deterministic tests.
    """

    def __init__(self, base: float = 0.5, factor: float = 2.0,
                 cap: float = 30.0, jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self.rng = rng if rng is not None else random.Random()

    def delay(self, attempt: int) -> float:
        raw = min(self.cap, self.base * self.factor ** max(0, attempt))
        return raw * (1.0 + self.jitter * self.rng.random())


class FailureWindow:
    """Windowed failure counter behind every circuit breaker here —
    the actor Supervisor's per-slot breaker and the LearnerGuard's
    relaunch breaker share THIS definition, so their semantics cannot
    drift: failures older than ``window`` seconds age out, and the
    breaker trips when the live count EXCEEDS ``max_failures``.  That
    makes 0 the STRICTEST setting (trip on the first failure), never
    "unlimited"."""

    __slots__ = ("max_failures", "window", "times")

    def __init__(self, max_failures: int, window: float):
        self.max_failures = int(max_failures)
        self.window = float(window)
        self.times: List[float] = []

    def record(self, now: float) -> bool:
        """Note one failure at ``now``; True when the breaker trips."""
        self.times.append(now)
        cutoff = now - self.window
        self.times = [t for t in self.times if t >= cutoff]
        return len(self.times) > self.max_failures

    def __len__(self) -> int:
        return len(self.times)


class SlotState(enum.Enum):
    RUNNING = "running"
    BACKOFF = "backoff"   # child gone; respawn scheduled at slot.due
    DEAD = "dead"         # circuit breaker tripped; never respawned
    STOPPED = "stopped"   # drain mode: child exit is expected, no respawn


class _Slot:
    __slots__ = ("index", "child", "state", "failures", "respawns", "due")

    def __init__(self, index: int, failures: FailureWindow):
        self.index = index
        self.child = None
        self.state = SlotState.BACKOFF  # spawns on the first poll
        self.failures = failures        # this slot's breaker window
        self.respawns = 0
        self.due = 0.0


class Supervisor:
    """Owns a fixed set of child slots and keeps them alive.

    ``spawn(slot_index)`` creates and starts one child, returning a
    handle with ``is_alive()`` and ``terminate()``; a raise from
    ``spawn`` counts as a failure of that slot (connect-refused on a
    remote dial rides the same backoff as a crash).  Drive the state
    machine with ``poll()`` from a monitor loop; ``kill_slot`` is the
    eviction entry point for chaos injection and missed-heartbeat
    peers.  ``stop()`` enters drain mode: child exits stop being
    failures (used at shutdown, when gathers exit BY DESIGN once their
    workers finish).
    """

    def __init__(self, spawn: Callable[[int], object], num_slots: int,
                 policy: Optional[BackoffPolicy] = None,
                 max_respawns: int = 5, failure_window: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 treat_clean_exit_as_drain: bool = False):
        self.spawn = spawn
        self.policy = policy if policy is not None else BackoffPolicy()
        self.max_respawns = int(max_respawns)
        self.failure_window = float(failure_window)
        self.clock = clock
        # remote fleets have no in-band drain signal from the learner:
        # a child that exits with code 0 (gather drained its workers
        # after the learner's None jobs) parks its slot STOPPED instead
        # of riding the failure->respawn path.  Local clusters keep
        # this off — their learner calls begin_drain explicitly, and a
        # mid-run clean exit (all workers crashed) should respawn.
        self.treat_clean_exit_as_drain = bool(treat_clean_exit_as_drain)
        self._slots: Dict[int, _Slot] = {
            i: _Slot(i, FailureWindow(self.max_respawns,
                                      self.failure_window))
            for i in range(num_slots)}
        self._lock = threading.Lock()
        self.stopped = False
        self._hold_until = 0.0  # respawns paused until this clock time

    # -- bookkeeping -------------------------------------------------
    @property
    def respawns(self) -> int:
        """Total successful respawns across every slot (the initial
        spawn of each slot is not a respawn)."""
        with self._lock:
            return sum(s.respawns for s in self._slots.values())

    def alive_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots.values()
                       if s.state is SlotState.RUNNING
                       and s.child is not None and s.child.is_alive())

    def dead_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots.values()
                       if s.state is SlotState.DEAD)

    def pending_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots.values()
                       if s.state is SlotState.BACKOFF)

    def stopped_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots.values()
                       if s.state is SlotState.STOPPED)

    def slot_state(self, index: int) -> SlotState:
        with self._lock:
            return self._slots[index].state

    def running_children(self) -> List[Tuple[int, object]]:
        with self._lock:
            return [(s.index, s.child) for s in self._slots.values()
                    if s.state is SlotState.RUNNING
                    and s.child is not None and s.child.is_alive()]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            slots = len(self._slots)
        return {
            "slots": slots,
            "respawns": self.respawns,
            "fleet_alive": self.alive_count(),
            "slots_dead": self.dead_count(),
        }

    # -- lifecycle ---------------------------------------------------
    def start_all(self, now: Optional[float] = None):
        """Spawn every slot; failures ride the normal backoff path."""
        self.poll(now=now)

    def stop(self):
        """Drain mode: from now on a child exit is expected, not a
        failure.  Children keep running (they exit on their own once
        their workers finish); nothing is ever respawned again."""
        with self._lock:
            self.stopped = True
            for slot in self._slots.values():
                if slot.state in (SlotState.RUNNING, SlotState.BACKOFF):
                    slot.state = SlotState.STOPPED

    def terminate_all(self):
        """Kill every live child (remote-cluster teardown: gathers are
        non-daemonic and must not be orphaned)."""
        self.stop()
        with self._lock:
            children = [s.child for s in self._slots.values()
                        if s.child is not None]
        for child in children:
            try:
                if child.is_alive():
                    child.terminate()
            except OSError:
                pass

    def hold_respawns(self, seconds: float, now: Optional[float] = None):
        """Pause every respawn for ``seconds`` (chaos surges: a burst
        preemption's replacement capacity does not come back
        instantly).  Failures are still observed and recorded — only
        the respawn side of the state machine waits, so backoff
        schedules and the circuit breaker stay truthful."""
        if now is None:
            now = self.clock()
        with self._lock:
            self._hold_until = max(self._hold_until, now + float(seconds))
        print(f"supervisor: respawns held for {seconds:.1f}s")

    def kill_slot(self, index: int, reason: str = ""):
        """Evict a slot's child (chaos injection, missed heartbeats).
        The next ``poll`` sees the death and runs the normal
        failure -> backoff -> respawn path."""
        with self._lock:
            slot = self._slots.get(index)
            child = slot.child if slot is not None else None
        if child is None:
            return
        print(f"supervisor: killing slot {index}"
              + (f" ({reason})" if reason else ""))
        try:
            child.terminate()
        except OSError:
            pass

    # -- the state machine -------------------------------------------
    def _record_failure(self, slot: _Slot, now: float):
        # the trip rule (incl. "max_respawns == 0 is the STRICTEST
        # breaker") lives in FailureWindow, shared with LearnerGuard
        if slot.failures.record(now):
            slot.state = SlotState.DEAD
            slot.child = None
            print(f"supervisor: slot {slot.index} marked dead after "
                  f"{len(slot.failures)} failures in "
                  f"{self.failure_window:.0f}s (circuit breaker); "
                  f"fleet shrinks to {self._unsafe_alive_estimate()}")
            return
        delay = self.policy.delay(len(slot.failures) - 1)
        slot.state = SlotState.BACKOFF
        slot.due = now + delay
        print(f"supervisor: slot {slot.index} down "
              f"(failure {len(slot.failures)}); respawn in {delay:.2f}s")

    def _unsafe_alive_estimate(self) -> int:
        # called with the lock held; avoids is_alive() syscalls
        return sum(1 for s in self._slots.values()
                   if s.state is SlotState.RUNNING)

    def poll(self, now: Optional[float] = None) -> List[Tuple[str, int]]:
        """One supervision tick; returns the events it produced as
        ``(kind, slot_index)`` pairs (kind in ``failure`` / ``respawn``
        / ``dead``)."""
        if now is None:
            now = self.clock()
        events: List[Tuple[str, int]] = []
        with self._lock:
            if self.stopped:
                return events
            slots = list(self._slots.values())
            for slot in slots:
                if slot.state is SlotState.RUNNING:
                    if slot.child is None or not slot.child.is_alive():
                        clean = (
                            self.treat_clean_exit_as_drain
                            and slot.child is not None
                            and getattr(slot.child, "exitcode", None) == 0)
                        slot.child = None
                        if clean:
                            slot.state = SlotState.STOPPED
                            print(f"supervisor: slot {slot.index} "
                                  f"drained (clean exit)")
                            events.append(("stopped", slot.index))
                            continue
                        self._record_failure(slot, now)
                        events.append(
                            ("dead" if slot.state is SlotState.DEAD
                             else "failure", slot.index))
                if (slot.state is SlotState.BACKOFF and now >= slot.due
                        and now >= self._hold_until):
                    first = slot.respawns == 0 and not slot.failures
                    try:
                        slot.child = self.spawn(slot.index)
                    except OSError as exc:
                        print(f"supervisor: spawn of slot {slot.index} "
                              f"failed ({exc!r})")
                        self._record_failure(slot, now)
                        events.append(
                            ("dead" if slot.state is SlotState.DEAD
                             else "failure", slot.index))
                        continue
                    slot.state = SlotState.RUNNING
                    if not first:
                        slot.respawns += 1
                        print(f"supervisor: respawned slot {slot.index} "
                              f"(respawn #{slot.respawns})")
                        events.append(("respawn", slot.index))
        return events
