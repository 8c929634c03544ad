"""Fault tolerance for the actor fleet, the learner and the control plane.

The counterpart of ``handyrl_tpu.resilience``, kept as the port's own
copy (plain Python, no framework):

  * :mod:`.supervisor` — child-process supervision: detect exits and
    missed heartbeats, respawn with jittered exponential backoff, and
    circuit-break a slot that keeps dying.
  * :mod:`.health` — the learner-side :class:`FleetRegistry`:
    per-gather last-seen / episode-rate / staleness bookkeeping behind
    the ``fleet_size`` / ``respawns`` / ``heartbeat_misses`` metrics.
  * :mod:`.chaos` — fault injection: kill gathers at configured
    rates/points, delay/drop/truncate control-plane frames, SIGKILL the
    learner itself (:class:`LearnerKillSwitch`), and fault the shm
    pipeline plane (:class:`ChaosRing` / :class:`ChaosBoard`).
  * :mod:`.guardian` — :class:`LearnerGuard` relaunches a crashed
    learner with ``restart_epoch: auto`` behind the same backoff and
    circuit breaker.

Nothing here touches the device.
"""

from .chaos import (
    ChaosBoard,
    ChaosConfig,
    ChaosConnection,
    ChaosMonkey,
    ChaosRing,
    LearnerKillSwitch,
    maybe_chaos_board,
    maybe_chaos_ring,
)
from .guardian import LearnerGuard
from .health import FleetRegistry
from .supervisor import BackoffPolicy, SlotState, Supervisor

__all__ = [
    "BackoffPolicy",
    "ChaosBoard",
    "ChaosConfig",
    "ChaosConnection",
    "ChaosMonkey",
    "ChaosRing",
    "FleetRegistry",
    "LearnerGuard",
    "LearnerKillSwitch",
    "SlotState",
    "Supervisor",
    "maybe_chaos_board",
    "maybe_chaos_ring",
]
