"""Learner-side fleet health: per-peer last-seen, rates, staleness.

A copy of ``handyrl_tpu.resilience.health`` (plain Python).

Heartbeats are piggybacked on the existing request/reply control
plane: EVERY message a gather sends (job request, model fetch, episode
upload, explicit ``beat``) proves it alive, so the registry just
timestamps each peer on each message.  A gather that has had no reason
to talk for ``heartbeat_interval`` seconds sends an explicit
``("beat", stats)`` — meaning a wedged gather is indistinguishable
from silence, which is exactly the property ``sweep`` exploits: a peer
silent past ``heartbeat_timeout`` is STALE (one counted heartbeat
miss) and gets reported to the supervisor for eviction.

The registry is bookkeeping only — it never touches sockets or
processes.  The clock is injectable so expiry tests are exact.
"""

import threading
import time
from typing import Any, Callable, Dict, List, Optional


class _Peer:
    __slots__ = ("first_seen", "last_seen", "episodes", "beats",
                 "stale", "stats")

    def __init__(self, now: float):
        self.first_seen = now
        self.last_seen = now
        self.episodes = 0
        self.beats = 0
        self.stale = False
        self.stats: Dict[str, Any] = {}


class FleetRegistry:
    """Tracks every control-plane peer the learner has heard from.

    Peers are keyed by connection object (identity is the session:
    a respawned gather arrives on a NEW connection and is a new peer;
    its predecessor goes stale and is eventually forgotten).
    """

    # a peer stale for this many timeouts is forgotten entirely, so
    # unbounded worker churn cannot grow the registry forever
    FORGET_AFTER_TIMEOUTS = 3

    def __init__(self, heartbeat_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.clock = clock
        self.heartbeat_misses = 0  # total stale transitions, cumulative
        self.peak_size = 0
        self._peers: Dict[Any, _Peer] = {}
        self._drops: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- intake ------------------------------------------------------
    def observe(self, peer: Any, verb: Optional[str] = None,
                payload: Any = None, now: Optional[float] = None):
        """Timestamp a peer on any control-plane message; episode
        uploads also feed the rate estimate, explicit beats merge the
        gather's self-reported stats."""
        if now is None:
            now = self.clock()
        with self._lock:
            rec = self._peers.get(peer)
            if rec is None:
                rec = self._peers[peer] = _Peer(now)
            rec.last_seen = now
            rec.stale = False  # a stale peer that speaks has recovered
            if verb == "episode":
                rec.episodes += len(payload) if isinstance(payload, list) \
                    else 1
            elif verb == "beat" and isinstance(payload, dict):
                rec.beats += 1
                rec.stats = dict(payload)

    def pardon(self, now: Optional[float] = None):
        """The LISTENER stalled (e.g. the learner spent seconds inside
        an epoch boundary): silence during that window says nothing
        about the peers, so refresh everyone instead of letting the
        next sweep mass-evict a healthy fleet."""
        if now is None:
            now = self.clock()
        with self._lock:
            for rec in self._peers.values():
                rec.last_seen = now

    def record_drops(self, drops: Dict[str, int]):
        """Latest communicator drop counters (QueueCommunicator
        ``drop_stats``): sends to dead peers and disconnect events."""
        with self._lock:
            self._drops = dict(drops)

    def forget(self, peer: Any):
        with self._lock:
            self._peers.pop(peer, None)

    def peers(self) -> List[Any]:
        with self._lock:
            return list(self._peers)

    # -- queries -----------------------------------------------------
    def _live_count(self, now: float) -> int:
        # called with the lock held
        return sum(1 for p in self._peers.values()
                   if now - p.last_seen <= self.heartbeat_timeout)

    def fleet_size(self, now: Optional[float] = None) -> int:
        if now is None:
            now = self.clock()
        with self._lock:
            return self._live_count(now)

    def sweep(self, now: Optional[float] = None) -> List[Any]:
        """Expire silent peers: returns the NEWLY stale ones (each a
        counted heartbeat miss) so the caller can evict their children;
        peers stale for several timeouts are forgotten entirely."""
        if now is None:
            now = self.clock()
        newly_stale = []
        with self._lock:
            forget_after = self.heartbeat_timeout \
                * self.FORGET_AFTER_TIMEOUTS
            for peer, rec in list(self._peers.items()):
                silent = now - rec.last_seen
                if silent > forget_after:
                    del self._peers[peer]
                elif silent > self.heartbeat_timeout and not rec.stale:
                    rec.stale = True
                    self.heartbeat_misses += 1
                    newly_stale.append(peer)
            # peak updates here, AFTER expiry/forget, not on observe:
            # during a respawn a dead-but-recent peer and its
            # replacement briefly coexist, and a peak latched in that
            # overlap would mislabel the healthy fleet as degraded
            # forever after
            self.peak_size = max(self.peak_size, self._live_count(now))
        return newly_stale

    def _eps_locked(self, now: float) -> float:
        # called with the lock held: one definition of the rate for
        # both the query and the snapshot
        total = 0.0
        for rec in self._peers.values():
            span = max(1e-6, now - rec.first_seen)
            total += rec.episodes / span
        return total

    def episodes_per_sec(self, now: Optional[float] = None) -> float:
        if now is None:
            now = self.clock()
        with self._lock:
            return self._eps_locked(now)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Per-epoch metrics record contribution (metrics.jsonl)."""
        if now is None:
            now = self.clock()
        with self._lock:
            fleet = self._live_count(now)
            # unknown_verbs rides the same drop_stats() dict but is a
            # protocol-skew signal, not a connection drop: surface it
            # as its own metric instead of folding it into conn_drops
            drops = sum(v for k, v in self._drops.items()
                        if k != "unknown_verbs")
            unknown = self._drops.get("unknown_verbs", 0)
            eps = self._eps_locked(now)
            # gather self-reports (best effort: carried by explicit
            # beats, so a gather busy enough to never beat reports 0)
            workers = sum(
                rec.stats.get("workers", 0)
                for rec in self._peers.values()
                if now - rec.last_seen <= self.heartbeat_timeout)
        return {
            "fleet_size": fleet,
            "fleet_workers": workers,
            "heartbeat_misses": self.heartbeat_misses,
            "conn_drops": drops,
            "unknown_verbs": unknown,
            "fleet_eps_per_sec": round(eps, 3),
        }
