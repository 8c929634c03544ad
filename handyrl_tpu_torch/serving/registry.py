"""Service registry + replica announcer: the pool's bulletin board.

A copy of ``handyrl_tpu.serving.registry`` (stdlib only).

The horizontal half of the serving tier (docs/serving.md "Pool
routing"): N independent learners each run their own SLO-bound
:class:`~.frontend.ServingFrontend`; to present them as ONE endpoint
the router needs a live map of who exists, what they can serve, and
how loaded they are.  This module generalizes two proven patterns:

  * the shm plane's **heartbeat/generation bulletin** (``ShmBoard``:
    a beat cadence plus an incarnation counter, so "silent" and
    "restarted" are distinguishable states) becomes a NETWORK
    bulletin — each replica ships a small advert dict over the
    existing framed-TCP protocol on the router-assigned cadence;
  * the control plane's **FleetRegistry sweep/expiry** (silence past
    ``heartbeat_timeout`` is a counted miss and an eviction) becomes
    the pool's membership rule — a silent replica is EVICTED from
    routing, never routed to and left to black-hole requests.

Advert wire format (one dict per ``register``/``beat`` payload; every
field optional but ``name``/``host``/``port`` — unknown fields ride
along untouched, so replicas can grow the advert without a registry
change):

  ==============  ====================================================
  field           meaning
  ==============  ====================================================
  ``name``        stable replica identity (generation is tracked per
                  name across evictions and re-registrations)
  ``host, port``  the replica frontend's dialable endpoint
  ``capacity``    the replica's ``serving.max_inflight``
  ``inflight``    currently-admitted requests (replica-reported)
  ``p99_ms``      the replica's sliding-window p99 (load signal)
  ``slo_breached``whether the replica is currently shedding on SLO
  ``epochs``      committed snapshot epochs this replica can serve —
                  the pin-routing advert (any replica can serve any
                  committed epoch via its ``model_resolver`` + LRU)
  ==============  ====================================================

:class:`ServiceRegistry` is bookkeeping only — it never touches
sockets or threads, and the clock is injectable so expiry/eviction
tests are exact (the FleetRegistry discipline).
:class:`ReplicaAnnouncer` is the replica-side thread that dials the
router and keeps the advert fresh; it re-registers (bumping the
registry's per-name generation) whenever the router forgot it.
"""

import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..connection import DEFAULT_MAX_FRAME_BYTES, open_socket_connection


class _Replica:
    __slots__ = ("advert", "first_seen", "last_seen", "generation",
                 "draining", "suspect", "inflight", "beats")

    def __init__(self, advert: Dict[str, Any], now: float,
                 generation: int):
        self.advert = dict(advert)
        self.first_seen = now
        self.last_seen = now
        self.generation = generation
        self.draining = False   # graceful goodbye: no new picks, ever
        self.suspect = False    # FailureWindow trip: cleared by a beat
        self.inflight = 0       # router-tracked in-flight forwards
        self.beats = 0


class ServiceRegistry:
    """Who is in the pool, what they advertise, who gets the request.

    Thread contract: every method takes the one internal lock; callers
    (the router's accept loop, its per-connection handlers, the status
    endpoint) never hold it across a network call — ``pick`` returns a
    name, and forwarding happens outside.
    """

    def __init__(self, heartbeat_timeout: float = 6.0,
                 clock: Callable[[], float] = time.monotonic):
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.clock = clock
        self._replicas: Dict[str, _Replica] = {}
        # generation memory survives eviction: a respawned replica
        # re-registering under its stable name gets a BUMPED number,
        # so "rejoined after a death" is observable (the ShmBoard /
        # frontend incarnation discipline, pool-wide)
        self._generations: Dict[str, int] = {}
        self.evictions = 0       # cumulative sweep expiries
        self.registrations = 0   # cumulative register calls
        self._lock = threading.Lock()

    # -- membership ---------------------------------------------------
    def register(self, name: str, advert: Dict[str, Any],
                 now: Optional[float] = None) -> int:
        """(Re-)register a replica; returns its assigned generation
        (0 on first sight of this name, +1 per re-registration)."""
        if now is None:
            now = self.clock()
        with self._lock:
            gen = self._generations.get(name)
            gen = 0 if gen is None else gen + 1
            self._generations[name] = gen
            self._replicas[name] = _Replica(advert, now, gen)
            self.registrations += 1
            return gen

    def beat(self, name: str, advert: Dict[str, Any],
             now: Optional[float] = None) -> bool:
        """Refresh a replica's advert; False when the name is unknown
        (evicted or never registered) — the sender must re-register.
        A suspect replica that beats has recovered (the FleetRegistry
        stale-peer-that-speaks rule); a DRAINING one stays draining —
        the goodbye was explicit, only a re-register undoes it."""
        if now is None:
            now = self.clock()
        with self._lock:
            rec = self._replicas.get(name)
            if rec is None:
                return False
            rec.last_seen = now
            rec.beats += 1
            rec.suspect = False
            rec.advert = dict(advert)
            return True

    def drain(self, name: str, suspect: bool = False):
        """Exclude a replica from new picks.  ``suspect=True`` is the
        router's FailureWindow verdict (recoverable: the next beat
        clears it); default is the replica's own graceful goodbye —
        in-flight forwards complete, nothing new routes there."""
        with self._lock:
            rec = self._replicas.get(name)
            if rec is None:
                return
            if suspect:
                rec.suspect = True
            else:
                rec.draining = True

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """Evict replicas silent past ``heartbeat_timeout``; returns
        the newly evicted names.  Eviction is full removal — a dead
        host must not linger as a routable entry — but its generation
        memory survives for the respawn bump."""
        if now is None:
            now = self.clock()
        evicted = []
        with self._lock:
            for name, rec in list(self._replicas.items()):
                if now - rec.last_seen > self.heartbeat_timeout:
                    del self._replicas[name]
                    self.evictions += 1
                    evicted.append(name)
        return evicted

    def note_inflight(self, name: str, delta: int):
        """Router-side in-flight accounting per replica (the load
        signal between heartbeats — adverts lag by up to a cadence)."""
        with self._lock:
            rec = self._replicas.get(name)
            if rec is not None:
                rec.inflight = max(0, rec.inflight + delta)

    # -- routing ------------------------------------------------------
    @staticmethod
    def _advertises(rec: _Replica, pin: int) -> bool:
        epochs = rec.advert.get("epochs") or ()
        try:
            return int(pin) in {int(e) for e in epochs}
        except (TypeError, ValueError):
            return False

    def _routable(self, now: float) -> List[Tuple[str, _Replica]]:
        # called with the lock held: live, not draining, not suspect
        return [(name, rec) for name, rec in self._replicas.items()
                if now - rec.last_seen <= self.heartbeat_timeout
                and not rec.draining and not rec.suspect]

    def pick(self, seat: Any = None, pin: Optional[int] = None,
             exclude: Optional[set] = None,
             policy: str = "least_loaded",
             now: Optional[float] = None) -> Optional[str]:
        """One routing decision; None when nothing qualifies.

        * ``pin`` restricts candidates to replicas ADVERTISING that
          snapshot epoch — a pin re-routes on eviction instead of
          dying, because any replica that committed the epoch serves
          it through its resolver;
        * ``policy='hash'`` with a ``seat`` uses rendezvous hashing
          (highest-random-weight), so a seat keeps its replica across
          UNRELATED pool changes and only seats of a removed replica
          remap;
        * least-loaded scores ``(inflight + 1) * max(p99_ms, 1)`` —
          both the router's own in-flight view and the advertised
          load/latency spread traffic away from a hot replica.
        """
        if now is None:
            now = self.clock()
        with self._lock:
            cands = self._routable(now)
            if exclude:
                cands = [(n, r) for n, r in cands if n not in exclude]
            if pin is not None:
                cands = [(n, r) for n, r in cands
                         if self._advertises(r, pin)]
            if not cands:
                return None
            if policy == "hash" and seat is not None:
                def weight(item):
                    name = item[0]
                    digest = hashlib.md5(
                        f"{name}|{seat}".encode()).hexdigest()
                    return (int(digest, 16), name)
                return max(cands, key=weight)[0]

            def score(item):
                name, rec = item
                inflight = rec.inflight + int(
                    rec.advert.get("inflight", 0) or 0)
                p99 = float(rec.advert.get("p99_ms", 0.0) or 0.0)
                return ((inflight + 1) * max(p99, 1.0), name)
            return min(cands, key=score)[0]

    def endpoint(self, name: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            rec = self._replicas.get(name)
            if rec is None:
                return None
            host = rec.advert.get("host") or "127.0.0.1"
            try:
                return str(host), int(rec.advert.get("port", 0))
            except (TypeError, ValueError):
                return None

    # -- views --------------------------------------------------------
    def pool_size(self, now: Optional[float] = None) -> int:
        if now is None:
            now = self.clock()
        with self._lock:
            return len(self._routable(now))

    def generation(self, name: str) -> Optional[int]:
        with self._lock:
            rec = self._replicas.get(name)
            return None if rec is None else rec.generation

    def all_breached(self, now: Optional[float] = None) -> bool:
        """True when every routable replica advertises an SLO breach —
        the whole-pool signal behind the router's typed escalation
        (False on an empty pool: that is ``pool_down``, not SLO)."""
        if now is None:
            now = self.clock()
        with self._lock:
            cands = self._routable(now)
            return bool(cands) and all(
                rec.advert.get("slo_breached") for _, rec in cands)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Status-endpoint / healthz view: constant-time bookkeeping
        reads only — NO replica is dialed to answer this."""
        if now is None:
            now = self.clock()
        with self._lock:
            replicas = {}
            for name, rec in self._replicas.items():
                replicas[name] = {
                    "generation": rec.generation,
                    "age_sec": round(now - rec.last_seen, 3),
                    "draining": rec.draining,
                    "suspect": rec.suspect,
                    "inflight": rec.inflight,
                    "beats": rec.beats,
                    "advert": dict(rec.advert),
                }
            return {
                "pool_size": len(self._routable(now)),
                "heartbeat_timeout": self.heartbeat_timeout,
                "evictions": self.evictions,
                "registrations": self.registrations,
                "replicas": replicas,
            }


class ReplicaAnnouncer:
    """The replica-side heartbeat thread: dials the router, registers,
    then beats the advert on the router-assigned cadence.

    ``advert_fn`` is called on the announcer thread per message and
    must be cheap and thread-safe (the frontend's ``advert()`` reads
    under its own lock).  A dead router (or an eviction: the router
    answers a beat with an error) tears the connection down and the
    loop re-registers behind ``retry_interval`` — each re-register
    bumps the registry's per-name generation, which is exactly how a
    respawn is observed pool-wide.  ``kill()`` is the chaos hook: the
    announcer goes silent WITHOUT a goodbye, the way a crashed host
    does, so the sweep eviction path gets exercised; ``close()`` sends
    the graceful ``drain`` verb so in-flight traffic finishes while
    nothing new routes here.
    """

    def __init__(self, address: str, port: int, name: str,
                 advert_fn: Callable[[], Dict[str, Any]],
                 interval: float = 2.0, retry_interval: float = 1.0,
                 reply_timeout: float = 3.0, max_frame_bytes: int = 0):
        self.address = address
        self.port = int(port)
        self.name = name
        self.advert_fn = advert_fn
        self.interval = float(interval)
        self.retry_interval = float(retry_interval)
        self.reply_timeout = float(reply_timeout)
        self.max_frame_bytes = int(max_frame_bytes
                                   or DEFAULT_MAX_FRAME_BYTES)
        self.generation: Optional[int] = None  # router-assigned
        self.registrations = 0
        self._conn = None
        # guards the _conn swap: _sever runs on BOTH the announcer
        # thread (loop errors) and the owner (close/kill), and the two
        # must not interleave the read-modify-write
        self._conn_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _payload(self) -> Dict[str, Any]:
        return {"name": self.name, **(self.advert_fn() or {})}

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serve-announce")
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _sever(self):
        with self._conn_lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _run(self):
        while not self._stop.is_set():
            try:
                if self._conn is None:
                    self._conn = open_socket_connection(
                        self.address, self.port,
                        max_frame_bytes=self.max_frame_bytes)
                    # bounded round trips: the deadline turns a dead
                    # router into a timeout, never a parked announcer
                    self._conn.sock.settimeout(self.reply_timeout)
                    self._conn.send(("register", self._payload()))
                    ack = self._conn.recv()
                    if not (isinstance(ack, dict)
                            and ack.get("status") == "ok"):
                        raise ConnectionError(
                            f"register rejected: {ack!r}")
                    # the router owns the cadence: one beat rate for
                    # the whole pool, assigned in the register ack
                    self.interval = float(
                        ack.get("heartbeat_interval", self.interval))
                    self.generation = ack.get("generation")
                    self.registrations += 1
                if self._stop.wait(self.interval):
                    break
                self._conn.send(("beat", self._payload()))
                ack = self._conn.recv()
                if not (isinstance(ack, dict)
                        and ack.get("status") == "ok"):
                    # evicted while we thought we were registered (a
                    # long GC pause, a router restart): re-register
                    raise ConnectionError(f"beat rejected: {ack!r}")
            except Exception:
                self._sever()
                if self._stop.wait(self.retry_interval):
                    break
        self._sever()

    def drain(self):
        """Best-effort graceful goodbye (fire-and-forget, like the
        battle plane's ``quit``): the router stops picking this
        replica while its in-flight forwards complete."""
        conn = self._conn
        try:
            if conn is None:
                conn = open_socket_connection(
                    self.address, self.port,
                    max_frame_bytes=self.max_frame_bytes)
            conn.send(("drain", {"name": self.name}))
        except Exception:
            pass  # a gone router needs no goodbye
        finally:
            if conn is not None and conn is not self._conn:
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self, drain: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if drain:
            self.drain()
        self._sever()

    def kill(self):
        """Chaos: go silent with no goodbye — the router must learn of
        the death from the missing heartbeats (sweep eviction), not
        from a courtesy the crashed host never sends."""
        self._stop.set()
        self._sever()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def respawn(self):
        """Relaunch after a kill: the fresh loop re-registers under
        the same name, so the registry's generation bump is the
        pool-visible proof of the respawn."""
        if self._thread is not None and self._thread.is_alive():
            return
        self.start()


__all__ = ["ServiceRegistry", "ReplicaAnnouncer"]
