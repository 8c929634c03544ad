"""Network-facing serving frontend over the pipeline inference core.

A copy of ``handyrl_tpu.serving.frontend`` whose feed is the port's
``pipeline.InferenceService``: the SLO-bound serving tier
(docs/serving.md), a framed-protocol TCP acceptor (the same
4-byte-length + pickle wire format as the evaluation stack's
``NetworkAgent``/``WorkerServer`` plumbing) whose handler threads feed
remote inference requests into the service's batching window
**alongside the shm traffic** — one bucket-padded forward on the card
covers a remote client's rows and a colocated worker's rows together
(SEED-style batching across actors).

Protocol (one request/reply round trip per frame, per connection;
clients open several connections to pipeline — the batching window is
what aggregates across them):

  =========  =====================================  ==================
  request    payload                                reply (a dict)
  =========  =====================================  ==================
  ``infer``  ``{"obs": <row-batched obs tree>,      ``{"status": "ok",
             "epoch": int|None}``                   "epoch", "outputs"}``
                                                    / ``{"status":
                                                    "shed"|"error",
                                                    "reason"}``
  ``stats``  ``None``                               ``{"status": "ok",
                                                    ...counters}``
  =========  =====================================  ==================

  Replies are bare payload dicts, not verb tuples — the same shape as
  every other request/reply plane here (job args, model blobs, acks).

What makes it a *server* rather than a socket:

  * **SLO machinery** — every completed request lands in a mergeable
    log2 :class:`~..telemetry.histogram.LatencyHistogram` (p50/p99/max
    per epoch in metrics.jsonl, cumulative on the status endpoint)
    plus an exact sliding window that drives admission;
  * **admission control / load-shedding** — arrivals are shed with a
    TYPED ``{"status": "shed", "reason": ...}`` reply (counted, never
    silently dropped) when the window p99 breaches ``serving.slo_ms`` (reason
    ``slo``; a configurable trickle keeps flowing so recovery is
    observable), when admitted requests exceed
    ``serving.max_inflight`` (``overload``), or when the inference
    service is down (``service_down``);
  * **multi-model routing** — an ``epoch``-pinned request resolves to
    that exact snapshot through the service's ``model_resolver``
    (league/opponent-pool snapshots as first-class serving targets); a
    pin nothing can resolve answers a typed error;
  * **supervision** — the learner's server loop respawns a dead
    acceptor behind the fleet's backoff + FailureWindow breaker
    (``Learner._serving_tick``), and ``inject_kill`` is the chaos
    drill's hook: the acceptor dies mid-load exactly like a crashed
    process (connections severed, no goodbye).

Reconciliation invariant (the chaos drill's proof of no silent loss):
``submitted == ok + shed + errors`` at all times.
"""

import socket
import threading
import time

import numpy as np

from .. import telemetry
from ..connection import DEFAULT_MAX_FRAME_BYTES, FramedConnection
from ..telemetry.histogram import LatencyHistogram
from ..utils.tree import tree_leaves, tree_structure

_PEER_GONE = (ConnectionResetError, BrokenPipeError, EOFError, OSError)


class _NetSeat:
    """Network-plane twin of the service's shm ``_Client``: carries
    the obs schema for in-dispatch unflatten and delivers each reply
    by waking the handler thread that parked on it."""

    def __init__(self, cid, example):
        self.cid = cid
        self.example = example
        self.treedef = tree_structure(example)  # the service unflattens
        self.drop_warned = False
        self._lock = threading.Lock()
        self._waiters = {}        # seq -> [event, epoch, outputs]
        self._seq = 0

    def register(self):
        with self._lock:
            self._seq += 1
            slot = [threading.Event(), None, None]
            self._waiters[self._seq] = slot
            return self._seq, slot

    def forget(self, seq):
        with self._lock:
            self._waiters.pop(seq, None)

    def deliver(self, seq, epoch, outputs) -> bool:
        """Service-side reply path (runs on the service thread)."""
        with self._lock:
            slot = self._waiters.pop(seq, None)
        if slot is None:
            return True  # the waiter already timed out; nothing leaks
        slot[1] = epoch
        slot[2] = outputs
        slot[0].set()
        return True


class ServingFrontend:
    """One learner's network serving frontend (see module docstring).

    Thread contract: ``start``/``respawn``/``close``/``inject_kill``
    and the stats readers belong to the learner's server thread; the
    accept loop and per-connection handlers run on their own daemon
    threads; ``_NetSeat.deliver`` runs on the inference service's
    thread.  ``clock`` is injectable so latency/QPS accounting is
    unit-testable without wall time.
    """

    ACCEPT_TIMEOUT = 0.5   # accept-loop shutdown poll, seconds
    CONN_TIMEOUT = 1.0     # per-connection recv poll, seconds
    ROWS_CAP_X = 4         # request rows cap, in units of max_batch

    def __init__(self, service, env, cfg, clock=time.monotonic,
                 max_frame_bytes=0):
        self.service = service
        self.cfg = cfg
        self.clock = clock
        self.max_frame_bytes = int(max_frame_bytes
                                   or DEFAULT_MAX_FRAME_BYTES)
        # the obs schema every request must match (the env the learner
        # trains/serves); built once, validated per request
        env.reset()
        obs = env.observation(env.players()[0])
        self.example = obs
        self.leaf_specs = [
            (tuple(np.asarray(a).shape), str(np.asarray(a).dtype))
            for a in tree_leaves(obs)]
        self._lock = threading.Lock()
        self._listener = None
        self._accept_thread = None
        self._stop = False
        self._kill = False
        self._conns = set()
        self._next_cid = 0
        self.port = 0
        self.generation = 0         # acceptor incarnations (respawns)
        # -- SLO state --
        self.hist = LatencyHistogram()        # cumulative
        self._hist_epoch = LatencyHistogram()
        from collections import deque

        self._window = deque(maxlen=int(cfg.slo_window))
        self._breached = False
        self._breach_tick = 0
        self.conns_refused = 0      # connects past max_connections
        # -- reconciliation counters (submitted == ok+shed+errors) --
        self.submitted = 0
        self.ok = 0
        self.errors = 0
        self.shed = 0
        self.shed_by = {}           # reason -> count
        self.inflight = 0
        self._epoch_counts = {"submitted": 0, "ok": 0, "shed": 0,
                              "errors": 0}
        self._epoch_t = clock()

    # -- lifecycle -----------------------------------------------------
    def _ensure_listener(self):
        if self._listener is not None:
            return
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind(("", int(self.cfg.port)))
        server.listen(128)
        self._listener = server
        self.port = server.getsockname()[1]

    def start(self):
        self._stop = False
        self._kill = False
        self._ensure_listener()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="serve-frontend")
        self._accept_thread.start()
        print(f"serving frontend on :{self.port}")

    @property
    def alive(self):
        return (self._accept_thread is not None
                and self._accept_thread.is_alive())

    def inject_kill(self):
        """Chaos: the acceptor dies mid-load exactly like a crashed
        frontend process — live connections sever without a goodbye,
        the listener closes, in-flight handlers die at their next
        poll.  The learner's serving tick observes the dead thread and
        respawns behind the FailureWindow breaker."""
        self._kill = True
        self._teardown_sockets()

    def respawn(self):
        """Relaunch after a death.  Whatever the old incarnation left
        behind is torn down first (an acceptor that died from an
        exception — not inject_kill — still holds its bound listener,
        which must close before a fixed ``serving.port`` can rebind),
        then the listener rebinds (port 0 picks a fresh ephemeral one)
        and clients reconnect — requests queued in the inference
        service meanwhile were answered or timed out, never silently
        lost."""
        self._teardown_sockets()
        self.generation += 1
        self.start()

    def close(self):
        self._stop = True
        self._teardown_sockets()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def _teardown_sockets(self):
        with self._lock:
            listener, self._listener = self._listener, None
            conns, self._conns = list(self._conns), set()
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    # -- accept + per-connection loops ---------------------------------
    def _accept_loop(self):
        self._warm_service()
        listener = self._listener
        if listener is None:
            return
        listener.settimeout(self.ACCEPT_TIMEOUT)
        while not (self._stop or self._kill):
            try:
                sock, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed under us (kill/close)
            with self._lock:
                full = len(self._conns) >= int(self.cfg.max_connections)
                if full:
                    self.conns_refused += 1
            if full:
                # each connection costs a handler thread: a connect
                # sweep past the cap is closed at accept (counted),
                # not allowed to grow unbounded threads next to a
                # training learner
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            conn = FramedConnection(
                sock, max_frame_bytes=self.max_frame_bytes)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="serve-conn").start()

    def _warm_service(self):
        """One zero-obs request through the whole path before the
        first client lands, so the first real request is not the one
        paying the forward's first-call set-up (the shm plane warms at
        attach; the network plane warms here, on its own acceptor
        thread)."""
        seat = _NetSeat("warm", self.example)
        seq, slot = seat.register()
        leaves = [np.zeros((1,) + shape, dtype)
                  for shape, dtype in self.leaf_specs]
        # only when the service is up: a frontend respawning across a
        # dead service must start accepting (and shedding typed
        # service_down) now, not after a warm wait nothing will
        # answer.  The wait itself also polls the service's pulse — a
        # service dying mid-warm must not park the acceptor (unserved
        # listen backlog, alive reading True) for the full deadline
        if self.service.alive and self.service.submit(
                seat, seq, 1, leaves):
            deadline = time.monotonic() + 30.0
            while (not slot[0].wait(0.25) and self.service.alive
                   and time.monotonic() < deadline):
                pass
        seat.forget(seq)

    def _serve_conn(self, conn):
        with self._lock:
            self._conns.add(conn)
            cid = self._next_cid
            self._next_cid += 1
        seat = _NetSeat(f"net-{cid}", self.example)
        try:
            # bounded recv: the socket deadline below turns a silent
            # peer into a periodic timeout so shutdown/kill can
            # interrupt the loop
            conn.sock.settimeout(self.CONN_TIMEOUT)
            while not (self._stop or self._kill):
                try:
                    verb, payload = conn.recv()
                except socket.timeout:
                    continue
                except Exception:
                    # a gone peer, a truncated frame, or garbage bytes
                    # (UnpicklingError / ValueError unpack): costs
                    # exactly this connection, never the frontend
                    break
                if verb == "infer":
                    self._handle_infer(conn, seat, payload)
                elif verb == "stats":
                    conn.send({"status": "ok", **self.stats()})
                else:
                    conn.send({"status": "error",
                               "reason": f"unknown verb {verb!r}"})
        except _PEER_GONE:
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- admission + SLO -----------------------------------------------
    def _admit(self):
        """Shed reason for one arriving request, or None (admitted —
        in which case the inflight slot is RESERVED inside the same
        lock section, so concurrent handlers cannot all pass the cap
        check before any of them counts; the caller must release the
        slot via ``_release`` on every admitted path).  Checks run
        cheapest-first; every shed is counted per reason and answered
        with a typed reply — never a silent drop."""
        if not self.service.alive:
            return "service_down"
        with self._lock:
            if self.inflight >= self.cfg.max_inflight:
                return "overload"
            if self._breached and self.cfg.slo_ms > 0:
                self._breach_tick += 1
                if self._breach_tick % self.cfg.breach_admit_every:
                    return "slo"
            self.inflight += 1
        return None

    def _release(self):
        with self._lock:
            self.inflight -= 1

    def _observe(self, ms):
        """Record one completed request's latency and refresh the SLO
        breach state from the exact sliding window."""
        with self._lock:
            self.hist.observe(ms)
            self._hist_epoch.observe(ms)
            self._window.append(ms)
            if self.cfg.slo_ms > 0 and len(self._window) >= 8:
                srt = sorted(self._window)
                p99 = srt[min(len(srt) - 1, int(0.99 * len(srt)))]
                breached = p99 > self.cfg.slo_ms
                if breached and not self._breached:
                    print(f"serving: p99 {p99:.1f}ms breached the "
                          f"{self.cfg.slo_ms:.1f}ms SLO — shedding "
                          f"(admitting 1 in "
                          f"{self.cfg.breach_admit_every})")
                elif self._breached and not breached:
                    print("serving: p99 back inside the SLO — "
                          "admission restored")
                self._breached = breached

    def _count(self, outcome, reason=None):
        with self._lock:
            if outcome == "ok":
                self.ok += 1
            elif outcome == "shed":
                self.shed += 1
                self.shed_by[reason] = self.shed_by.get(reason, 0) + 1
            else:
                self.errors += 1
            self._epoch_counts[outcome if outcome in
                               ("ok", "shed") else "errors"] += 1

    # -- the request handler -------------------------------------------
    def _coerce(self, payload):
        """(rows, leaves, pin) from one infer payload, validated
        against the serving env's schema; raises on mismatch (a typed
        error upstream — malformed requests must cost the requester,
        never the service thread mid-dispatch)."""
        if not isinstance(payload, dict):
            raise ValueError("payload must be a dict")
        pin = payload.get("epoch")
        if pin is not None:
            pin = int(pin)
        leaves = [np.asarray(a) for a in tree_leaves(payload["obs"])]
        if len(leaves) != len(self.leaf_specs):
            raise ValueError(
                f"expected {len(self.leaf_specs)} observation leaves, "
                f"got {len(leaves)}")
        rows = int(leaves[0].shape[0]) if leaves[0].ndim else 0
        cap = self.ROWS_CAP_X * int(self.service.cfg.max_batch)
        if not 1 <= rows <= cap:
            raise ValueError(f"rows must be in [1, {cap}], got {rows}")
        coerced = []
        for leaf, (shape, dtype) in zip(leaves, self.leaf_specs):
            if tuple(leaf.shape) != (rows,) + shape:
                raise ValueError(
                    f"leaf shape {tuple(leaf.shape)} != "
                    f"{(rows,) + shape}")
            coerced.append(np.ascontiguousarray(leaf, dtype=dtype))
        return rows, coerced, pin

    def _handle_infer(self, conn, seat, payload):
        t0 = self.clock()
        with self._lock:
            self.submitted += 1
            self._epoch_counts["submitted"] += 1
        try:
            rows, leaves, pin = self._coerce(payload)
        except Exception as exc:
            self._count("error")
            conn.send({"status": "error",
                       "reason": f"bad request ({exc!r})"})
            return
        reason = self._admit()
        if reason is not None:
            self._count("shed", reason)
            conn.send({"status": "shed", "reason": reason,
                       "slo_ms": self.cfg.slo_ms})
            return
        span0 = telemetry.span_begin()
        try:
            seq, slot = seat.register()
            if not self.service.submit(seat, seq, rows, leaves,
                                       epoch=pin):
                seat.forget(seq)
                self._count("shed", "service_down")
                conn.send({"status": "shed", "reason": "service_down",
                           "slo_ms": self.cfg.slo_ms})
                return
            if not slot[0].wait(self.cfg.reply_timeout):
                seat.forget(seq)
                self._count("error")
                conn.send({"status": "error",
                           "reason": "inference reply timed out"})
                return
            epoch, outputs = slot[1], slot[2]
            if outputs is None:
                self._count("error")
                conn.send({"status": "error",
                           "reason": f"snapshot {pin} unavailable"})
                return
            ms = (self.clock() - t0) * 1e3
            self._observe(ms)
            self._count("ok")
            telemetry.span_end("serve.request", span0, rows=rows,
                               epoch=epoch, ms=round(ms, 3))
            conn.send({"status": "ok", "epoch": epoch,
                       "outputs": outputs})
        finally:
            self._release()  # the slot _admit reserved

    # -- metrics -------------------------------------------------------
    def epoch_stats(self):
        """Per-epoch reduction for metrics.jsonl; resets the epoch
        accumulators.  Keys are the docs/observability.md contract."""
        now = self.clock()
        with self._lock:
            counts = dict(self._epoch_counts)
            hist = self._hist_epoch
            self._epoch_counts = {"submitted": 0, "ok": 0, "shed": 0,
                                  "errors": 0}
            self._hist_epoch = LatencyHistogram()
            dt = max(1e-9, now - self._epoch_t)
            self._epoch_t = now
        out = {
            "serve_requests": counts["submitted"],
            "serve_ok": counts["ok"],
            "serve_shed": counts["shed"],
            "serve_errors": counts["errors"],
            "serve_qps": round(counts["submitted"] / dt, 2),
        }
        if hist.count:
            out["serve_p50_ms"] = round(hist.p50, 3)
            out["serve_p99_ms"] = round(hist.p99, 3)
            out["serve_max_ms"] = round(hist.max_ms, 3)
        return out

    def advert(self, epochs=()):
        """This replica's registry advertisement (the pool-router wire
        format, docs/serving.md "Pool routing"): capacity and load for
        the least-loaded spread, the sliding-window p99 + breach flag
        for pool-level SLO escalation, and the committed ``epochs``
        this replica can serve pinned requests for (the caller supplies
        them — the checkpoint manifest is learner state, not frontend
        state)."""
        with self._lock:
            if self._window:
                srt = sorted(self._window)
                p99 = srt[min(len(srt) - 1, int(0.99 * len(srt)))]
            else:
                p99 = 0.0
            return {
                "port": self.port,
                "capacity": int(self.cfg.max_inflight),
                "inflight": self.inflight,
                "p99_ms": round(p99, 3),
                "slo_breached": self._breached,
                "generation": self.generation,
                "epochs": sorted(int(e) for e in epochs),
            }

    def stats(self):
        """Cumulative snapshot (status endpoint + the ``stats`` verb).
        Every count is monotone; ``submitted == ok + shed + errors``
        is the reconciliation invariant the chaos drill checks."""
        with self._lock:
            return {
                "port": self.port,
                "alive": self.alive,
                "generation": self.generation,
                "connections": len(self._conns),
                "connections_refused": self.conns_refused,
                "submitted": self.submitted,
                "ok": self.ok,
                "shed": self.shed,
                "shed_by": dict(self.shed_by),
                "errors": self.errors,
                "inflight": self.inflight,
                "slo_breached": self._breached,
                "latency": self.hist.summary(prefix="serve_"),
            }
