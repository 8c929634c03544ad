"""Worker-side pipeline client: served inference + trajectory shipping.

The counterpart of ``handyrl_tpu.pipeline.client``.  A worker maps the
three rings the inference service allocated for it (the attach
descriptor of :meth:`InferenceService.attach`) and wraps its local
model in a :class:`ServedModel`: the same ``inference`` /
``inference_batch`` / ``init_hidden`` duck type the rollout engines
consume, answered from the service's batched forward.

The wrapped local model stays warm as the **fallback**: a stale service
heartbeat, a full ring, or a reply deadline sends the call to the
worker's own forward (``pipeline.fallback: local``) instead of stalling
the env loop.  Every such call is counted in ``fallbacks``, and every
row the local model answers, for whatever reason, in ``local_rows``,
so a run can show that the service did the work.

Recurrent models are never wrapped: their hidden state lives on the
worker.  A training worker finds the service with
:func:`attach_pipeline`, a handshake over the learner's control plane.

The client owns the worker side of the chaos drills: with ``chaos``
shm faults armed its three ring endpoints are wrapped in
:class:`~..resilience.chaos.ChaosRing` (seeded as in the JAX package),
and ``chaos.surge_hold_uploads`` browns out its episode shipping
(:meth:`PipelineClient.ship_episode`).
"""

import random
import time
from collections import Counter, deque

import numpy as np

from ..utils.tree import tree_leaves
from .shm import ShmBoard, ShmRing, dumps, loads_view, pack_request


def build_obs_spec(env, rows_max):
    """The handshake payload: leaf schema + a structure example of this
    env's observation, plus the worst-case row count (lockstep
    episodes x players)."""
    env.reset()
    obs = env.observation(env.players()[0])
    leaves = [np.asarray(a) for a in tree_leaves(obs)]
    return {
        "leaves": [(tuple(a.shape), str(a.dtype)) for a in leaves],
        "example": obs,
        "rows_max": int(rows_max),
    }


def attach_pipeline(conn, env, args):
    """The shm handshake over the control plane (verb ``"shm"``,
    forwarded by the gather): send this worker's observation schema;
    the learner's inference service allocates the rings and replies
    with an attach descriptor.  Returns a :class:`PipelineClient`, or
    None — pipeline off, the learner refused (shutting down), or the
    rings could not be mapped — and the worker keeps local inference."""
    from ..connection import send_recv
    from ..resilience.chaos import ChaosConfig
    from .config import PipelineConfig

    cfg = PipelineConfig.from_config(args.get("pipeline") or {})
    chaos = ChaosConfig.from_config(args.get("chaos") or {})
    if not cfg.enabled:
        return None
    lockstep = int(args.get("lockstep_episodes", 1) or 1)
    rows_max = max(1, lockstep) * len(env.players())
    try:
        desc = send_recv(conn, ("shm", build_obs_spec(env, rows_max)))
    except (ConnectionError, EOFError, OSError):
        return None
    if not desc:
        return None
    try:
        return PipelineClient(desc, cfg, chaos=chaos)
    except (FileNotFoundError, OSError, ValueError) as exc:
        print(f"pipeline attach failed ({exc!r}); "
              "falling back to local inference")
        return None


class PipelineClient:
    """One worker's mapped endpoint of the shm transport.

    Beyond the request/reply round trip, the client owns the worker
    side of the SURGE BROWNOUT (``chaos.surge_hold_uploads`` browns out
    shm-shipped episodes as the gather holds its control-plane
    uploads): when the job stream (:meth:`note_jobs`) first carries a
    model id at or past ``chaos.surge_epoch``, :meth:`ship_episode`
    stages finished episodes in a bounded FIFO backlog
    (``pipeline.traj_slots``) for the hold window instead of the
    trajectory ring; overflow spills to the control plane (stamped
    ``shm_spilled``, counted, never dropped), and the drain after the
    hold is paced, a small block per shipped episode.  Episodes shipped
    while a backlog remains carry its depth (``upload_backlog``)."""

    DEGRADE_AFTER = 3  # consecutive reply timeouts before giving up
    DRAIN_BLOCK = 2    # backlog items drained per shipped episode

    def __init__(self, desc, cfg, clock=time.monotonic, sleep=time.sleep,
                 chaos=None):
        from ..resilience.chaos import maybe_chaos_ring

        self.cfg = cfg
        self.clock = clock
        self.sleep = sleep
        self.client_id = desc["client"]
        self.board = ShmBoard.attach(desc["board"])
        self.req = ShmRing.attach(**desc["req"])
        self.rsp = ShmRing.attach(**desc["rsp"])
        self.traj = ShmRing.attach(**desc["traj"])
        if chaos is not None and chaos.shm_faults_enabled:
            # this endpoint produces on req/traj and consumes rsp: the
            # wrappers arm exactly the faults its role can express, from
            # one RNG seeded as the JAX client seeds it
            rng = random.Random((chaos.seed << 20) ^ 0x5AD0
                                ^ int(self.client_id))
            self.req = maybe_chaos_ring(self.req, chaos, rng=rng)
            self.rsp = maybe_chaos_ring(self.rsp, chaos, rng=rng)
            self.traj = maybe_chaos_ring(self.traj, chaos, rng=rng)
        # surge brownout: armed from the chaos config, triggered by the
        # job stream (note_jobs)
        self._surge_epoch = chaos.surge_epoch if chaos else 0
        self._surge_hold = chaos.surge_hold_uploads if chaos else 0.0
        self._surge_pending = (chaos is not None and chaos.surges_enabled
                               and self._surge_hold > 0)
        self._hold_until = 0.0
        self.backlog = deque()
        self.backlog_cap = int(cfg.traj_slots)
        self.episodes_held = 0     # episodes staged by a hold
        self.seq = 0
        self.fallbacks = 0         # served calls answered locally
        self.fallback_causes = Counter()  # why, one key per fallback
        self.local_rows = 0        # rows the local model answered
        self.served_rows = 0       # rows the service answered
        self.request_sec = 0.0     # time blocked in request round trips
        self.replies_by_epoch = Counter()
        self.episodes_shipped = 0
        self.episodes_spilled = 0  # refused by the trajectory ring
        self._served = {}          # (id(model), epoch) -> ServedModel
        # self-degradation: a service that BEATS but never lands our
        # replies must not cost the env loop a full reply deadline per
        # step forever — after a few consecutive reply timeouts this
        # client stops trying until the service's next incarnation
        self.degraded = False
        self._timeouts = 0
        self._degraded_gen = -1

    def healthy(self):
        return self.board.age() < self.cfg.fallback_after

    def usable(self):
        """Healthy AND not self-degraded.  A new service incarnation
        (the board generation moves) clears the degradation."""
        if self.degraded:
            if self.board.generation == self._degraded_gen:
                return False
            self.degraded = False
            self._timeouts = 0
        return self.healthy()

    def serving_epoch(self):
        """The snapshot epoch the service currently holds."""
        return self.board.epoch

    def wrap(self, model, epoch):
        """A stable ServedModel per underlying model instance, pinned
        to ``epoch``: served only while the service holds that exact
        snapshot, answered locally otherwise."""
        key = (id(model), int(epoch))
        wrapper = self._served.get(key)
        if wrapper is None or wrapper.local is not model:
            wrapper = ServedModel(model, self, epoch)
            self._served[key] = wrapper
            while len(self._served) > 6:
                self._served.pop(next(iter(self._served)))
        return wrapper

    # -- obs -> action round trip -------------------------------------
    def request(self, leaves):
        """Ship one batch of obs rows; block (bounded) for the reply.
        Returns ``(epoch, outputs)`` — the snapshot epoch that actually
        answered — or None when the caller must fall back locally
        (counted)."""
        if not self.usable():
            return self._fallback("service unusable")
        rows = int(leaves[0].shape[0])
        self.seq += 1
        parts = pack_request(
            self.seq, rows,
            [np.ascontiguousarray(a) for a in leaves])
        if not self.req.push(parts):
            return self._fallback("request ring full")
        t0 = self.clock()
        try:
            return self._await_reply(t0 + max(
                self.cfg.fallback_after, 4 * self.cfg.batch_window))
        finally:
            self.request_sec += self.clock() - t0

    def _await_reply(self, deadline):
        while True:
            try:
                reply = self.rsp.pop(loads=loads_view)
            except Exception as exc:
                # a corrupt reply frame costs that slot, never the
                # client: skip it loudly and keep waiting
                self.rsp.skip_one()
                print(f"pipeline client {self.client_id}: corrupt "
                      f"reply slot skipped ({exc!r})")
                continue
            if reply is not None:
                seq, epoch, outputs = reply
                if seq == self.seq:
                    self._timeouts = 0
                    self.replies_by_epoch[epoch] += 1
                    return epoch, outputs
                continue  # stale reply from an abandoned request
            if not self.healthy():
                return self._fallback("service died mid-request")
            if self.clock() > deadline:
                self._timeouts += 1
                if self._timeouts >= self.DEGRADE_AFTER:
                    self.degraded = True
                    self._degraded_gen = self.board.generation
                    print("pipeline client: replies keep timing out "
                          "with a live service; degrading to local "
                          "inference until its next incarnation")
                return self._fallback("reply deadline")
            self.sleep(1e-4)

    def _fallback(self, cause):
        self.fallbacks += 1
        self.fallback_causes[cause] += 1
        return None

    # -- trajectory shipping ------------------------------------------
    def push_episode(self, episode) -> bool:
        """Write one finished episode into the trajectory ring.  False
        (counted) = the caller ships it over the control plane."""
        if self.traj.push(dumps(episode)):
            self.episodes_shipped += 1
            return True
        self.episodes_spilled += 1
        return False

    # -- surge brownout -----------------------------------------------
    def note_jobs(self, jobs):
        """Arm the surge hold when the job stream first carries a model
        id at or past ``chaos.surge_epoch`` (the gather's trigger)."""
        if not self._surge_pending:
            return
        for job in jobs:
            ids = (job or {}).get("model_id") or {}
            if any(v >= self._surge_epoch for v in ids.values()):
                self._surge_pending = False
                self._hold_until = self.clock() + self._surge_hold
                print(f"pipeline client {self.client_id}: surge — "
                      f"holding shm episode shipping for "
                      f"{self._surge_hold:.1f}s")
                return

    def holding(self):
        return self.clock() < self._hold_until

    def _spill_overflow(self, episode):
        """An episode the hold window cannot buffer: stamped and counted
        for the control plane, spilled, never dropped."""
        episode["shm_spilled"] = True
        episode["upload_backlog"] = len(self.backlog)
        self.episodes_spilled += 1
        return episode

    def ship_episode(self, episode):
        """Route one finished episode: the trajectory ring, the surge
        backlog, or the control plane.  Returns the episodes the CALLER
        must ship over the control plane, each stamped ``shm_spilled``:
        empty when everything rode shared memory or was staged."""
        if self.holding():
            self.backlog.append(episode)
            self.episodes_held += 1
            spill = []
            while len(self.backlog) > self.backlog_cap:
                spill.append(self._spill_overflow(self.backlog.popleft()))
            return spill
        # paced FIFO drain: the current episode joins the tail and a
        # small block ships from the head, so a post-hold backlog drains
        # over the next few episodes instead of as one burst
        self.backlog.append(episode)
        spill = []
        budget = min(len(self.backlog), 1 + self.DRAIN_BLOCK)
        while self.backlog and budget > 0:
            budget -= 1
            ep = self.backlog.popleft()
            if self.backlog:
                ep["upload_backlog"] = len(self.backlog)
            if not self.push_episode(ep):  # counted spilled inside
                ep["shm_spilled"] = True
                spill.append(ep)
        return spill

    def flush_backlog(self):
        """Exit drain: everything still held ships NOW, over the ring
        where it fits, else returned for the control plane."""
        self._hold_until = 0.0
        spill = []
        while self.backlog:
            ep = self.backlog.popleft()
            if not self.push_episode(ep):
                ep["shm_spilled"] = True
                spill.append(ep)
        return spill

    def chaos_counts(self):
        """Faults this endpoint's chaos rings injected, summed over its
        three rings (empty when shm chaos is off)."""
        if not hasattr(self.traj, "torn_injected"):
            return {}
        keys = ("torn_injected", "full_injected", "truncated_injected",
                "stalls_injected")
        return {key: sum(getattr(ring, key) for ring in
                         (self.req, self.rsp, self.traj)) for key in keys}

    def close(self):
        self.board.close()
        self.req.close()
        self.rsp.close()
        self.traj.close()


class ServedModel:
    """Model duck type whose forward runs on the inference service.

    ``supports_rows`` lets the RolloutPool ship only the rows that
    actually need inference this step; outputs scatter back into
    N-shaped arrays so the pool's absolute-row indexing is untouched.
    """

    supports_rows = True

    def __init__(self, model, client, epoch):
        self.local = model
        self.client = client
        self.epoch = int(epoch)

    @property
    def is_recurrent(self):
        return self.local.is_recurrent

    def init_hidden(self, batch_shape=None):
        return self.local.init_hidden(batch_shape)

    def _spin_until_healthy(self):
        # pipeline.fallback: none — wait out the gap, BOUNDED: a
        # service that never beats again must not wedge the worker
        deadline = self.client.clock() + max(
            60.0, 10 * self.client.cfg.fallback_after)
        while (not self.client.usable()
               and self.client.clock() < deadline):
            self.client.sleep(1e-3)

    def _served_rows(self, leaves):
        """Rows -> outputs via the service, or None (answer locally).
        A service holding another snapshot than this wrapper's epoch is
        skipped: a pinned seat never acts on a different policy."""
        if self.client.serving_epoch() != self.epoch:
            return None
        result = self.client.request(leaves)
        if result is None and self.client.cfg.fallback == "none":
            self._spin_until_healthy()
            result = self.client.request(leaves)
        if result is None:
            return None
        epoch, outputs = result
        if epoch != self.epoch:
            return None  # swapped mid-flight: the local copy answers
        self.client.served_rows += int(leaves[0].shape[0])
        return outputs

    def _local(self, rows):
        self.client.local_rows += rows

    def inference(self, obs, hidden=None):
        """Single-state forward: one-row served batch, batch dim
        stripped."""
        if hidden is not None:
            self._local(1)
            return self.local.inference(obs, hidden)
        leaves = [np.asarray(a)[None] for a in tree_leaves(obs)]
        outputs = self._served_rows(leaves)
        if outputs is None:
            self._local(1)
            return self.local.inference(obs, None)
        return {k: np.asarray(v)[0] for k, v in outputs.items()}

    def inference_batch(self, obs, hidden=None, rows=None):
        """Batched forward via the service.  ``rows`` (optional int
        array) selects the rows to compute; outputs come back N-shaped
        with zeros elsewhere."""
        leaves = [np.asarray(a) for a in tree_leaves(obs)]
        if hidden is not None:
            self._local(leaves[0].shape[0])
            return self.local.inference_batch(obs, hidden)
        sel = leaves if rows is None else [leaf[rows] for leaf in leaves]
        outputs = self._served_rows(sel)
        if outputs is None:
            self._local(leaves[0].shape[0])
            return self.local.inference_batch(obs, hidden)
        if rows is None:
            return outputs
        n = leaves[0].shape[0]
        full = {}
        for k, v in outputs.items():
            v = np.asarray(v)
            buf = np.zeros((n,) + v.shape[1:], v.dtype)
            buf[rows] = v
            full[k] = buf
        return full
