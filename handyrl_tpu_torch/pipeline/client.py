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
The chaos-driven surge brownout comes with the resilience item.
"""

import time
from collections import Counter

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
    from .config import PipelineConfig

    cfg = PipelineConfig.from_config(args.get("pipeline") or {})
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
        return PipelineClient(desc, cfg)
    except (FileNotFoundError, OSError, ValueError) as exc:
        print(f"pipeline attach failed ({exc!r}); "
              "falling back to local inference")
        return None


class PipelineClient:
    """One worker's mapped endpoint of the shm transport."""

    DEGRADE_AFTER = 3  # consecutive reply timeouts before giving up

    def __init__(self, desc, cfg, clock=time.monotonic, sleep=time.sleep):
        self.cfg = cfg
        self.clock = clock
        self.sleep = sleep
        self.client_id = desc["client"]
        self.board = ShmBoard.attach(desc["board"])
        self.req = ShmRing.attach(**desc["req"])
        self.rsp = ShmRing.attach(**desc["rsp"])
        self.traj = ShmRing.attach(**desc["traj"])
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
