"""Client SDK for the network serving frontend.

A copy of ``handyrl_tpu.serving.client``: the wire protocol is the
JAX package's, so this client talks to either package's frontend or
router, and theirs to ours.

``ServeClient`` speaks the framed serving protocol (docs/serving.md)
over one TCP connection: one blocking ``infer`` round trip at a time —
throughput comes from the SERVER batching across many connections
(open several clients to pipeline), not from per-connection
multiplexing, which keeps the protocol trivially debuggable and the
failure model per-request.

Typed outcomes: a shed request raises :class:`ShedError` (admission
control spoke — back off or retry elsewhere), a serving failure raises
:class:`ServeError` (bad request, unroutable snapshot pin, reply
timeout); both carry the frontend's reason payload.  Transport-level
failures raise the usual ``ConnectionError``/``socket.timeout``.

A serving client is a plain consumer process: numpy and the stdlib.
"""

import numpy as np

from ..connection import DEFAULT_MAX_FRAME_BYTES, open_socket_connection
from ..utils.tree import tree_map_leaves


class ShedError(RuntimeError):
    """The frontend shed this request (typed admission reply)."""

    def __init__(self, info):
        super().__init__(f"request shed: {info.get('reason')}")
        self.info = info
        self.reason = info.get("reason")


class ServeError(RuntimeError):
    """The frontend answered a typed error for this request."""

    def __init__(self, info):
        super().__init__(f"serving error: {info.get('reason')}")
        self.info = info
        self.reason = info.get("reason")


class ServeClient:
    """One framed connection to a serving frontend."""

    def __init__(self, address, port, timeout=10.0,
                 max_frame_bytes=DEFAULT_MAX_FRAME_BYTES):
        self.timeout = float(timeout)
        self.conn = open_socket_connection(
            address, int(port), max_frame_bytes=max_frame_bytes)

    def _call(self, verb, payload):
        # per-request deadline: a dead/wedged server raises
        # socket.timeout out of the recv instead of parking this
        # client forever (the settimeout is what bounds the recv)
        self.conn.sock.settimeout(self.timeout)
        self.conn.send((verb, payload))
        reply = self.conn.recv()
        status = reply.get("status") if isinstance(reply, dict) else None
        if status == "ok":
            return reply
        if status == "shed":
            raise ShedError(reply)
        if status == "error":
            raise ServeError(reply)
        raise ServeError({"reason": f"malformed reply {reply!r}"})

    def infer_batch(self, obs_batch, epoch=None, seat=None):
        """Row-batched forward: ``obs_batch`` is an observation tree
        with a leading row dimension on every leaf.  Returns
        ``{"epoch": served_epoch, "outputs": {...row-batched...}}``
        (the reply's payload fields, status stripped).
        ``epoch`` pins the request to that exact snapshot (multi-model
        routing); None serves the live model.  ``seat`` is an opaque
        affinity key: a pool router with ``router.policy: hash`` sends
        every request carrying the same seat to the same replica (a
        single frontend ignores it)."""
        payload = {"obs": obs_batch, "epoch": epoch}
        if seat is not None:
            payload["seat"] = seat
        reply = self._call("infer", payload)
        return {"epoch": reply["epoch"], "outputs": reply["outputs"]}

    def infer(self, obs, epoch=None):
        """Single-observation forward (row dim added/stripped here)."""
        batched = tree_map_leaves(lambda a: np.asarray(a)[None], obs)
        reply = self.infer_batch(batched, epoch=epoch)
        return {
            "epoch": reply["epoch"],
            "outputs": {k: np.asarray(v)[0]
                        for k, v in reply["outputs"].items()},
        }

    def stats(self):
        """The frontend's cumulative counters (reconciliation,
        latency summary, shed reasons)."""
        return self._call("stats", None)

    def close(self):
        try:
            self.conn.close()
        except OSError:
            pass


__all__ = ["ServeClient", "ShedError", "ServeError"]
