"""Control-plane messaging between the learner and its CPU children.

The counterpart of ``handyrl_tpu.connection``: pickle messages between
the learner, its gather processes, their workers and the batcher farm,
over ``multiprocessing`` pipes on one machine and over length-framed
TCP sockets (:class:`FramedConnection`) to remote worker machines.
The wire format is the JAX package's (4-byte big-endian length +
pickle payload), so a worker machine of either package frames alike.
The telemetry trace-context envelope is the JAX package's too:
:class:`TracedConnection` wraps a single-owner connection, and the
:class:`QueueCommunicator` codecs at its queue boundaries; untraced
traffic stays byte-identical on the wire.

Child processes are SPAWNED, not forked: a parent that holds a CUDA
context cannot fork it into a child, so children start from a fresh
interpreter.  They rebuild models from pickled numpy state and run on
the device their caller names (the CPU for workers, batchers and
evaluation children).
"""

import io
import multiprocessing as mp
import multiprocessing.connection  # noqa: F401  (mp.connection.wait)
import pickle
import queue
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Iterable

from .telemetry.spans import unwrap_trace, wrap_trace

CHUNK = 1 << 14  # 16 KiB send granularity

# Ceiling on one control-plane frame: a corrupt 4-byte header must not
# demand a ~4 GiB allocation before the first payload byte arrives.
# Configurable per connection (the ``max_frame_bytes`` config key).
DEFAULT_MAX_FRAME_BYTES = 1 << 30  # 1 GiB


class FrameError(ConnectionError):
    """Corrupt, truncated, or oversized control-plane frame.

    A ``ConnectionError``, so every dead-peer handler treats the peer
    as gone: a byte stream that can no longer be trusted is dead."""


class FramedConnection:
    """Length-prefixed pickle messaging over a stream socket, with the
    duck type of an ``mp.Pipe`` connection (``send``/``recv``/
    ``close``/``fileno``)."""

    def __init__(self, sock: socket.socket,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.sock = sock
        self.max_frame_bytes = int(max_frame_bytes
                                   or DEFAULT_MAX_FRAME_BYTES)

    def fileno(self):
        return self.sock.fileno()

    def close(self):
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def send(self, data: Any):
        payload = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
        buf = memoryview(struct.pack("!I", len(payload)) + payload)
        while buf:
            sock = self.sock
            if sock is None:
                # closed under us (kill/teardown race): a typed
                # dead-peer error, not an AttributeError on None
                raise ConnectionResetError("connection closed")
            n = sock.send(buf[:CHUNK])
            buf = buf[n:]

    def _recv_exact(self, n: int, what: str = "frame") -> bytes:
        chunks = io.BytesIO()
        remaining = n
        while remaining:
            sock = self.sock
            if sock is None:
                raise ConnectionResetError("connection closed")
            data = sock.recv(remaining)
            if not data:
                got = n - remaining
                if got:
                    # mid-frame close: the stream is corrupt, not
                    # merely finished
                    raise FrameError(
                        f"truncated {what}: peer closed after "
                        f"{got} of {n} bytes")
                raise ConnectionResetError("peer closed")
            chunks.write(data)
            remaining -= len(data)
        return chunks.getvalue()

    def recv(self) -> Any:
        (length,) = struct.unpack("!I", self._recv_exact(4, "header"))
        if length > self.max_frame_bytes:
            # validate BEFORE allocating
            raise FrameError(
                f"frame length {length} exceeds max_frame_bytes "
                f"{self.max_frame_bytes} (corrupt header?)")
        return pickle.loads(self._recv_exact(length, "payload"))


class TracedConnection:
    """Trace-context codec over any connection duck type.

    Sends wrap the message in the telemetry envelope when the calling
    thread carries a trace context (untraced traffic stays
    byte-identical on the wire); recvs strip the envelope and adopt the
    sender's context into this thread.  Single-threaded owners only:
    the learner-side ``QueueCommunicator`` instead codecs at its own
    queue boundaries, because its recv thread is not the thread that
    handles the message.  Workers wrap their gather pipe, gathers wrap
    their learner connection (outside ``ChaosConnection``, so injected
    faults hit enveloped frames like real ones)."""

    __slots__ = ("conn",)

    def __init__(self, conn):
        self.conn = conn

    def fileno(self):
        return self.conn.fileno()

    def close(self):
        return self.conn.close()

    def send(self, data: Any):
        self.conn.send(wrap_trace(data))

    def recv(self) -> Any:
        return unwrap_trace(self.conn.recv())

    def __getattr__(self, name):
        return getattr(self.conn, name)


# -- TCP helpers --------------------------------------------------------

def find_free_port() -> int:
    """An OS-assigned free TCP port."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def open_socket_connection(address: str, port: int,
                           max_frame_bytes=DEFAULT_MAX_FRAME_BYTES):
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.connect((address, port))
    return FramedConnection(sock, max_frame_bytes=max_frame_bytes)


def accept_socket_connections(port: int, timeout=None, backlog=128,
                              max_frame_bytes=DEFAULT_MAX_FRAME_BYTES):
    """Generator of connections; yields None on accept timeout so the
    caller's loop can check for shutdown.  Accepts forever: workers
    are elastic, and live-connection bookkeeping belongs to the
    consumer.  The listening socket closes with the generator."""
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind(("", port))
        server.listen(backlog)
        server.settimeout(timeout)
        while True:
            try:
                sock, _ = server.accept()
                yield FramedConnection(
                    sock, max_frame_bytes=max_frame_bytes)
            except socket.timeout:
                yield None
    finally:
        server.close()


_mp = mp.get_context("spawn")


def send_recv(conn, sdata):
    """One request/reply round trip."""
    conn.send(sdata)
    return conn.recv()


def open_multiprocessing_connections(num_procs: int, target: Callable,
                                     args_func: Callable[[int], tuple]):
    """Spawn ``num_procs`` daemon processes, each holding one end of a
    duplex pipe; returns the parent-side connections."""
    parent_conns = []
    for i in range(num_procs):
        parent, child = _mp.Pipe(duplex=True)
        proc = _mp.Process(target=target, args=(child,) + args_func(i),
                           daemon=True)
        proc.start()
        child.close()
        parent_conns.append(parent)
    return parent_conns


class MultiProcessJobExecutor:
    """Farm (send job -> recv result) over worker processes.

    ``func(conn, *args)`` runs in each child and loops ``recv -> work
    -> send``.  The parent pushes jobs from ``send_generator`` whenever
    a worker's slot frees; a receiver thread drains results into a
    bounded queue."""

    def __init__(self, func, send_generator, num_workers,
                 args_func: Callable[[int], tuple] = lambda i: ()):
        self.send_generator = send_generator
        self.conns = open_multiprocessing_connections(
            num_workers, func, args_func)
        self.waiting_conns = queue.Queue()
        for conn in self.conns:
            self.waiting_conns.put(conn)
        self.output_queue = queue.Queue(maxsize=8)
        self.shutdown_flag = False
        self.threads = []

    def shutdown(self):
        self.shutdown_flag = True
        for t in self.threads:
            t.join(timeout=5)
        for conn in self.conns:
            conn.close()

    def recv(self, timeout=None):
        return self.output_queue.get(timeout=timeout)

    def start(self):
        self.threads = [
            threading.Thread(target=self._sender, daemon=True),
            threading.Thread(target=self._receiver, daemon=True),
        ]
        for t in self.threads:
            t.start()

    def _sender(self):
        while not self.shutdown_flag:
            try:
                conn = self.waiting_conns.get(timeout=0.3)
            except queue.Empty:
                continue
            conn.send(next(self.send_generator))

    def _receiver(self):
        while not self.shutdown_flag:
            ready = mp.connection.wait(self.conns, timeout=0.3)
            for conn in ready:
                try:
                    data = conn.recv()
                except EOFError:
                    continue
                self.waiting_conns.put(conn)
                while not self.shutdown_flag:
                    try:
                        self.output_queue.put(data, timeout=0.3)
                        break
                    except queue.Full:
                        continue


class QueueCommunicator:
    """Async request hub over a mutable set of connections.

    Receives from every registered connection into ``input_queue`` as
    ``(conn, data)`` pairs; ``output_queue`` drains in a writer thread.
    Dead peers (reset/EOF) are dropped and counted: replies dropped
    because their peer died first (``send_drops``), disconnects, and
    requests whose verb no handler knows (``unknown_verbs``), which the
    learner's ``FleetRegistry`` reports per epoch."""

    def __init__(self, conns: Iterable = ()):
        self.input_queue = queue.Queue(maxsize=256)
        self.output_queue = queue.Queue(maxsize=256)
        self.conns: Dict[Any, bool] = {}
        self._lock = threading.Lock()
        self.send_drops = 0
        self.disconnects = 0
        self.unknown_verbs: Dict[str, int] = {}
        # StallWatchdog beat (set by the learner): the writer and
        # reader threads prove liveness once per loop pass
        self.liveness_hook = None
        for conn in conns:
            self.add_connection(conn)
        self.shutdown_flag = False
        self.threads = [
            threading.Thread(target=self._send_loop, daemon=True),
            threading.Thread(target=self._recv_loop, daemon=True),
        ]
        for t in self.threads:
            t.start()

    def shutdown(self):
        self.shutdown_flag = True

    def connection_count(self):
        return len(self.conns)

    def live_connections(self):
        with self._lock:
            return list(self.conns)

    def recv(self, timeout=None):
        # the envelope codec runs HERE, not in the reader thread: the
        # thread that handles the message is the one that must adopt
        # (or clear) the sender's trace context
        conn, data = self.input_queue.get(timeout=timeout)
        return conn, unwrap_trace(data)

    def send(self, conn, send_data):
        # wrap in the caller's thread for the same reason: a reply
        # enqueued while a request's context is current carries it
        self.output_queue.put((conn, wrap_trace(send_data)))

    def note_unknown_verb(self, verb):
        """Count a request whose verb no handler knows (version skew or
        a stray client); logged once per verb name."""
        verb = str(verb)
        with self._lock:
            count = self.unknown_verbs.get(verb, 0)
            self.unknown_verbs[verb] = count + 1
        if count == 0:
            print(f"WARNING: unknown control-plane verb {verb!r} "
                  f"(version skew or a stray client?); replying empty "
                  f"— further occurrences counted silently")

    def drop_stats(self) -> Dict[str, int]:
        """Drop counters, read under their lock as one snapshot."""
        with self._lock:
            return {"send_drops": self.send_drops,
                    "disconnects": self.disconnects,
                    "unknown_verbs": sum(self.unknown_verbs.values())}

    def fleet_stats(self) -> Dict[str, int]:
        """Fleet-health contribution to the per-epoch metrics record;
        supervised subclasses add respawn/alive counts."""
        return self.drop_stats()

    def begin_drain(self):
        """Shutdown is coming: child exits are expected from here on.
        No-op here; supervised subclasses stop respawning."""

    def report_stale(self, conn):
        """A peer missed its heartbeats.  No-op here; subclasses evict
        the wedged child or sever its socket."""

    def _send_loop(self):
        while not self.shutdown_flag:
            hook = self.liveness_hook
            if hook is not None:
                hook("send_loop")
            try:
                conn, send_data = self.output_queue.get(timeout=0.3)
            except queue.Empty:
                continue
            with self._lock:
                live = conn in self.conns
                if not live:
                    self.send_drops += 1  # the peer died after asking
            if not live:
                continue
            try:
                conn.send(send_data)
            except (ConnectionResetError, BrokenPipeError, OSError):
                with self._lock:
                    self.send_drops += 1
                self.disconnect(conn)

    def add_connection(self, conn):
        with self._lock:
            self.conns[conn] = True

    def disconnect(self, conn):
        with self._lock:
            if self.conns.pop(conn, None) is not None:
                self.disconnects += 1
        try:
            conn.close()
        except OSError:
            pass

    def _recv_loop(self):
        while not self.shutdown_flag:
            hook = self.liveness_hook
            if hook is not None:
                hook("recv_loop")
            with self._lock:
                conns = list(self.conns)
            if not conns:
                time.sleep(0.1)
                continue
            try:
                ready = mp.connection.wait(conns, timeout=0.3)
            except OSError:
                ready = []
            for conn in ready:
                try:
                    data = conn.recv()
                except (ConnectionResetError, BrokenPipeError, EOFError,
                        OSError):
                    self.disconnect(conn)
                    continue
                while not self.shutdown_flag:
                    try:
                        self.input_queue.put((conn, data), timeout=0.3)
                        break
                    except queue.Full:
                        continue
