"""The port's control plane over sockets, held against the JAX package's.

  * frame limits: an oversized header fails before allocating, a
    payload cut mid-frame is a ``FrameError``, a clean close is a reset;
  * wire parity over ``socket.socketpair()``: the JAX package's
    ``FramedConnection`` on one end and the port's on the other carry
    the same objects both ways (equal after the round trip);
  * chaos on frames (drop, truncate, delay) and its wiring into the
    gather's learner connection;
  * ``WorkerServer``'s entry port survives garbage and silent peers,
    admits concurrent joins with disjoint worker-id blocks, and a
    worker machine of either package completes the handshake;
  * the communicator counts drops, disconnects and unknown verbs.

Every port binds comes from ``find_free_port()``: the fixed ports 9999
and 9998 stay free for whatever else runs on the machine.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

import handyrl_tpu.connection as jconn
import handyrl_tpu.worker as jworker
import handyrl_tpu_torch.connection as tconn
import handyrl_tpu_torch.worker as tworker
from handyrl_tpu_torch.resilience import ChaosConfig, ChaosConnection


class SeqRng:
    """Scripted random() draws for exact fault placement."""

    def __init__(self, seq):
        self.seq = list(seq)

    def random(self):
        return self.seq.pop(0)


def _pair(a_cls=tconn.FramedConnection, b_cls=tconn.FramedConnection,
          max_frame_bytes=1 << 20):
    a, b = socket.socketpair()
    return (a_cls(a, max_frame_bytes=max_frame_bytes),
            b_cls(b, max_frame_bytes=max_frame_bytes))


def test_oversized_header_fails_before_allocating():
    tx, rx = _pair(max_frame_bytes=1024)
    tx.sock.sendall(struct.pack("!I", 1 << 27))
    with pytest.raises(tconn.FrameError, match="max_frame_bytes"):
        rx.recv()
    tx.close()
    rx.close()


def test_truncated_payload_is_a_frame_error_and_a_dead_peer():
    tx, rx = _pair()
    tx.sock.sendall(struct.pack("!I", 100) + b"x" * 10)
    tx.close()
    with pytest.raises(tconn.FrameError, match="truncated payload"):
        rx.recv()
    assert issubclass(tconn.FrameError, ConnectionError)
    rx.close()


def test_clean_close_is_a_reset_and_frames_under_the_limit_pass():
    tx, rx = _pair(max_frame_bytes=4096)
    tx.send({"k": "v" * 1000})
    assert rx.recv() == {"k": "v" * 1000}
    tx.close()
    with pytest.raises(ConnectionResetError):
        rx.recv()
    with pytest.raises(ConnectionResetError):
        tx.send("after close")
    rx.close()


def _objects():
    rng = np.random.default_rng(0)
    return [
        None, 7, "args", ("episode", [None, None]),
        {"role": "g", "player": [0, 1], "model_id": {0: 3, 1: -1}},
        ("beat", {"gather_id": 2, "workers": 16, "send_drops": 0}),
        {"moment": [b"\x42" * 70_000], "outcome": {0: 1.0, 1: -1.0},
         "steps": 9, "obs": rng.standard_normal((4, 3, 3)).astype(
             np.float32)},
    ]


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wire_parity_with_the_jax_framing(direction):
    """Bytes on the wire are the same format: each package reads what
    the other writes (exact equality of every object, arrays too)."""
    classes = (jconn.FramedConnection, tconn.FramedConnection)
    if direction == "port_to_jax":
        classes = classes[::-1]
    tx, rx = _pair(*classes, max_frame_bytes=1 << 22)
    got = []
    reader = threading.Thread(
        target=lambda: got.extend(rx.recv() for _ in _objects()))
    reader.start()
    for obj in _objects():
        tx.send(obj)
    reader.join(timeout=30)
    assert len(got) == len(_objects())
    for sent, received in zip(_objects(), got):
        assert _equal(sent, received)
    tx.close()
    rx.close()


def test_chaos_connection_drops_truncates_and_delays():
    tx, rx = _pair()
    chaos = ChaosConnection(tx, ChaosConfig(frame_drop_prob=0.5),
                            rng=SeqRng([0.1, 0.9]))
    chaos.send("lost")
    chaos.send("kept")
    assert chaos.dropped == 1 and rx.recv() == "kept"

    late = ChaosConnection(tx, ChaosConfig(frame_delay_prob=1.0,
                                           frame_delay=0.05),
                           rng=SeqRng([0.0]))
    t0 = time.monotonic()
    late.send("late")
    assert time.monotonic() - t0 >= 0.05 and late.delayed == 1
    assert rx.recv() == "late"

    cut = ChaosConnection(tx, ChaosConfig(frame_truncate_prob=1.0),
                          rng=SeqRng([0.0]))
    cut.send({"payload": "x" * 1000})
    assert cut.truncated == 1
    with pytest.raises(tconn.FrameError, match="truncated"):
        rx.recv()
    rx.close()


def test_frame_chaos_wraps_the_gather_connection():
    tx, rx = _pair()
    wrapped = tworker._maybe_chaos_wrap(
        tx, {"chaos": {"frame_drop_prob": 1.0, "seed": 3}}, 0)
    assert isinstance(wrapped, ChaosConnection)
    wrapped.send("gone")
    assert wrapped.dropped == 1
    assert tworker._maybe_chaos_wrap(tx, {"chaos": {"kill_prob": 1.0}},
                                     0) is tx
    assert tworker._maybe_chaos_wrap(tx, {}, 0) is tx
    # the same seed and slot give the JAX package's fault schedule
    cfg = {"chaos": {"frame_drop_prob": 0.5, "seed": 3}}
    port = tworker._maybe_chaos_wrap(tx, cfg, 1)
    jax = jworker._maybe_chaos_wrap(tx, cfg, 1)
    other = tworker._maybe_chaos_wrap(tx, cfg, 2)
    seq = [port.rng.random() for _ in range(8)]
    assert seq == [jax.rng.random() for _ in range(8)]
    assert seq != [other.rng.random() for _ in range(8)]
    tx.close()
    rx.close()


# -- the entry port --------------------------------------------------------

def _entry_server(monkeypatch):
    monkeypatch.setattr(tworker, "ENTRY_PORT", tconn.find_free_port())
    monkeypatch.setattr(tworker, "WORKER_PORT", tconn.find_free_port())
    server = tworker.WorkerServer({"seed": 0, "worker": {}})
    server.ENTRY_TIMEOUT = 0.8  # a silent peer pays this, not 10 s
    server.run()
    return server


def _dial(port):
    for _ in range(100):  # the listener races the first connect
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=5)
        except OSError:
            time.sleep(0.05)
    raise AssertionError("entry server never came up")


def test_entry_survives_garbage_and_silence_and_admits_concurrently(
        monkeypatch):
    server = _entry_server(monkeypatch)
    port = server.entry_port
    loris = [_dial(port) for _ in range(2)]     # connect, say nothing
    for _ in range(2):                          # junk where a frame goes
        g = _dial(port)
        g.sendall(b"\xff" * 16)
        g.close()
    bad = tconn.open_socket_connection("127.0.0.1", port)
    bad.send({"not": "a worker config"})        # KeyError in _admit
    bad.close()

    merged, lock = [], threading.Lock()

    def join(i):
        conn = tconn.open_socket_connection("127.0.0.1", port)
        conn.send({"address": f"machine-{i}", "num_parallel": 2})
        reply = conn.recv()
        conn.close()
        with lock:
            merged.append(reply["worker"])

    t0 = time.monotonic()
    joiners = [threading.Thread(target=join, args=(i,)) for i in range(3)]
    for t in joiners:
        t.start()
    for t in joiners:
        t.join(timeout=10)
    assert len(merged) == 3, "a valid join wedged behind a silent peer"
    assert time.monotonic() - t0 < 5.0
    assert sorted(c["base_worker_id"] for c in merged) == [0, 2, 4]
    assert server.total_worker_count == 6
    time.sleep(1.0)  # the silent peers' deadline passes
    join(99)
    assert merged[-1]["base_worker_id"] == 6
    for sock in loris:
        sock.close()
    server.shutdown()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_worker_machine_of_either_package_joins_the_port(package,
                                                         monkeypatch):
    """``entry`` (the worker machine's handshake) of each package against
    the port's entry server: the merged config comes back with the
    learner's args and this machine's id block."""
    server = _entry_server(monkeypatch)
    server.args = {"seed": 5, "worker": {}, "env": {"env": "TicTacToe"}}
    module = tworker if package == "port" else jworker
    monkeypatch.setattr(module, "ENTRY_PORT", server.entry_port)
    _dial(server.entry_port).close()
    merged = module.entry({"server_address": "127.0.0.1",
                           "address": "m", "num_parallel": 3})
    assert merged["seed"] == 5 and merged["env"] == {"env": "TicTacToe"}
    assert merged["worker"]["base_worker_id"] == 0
    assert merged["worker"]["num_parallel"] == 3
    server.shutdown()


def test_report_stale_severs_a_remote_gather(monkeypatch):
    server = tworker.WorkerServer({"worker": {}})
    tx, rx = _pair()
    server.add_connection(rx)
    server.report_stale(rx)
    assert server.connection_count() == 0 and server.disconnects == 1
    with pytest.raises(ConnectionError):
        tx.recv()
    tx.close()
    server.shutdown()


def test_communicator_counts_drops_and_unknown_verbs(capsys):
    comm = tconn.QueueCommunicator()
    ours, theirs = tconn._mp.Pipe(duplex=True)
    comm.add_connection(ours)
    theirs.close()
    comm.send(ours, "first")
    deadline = time.monotonic() + 5.0
    while (comm.send_drops < 1 or comm.connection_count()) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    comm.send(ours, "second")
    while comm.send_drops < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    comm.note_unknown_verb("bogus")
    comm.note_unknown_verb("bogus")
    assert comm.drop_stats() == {"send_drops": 2, "disconnects": 1,
                                 "unknown_verbs": 2}
    assert comm.fleet_stats() == comm.drop_stats()
    assert capsys.readouterr().out.count("unknown control-plane verb") == 1
    comm.shutdown()
