"""Control-plane messaging between the learner and its CPU children.

The counterpart of the pipe half of ``handyrl_tpu.connection``: pickle
messages over ``multiprocessing`` pipes between the learner, its
gather processes, their workers and the batcher farm.  The socket
transport (remote workers) comes with the remote-worker item, and the
port carries no telemetry envelope yet.

Child processes are SPAWNED, not forked: a parent that holds a CUDA
context cannot fork it into a child, so children start from a fresh
interpreter.  They rebuild models from pickled numpy state and run on
the device their caller names (the CPU for workers, batchers and
evaluation children).
"""

import multiprocessing as mp
import multiprocessing.connection  # noqa: F401  (mp.connection.wait)
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable

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
    Dead peers (reset/EOF) are dropped."""

    def __init__(self, conns: Iterable = ()):
        self.input_queue = queue.Queue(maxsize=256)
        self.output_queue = queue.Queue(maxsize=256)
        self.conns: Dict[Any, bool] = {}
        self._lock = threading.Lock()
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

    def recv(self, timeout=None):
        return self.input_queue.get(timeout=timeout)

    def send(self, conn, send_data):
        self.output_queue.put((conn, send_data))

    def _send_loop(self):
        while not self.shutdown_flag:
            try:
                conn, send_data = self.output_queue.get(timeout=0.3)
            except queue.Empty:
                continue
            with self._lock:
                live = conn in self.conns
            if not live:
                continue  # the peer died after the request
            try:
                conn.send(send_data)
            except (ConnectionResetError, BrokenPipeError, OSError):
                self.disconnect(conn)

    def add_connection(self, conn):
        with self._lock:
            self.conns[conn] = True

    def disconnect(self, conn):
        with self._lock:
            self.conns.pop(conn, None)
        try:
            conn.close()
        except OSError:
            pass

    def _recv_loop(self):
        while not self.shutdown_flag:
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
