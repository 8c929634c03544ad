"""The port's telemetry against the JAX package's.

  * the span recorder: the same spans recorded through either package
    give span-log lines of the same format; the JAX exporter reads a
    port run directory and the port's exporter reads a JAX one, and
    ``build_trace`` turns the same records into the same document;
  * the trace-context envelope: ``wrap_trace``/``unwrap_trace`` equal
    the JAX codec, untraced traffic is byte-identical on the wire,
    ``TracedConnection`` and the ``QueueCommunicator`` adopt the
    sender's context across packages;
  * ``LatencyHistogram``: percentiles, merge and the wire form equal the
    JAX histogram's on seeded latencies, and each reads the other's
    ``to_dict``;
  * attribution: ``self_time_tree`` / ``top_self`` /
    ``untracked_residual`` equal the JAX functions on seeded span
    records, and the ``Attributor`` folds only this epoch's spans;
  * the flight recorder: ``dump`` writes the JAX document's keys with
    registered extras, and ``install_signal_dump`` runs its
    ``pre_dump`` before the dump in a SIGTERMed child;
  * the status server answers the snapshot and ``/healthz``.
"""

import json
import multiprocessing as mp
import os
import pickle
import subprocess
import sys
import textwrap
import urllib.request

import numpy as np
import pytest

from handyrl_tpu import telemetry as jtel
from handyrl_tpu.connection import TracedConnection as JaxTraced
from handyrl_tpu.telemetry import attribution as jattr
from handyrl_tpu.telemetry import export as jexport
from handyrl_tpu.telemetry.histogram import LatencyHistogram as JaxHist
from handyrl_tpu_torch import telemetry as ttel
from handyrl_tpu_torch.connection import QueueCommunicator, TracedConnection
from handyrl_tpu_torch.telemetry import attribution as tattr
from handyrl_tpu_torch.telemetry import export as texport
from handyrl_tpu_torch.telemetry.histogram import LatencyHistogram
from handyrl_tpu_torch.telemetry.status import StatusServer
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.fixture
def telemetry_off():
    """Both packages' process-wide telemetry back to its off state."""
    yield
    ttel.configure(enabled=False)
    jtel.configure(enabled=False)
    ttel.clear_trace()
    jtel.clear_trace()


def _record_script(tel, clock):
    """One scripted span sequence, the same for either package."""
    tel.set_trace((7, 9))
    with tel.trace_span("batch.make", episodes=4):
        clock.now += 0.25
    tel.clear_trace()
    t0 = tel.span_begin()
    clock.now += 0.5
    tel.span_end("episode.rollout", t0, mode="g", steps=12)
    tel.add_event("stall", loop="server", silent_sec=1.5)
    tel.record_span("infer.batch", 101.0, 0.125, rows=8, epoch=3)
    tel.flush()


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("pid", "tid")}


def test_span_logs_have_the_jax_format_and_cross_read(tmp_path,
                                                      telemetry_off):
    logs = {}
    for name, tel in (("port", ttel), ("jax", jtel)):
        run = tmp_path / name
        clock = _Clock()
        tel.configure(enabled=True, log_dir=str(run), role="learner",
                      clock=clock)
        _record_script(tel, clock)
        tel.configure(enabled=False)  # closes nothing; stops recording
        logs[name] = run
    port_roles, port_spans = texport.collect_run(str(logs["port"]))
    jax_roles, jax_spans = jexport.collect_run(str(logs["jax"]))
    assert list(port_roles.values()) == list(jax_roles.values())
    assert [_strip(r) for r in port_spans] == \
        [_strip(r) for r in jax_spans]
    # each package's exporter reads the other's run directory alike
    assert jexport.collect_run(str(logs["port"])) == (port_roles,
                                                      port_spans)
    assert texport.collect_run(str(logs["jax"])) == (jax_roles, jax_spans)
    assert texport.build_trace(port_spans, port_roles) == \
        jexport.build_trace(port_spans, port_roles)
    path, count = texport.export_run(str(logs["jax"]))
    assert count == len(jax_spans) + 1          # + the process row
    with open(path) as f:
        doc = json.load(f)
    assert doc == jexport.build_trace(jax_spans, jax_roles)
    traced = [e for e in doc["traceEvents"] if "args" in e
              and "trace" in e["args"]]
    assert [e["args"]["trace"] for e in traced] == ["7"]


@pytest.mark.parametrize("seed", range(4))
def test_build_trace_equals_jax_on_seeded_records(seed):
    rng = np.random.default_rng(seed)
    records = []
    for i in range(int(rng.integers(1, 40))):
        rec = {"name": f"s{int(rng.integers(5))}",
               "ts": round(float(rng.uniform(0, 50)), 6),
               "dur": round(float(rng.choice([0.0, rng.uniform(0, 2)])), 6),
               "pid": int(rng.integers(1, 4)),
               "tid": int(rng.integers(1, 3)), "role": "r"}
        if rng.random() < 0.5:
            rec["trace"], rec["parent"] = (int(rng.integers(1 << 40)),
                                           int(rng.integers(1 << 40)))
        if rng.random() < 0.5:
            rec["attrs"] = {"rows": int(rng.integers(9))}
        records.append(rec)
    roles = {1: "learner", 2: "worker-0", 3: ""}
    assert texport.build_trace(records, roles) == \
        jexport.build_trace(records, roles)


def test_trace_envelope_equals_jax_and_untraced_bytes_are_unchanged(
        telemetry_off):
    msg = ("episode", {"steps": 3, "obs": np.arange(4)})
    for tel in (ttel, jtel):
        tel.clear_trace()
    raw = pickle.dumps(msg)
    assert pickle.dumps(ttel.wrap_trace(msg)) == raw  # no context
    ttel.set_trace((11, 12))
    jtel.set_trace((11, 12))
    assert pickle.dumps(ttel.wrap_trace(msg)) == \
        pickle.dumps(jtel.wrap_trace(msg))
    wrapped = ttel.wrap_trace(msg)
    ttel.clear_trace()
    assert jtel.unwrap_trace(wrapped)[0] == "episode"
    assert ttel.unwrap_trace(wrapped)[0] == "episode"
    assert ttel.current_trace() == (11, 12)
    ttel.unwrap_trace(msg)  # a raw message clears a stale context
    assert ttel.current_trace() is None


def test_traced_connection_crosses_packages(telemetry_off):
    a, b = mp.Pipe()
    try:
        port_end, jax_end = TracedConnection(a), JaxTraced(b)
        ttel.set_trace((1, 2))
        port_end.send(("args", None))
        assert jax_end.recv() == ("args", None)
        assert jtel.current_trace() == (1, 2)
        jtel.set_trace((3, 4))
        jax_end.send({"role": "g"})
        assert port_end.recv() == {"role": "g"}
        assert ttel.current_trace() == (3, 4)
        # untraced: the raw frame, and the receiver's context clears
        ttel.clear_trace()
        port_end.send(("beat", None))
        assert b.recv() == ("beat", None)
        assert port_end.fileno() == a.fileno()
    finally:
        a.close()
        b.close()


def test_queue_communicator_codecs_at_its_queue_boundaries(
        telemetry_off):
    a, b = mp.Pipe()
    comm = QueueCommunicator([a])
    try:
        jtel.set_trace((5, 6))
        JaxTraced(b).send(("episode", [1]))
        conn, data = comm.recv(timeout=5)
        assert data == ("episode", [1])
        assert ttel.current_trace() == (5, 6)   # adopted by THIS thread
        comm.send(conn, "reply")                 # carries it back
        assert b.recv() == (ttel.TRACE_HEAD, (5, 6), "reply")
        ttel.clear_trace()
        comm.send(conn, "plain")
        assert b.recv() == "plain"
    finally:
        comm.shutdown()
        a.close()
        b.close()


@pytest.mark.parametrize("seed", range(5))
def test_latency_histogram_equals_jax(seed):
    rng = np.random.default_rng(seed)
    samples = np.exp(rng.normal(0, 3, int(rng.integers(1, 300))))
    ours, theirs = LatencyHistogram(), JaxHist()
    for ms in samples:
        ours.observe(float(ms))
        theirs.observe(float(ms))
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.percentile(q) == theirs.percentile(q)
    assert ours.summary("serve_") == theirs.summary("serve_")
    assert ours.to_dict() == theirs.to_dict()
    # the wire form crosses packages, and merge is elementwise
    other = LatencyHistogram()
    for ms in samples[::2]:
        other.observe(float(ms) * 3)
    merged = LatencyHistogram.from_dict(theirs.to_dict()).merge(other)
    jmerged = JaxHist.from_dict(ours.to_dict()).merge(
        JaxHist.from_dict(other.to_dict()))
    assert merged.to_dict() == jmerged.to_dict()
    assert merged.count == len(samples) + len(samples[::2])
    assert LatencyHistogram().p99 == 0.0


def _seeded_spans(rng, n):
    spans = []
    for _ in range(n):
        ts = round(float(rng.uniform(0, 10)), 6)
        spans.append({
            "name": f"n{int(rng.integers(4))}", "ts": ts,
            "dur": round(float(rng.choice([0.0, rng.uniform(0, 3)])), 6),
            "pid": int(rng.integers(1, 3)), "tid": int(rng.integers(1, 3)),
            "role": ["learner", "worker-0"][int(rng.integers(2))]})
    return spans


@pytest.mark.parametrize("seed", range(5))
def test_attribution_equals_jax(seed):
    rng = np.random.default_rng(seed)
    spans = _seeded_spans(rng, int(rng.integers(0, 60)))
    tree = tattr.self_time_tree(spans)
    assert tree == jattr.self_time_tree(spans)
    assert tattr.top_self(tree, 5) == jattr.top_self(tree, 5)
    record = {"epoch_wall_sec": round(float(rng.uniform(1, 9)), 3),
              "profile_update_sec": round(float(rng.uniform(0, 1)), 4),
              "profile_ingest_sec": round(float(rng.uniform(0, 1)), 4),
              "batch_wait_sec": 3.0}
    assert tattr.untracked_residual(record) == \
        jattr.untracked_residual(record)


def test_nested_spans_attribute_self_time():
    spans = [
        {"name": "outer", "ts": 0.0, "dur": 1.0, "pid": 1, "tid": 1},
        {"name": "inner", "ts": 0.25, "dur": 0.5, "pid": 1, "tid": 1},
        {"name": "other", "ts": 0.25, "dur": 0.5, "pid": 2, "tid": 1},
    ]
    tree = tattr.self_time_tree(spans)
    assert tree["/outer"]["self_sec"] == 0.5
    assert tree["/inner"]["self_sec"] == 0.5
    assert tree["/other"]["self_sec"] == 0.5  # other process: no nesting


def test_attributor_folds_this_epochs_ring(telemetry_off):
    clock = _Clock()
    ttel.configure(enabled=True, clock=clock, role="learner")
    att = ttel.Attributor()
    ttel.record_span("a", 90.0, 1.0)
    first = att.note_epoch({"epoch": 0, "epoch_wall_sec": 2.0,
                            "untracked_residual_sec": 0.5})
    assert first["tree"]["learner/a"]["self_sec"] == 1.0
    clock.now = 200.0
    ttel.record_span("b", 50.0, 2.0)      # before the mark: dropped
    ttel.record_span("c", 99.0, 0.0)
    ttel.record_span("d", 150.0, 3.0)
    second = att.note_epoch({"epoch": 1})
    assert set(second["tree"]) == {"learner/d"}
    assert att.epochs == 2 and att.last is second
    ttel.configure(enabled=False)
    assert ttel.Attributor().note_epoch({}) is None


def test_flight_recorder_dump_has_the_jax_keys(tmp_path, telemetry_off):
    ttel.configure(enabled=True, log_dir=str(tmp_path), role="learner",
                   ring=4)
    ttel.register_dump_extra("attribution", lambda: {"top": 1})
    ttel.register_dump_extra("broken", lambda: 1 / 0)
    with pytest.raises(ValueError):
        ttel.register_dump_extra("spans", lambda: 0)
    for i in range(6):
        ttel.record_span(f"s{i}", float(i), 0.1)
    ttel.stall_hook("server", 12.5)
    path = str(tmp_path / "flightrec.json")
    assert os.path.exists(path) and ttel.dump_count() == 1
    with open(path) as f:
        doc = json.load(f)
    assert set(doc) == {"reason", "role", "pid", "dumped_at", "spans",
                        "attribution"}
    assert doc["reason"] == "stall_event" and doc["role"] == "learner"
    assert len(doc["spans"]) == 4          # the bounded ring
    assert doc["spans"][-1]["name"] == "stall"
    assert doc["attribution"] == {"top": 1}
    assert ttel.stats()["dumps"] == 1
    # a child process writes its own file, never the learner's
    ttel.configure(enabled=True, log_dir=str(tmp_path), primary=False)
    ttel.crash_dump("trainer", RuntimeError("boom"))
    assert os.path.exists(tmp_path / f"flightrec-{os.getpid()}.json")


SIGTERM_CHILD = textwrap.dedent("""
    import os, signal, sys, time
    from handyrl_tpu_torch import telemetry

    run = sys.argv[1]
    telemetry.configure(enabled=True, log_dir=run, role="learner")

    def save():
        with open(os.path.join(run, "saved"), "w") as f:
            f.write(str(telemetry.dump_count()))

    assert telemetry.install_signal_dump(pre_dump=save)
    telemetry.record_span("before", telemetry.now(), 0.01)
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(10)
""")


def test_signal_dump_chains_the_pre_dump_save(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SIGTERM_CHILD, str(tmp_path)],
        cwd=tmp_path, env=dict(CHILD_ENV, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1, proc.stderr
    with open(tmp_path / "saved") as f:
        assert f.read() == "0"              # the save ran FIRST
    with open(tmp_path / "flightrec.json") as f:
        doc = json.load(f)
    assert doc["reason"] == "sigterm"
    assert [s["name"] for s in doc["spans"]] == ["before", "sigterm"]
    assert "dumped 2 spans" in proc.stdout


def test_status_server_answers_the_snapshot_and_healthz():
    snaps = []

    def snapshot():
        snaps.append(1)
        return {"epoch": 3}

    status = StatusServer(0, snapshot)
    try:
        base = f"http://127.0.0.1:{status.port}"
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert json.loads(r.read()) == {"epoch": 3}
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        assert len(snaps) == 1               # healthz never snapshots
    finally:
        status.close()
    status = StatusServer(0, lambda: 1 / 0,
                          healthz_fn=lambda: {"ok": False, "pool": 0})
    try:
        base = f"http://127.0.0.1:{status.port}"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/", timeout=10)
        assert err.value.code == 500
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": False, "pool": 0}
    finally:
        status.close()


def test_sampling_and_off_state_are_no_ops(telemetry_off):
    ttel.configure(enabled=False)
    assert ttel.maybe_trace() is None and ttel.span_begin() == 0.0
    with ttel.trace_span("x"):
        pass
    assert ttel.ring_snapshot() == []
    ttel.configure(enabled=True, sample_rate=0.0)
    assert ttel.maybe_trace() is None
    ttel.configure(enabled=True, sample_rate=1.0)
    ctx = ttel.maybe_trace()
    assert isinstance(ctx, tuple) and len(ctx) == 2
    args = {"metrics_path": "runs/x/metrics.jsonl", "telemetry": True,
            "trace_sample_rate": 0.5, "flightrec_spans": 7}
    port, ref = (ttel.configure_from_args(args, role="r"),
                 jtel.configure_from_args(args, role="r"))
    for key in ("enabled", "sample_rate", "log_dir", "dump_path"):
        assert getattr(port, key) == getattr(ref, key), key
    assert port.ring.maxlen == ref.ring.maxlen == 7
