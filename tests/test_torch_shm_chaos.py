"""The port's shm chaos layer and the workers' surge brownout.

Twins of tests/test_pipeline.py's shm-chaos and brownout cases on the
port's classes: ``ChaosRing`` tear, full, truncate and stall,
``ChaosBoard``, the service's drain skipping a corrupt trajectory slot,
the client's surge hold with its paced drain and overflow spill, the
spill path under a ring pinned full, and the learner's status section.
Then parity with the JAX package, exactly:

  * both packages' ``ChaosRing`` with the same seed and push/pop
    sequence inject the same faults in the same order and leave the
    segments byte-identical;
  * a JAX ``PipelineClient`` and the port's, each attached to a port
    service as client 0 with the same chaos config, seed their rings
    alike: the same episodes shipped through both give the same fault
    counts, the same ring bytes and the same drained episodes;
  * both clients route the same surge sequence (held, spilled, drained,
    flushed) the same way.
"""

import random

import numpy as np
import pytest

from handyrl_tpu.pipeline import shm as jshm
from handyrl_tpu.pipeline.client import PipelineClient as JaxClient
from handyrl_tpu.resilience import chaos as jchaos
from handyrl_tpu_torch.pipeline import (
    InferenceService,
    PipelineClient,
    PipelineConfig,
    ShmBoard,
    ShmRing,
)
from handyrl_tpu_torch.pipeline import shm as shm_mod
from handyrl_tpu_torch.resilience import chaos as tchaos
from handyrl_tpu_torch.resilience import (
    ChaosBoard,
    ChaosConfig,
    ChaosRing,
    maybe_chaos_board,
    maybe_chaos_ring,
)
from torchfix import one_torch_thread  # noqa: F401  (autouse)


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def sleep(self, dt):
        self.now += dt


class _StubModel:
    def inference_batch(self, obs, hidden=None):
        return {"policy": np.zeros((obs.shape[0], 3), np.float32)}


SPEC = {"leaves": [((2,), "float32")],
        "example": np.zeros(2, np.float32), "rows_max": 4}


def _make_service(**cfg_over):
    raw = {"mode": "on", "batch_window": 0.0, "ring_slots": 8,
           "slot_bytes": 4096, "traj_slots": 4, "traj_slot_mb": 1}
    raw.update(cfg_over)
    cfg = PipelineConfig.from_config(raw)
    clock = _FakeClock()
    svc = InferenceService(_StubModel(), cfg, epoch=1, device="cpu",
                           clock=clock, sleep=clock.sleep)
    return svc, cfg


# -- config ------------------------------------------------------------------

@pytest.mark.parametrize("raw", [
    {"shm_tear_prob": 0.5, "shm_stall_prob": 1.0},
    {"shm_beat_drop_prob": 0.1}, {"shm_beat_delay_prob": 0.2},
    {}, {"serve_kill_epoch": 3},
])
def test_chaos_config_shm_flags_match_jax(raw):
    port, jax = ChaosConfig.from_config(raw), \
        jchaos.ChaosConfig.from_config(raw)
    for flag in ("shm_faults_enabled", "shm_beat_faults_enabled",
                 "serve_kill_enabled"):
        assert getattr(port, flag) == getattr(jax, flag), flag


@pytest.mark.parametrize("raw,match", [
    ({"shm_tear_prob": 1.5}, "shm_tear_prob"),
    ({"shm_beat_delay": -1.0}, "shm_beat_delay"),
    ({"shm_tear_prob": 0.6, "shm_truncate_prob": 0.6}, "shm push"),
    ({"shm_beat_drop_prob": 0.7, "shm_beat_delay_prob": 0.7}, "shm beat"),
])
def test_chaos_config_validates_shm_keys(raw, match):
    with pytest.raises(ValueError, match=match):
        ChaosConfig.from_config(raw)
    with pytest.raises(ValueError, match=match):
        jchaos.ChaosConfig.from_config(raw)


def test_maybe_wrappers_are_identity_when_off():
    ring = ShmRing.create(slots=2, slot_bytes=64)
    board = ShmBoard.create()
    try:
        off = ChaosConfig.from_config({"shm_beat_drop_prob": 0.5})
        assert maybe_chaos_ring(ring, off) is ring
        assert maybe_chaos_ring(ring, None) is ring
        assert maybe_chaos_board(board, ChaosConfig()) is board
        assert isinstance(maybe_chaos_board(board, off), ChaosBoard)
    finally:
        ring.close()
        board.close()


# -- ChaosRing / ChaosBoard ---------------------------------------------------

def test_chaos_ring_tear_injection_leaves_a_real_torn_slot():
    ring = ShmRing.create(slots=4, slot_bytes=64)
    chaos = ChaosRing(ring, ChaosConfig.from_config(
        {"shm_tear_prob": 1.0, "seed": 1}))
    try:
        assert chaos.push(b"doomed")       # the "producer" died
        assert chaos.torn_injected == 1
        assert ring.pending() and not ring.readable()
        assert ring.pop() is None          # never consumed as data
        assert ring.skip_torn()            # reclaim
        assert ring.torn_count == 1
    finally:
        ring.close()


def test_chaos_ring_full_injection_counts_in_the_header():
    ring = ShmRing.create(slots=4, slot_bytes=64)
    chaos = ChaosRing(ring, ChaosConfig.from_config(
        {"shm_full_prob": 1.0, "seed": 1}))
    try:
        assert not chaos.push(b"refused")
        assert chaos.full_injected == 1
        assert ring.full_count == 1        # consumer-visible
        assert len(ring) == 0 and len(chaos) == 0
    finally:
        ring.close()


def test_chaos_ring_truncated_payload_is_skipped_not_crashed():
    ring = ShmRing.create(slots=4, slot_bytes=1024)
    chaos = ChaosRing(ring, ChaosConfig.from_config(
        {"shm_truncate_prob": 1.0, "seed": 1}))
    try:
        blob = shm_mod.dumps({"payload": list(range(64))})
        assert chaos.push(blob)
        assert chaos.truncated_injected == 1
        assert ring.readable()             # looks complete...
        with pytest.raises(Exception):
            ring.pop(loads=shm_mod.loads_view)  # ...but will not decode
        assert ring.skip_one()
        assert ring.torn_count == 1
        assert ring.push(blob)             # a clean producer resumes
        assert ring.pop(loads=shm_mod.loads_view)["payload"][3] == 3
    finally:
        ring.close()
    # a RAW request frame cut short fails np.frombuffer: truncation
    # never decodes silently into garbage observations
    reqring = ShmRing.create(slots=2, slot_bytes=1024)
    try:
        chaos2 = ChaosRing(reqring, ChaosConfig.from_config(
            {"shm_truncate_prob": 1.0, "seed": 1}))
        assert chaos2.push(shm_mod.pack_request(
            1, 2, [np.zeros((2, 4), np.float32)]))
        with pytest.raises(Exception):
            reqring.pop(loads=lambda v: shm_mod.unpack_request(
                v, [((4,), "float32")]))
        assert reqring.skip_one()
        assert reqring.torn_count == 1
    finally:
        reqring.close()


def test_chaos_ring_keeps_the_real_refusal_of_a_full_ring():
    ring = ShmRing.create(slots=1, slot_bytes=64)
    chaos = ChaosRing(ring, ChaosConfig.from_config(
        {"shm_tear_prob": 1.0, "seed": 1}))
    try:
        assert ring.push(b"x")             # the ring is really full now
        assert not chaos.push(b"y")        # refused before any fault
        assert chaos.torn_injected == 0 and ring.full_count == 1
    finally:
        ring.close()


def test_chaos_ring_stalled_consumer_backs_the_ring_up():
    ring = ShmRing.create(slots=4, slot_bytes=64)
    chaos = ChaosRing(ring, ChaosConfig.from_config(
        {"shm_stall_prob": 1.0, "seed": 1}))
    try:
        assert ring.push(b"waiting")
        assert chaos.pop() is None         # stalled: the item stays
        assert chaos.stalls_injected == 1
        assert len(ring) == 1
        assert ring.pop() == b"waiting"    # a healthy consumer drains
    finally:
        ring.close()


def test_chaos_board_withholds_and_backdates_beats():
    board = ShmBoard.create()
    try:
        drop = ChaosBoard(board, ChaosConfig.from_config(
            {"shm_beat_drop_prob": 1.0, "seed": 1}))
        drop.beat(epoch=3, now=100.0)
        assert drop.beats_dropped == 1
        assert board.age(now=100.0) == float("inf")  # never landed
        delay = ChaosBoard(board, ChaosConfig.from_config(
            {"shm_beat_delay_prob": 1.0, "shm_beat_delay": 0.5,
             "seed": 1}))
        delay.beat(epoch=3, now=100.0)
        assert delay.beats_delayed == 1
        assert board.age(now=100.0) == pytest.approx(0.5)
        assert delay.epoch == 3            # reads delegate untouched
    finally:
        board.close()


def test_service_drain_skips_corrupt_trajectory_slots():
    svc, _ = _make_service()
    try:
        desc = svc.attach(SPEC)
        traj = ShmRing.attach(**desc["traj"])
        poison = ChaosRing(traj, ChaosConfig.from_config(
            {"shm_truncate_prob": 1.0, "seed": 1}))
        assert poison.push(shm_mod.dumps({"steps": 1}))   # corrupt
        assert traj.push(shm_mod.dumps({"steps": 2}))     # clean
        drained = svc.drain_trajectories()
        assert [ep["steps"] for ep in drained] == [2]
        assert svc.corrupt == 1
        assert svc.stats()["corrupt_slots"] == 1
        assert svc.epoch_stats()["shm_torn_slots"] == 1
        traj.close()
    finally:
        svc.close()


def test_service_side_chaos_wraps_board_and_rings_and_reports_counts():
    cfg = PipelineConfig.from_config({"mode": "on", "batch_window": 0.0})
    chaos = ChaosConfig.from_config({"shm_stall_prob": 1.0,
                                     "shm_beat_drop_prob": 1.0, "seed": 3})
    svc = InferenceService(_StubModel(), cfg, epoch=1, device="cpu",
                           chaos=chaos)
    try:
        assert isinstance(svc.board, ChaosBoard)
        desc = svc.attach(SPEC)
        traj = ShmRing.attach(**desc["traj"])
        assert traj.push(shm_mod.dumps({"steps": 1}))
        assert svc.drain_trajectories() == []    # every pop stalls
        svc.board.beat(epoch=1)
        counts = svc.stats()["chaos"]
        assert counts["stalls_injected"] >= 1
        assert counts["beats_dropped"] == 1
        traj.close()
    finally:
        svc.close()
    plain, _ = _make_service()
    try:
        assert "chaos" not in plain.stats()
    finally:
        plain.close()


# -- surge brownout -------------------------------------------------------------

def test_client_surge_hold_stages_paced_drain_and_overflow_spill():
    """During the hold episodes stage in the bounded backlog (overflow
    spills, stamped and counted); after it the drain is paced FIFO; the
    exit flush ships everything; every episode is accounted for."""
    svc, cfg = _make_service()
    try:
        desc = svc.attach(SPEC)
        chaos = ChaosConfig.from_config(
            {"surge_epoch": 2, "surge_hold_uploads": 30.0})
        clock = _FakeClock()
        client = PipelineClient(desc, cfg, clock=clock, sleep=clock.sleep,
                                chaos=chaos)
        try:
            client.note_jobs([{"model_id": {0: 1, 1: -1}}, None])
            assert not client.holding()
            client.note_jobs([{"model_id": {0: 2, 1: 2}}])
            assert client.holding()
            spills = []
            for i in range(7):
                spills += client.ship_episode({"i": i})
            assert [e["i"] for e in spills] == [0, 1, 2]
            assert all(e["shm_spilled"] for e in spills)
            assert client.episodes_spilled == 3
            assert client.episodes_held == 7
            assert svc.drain_trajectories() == []
            clock.now = 31.0
            assert client.ship_episode({"i": 7}) == []
            drained = svc.drain_trajectories()
            assert [e["i"] for e in drained] == [3, 4, 5]
            assert drained[0]["upload_backlog"] == 4
            spills2 = client.flush_backlog()
            drained2 = svc.drain_trajectories()
            shipped = {e["i"] for e in drained + drained2}
            spilled = {e["i"] for e in spills + spills2}
            assert shipped | spilled == set(range(8))
            assert not shipped & spilled
            assert client.episodes_shipped + client.episodes_spilled == 8
        finally:
            client.close()
    finally:
        svc.close()


def test_spill_path_under_sustained_full_ring_pressure():
    svc, cfg = _make_service(traj_slots=64)
    try:
        client = PipelineClient(svc.attach(SPEC), cfg)
        try:
            real_traj = client.traj
            client.traj = ChaosRing(real_traj, ChaosConfig.from_config(
                {"shm_full_prob": 1.0, "seed": 3}))
            spilled = []
            for i in range(20):
                spilled += client.ship_episode({"i": i})
            assert [e["i"] for e in spilled] == list(range(20))
            assert all(e["shm_spilled"] for e in spilled)
            assert client.episodes_spilled == 20
            assert svc.ring_full_count() >= 20
            assert svc.drain_trajectories() == []
            client.traj = real_traj
            for i in range(20, 30):
                assert client.ship_episode({"i": i}) == []
            drained = svc.drain_trajectories()
            assert [e["i"] for e in drained] == list(range(20, 30))
            assert client.episodes_shipped + client.episodes_spilled == 30
        finally:
            client.close()
    finally:
        svc.close()


def test_status_snapshot_exposes_shm_counters():
    from types import SimpleNamespace

    from handyrl_tpu_torch.learner import Learner

    svc, _ = _make_service()
    try:
        learner = Learner.__new__(Learner)
        learner.model_epoch = 3
        learner.episodes_received = 10
        learner.episodes_rejected_stale = 0
        learner.episodes_replayed = 0
        learner.worker = SimpleNamespace(connection_count=lambda: 0)
        learner._run_t0 = 0.0
        learner.fleet = SimpleNamespace(snapshot=lambda: {})
        learner._last_record = None
        learner.wal = None
        learner.attributor = SimpleNamespace(last=None)
        learner.trainer = SimpleNamespace(
            costmodel=SimpleNamespace(stats=lambda: {}), anakin=None,
            num_guard=None)
        learner.infer_service = svc
        learner._infer_respawns = 0
        learner.episodes_shm = 7
        learner.episodes_spilled = 3
        learner._upload_backlog_peak = 5
        pipe = learner._status_snapshot()["pipeline"]
        assert pipe["episodes_shm"] == 7 and pipe["episodes_spilled"] == 3
        assert pipe["upload_backlog_peak"] == 5
        assert pipe["shm_torn_slots"] == 0 and pipe["corrupt_slots"] == 0
        assert "torn_reclaimed" in pipe and "clients_reaped" in pipe
    finally:
        svc.close()


# -- parity with the JAX package --------------------------------------------------

CHAOS_MIX = {"seed": 7, "shm_tear_prob": 0.15, "shm_full_prob": 0.15,
             "shm_truncate_prob": 0.15, "shm_stall_prob": 0.2}
COUNTERS = ("torn_injected", "full_injected", "truncated_injected",
            "stalls_injected")


def _fault_trace(shm, chaos_mod, ring_cls, seed_draws):
    """One scripted push/pop sequence through a package's ChaosRing:
    per op, which counter moved and what the op returned, then the
    segment's bytes."""
    ring = ring_cls.create(slots=8, slot_bytes=256)
    cfg = chaos_mod.ChaosConfig.from_config(CHAOS_MIX)
    chaos = chaos_mod.ChaosRing(ring, cfg, rng=random.Random(seed_draws))
    trace = []
    try:
        for i in range(60):
            before = [getattr(chaos, c) for c in COUNTERS]
            if i % 3 == 2:
                try:
                    out = chaos.pop(loads=shm.loads_view)
                except Exception:
                    ring.skip_one()
                    out = "corrupt"
            else:
                out = chaos.push(shm.dumps({"i": i, "x": list(range(i))}))
            moved = [c for c, b in zip(COUNTERS, before)
                     if getattr(chaos, c) != b]
            if i % 9 == 8 and ring.pending() and not ring.readable():
                ring.skip_torn()           # a consumer's reclaim
            trace.append((i, moved, out))
        return trace, bytes(ring._buf), ring.full_count, ring.torn_count
    finally:
        ring.close()


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_same_seed_same_shm_fault_sequence_as_jax(seed):
    port = _fault_trace(shm_mod, tchaos, ShmRing, seed)
    jax = _fault_trace(jshm, jchaos, jshm.ShmRing, seed)
    assert port[0] == jax[0]          # the same faults, op by op
    assert port[1] == jax[1]          # byte-identical segments
    assert port[2:] == jax[2:]        # the same header counters
    kinds = {c for _, moved, _ in port[0] for c in moved}
    assert kinds == set(COUNTERS)     # every fault class fired


def _ship_through(client_cls, chaos_raw, episodes):
    svc, cfg = _make_service(traj_slots=16)
    try:
        desc = svc.attach(SPEC)
        chaos_mod = jchaos if client_cls is JaxClient else tchaos
        chaos = chaos_mod.ChaosConfig.from_config(chaos_raw)
        clock = _FakeClock()
        client = client_cls(desc, cfg, clock=clock, sleep=clock.sleep,
                            chaos=chaos)
        try:
            routed = []
            for i, ep in enumerate(episodes):
                if i == 5:
                    client.note_jobs([{"model_id": {0: 2}}])
                if i == 30:
                    clock.now = 100.0      # the hold has passed
                routed.append([e["i"] for e in
                               client.ship_episode(dict(ep))])
                if i % 4 == 3:
                    routed.append(sorted(
                        e["i"] for e in svc.drain_trajectories()))
            routed.append([e["i"] for e in client.flush_backlog()])
            routed.append(sorted(e["i"]
                                 for e in svc.drain_trajectories()))
            counts = {c: sum(getattr(r, c, 0) for r in
                             (client.req, client.rsp, client.traj))
                      for c in COUNTERS}
            return (routed, counts, client.episodes_shipped,
                    client.episodes_spilled, client.episodes_held,
                    bytes(client.traj._buf))
        finally:
            client.close()
    finally:
        svc.close()


@pytest.mark.parametrize("chaos_raw", [
    {"seed": 7, "shm_tear_prob": 0.1, "shm_full_prob": 0.1,
     "shm_truncate_prob": 0.1},
    {"seed": 3, "surge_epoch": 2, "surge_hold_uploads": 8.0},
    {"seed": 7, "shm_full_prob": 0.3, "surge_epoch": 2,
     "surge_hold_uploads": 8.0},
], ids=["faults", "surge", "faults+surge"])
def test_client_routes_and_faults_match_the_jax_client(chaos_raw):
    episodes = [{"i": i, "moment": [b"m" * (i % 5)]} for i in range(40)]
    port = _ship_through(PipelineClient, chaos_raw, episodes)
    jax = _ship_through(JaxClient, chaos_raw, episodes)
    assert port == jax
    # every episode took exactly one path: pushed into the ring (a torn
    # or truncated push is the drill's dead producer) or spilled
    _routed, _counts, shipped, spilled, _held, _ = port
    assert shipped + spilled == len(episodes)
