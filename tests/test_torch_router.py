"""The port's replica-pool routing tier against the JAX package's.

Ported from tests/test_router.py onto the port's classes (the registry,
the announcer, the router and replica stacks of the port's inference
service and frontend, stub models on the CPU):

  * the registry's exact-clock lifecycle (expiry/eviction, generation
    bumps, drain vs suspect, least-loaded and rendezvous-hash picks,
    pin routing), plus a seeded operation script run through the JAX
    registry and the port's under the same clock, whose picks and
    snapshots must agree;
  * the announcer's register/beat/re-register loop, the router over
    real TCP (an unmodified client cannot tell the pool from one
    frontend), typed pool-level sheds, ``healthz`` from bookkeeping
    with no replica dialed;
  * the kill-1-of-2-replicas drill: zero lost pinned requests, eviction
    within the heartbeat timeout, exact reconciliation, a generation
    bump on respawn;
  * interop: a port replica announced into the JAX router serves a JAX
    client, and a JAX client is served through the port's router.
"""

import hashlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from handyrl_tpu.serving.client import ServeClient as JaxClient
from handyrl_tpu.serving.registry import ServiceRegistry as JaxRegistry
from handyrl_tpu.serving.router import RouterFrontend as JaxRouter
from handyrl_tpu.serving import RouterConfig as JaxRouterConfig
from handyrl_tpu_torch.pipeline.config import PipelineConfig
from handyrl_tpu_torch.pipeline.service import InferenceService
from handyrl_tpu_torch.serving import RouterConfig, ServingConfig
from handyrl_tpu_torch.serving.client import ServeClient, ServeError, ShedError
from handyrl_tpu_torch.serving.frontend import ServingFrontend
from handyrl_tpu_torch.serving.registry import (
    ReplicaAnnouncer,
    ServiceRegistry,
)
from handyrl_tpu_torch.serving.router import RouterFrontend
from torchfix import one_torch_thread  # noqa: F401  (autouse)


# ---------------------------------------------------------------------
# registry lifecycle (injectable clock: expiry tests are exact)
# ---------------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _advert(port=1000, **over):
    out = {"port": port, "capacity": 8, "inflight": 0, "p99_ms": 1.0,
           "slo_breached": False, "epochs": [1]}
    out.update(over)
    return out


def test_registry_evicts_silent_replicas_exactly_on_timeout():
    clock = _FakeClock()
    reg = ServiceRegistry(heartbeat_timeout=6.0, clock=clock)
    assert reg.register("a", _advert()) == 0
    assert reg.register("b", _advert(port=2000)) == 0
    clock.now = 4.0
    assert reg.beat("a", _advert())
    # b has been silent 4s < timeout: both still routable
    assert reg.sweep() == [] and reg.pool_size() == 2
    clock.now = 6.0
    # b is now silent EXACTLY the timeout: boundary is inclusive-alive
    assert reg.sweep() == [] and reg.pool_size() == 2
    clock.now = 6.01
    assert reg.sweep() == ["b"]
    assert reg.pool_size() == 1 and reg.evictions == 1
    # a beat from the evicted name is refused — the re-register trigger
    assert not reg.beat("b", _advert(port=2000))
    assert reg.beat("a", _advert())


def test_reregistration_bumps_generation_across_eviction():
    clock = _FakeClock()
    reg = ServiceRegistry(heartbeat_timeout=1.0, clock=clock)
    assert reg.register("r", _advert()) == 0
    assert reg.generation("r") == 0
    clock.now = 5.0
    assert reg.sweep() == ["r"]
    assert reg.generation("r") is None
    # generation memory SURVIVES eviction: the respawned replica's
    # re-register is observably a rejoin, not a first sight
    assert reg.register("r", _advert()) == 1
    assert reg.generation("r") == 1
    assert reg.register("r", _advert()) == 2
    assert reg.registrations == 3


def test_drain_is_sticky_but_suspect_clears_on_beat():
    clock = _FakeClock()
    reg = ServiceRegistry(heartbeat_timeout=10.0, clock=clock)
    reg.register("r", _advert())
    # suspect (the router's FailureWindow verdict) recovers on a beat
    reg.drain("r", suspect=True)
    assert reg.pool_size() == 0
    assert reg.beat("r", _advert())
    assert reg.pool_size() == 1
    # a graceful drain is the replica's explicit goodbye: beats keep
    # the entry fresh but never make it routable again
    reg.drain("r")
    assert reg.beat("r", _advert())
    assert reg.pool_size() == 0
    assert reg.snapshot()["replicas"]["r"]["draining"]
    # only a re-register (a fresh incarnation) undoes the goodbye
    reg.register("r", _advert())
    assert reg.pool_size() == 1


def test_least_loaded_spreads_away_from_the_hot_replica():
    clock = _FakeClock()
    reg = ServiceRegistry(heartbeat_timeout=10.0, clock=clock)
    reg.register("hot", _advert(p99_ms=50.0, inflight=6))
    reg.register("cold", _advert(port=2000, p99_ms=2.0))
    assert reg.pick() == "cold"
    # the router's own in-flight view counts too (adverts lag a beat)
    for _ in range(200):
        reg.note_inflight("cold", +1)
    assert reg.pick() == "hot"
    for _ in range(300):
        reg.note_inflight("cold", -1)  # floors at 0, never negative
    assert reg.snapshot()["replicas"]["cold"]["inflight"] == 0
    assert reg.pick() == "cold"


def test_pin_routes_only_to_advertising_replicas():
    clock = _FakeClock()
    reg = ServiceRegistry(heartbeat_timeout=10.0, clock=clock)
    reg.register("old", _advert(epochs=[1, 7]))
    reg.register("new", _advert(port=2000, epochs=[1], p99_ms=0.1))
    # unpinned goes least-loaded (new is cheaper)...
    assert reg.pick() == "new"
    # ...but the epoch-7 pin must land on its advertiser
    assert reg.pick(pin=7) == "old"
    assert reg.pick(pin=7, exclude={"old"}) is None
    assert reg.pick(pin=99) is None
    # eviction re-routes the pin to any surviving advertiser
    reg.register("new", _advert(port=2000, epochs=[1, 7]))
    reg.drain("old")
    assert reg.pick(pin=7) == "new"


def test_rendezvous_hash_keeps_seats_put_across_pool_changes():
    clock = _FakeClock()
    reg = ServiceRegistry(heartbeat_timeout=10.0, clock=clock)
    names = ["r0", "r1", "r2"]
    for i, n in enumerate(names):
        reg.register(n, _advert(port=1000 + i))

    def hrw(cands, seat):
        return max(cands, key=lambda n: (int(hashlib.md5(
            f"{n}|{seat}".encode()).hexdigest(), 16), n))

    picks = {s: reg.pick(seat=s, policy="hash") for s in range(32)}
    assert picks == {s: hrw(names, s) for s in range(32)}
    # an UNRELATED addition moves only seats that hash onto it —
    # highest-random-weight, not modulo
    reg.register("r3", _advert(port=1003))
    for s in range(32):
        if hrw(names + ["r3"], s) != "r3":
            assert reg.pick(seat=s, policy="hash") == picks[s]
    # removing a replica remaps ONLY its seats
    reg.drain("r1")
    for s in range(32):
        if picks[s] != "r1":
            assert reg.pick(seat=s, policy="hash") in (picks[s], "r3")
        else:
            assert reg.pick(seat=s, policy="hash") != "r1"


def test_all_breached_is_the_whole_pool_signal():
    clock = _FakeClock()
    reg = ServiceRegistry(heartbeat_timeout=10.0, clock=clock)
    assert not reg.all_breached()  # empty pool is pool_down, not SLO
    reg.register("a", _advert(slo_breached=True))
    reg.register("b", _advert(port=2000, slo_breached=False))
    assert not reg.all_breached()
    reg.beat("b", _advert(port=2000, slo_breached=True))
    assert reg.all_breached()


# ---------------------------------------------------------------------
# announcer <-> router registry verbs (real TCP, no serving replicas)
# ---------------------------------------------------------------------

def _router(**over):
    cfg = RouterConfig.from_config({
        "mode": "on", "port": 0, "heartbeat_interval": 0.05,
        "heartbeat_timeout": 1.0, "reply_timeout": 3.0,
        "replica_failures": 0, "failure_window": 5.0, **over})
    router = RouterFrontend(cfg)
    router.start()
    return router


def _wait(cond, deadline=10.0, msg="condition never held"):
    limit = time.monotonic() + deadline
    while not cond():
        assert time.monotonic() < limit, msg
        time.sleep(0.01)


def test_announcer_registers_beats_and_reregisters_after_eviction():
    router = _router()
    ann = ReplicaAnnouncer(
        "127.0.0.1", router.port, "r0",
        lambda: {"port": 1234, "epochs": [1]},
        interval=2.0, retry_interval=0.05)
    try:
        ann.start()
        _wait(lambda: ann.generation == 0, msg="register never landed")
        # the router owns the cadence: the ack's interval replaced ours
        assert ann.interval == router.cfg.heartbeat_interval
        _wait(lambda: router.registry.snapshot()
              ["replicas"].get("r0", {}).get("beats", 0) >= 2,
              msg="beats never flowed")
        assert router.registry.generation("r0") == 0
        # forced eviction (a future-now sweep): the next beat answers
        # the typed unknown-replica error, the announcer re-registers,
        # and the registry's generation bump records the rejoin
        router.registry.sweep(now=router.clock() + 100.0)
        _wait(lambda: router.registry.generation("r0") == 1,
              msg="re-register never landed")
        # the router bumps the generation before its ack reaches the
        # announcer, which counts the registration on the ack
        _wait(lambda: ann.registrations >= 2,
              msg="the re-register's ack never landed")
        # graceful close sends the drain goodbye: the entry survives
        # (in-flight completes) but is never picked again
        ann.close()
        _wait(lambda: router.registry.snapshot()
              ["replicas"].get("r0", {}).get("draining", False),
              msg="drain never landed")
        assert router.registry.pool_size() == 0
    finally:
        ann.close()
        router.close()


def test_router_sheds_pool_down_on_an_empty_pool():
    router = _router()
    client = None
    try:
        client = ServeClient("127.0.0.1", router.port, timeout=5.0)
        with pytest.raises(ShedError) as err:
            client.infer_batch(np.zeros((1, 2), np.float32))
        assert err.value.reason == "pool_down"
        stats = client.stats()
        assert stats["pool_sheds"] == 1
        assert stats["shed_by"] == {"pool_down": 1}
        assert stats["submitted"] == (stats["ok"] + stats["shed"]
                                      + stats["errors"])
    finally:
        if client is not None:
            client.close()
        router.close()


# ---------------------------------------------------------------------
# the pool over real TCP: 2 replica stacks behind one router
# ---------------------------------------------------------------------

class _StubEnv:
    def players(self):
        return [0]

    def reset(self):
        pass

    def observation(self, player):
        return np.zeros(2, np.float32)


class _StubModel:
    """Policy = tag + row index: replies prove WHICH replica answered."""

    def __init__(self, tag=0.0):
        self.tag = float(tag)
        self.calls = []

    def inference_batch(self, obs, hidden=None):
        rows = obs.shape[0]
        self.calls.append(rows)
        return {"policy": self.tag + np.tile(
            np.arange(rows, dtype=np.float32)[:, None], (1, 3))}


class _Pool:
    """N real serving stacks (stub model + InferenceService +
    ServingFrontend + ReplicaAnnouncer) registered into one router."""

    def __init__(self, n=2, router_over=None, epochs=None):
        
        self.router = _router(**(router_over or {}))
        self.models, self.services = [], []
        self.frontends, self.announcers = [], []
        env = _StubEnv()
        for i in range(n):
            model = _StubModel(tag=1000.0 * i)
            pcfg = PipelineConfig.from_config(
                {"mode": "on", "batch_window": 0.001, "max_batch": 16})
            svc = InferenceService(model, pcfg, epoch=1, device="cpu")
            svc.start()
            scfg = ServingConfig.from_config(
                {"mode": "on", "port": 0, "slo_ms": 0.0,
                 "reply_timeout": 3.0})
            fe = ServingFrontend(svc, env, scfg)
            fe.start()
            eps = (epochs or [(1,)] * n)[i]
            ann = ReplicaAnnouncer(
                "127.0.0.1", self.router.port, f"replica-{i}",
                (lambda fe=fe, eps=eps: fe.advert(epochs=eps)),
                interval=self.router.cfg.heartbeat_interval,
                retry_interval=0.05)
            ann.start()
            self.models.append(model)
            self.services.append(svc)
            self.frontends.append(fe)
            self.announcers.append(ann)
        _wait(lambda: self.router.registry.pool_size() >= n,
              msg="pool never formed")

    def close(self):
        for ann in self.announcers:
            ann.close(drain=False)
        self.router.close()
        for fe in self.frontends:
            fe.close()
        for svc in self.services:
            svc.close()


def test_pool_serves_unmodified_clients_and_reconciles():
    pool = _Pool(n=2)
    client = None
    try:
        client = ServeClient("127.0.0.1", pool.router.port, timeout=5.0)
        batch = np.zeros((3, 2), np.float32)
        tags = set()
        for _ in range(8):
            reply = client.infer_batch(batch)
            assert reply["epoch"] == 1
            assert reply["outputs"]["policy"].shape == (3, 3)
            # the tag digit identifies the serving replica
            tags.add(float(reply["outputs"]["policy"][0, 0]))
        assert tags <= {0.0, 1000.0}
        # live-epoch pin serves through the pool like a direct client
        reply = client.infer_batch(batch, epoch=1)
        assert reply["epoch"] == 1
        # the stats verb answers the ROUTER's counters, reconciled
        stats = client.stats()
        assert stats["submitted"] >= 9
        assert stats["submitted"] == (stats["ok"] + stats["shed"]
                                      + stats["errors"])
        assert stats["registry"]["pool_size"] == 2
        # a replica error is forwarded verbatim (bad schema stays typed)
        with pytest.raises(ServeError, match="bad request"):
            client.infer_batch(np.zeros((2, 9), np.float32))
        assert client.infer_batch(batch)["epoch"] == 1  # conn survives
    finally:
        if client is not None:
            client.close()
        pool.close()


def test_hash_policy_pins_a_seat_to_one_replica():
    pool = _Pool(n=2, router_over={"policy": "hash"})
    client = None
    try:
        client = ServeClient("127.0.0.1", pool.router.port, timeout=5.0)
        batch = np.zeros((1, 2), np.float32)
        expect = max(
            ("replica-0", "replica-1"),
            key=lambda n: (int(hashlib.md5(
                f"{n}|league-seat-3".encode()).hexdigest(), 16), n))
        tag = 1000.0 * int(expect[-1])
        for _ in range(6):
            reply = client.infer_batch(batch, seat="league-seat-3")
            assert float(reply["outputs"]["policy"][0, 0]) == tag
    finally:
        if client is not None:
            client.close()
        pool.close()


def test_unroutable_pin_answers_typed_error_not_a_shed():
    pool = _Pool(n=2)
    client = None
    try:
        client = ServeClient("127.0.0.1", pool.router.port, timeout=5.0)
        with pytest.raises(ServeError, match="snapshot 42 unavailable"):
            client.infer_batch(np.zeros((1, 2), np.float32), epoch=42)
        stats = client.stats()
        assert stats["errors"] == 1 and stats["shed"] == 0
        assert stats["pool_sheds"] == 0  # a live pool: not pool_down
    finally:
        if client is not None:
            client.close()
        pool.close()


def test_per_replica_sheds_reroute_but_pool_wide_sheds_escalate():
    pool = _Pool(n=2)
    client = None
    try:
        client = ServeClient("127.0.0.1", pool.router.port, timeout=5.0)
        batch = np.zeros((1, 2), np.float32)
        # jam ONE replica's admission (inflight at cap => "overload"):
        # the router re-routes to the other; the client never sees it
        fe0 = pool.frontends[0]
        fe0.inflight = fe0.cfg.max_inflight
        for _ in range(4):
            assert client.infer_batch(batch)["epoch"] == 1
        assert pool.router.stats()["pool_sheds"] == 0
        # jam BOTH: every attempted replica sheds — the POOL breached,
        # and the escalation is typed pool_overload (counted)
        fe1 = pool.frontends[1]
        fe1.inflight = fe1.cfg.max_inflight
        with pytest.raises(ShedError) as err:
            client.infer_batch(batch)
        assert err.value.reason == "pool_overload"
        stats = pool.router.stats()
        assert stats["pool_sheds"] == 1
        assert stats["shed_by"].get("pool_overload") == 1
        assert stats["reroutes"] >= 1
        # release both gates: the pool serves again
        fe0.inflight = 0
        fe1.inflight = 0
        assert client.infer_batch(batch)["epoch"] == 1
        stats = client.stats()
        assert stats["submitted"] == (stats["ok"] + stats["shed"]
                                      + stats["errors"])
    finally:
        if client is not None:
            client.close()
        pool.close()


def test_epoch_stats_report_the_metrics_contract_keys():
    pool = _Pool(n=2)
    client = None
    try:
        client = ServeClient("127.0.0.1", pool.router.port, timeout=5.0)
        assert client.infer_batch(
            np.zeros((1, 2), np.float32))["epoch"] == 1
        out = pool.router.epoch_stats()
        assert out["router_requests"] == 1 and out["router_ok"] == 1
        assert out["router_shed"] == 0 and out["router_errors"] == 0
        assert out["router_pool_size"] == 2
        assert out["reroutes"] == 0 and out["pool_sheds"] == 0
        # reset: the next epoch starts from zero (pool size is a gauge)
        again = pool.router.epoch_stats()
        assert again["router_requests"] == 0
        assert again["router_pool_size"] == 2
    finally:
        if client is not None:
            client.close()
        pool.close()


# ---------------------------------------------------------------------
# healthz: registry bookkeeping only — no replica is dialed
# ---------------------------------------------------------------------

def test_healthz_answers_from_the_registry_without_dialing_replicas():
    import socket as socket_mod

    from handyrl_tpu_torch.telemetry.status import StatusServer

    router = _router()
    status = StatusServer(0, router.stats, healthz_fn=router.healthz)
    probe = socket_mod.socket()
    try:
        url = f"http://127.0.0.1:{status.port}/healthz"
        # empty pool: the probe answers (200, bookkeeping) but not-ok
        with urllib.request.urlopen(url, timeout=10) as r:
            body = json.loads(r.read())
        assert body == {"ok": False, "pool_size": 0, "generation": 0}
        # register a replica whose advertised endpoint is a listener
        # WE own: if healthz dialed replicas, it would have to connect
        # here — the accept queue staying empty is the proof
        probe.bind(("127.0.0.1", 0))
        probe.listen(1)
        probe.setblocking(False)
        router.registry.register(
            "fake", _advert(port=probe.getsockname()[1]))
        with urllib.request.urlopen(url, timeout=10) as r:
            body = json.loads(r.read())
        assert body == {"ok": True, "pool_size": 1, "generation": 0}
        with pytest.raises(BlockingIOError):
            probe.accept()  # nobody ever dialed the replica
        # the full snapshot view rides the same no-dial contract
        with urllib.request.urlopen(
                f"http://127.0.0.1:{status.port}/", timeout=10) as r:
            snap = json.loads(r.read())
        assert snap["registry"]["pool_size"] == 1
        assert "fake" in snap["registry"]["replicas"]
        with pytest.raises(BlockingIOError):
            probe.accept()
    finally:
        probe.close()
        status.close()
        router.close()


# ---------------------------------------------------------------------
# tier-1 chaos drill: kill 1 of 2 replicas mid-load
# ---------------------------------------------------------------------

def test_chaos_kill_one_replica_evicts_reroutes_and_respawns():
    """The acceptance drill for the pool's failure model, with the
    port's replicas and router.  Kill 1 of 2 replicas SILENTLY
    (frontend + announcer, no goodbye) under epoch-pinned load:

      * zero lost in-flight — every request answers typed (ok with the
        pinned epoch, shed with a reason, or error), none time out;
      * the corpse is evicted within router.heartbeat_timeout (+ one
        accept poll + one beat of advert lag);
      * the reconciliation invariant holds exactly at the router;
      * respawn re-registers under the same name with a GENERATION
        BUMP, and the pool serves from both replicas again."""
    rt_over = {"heartbeat_interval": 0.1, "heartbeat_timeout": 1.0}
    pool = _Pool(n=2, router_over=rt_over)
    outcomes = {"ok": 0, "shed": 0, "error": 0, "lost": 0}
    bad_epochs = []
    stop = threading.Event()
    lock = threading.Lock()

    def load():
        client = ServeClient("127.0.0.1", pool.router.port,
                             timeout=10.0)
        batch = np.zeros((2, 2), np.float32)
        try:
            while not stop.is_set():
                try:
                    reply = client.infer_batch(batch, epoch=1)
                    with lock:
                        outcomes["ok"] += 1
                        if reply["epoch"] != 1:
                            bad_epochs.append(reply["epoch"])
                except ShedError:
                    with lock:
                        outcomes["shed"] += 1
                except ServeError:
                    with lock:
                        outcomes["error"] += 1
                except Exception:
                    # a transport failure or timeout at the CLIENT is
                    # a lost request — the drill's zero-loss clause
                    with lock:
                        outcomes["lost"] += 1
        finally:
            client.close()

    threads = [threading.Thread(target=load, daemon=True)
               for _ in range(3)]
    try:
        for t in threads:
            t.start()
        _wait(lambda: outcomes["ok"] >= 20, msg="load never warmed")

        # -- the silent kill: announcer first (no drain goodbye), then
        # the frontend dies like a crashed process
        victim_fe = pool.frontends[0]
        victim_ann = pool.announcers[0]
        victim_ann.kill()
        victim_fe.inject_kill()
        t_kill = time.monotonic()

        # eviction within the configured timeout: the sweep rides the
        # accept poll, and the last beat lags by up to one cadence
        _wait(lambda: pool.router.registry.generation("replica-0")
              is None, deadline=10.0, msg="corpse never evicted")
        elapsed = time.monotonic() - t_kill
        budget = (pool.router.cfg.heartbeat_timeout
                  + pool.router.cfg.heartbeat_interval
                  + 2 * RouterFrontend.ACCEPT_TIMEOUT)
        assert elapsed <= budget, (
            f"eviction took {elapsed:.2f}s > {budget:.2f}s")

        # pinned load keeps serving through the survivor
        ok_at_evict = outcomes["ok"]
        _wait(lambda: outcomes["ok"] >= ok_at_evict + 20,
              msg="survivor never served")

        # -- respawn: fresh port, same name — the announcer's
        # re-register must show up as a generation bump
        victim_fe.respawn()
        victim_ann.respawn()
        _wait(lambda: pool.router.registry.generation("replica-0") == 1,
              msg="generation bump never observed")
        _wait(lambda: pool.router.registry.pool_size() == 2,
              msg="pool never recovered")
        ok_at_respawn = outcomes["ok"]
        _wait(lambda: outcomes["ok"] >= ok_at_respawn + 20,
              msg="recovered pool never served")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        stats = pool.router.stats()
        pool.close()

    # zero lost epoch-pinned in-flight: every request answered typed,
    # and every ok carried the pinned snapshot
    assert outcomes["lost"] == 0, f"lost in-flight requests: {outcomes}"
    assert bad_epochs == []
    assert outcomes["error"] == 0, f"typed errors under pin: {outcomes}"
    # reconciliation holds EXACTLY at the router, and any sheds that
    # happened in the eviction gap are typed pool-level escalations
    assert stats["submitted"] == (stats["ok"] + stats["shed"]
                                  + stats["errors"])
    assert stats["submitted"] >= outcomes["ok"]
    for reason, count in stats["shed_by"].items():
        assert reason.startswith("pool_") and count > 0
    # the kill was detected through the failure path, not a goodbye:
    # eviction counted, and the dying host was suspect-drained (or the
    # sweep beat the first forward to it)
    assert stats["registry"]["evictions"] >= 1
    assert stats["registry"]["registrations"] >= 3  # 2 joins + rejoin


# ---------------------------------------------------------------------
# parity with the JAX registry, and interop with the JAX router
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_registry_script_matches_jax_under_one_clock(seed):
    """A seeded script of registers, beats, drains, in-flight notes,
    sweeps and picks runs through both registries on one clock; every
    answer and the final snapshot agree."""
    rng = np.random.default_rng(seed)
    clock = _FakeClock()
    ours = ServiceRegistry(heartbeat_timeout=3.0, clock=clock)
    theirs = JaxRegistry(heartbeat_timeout=3.0, clock=clock)
    names = [f"r{i}" for i in range(4)]
    for _ in range(120):
        clock.now += float(rng.uniform(0, 1.2))
        op = int(rng.integers(7))
        name = names[int(rng.integers(len(names)))]
        advert = _advert(port=1000 + int(rng.integers(9)),
                         inflight=int(rng.integers(5)),
                         p99_ms=float(rng.uniform(0, 20)),
                         slo_breached=bool(rng.random() < 0.3),
                         epochs=sorted({int(e) for e in
                                        rng.integers(1, 5, 2)}))
        if op == 0:
            got = [r.register(name, advert) for r in (ours, theirs)]
        elif op == 1:
            got = [r.beat(name, advert) for r in (ours, theirs)]
        elif op == 2:
            suspect = bool(rng.random() < 0.5)
            got = [r.drain(name, suspect=suspect) for r in (ours, theirs)]
        elif op == 3:
            delta = int(rng.integers(-2, 3))
            got = [r.note_inflight(name, delta) for r in (ours, theirs)]
        elif op == 4:
            got = [r.sweep() for r in (ours, theirs)]
        else:
            pin = [None, 1, 2, 7][int(rng.integers(4))]
            seat = int(rng.integers(3))
            policy = ["least_loaded", "hash"][op - 5]
            exclude = {names[int(rng.integers(4))]}
            got = [r.pick(seat=seat, pin=pin, exclude=exclude,
                          policy=policy) for r in (ours, theirs)]
        assert got[0] == got[1], op
        assert ours.all_breached() == theirs.all_breached()
        assert ours.pool_size() == theirs.pool_size()
    assert ours.snapshot() == theirs.snapshot()
    for name in names:
        assert ours.endpoint(name) == theirs.endpoint(name)
        assert ours.generation(name) == theirs.generation(name)


def _replica(port_router):
    """One port replica stack (service + frontend + announcer) dialing
    the router at ``port_router``."""
    pcfg = PipelineConfig.from_config(
        {"mode": "on", "batch_window": 0.001, "max_batch": 16})
    svc = InferenceService(_StubModel(tag=7.0), pcfg, epoch=1,
                           device="cpu")
    svc.start()
    fe = ServingFrontend(svc, _StubEnv(), ServingConfig.from_config(
        {"mode": "on", "port": 0, "slo_ms": 0.0, "reply_timeout": 3.0}))
    fe.start()
    ann = ReplicaAnnouncer("127.0.0.1", port_router, "port-replica",
                           lambda: fe.advert(epochs=[1]),
                           interval=0.05, retry_interval=0.05)
    ann.start()
    return svc, fe, ann


def test_port_replica_joins_the_jax_router_and_serves_a_jax_client():
    router = JaxRouter(JaxRouterConfig.from_config({
        "mode": "on", "port": 0, "heartbeat_interval": 0.05,
        "heartbeat_timeout": 1.0, "reply_timeout": 3.0}))
    router.start()
    svc, fe, ann = _replica(router.port)
    client = None
    try:
        _wait(lambda: router.registry.pool_size() == 1,
              msg="the port replica never registered")
        assert router.registry.generation("port-replica") == 0
        client = JaxClient("127.0.0.1", router.port, timeout=5.0)
        reply = client.infer_batch(np.zeros((3, 2), np.float32), epoch=1)
        assert reply["epoch"] == 1
        np.testing.assert_array_equal(
            reply["outputs"]["policy"][:, 0], [7, 8, 9])
        stats = client.stats()
        assert stats["ok"] == 1 and stats["submitted"] == 1
    finally:
        if client is not None:
            client.close()
        ann.close(drain=False)
        router.close()
        fe.close()
        svc.close()


def test_jax_client_is_served_through_the_port_router():
    router = _router()
    svc, fe, ann = _replica(router.port)
    client = None
    try:
        _wait(lambda: router.registry.pool_size() == 1,
              msg="the replica never registered")
        client = JaxClient("127.0.0.1", router.port, timeout=5.0)
        assert client.infer(np.zeros(2, np.float32))["epoch"] == 1
        with pytest.raises(Exception, match="unavailable"):
            client.infer_batch(np.zeros((1, 2), np.float32), epoch=5)
        stats = router.stats()
        assert (stats["ok"], stats["errors"]) == (1, 1)
    finally:
        if client is not None:
            client.close()
        ann.close(drain=False)
        router.close()
        fe.close()
        svc.close()
