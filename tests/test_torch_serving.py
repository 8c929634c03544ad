"""The port's network serving tier against the JAX package's.

  * ``ServingConfig`` / ``RouterConfig`` and the learner config's
    cross-section checks accept and refuse what the JAX package does;
  * the service's network plane, ported from tests/test_serving.py: a
    network submit joins the shm rows' dispatch, a pinned submit routes
    through ``model_resolver`` (unroutable pins answer typed), a pin
    naming the live epoch joins the unpinned group;
  * the device-module LRU: ``param_loads`` counts distinct snapshots,
    not dispatches, under alternating pinned and live traffic;
  * the frontend's admission (SLO trickle, overload, dead service, the
    atomic inflight reservation) and per-epoch stats, as in the JAX
    tests;
  * over TCP: typed failures, a service kill shedding ``service_down``
    then serving again, the connection cap, the frontend kill/respawn;
  * serving parity: an 8x2 GeeseNet, its Flax params carried over by
    ``models/convert.py``, served over TCP by both packages; unpinned
    and epoch-pinned outputs agree within ``atol=1e-5`` (the served
    forward tolerance of test_torch_pipeline.py), and each package's
    client talks to the other's frontend;
  * a CPU ``Learner`` with serving, router and the status endpoint on,
    2 epochs: a client pinned to epoch 1 through the router gets the
    local forward of ``models/1.ckpt``; metrics.jsonl carries the
    ``serve_*``/``router_*`` keys, ``untracked_residual_sec`` and a
    non-None ``arithmetic_intensity``; the status JSON parses; the
    span logs export to a trace linking worker and learner spans.
"""

import json
import os
import random
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

from handyrl_tpu.config import Config as JaxConfig
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.models import TPUModel
from handyrl_tpu.models.geese_net import GeeseNet as FlaxGeeseNet
from handyrl_tpu.pipeline.config import PipelineConfig as JaxPipelineConfig
from handyrl_tpu.pipeline.service import InferenceService as JaxService
from handyrl_tpu.serving import RouterConfig as JaxRouterConfig
from handyrl_tpu.serving import ServingConfig as JaxServingConfig
from handyrl_tpu.serving.client import ServeClient as JaxClient
from handyrl_tpu.serving.frontend import ServingFrontend as JaxFrontend
from handyrl_tpu_torch.config import Config
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models.geese_net import GeeseNet
from handyrl_tpu_torch.pipeline import PipelineConfig, ShmRing
from handyrl_tpu_torch.pipeline import shm as shm_mod
from handyrl_tpu_torch.pipeline.service import InferenceService
from handyrl_tpu_torch.serving import RouterConfig, ServingConfig
from handyrl_tpu_torch.serving.client import ServeClient, ServeError, ShedError
from handyrl_tpu_torch.serving.frontend import ServingFrontend, _NetSeat
from torchfix import one_torch_thread  # noqa: F401  (autouse)

# ---------------------------------------------------------------------
# config
# ---------------------------------------------------------------------

SECTIONS = [
    ("serving", None), ("serving", {"mode": "on", "port": 0}),
    ("serving", {"mode": "sideways"}), ("serving", {"bogus_key": 1}),
    ("serving", {"slo_window": 2}), ("serving", {"breach_admit_every": 1}),
    ("serving", {"reply_timeout": 0}), ("serving", {"snapshot_cache": 0}),
    ("serving", {"max_connections": 0}), ("serving", {"port": -1}),
    ("serving", {"mode": "on", "router_address": "10.0.0.1:9994"}),
    ("serving", {"mode": "on", "router_address": "nocolon"}),
    ("router", None), ("router", {"mode": "on", "port": 0}),
    ("router", {"policy": "random"}), ("router", {"policy": "hash"}),
    ("router", {"heartbeat_interval": 0}),
    ("router", {"heartbeat_interval": 2.0, "heartbeat_timeout": 1.0}),
    ("router", {"max_attempts": 0}), ("router", {"reply_timeout": 0}),
    ("router", {"replica_failures": -1}), ("router", {"failure_window": 0}),
]


@pytest.mark.parametrize("section,raw", SECTIONS, ids=str)
def test_section_configs_accept_and_refuse_as_jax(section, raw):
    cls, ref = ((ServingConfig, JaxServingConfig) if section == "serving"
                else (RouterConfig, JaxRouterConfig))

    def verdict(c):
        try:
            return vars(c.from_config(raw))
        except ValueError as exc:
            return str(exc)

    assert verdict(cls) == verdict(ref)


@pytest.mark.parametrize("train", [
    {"serving": {"mode": "on", "port": 0}},
    {"serving": {"mode": "on", "port": 0}, "pipeline": {"mode": "off"}},
    {"router": {"mode": "on", "port": 0}},
    {"router": {"mode": "on"}, "serving": {"mode": "on"}},
    {"status_port": 8787}, {"status_port": -1},
    {"serving": {"mode": "on"}, "router": {"mode": "on"},
     "status_port": 9000, "profile_dir": "prof", "telemetry": False},
], ids=str)
def test_learner_config_serving_keys_as_jax(train):
    raw = {"env_args": {"env": "TicTacToe"}, "train_args": dict(train)}

    def verdict(module_config):
        try:
            cfg = module_config.from_dict(raw)
        except ValueError as exc:
            assert "not ported" not in str(exc)
            return "refused"
        ta = cfg.train_args
        return {k: ta[k] for k in ("serving", "router", "status_port")}

    assert verdict(Config) == verdict(JaxConfig)


# ---------------------------------------------------------------------
# the service's network plane (stub models, injected clock)
# ---------------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.now = 0.0
        self.on_advance = None

    def __call__(self):
        return self.now

    def sleep(self, dt):
        self.now += dt
        if self.on_advance is not None:
            self.on_advance(self.now)


class _StubModel:
    """Counts forwards; policy = row index + a model tag, so replies
    prove WHICH snapshot answered."""

    def __init__(self, tag=0.0):
        self.tag = float(tag)
        self.calls = []

    def inference_batch(self, obs, hidden=None):
        rows = obs.shape[0]
        self.calls.append(rows)
        return {"policy": self.tag + np.tile(
            np.arange(rows, dtype=np.float32)[:, None], (1, 3))}


def _make_service(window=1.0, max_batch=64, model=None):
    cfg = PipelineConfig.from_config({
        "mode": "on", "batch_window": window, "max_batch": max_batch,
        "ring_slots": 8, "slot_bytes": 4096,
        "traj_slots": 4, "traj_slot_mb": 1})
    clock = _FakeClock()
    model = model if model is not None else _StubModel()
    svc = InferenceService(model, cfg, epoch=1, device="cpu",
                           clock=clock, sleep=clock.sleep)
    return svc, clock, model


def test_network_and_shm_planes_share_one_dispatch():
    svc, clock, model = _make_service(window=1.0)
    try:
        spec = {"leaves": [((2,), "float32")],
                "example": np.zeros(2, np.float32), "rows_max": 4}
        desc = svc.attach(spec)
        req = ShmRing.attach(**desc["req"])
        assert req.push(shm_mod.pack_request(
            1, 2, [np.full((2, 2), 1.0, np.float32)]))
        req.close()
        seat = _NetSeat("net-0", np.zeros(2, np.float32))
        seq, slot = seat.register()

        def arrive(now):
            if now >= 0.4 and not arrive.done:
                arrive.done = True
                assert svc.submit(
                    seat, seq, 3, [np.zeros((3, 2), np.float32)])
        arrive.done = False
        clock.on_advance = arrive

        assert svc.step()
        assert model.calls == [8]  # 2 shm + 3 net rows, padded to 8
        rsp = ShmRing.attach(**desc["rsp"])
        shm_reply = rsp.pop(loads=shm_mod.loads_view)
        rsp.close()
        assert shm_reply[0] == 1 and shm_reply[1] == 1
        np.testing.assert_array_equal(shm_reply[2]["policy"][:, 0], [0, 1])
        assert slot[0].is_set() and slot[1] == 1
        np.testing.assert_array_equal(slot[2]["policy"][:, 0], [2, 3, 4])
        assert svc.stats()["net_requests"] == 1
    finally:
        svc.close()


def test_epoch_pinned_submit_routes_through_the_resolver():
    svc, clock, model = _make_service(window=0.0)
    try:
        routed = _StubModel(tag=100.0)
        svc.model_resolver = lambda epoch: (routed if epoch == 7
                                            else None)
        example = np.zeros(2, np.float32)
        seats = [_NetSeat(f"net-{i}", example) for i in range(3)]
        (sq1, live), (sq2, pinned), (sq3, lost) = [
            s.register() for s in seats]
        one = [np.zeros((1, 2), np.float32)]
        assert svc.submit(seats[0], sq1, 1, one)
        assert svc.submit(seats[1], sq2, 1, one, epoch=7)
        assert svc.submit(seats[2], sq3, 1, one, epoch=99)
        assert svc.step()
        assert live[0].is_set() and live[1] == 1
        assert live[2]["policy"][0, 0] == 0.0      # live model
        assert pinned[0].is_set() and pinned[1] == 7
        assert pinned[2]["policy"][0, 0] == 100.0  # routed snapshot
        assert lost[0].is_set() and lost[2] is None  # typed unavailable
        assert model.calls and routed.calls         # two dispatches
        svc.model_resolver = None                   # nothing routes
        sq4, slot4 = seats[0].register()
        assert svc.submit(seats[0], sq4, 1, one, epoch=7)
        assert svc.step() and slot4[2] is None
    finally:
        svc.close()


def test_live_epoch_pin_normalizes_into_the_unpinned_group():
    svc, clock, model = _make_service(window=0.0)
    try:
        example = np.zeros(2, np.float32)
        a, b = _NetSeat("net-a", example), _NetSeat("net-b", example)
        sq_a, slot_a = a.register()
        sq_b, slot_b = b.register()
        one = [np.zeros((1, 2), np.float32)]
        assert svc.submit(a, sq_a, 1, one)
        assert svc.submit(b, sq_b, 1, one, epoch=1)  # pinned to live
        assert svc.step()
        assert model.calls == [8]                    # ONE forward
        assert slot_a[1] == 1 and slot_b[1] == 1
        svc.stop()
        assert not svc.submit(a, 9, 1, one)          # shut for good
    finally:
        svc.close()


def _geese(seed, filters=8, blocks=2):
    env = jax_make_env({"env": "HungryGeese"})
    jax_model = TPUModel(FlaxGeeseNet(filters=filters, blocks=blocks))
    jax_model.init_params(env.observation(0), seed=seed)
    params = jax.tree.map(np.asarray, jax_model.params)
    return jax_model, TorchModel.from_flax(
        GeeseNet(filters=filters, blocks=blocks), params, device="cpu")


def _geese_obs(rows, seed):
    random.seed(seed)
    rng = np.random.default_rng(seed)
    env = make_env({"env": "HungryGeese"})
    obs = []
    for _ in range(rows):
        env.reset()
        for _ in range(int(rng.integers(0, 5))):
            env.step({p: int(rng.integers(4)) for p in env.turns()})
            if env.terminal():
                break
        obs.append(env.observation(int(rng.integers(4))))
    return np.stack(obs)


@pytest.mark.parametrize("cache,loads", [(4, 3), (1, 7)])
def test_param_loads_count_snapshots_not_dispatches(cache, loads):
    """Alternating live and pinned traffic: with room for both routed
    snapshots every snapshot is copied to the device once (3 loads: the
    live one and two pins); a one-snapshot cache re-copies each time a
    pin alternates (the LRU's bound, not a per-dispatch reload)."""
    models = {}
    for e in (1, 2, 3):
        models[e] = TorchModel(GeeseNet(filters=8, blocks=2), device="cpu")
        models[e].init_params(seed=e)
    svc, clock, _ = _make_service(window=0.0, model=models[1])
    try:
        svc.snapshot_cache = cache
        svc.model_resolver = models.get
        obs = _geese_obs(2, seed=0)
        seat = _NetSeat("net", obs[0])
        replies = []
        for pin in (None, 2, None, 3, 2, 3, None, 2, 3, 2):
            seq, slot = seat.register()
            assert svc.submit(seat, seq, 2, [obs], epoch=pin)
            assert svc.step() and slot[0].is_set()
            replies.append((pin, slot[1], slot[2]))
        assert svc.stats()["param_loads"] == loads
        assert svc.stats()["device_modules"] == min(3, cache + 1)
        for pin, epoch, out in replies:
            assert epoch == (pin or 1)
            want = models[pin or 1].inference_batch(obs)
            np.testing.assert_allclose(out["policy"], want["policy"],
                                       rtol=0, atol=1e-5)
    finally:
        svc.close()


# ---------------------------------------------------------------------
# frontend admission / SLO (stub service, no sockets)
# ---------------------------------------------------------------------

class _StubEnv:
    def players(self):
        return [0]

    def reset(self):
        pass

    def observation(self, player):
        return np.zeros(2, np.float32)


class _StubService:
    def __init__(self):
        self.alive = True
        self.cfg = PipelineConfig.from_config({"max_batch": 64})

    def submit(self, *a, **k):
        return True


def _frontend(**over):
    cfg = ServingConfig.from_config({
        "mode": "on", "port": 0, "slo_ms": 10.0, "slo_window": 8,
        "max_inflight": 4, "breach_admit_every": 4, **over})
    return ServingFrontend(_StubService(), _StubEnv(), cfg)


def test_admission_sheds_on_breach_with_a_trickle():
    fe = _frontend()
    for _ in range(8):
        fe._observe(1.0)
    assert fe._admit() is None and not fe._breached
    fe._release()
    for _ in range(8):
        fe._observe(50.0)
    assert fe._breached
    outcomes = [fe._admit() for _ in range(8)]
    assert outcomes.count("slo") == 6 and outcomes.count(None) == 2
    for _ in range(8):
        fe._observe(1.0)
    assert not fe._breached


def test_admission_reserves_inflight_and_sheds_overload_and_down():
    fe = _frontend()
    for _ in range(fe.cfg.max_inflight):
        assert fe._admit() is None
    assert fe._admit() == "overload"
    fe._release()
    assert fe._admit() is None
    fe.inflight = 0
    fe.service.alive = False
    assert fe._admit() == "service_down"


def test_epoch_stats_reduce_and_reset():
    fe = _frontend()
    fe._count("ok")
    fe._count("shed", "slo")
    fe._count("error")
    with fe._lock:
        fe._epoch_counts["submitted"] = 3
    fe._observe(2.0)
    out = fe.epoch_stats()
    assert (out["serve_requests"], out["serve_ok"], out["serve_shed"],
            out["serve_errors"]) == (3, 1, 1, 1)
    assert out["serve_p50_ms"] > 0 and out["serve_max_ms"] == 2.0
    again = fe.epoch_stats()
    assert again["serve_requests"] == 0 and "serve_p50_ms" not in again
    stats = fe.stats()
    assert stats["ok"] == 1 and stats["shed_by"] == {"slo": 1}
    advert = fe.advert(epochs=[3, 1])
    assert advert["epochs"] == [1, 3] and advert["capacity"] == 4


# ---------------------------------------------------------------------
# over real TCP (stub model, real service thread)
# ---------------------------------------------------------------------

def _real_stack(model=None, env=None, **serving_over):
    pcfg = PipelineConfig.from_config({
        "mode": "on", "batch_window": 0.001, "max_batch": 16})
    model = model if model is not None else _StubModel()
    svc = InferenceService(model, pcfg, epoch=1, device="cpu")
    svc.start()
    scfg = ServingConfig.from_config({
        "mode": "on", "port": 0, "slo_ms": 0.0, "reply_timeout": 3.0,
        **serving_over})
    fe = ServingFrontend(svc, env or _StubEnv(), scfg)
    fe.start()
    return svc, fe


def _wait(cond, deadline=10.0, msg="condition never held"):
    limit = time.monotonic() + deadline
    while not cond():
        assert time.monotonic() < limit, msg
        time.sleep(0.01)


def test_served_requests_over_tcp_and_typed_failures():
    svc, fe = _real_stack()
    client = None
    try:
        client = ServeClient("127.0.0.1", fe.port, timeout=5.0)
        reply = client.infer(np.zeros(2, np.float32))
        assert reply["epoch"] == 1
        assert reply["outputs"]["policy"].shape == (3,)
        batch = np.zeros((4, 2), np.float32)
        assert client.infer_batch(batch)["outputs"]["policy"].shape == (4, 3)
        with pytest.raises(ServeError, match="bad request"):
            client.infer_batch(np.zeros((2, 9), np.float32))
        with pytest.raises(ServeError, match="unavailable"):
            client.infer_batch(batch, epoch=42)
        assert client.infer_batch(batch)["epoch"] == 1
        stats = client.stats()
        assert stats["submitted"] == 5 and stats["errors"] == 2
        assert stats["submitted"] == (stats["ok"] + stats["shed"]
                                      + stats["errors"])
    finally:
        if client is not None:
            client.close()
        fe.close()
        svc.close()


def test_service_kill_sheds_typed_then_respawn_resumes():
    svc, fe = _real_stack()
    client = None
    try:
        client = ServeClient("127.0.0.1", fe.port, timeout=5.0)
        obs = np.zeros(2, np.float32)
        assert client.infer(obs)["epoch"] == 1
        svc.inject_kill()
        _wait(lambda: not svc.alive, 3.0, "kill never landed")
        with pytest.raises(ShedError) as err:
            client.infer(obs)
        assert err.value.reason == "service_down"
        svc.respawn()
        assert client.infer(obs)["epoch"] == 1
        stats = fe.stats()
        assert stats["shed_by"] == {"service_down": 1}
        assert stats["submitted"] == (stats["ok"] + stats["shed"]
                                      + stats["errors"])
    finally:
        if client is not None:
            client.close()
        fe.close()
        svc.close()


def test_connection_cap_and_frontend_kill_respawn():
    svc, fe = _real_stack(max_connections=1)
    clients = []
    try:
        obs = np.zeros(2, np.float32)
        clients.append(ServeClient("127.0.0.1", fe.port, timeout=5.0))
        assert clients[0].infer(obs)["epoch"] == 1
        refused = ServeClient("127.0.0.1", fe.port, timeout=3.0)
        with pytest.raises(Exception):
            refused.infer(obs)
        refused.close()
        _wait(lambda: fe.stats()["connections_refused"] >= 1)
        fe.inject_kill()
        _wait(lambda: not fe.alive, 3.0, "kill never landed")
        with pytest.raises(Exception):
            clients[0].infer(obs)
        fe.respawn()
        assert fe.alive and fe.generation == 1
        clients.append(ServeClient("127.0.0.1", fe.port, timeout=5.0))
        assert clients[-1].infer(obs)["epoch"] == 1
    finally:
        for c in clients:
            c.close()
        fe.close()
        svc.close()


# ---------------------------------------------------------------------
# serving parity: both packages serve the same GeeseNet over TCP
# ---------------------------------------------------------------------

def test_served_geesenet_matches_jax_and_clients_cross():
    (jax_live, torch_live), (jax_old, torch_old) = _geese(11), _geese(12)
    window = {"mode": "on", "batch_window": 0.001, "max_batch": 16}
    scfg = {"mode": "on", "port": 0, "slo_ms": 0.0, "reply_timeout": 10.0}
    jsvc = JaxService(jax_live, JaxPipelineConfig.from_config(window),
                      epoch=5)
    tsvc = InferenceService(torch_live, PipelineConfig.from_config(window),
                            epoch=5, device="cpu")
    jsvc.model_resolver = lambda e: jax_old if e == 4 else None
    tsvc.model_resolver = lambda e: torch_old if e == 4 else None
    tsvc.snapshot_cache = 4   # what the learner sets from serving.*
    stacks = []
    clients = []
    try:
        for svc, fe_cls, cfg_cls, env in (
                (jsvc, JaxFrontend, JaxServingConfig,
                 jax_make_env({"env": "HungryGeese"})),
                (tsvc, ServingFrontend, ServingConfig,
                 make_env({"env": "HungryGeese"}))):
            svc.start()
            fe = fe_cls(svc, env, cfg_cls.from_config(scfg))
            fe.start()
            stacks.append(fe)
        jfe, tfe = stacks
        # each package's client on each frontend
        for cls, fe in ((JaxClient, jfe), (ServeClient, tfe),
                        (ServeClient, jfe), (JaxClient, tfe)):
            clients.append(cls("127.0.0.1", fe.port, timeout=60.0))
        for seed, rows in ((0, 4), (1, 1), (2, 7)):
            obs = _geese_obs(rows, seed)
            for pin, epoch in ((None, 5), (4, 4), (5, 5)):
                got = [c.infer_batch(obs, epoch=pin) for c in clients]
                for reply in got:
                    assert reply["epoch"] == epoch
                ref = got[0]["outputs"]
                for reply in got[1:]:
                    for key in ("policy", "value"):
                        out = np.asarray(reply["outputs"][key])
                        assert out.shape == np.asarray(ref[key]).shape
                        np.testing.assert_allclose(
                            out, np.asarray(ref[key]), rtol=0, atol=1e-5)
        for c in clients[:2]:
            with pytest.raises(Exception, match="unavailable"):
                c.infer_batch(_geese_obs(1, 3), epoch=9)
        assert tsvc.stats()["param_loads"] == 2   # live + one pin
    finally:
        for c in clients:
            c.close()
        for fe in stacks:
            fe.close()
        jsvc.close()
        tsvc.close()


# ---------------------------------------------------------------------
# a CPU learner with the whole serving tier on
# ---------------------------------------------------------------------

def test_learner_serves_pinned_epochs_through_router_and_status(
        tmp_path, monkeypatch):
    from handyrl_tpu_torch.connection import find_free_port
    from handyrl_tpu_torch.durability import read_verified
    from handyrl_tpu_torch.learner import Learner
    from handyrl_tpu_torch.models.convert import from_flax
    from handyrl_tpu_torch.telemetry.export import collect_run

    monkeypatch.chdir(tmp_path)
    status_port = find_free_port()
    args = {"env_args": {"env": "TicTacToe"}, "train_args": {
        "turn_based_training": True, "observation": False, "gamma": 0.8,
        "forward_steps": 4, "burn_in_steps": 0, "compress_steps": 4,
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1, "update_episodes": 20,
        "batch_size": 4, "minimum_episodes": 10, "maximum_episodes": 200,
        # the client's requests start once epoch 2 is live: a fourth
        # epoch keeps them inside a recorded epoch under load (with 3,
        # a fast last epoch could close before they were served)
        "epochs": 4, "num_batchers": 1, "eval_rate": 0.1,
        "worker": {"num_parallel": 2}, "lambda": 0.7,
        "policy_target": "TD", "value_target": "TD", "seed": 1,
        "metrics_path": "metrics.jsonl", "status_port": status_port,
        "updates_per_epoch": 4, "profile_dir": "prof",
        "serving": {"mode": "on", "port": 0, "slo_ms": 0.0},
        "router": {"mode": "on", "port": 0, "heartbeat_interval": 0.2,
                   "heartbeat_timeout": 1.0}},
        "worker_args": {"num_parallel": 2}}
    learner = Learner(args, device="cpu")
    runner = threading.Thread(target=learner.run, daemon=True)
    runner.start()
    client = None
    try:
        deadline = time.monotonic() + 120
        while not (learner.model_epoch >= 2
                   and os.path.exists("models/1.ckpt")):
            assert time.monotonic() < deadline, "epoch 2 never came"
            assert runner.is_alive(), "learner died early"
            time.sleep(0.05)
        _wait(lambda: learner.router_frontend.registry.pool_size() == 1,
              msg="the learner's frontend never joined its router")
        env = make_env({"env": "TicTacToe"})
        env.reset()
        obs = np.stack([env.observation(0)] * 4)
        client = ServeClient("127.0.0.1", learner.router_frontend.port,
                             timeout=30.0)
        pinned = client.infer_batch(obs, epoch=1)
        assert pinned["epoch"] == 1
        local = TorchModel(env.net(), device="cpu")
        local.load_params(from_flax(
            read_verified("models/1.ckpt")["params"], local.module))
        want = local.inference_batch(obs)
        for key in ("policy", "value"):
            np.testing.assert_allclose(pinned["outputs"][key], want[key],
                                       rtol=0, atol=1e-5)
        assert client.infer_batch(obs)["epoch"] >= 2
        base = f"http://127.0.0.1:{status_port}"
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            snap = json.loads(r.read())
        assert snap["serving"]["ok"] >= 2
        assert snap["router"]["registry"]["pool_size"] == 1
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["ok"] is True
    finally:
        if client is not None:
            client.close()
        runner.join(timeout=120)
    assert not runner.is_alive() and learner.trainer.failure is None
    with open("metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 4
    for r in records:
        for key in ("serve_requests", "serve_ok", "serve_shed",
                    "serve_qps", "serve_respawns", "router_requests",
                    "router_pool_size", "router_respawns"):
            assert key in r, key
        assert r["arithmetic_intensity"] is not None
        tracked = sum(v for k, v in r.items()
                      if k.startswith("profile_") and k.endswith("_sec"))
        assert round(r["epoch_wall_sec"] - tracked, 6) == \
            r["untracked_residual_sec"]
    assert sum(r["serve_ok"] for r in records) >= 2
    assert sum(r["router_ok"] for r in records) >= 2
    roles, spans = collect_run(".")
    names = {(roles.get(s["pid"], "")[:6], s["name"]) for s in spans}
    for want in (("learne", "trainer.update"), ("learne", "infer.batch"),
                 ("learne", "serve.request"), ("learne", "route.request"),
                 ("worker", "episode.rollout")):
        assert want in names, want
    by_trace = {}
    for s in spans:
        if "trace" in s:
            by_trace.setdefault(s["trace"], set()).add(s["pid"])
    assert any(len(pids) > 1 for pids in by_trace.values())
    assert os.listdir("prof")          # the profiler window's trace
