"""The port's resilience layer held against the JAX package's, scenario
by scenario.

Each scenario drives one package's ``resilience`` (and the gather's
surge hold and backlog pacing) on an injected clock, an injected RNG
and fake children, and returns what it observed: backoff schedules,
supervisor events and slot states, breaker trips, registry sweeps and
snapshots, chaos kills and surges, the learner kill switch and the
relaunch guard.  The port's trace must EQUAL the JAX package's
(exact: the state machines are deterministic under injection), and
each scenario asserts the behaviour it is named for.  ``ChaosConfig``
accepts and refuses the same sections in both packages, the shm-plane
and serving-replica keys included, with the same enabled flags.
"""

import dataclasses
import os
import random
import types

import pytest

import handyrl_tpu.resilience as jres
import handyrl_tpu.resilience.supervisor as jsup
import handyrl_tpu.worker as jworker
import handyrl_tpu_torch.resilience as tres
import handyrl_tpu_torch.resilience.supervisor as tsup
import handyrl_tpu_torch.worker as tworker

PACKAGES = {
    "jax": types.SimpleNamespace(
        res=jres, FailureWindow=jsup.FailureWindow, Gather=jworker.Gather),
    "port": types.SimpleNamespace(
        res=tres, FailureWindow=tsup.FailureWindow, Gather=tworker.Gather),
}


class FakeChild:
    """Supervised-child duck type (is_alive/terminate/exitcode)."""

    def __init__(self, alive=True, exitcode=None):
        self.alive = alive
        self.exitcode = exitcode
        self.terminations = 0

    def is_alive(self):
        return self.alive

    def terminate(self):
        self.terminations += 1
        self.alive = False


class FixedRng:
    def __init__(self, value=0.0):
        self.value = value

    def random(self):
        return self.value

    def randrange(self, n):
        return 0


class FakeProc:
    def __init__(self, code):
        self.exitcode = code

    def join(self):
        pass


def _supervisor(m, num_slots=1, max_respawns=3, window=100.0, **kw):
    spawned = []

    def spawn(slot):
        child = FakeChild()
        spawned.append((slot, child))
        return child

    sup = m.res.Supervisor(
        spawn, num_slots,
        policy=m.res.BackoffPolicy(base=1.0, factor=2.0, cap=64.0,
                                   jitter=0.5, rng=FixedRng(0.0)),
        max_respawns=max_respawns, failure_window=window,
        clock=lambda: 0.0, **kw)
    return sup, spawned


def _events(events):
    return [tuple(e) for e in events]


# -- scenarios: each returns a trace; port == jax is the test ------------

def backoff_schedule(m, tmp):
    capped = m.res.BackoffPolicy(base=1.0, factor=2.0, cap=8.0,
                                 jitter=0.5, rng=FixedRng(0.0))
    full = m.res.BackoffPolicy(base=1.0, factor=2.0, cap=8.0, jitter=0.5,
                               rng=FixedRng(1.0))
    seeded = m.res.BackoffPolicy(rng=random.Random(42))
    trace = {"capped": [capped.delay(a) for a in range(5)],
             "full_jitter": full.delay(0),
             "seeded": [seeded.delay(a) for a in range(6)]}
    assert trace["capped"] == [1.0, 2.0, 4.0, 8.0, 8.0]
    assert trace["full_jitter"] == pytest.approx(1.5)
    return trace


def failure_window(m, tmp):
    win = m.FailureWindow(2, 5.0)
    trips = [(t, win.record(t), len(win))
             for t in (0.0, 1.0, 2.0, 3.0, 10.0, 11.0, 12.0, 13.0)]
    strict = m.FailureWindow(0, 60.0)
    trace = {"trips": trips, "strict": strict.record(0.0)}
    assert trace["strict"] is True       # 0 trips on the first failure
    assert [t for t, tripped, _ in trips if tripped] == [2.0, 3.0, 12.0,
                                                         13.0]
    return trace


def supervisor_respawn_schedule(m, tmp):
    sup, spawned = _supervisor(m)
    sup.start_all(now=0.0)
    trace = [sup.respawns]
    spawned[0][1].alive = False
    for now in (10.0, 10.9, 11.0):
        trace.append(_events(sup.poll(now=now)))
    spawned[1][1].alive = False
    for now in (20.0, 21.9, 22.0):
        trace.append(_events(sup.poll(now=now)))
    trace.append((sup.respawns, sup.slot_state(0).value, len(spawned)))
    assert trace[-1] == (2, "running", 3)
    return trace


def supervisor_breaker_trips(m, tmp):
    sup, spawned = _supervisor(m, num_slots=2, max_respawns=2)
    sup.start_all(now=0.0)
    trace, t = [], 0.0
    for _ in range(3):
        [c for s, c in spawned if s == 0][-1].alive = False
        t += 10.0
        trace.append(_events(sup.poll(now=t)))
        t += 10.0
        trace.append(_events(sup.poll(now=t)))
    trace.append((sup.slot_state(0).value, sup.dead_count(),
                  sup.alive_count(), sup.stats()))
    assert trace[-1][0] == "dead" and trace[-1][2] == 1
    return trace


def supervisor_window_ages_out(m, tmp):
    sup, spawned = _supervisor(m, max_respawns=2, window=5.0)
    sup.start_all(now=0.0)
    trace, t = [], 0.0
    for _ in range(6):
        [c for s, c in spawned if s == 0][-1].alive = False
        t += 10.0
        sup.poll(now=t)
        trace.append(sup.slot_state(0).value)
        t += 5.0
        sup.poll(now=t)
        trace.append(sup.slot_state(0).value)
    assert sup.respawns == 6
    return trace


def supervisor_drain_and_kill(m, tmp):
    sup, spawned = _supervisor(m)
    sup.start_all(now=0.0)
    sup.kill_slot(0, reason="test eviction")
    trace = [spawned[0][1].terminations, _events(sup.poll(now=1.0)),
             _events(sup.poll(now=2.0))]
    sup.stop()
    spawned[-1][1].alive = False  # a drain-time exit is expected
    trace += [_events(sup.poll(now=10.0)), sup.slot_state(0).value,
              len(spawned)]
    assert trace[-2:] == ["stopped", 2]
    return trace


def supervisor_spawn_failure_and_hold(m, tmp):
    attempts = []

    def flaky(slot):
        attempts.append(slot)
        if len(attempts) <= 2:
            raise OSError("connection refused")
        return FakeChild()

    sup = m.res.Supervisor(
        flaky, 1, policy=m.res.BackoffPolicy(
            base=1.0, factor=2.0, jitter=0.5, rng=FixedRng(0.0)),
        max_respawns=5, clock=lambda: 0.0)
    trace = []
    for now in (0.0, 1.0, 3.0):
        trace.append((_events(sup.poll(now=now)), sup.alive_count()))
    sup.hold_respawns(20.0, now=10.0)
    sup.kill_slot(0)
    for now in (10.0, 15.0, 29.9, 30.0):
        trace.append(_events(sup.poll(now=now)))
    assert trace[2][1] == 1 and trace[-1] == [("respawn", 0)]
    return trace


def supervisor_clean_exit_is_a_drain(m, tmp):
    children = []

    def spawn(slot):
        child = FakeChild()
        children.append(child)
        return child

    sup = m.res.Supervisor(
        spawn, 2, policy=m.res.BackoffPolicy(base=1.0, jitter=0.5,
                                             rng=FixedRng(0.0)),
        clock=lambda: 0.0, treat_clean_exit_as_drain=True)
    sup.start_all(now=0.0)
    children[0].alive, children[0].exitcode = False, 0
    children[1].alive, children[1].exitcode = False, 1
    trace = [sorted(_events(sup.poll(now=10.0))),
             _events(sup.poll(now=11.0)), sup.stopped_count(),
             len(children)]
    assert trace[-2:] == [1, 3]
    return trace


def registry_expiry_and_recovery(m, tmp):
    t = [0.0]
    reg = m.res.FleetRegistry(heartbeat_timeout=10.0, clock=lambda: t[0])
    reg.observe("a", "args", None)
    reg.observe("b", "beat", {"gather_id": 1, "workers": 4})
    trace = [reg.fleet_size()]
    t[0] = 5.0
    reg.observe("b", "episode", [{"e": 1}, {"e": 2}])
    trace += [reg.sweep(), reg.heartbeat_misses, reg.peak_size]
    t[0] = 10.5
    trace += [reg.sweep(), reg.heartbeat_misses, reg.fleet_size(),
              reg.sweep()]
    t[0] = 11.0
    reg.observe("a", "args", None)
    trace += [reg.fleet_size(), reg.heartbeat_misses]
    t[0] = 11.0 + 10.0 * reg.FORGET_AFTER_TIMEOUTS + 1.0
    reg.sweep()
    trace.append(reg.peers())
    assert trace[4] == ["a"] and trace[-1] == []
    return trace


def registry_pardon_and_peak(m, tmp):
    t = [0.0]
    reg = m.res.FleetRegistry(heartbeat_timeout=10.0, clock=lambda: t[0])
    reg.observe("a", "args", None)
    reg.observe("b", "args", None)
    t[0] = 40.0
    reg.pardon()
    trace = [reg.sweep(), reg.heartbeat_misses]
    t[0] = 51.0
    trace.append(sorted(reg.sweep()))
    peak = m.res.FleetRegistry(heartbeat_timeout=10.0, clock=lambda: t[0])
    peak.observe("old", "args", None)
    t[0] = 52.0
    peak.observe("new", "args", None)
    trace.append(peak.peak_size)
    peak.forget("old")
    peak.sweep()
    trace.append(peak.peak_size)
    assert trace[0] == [] and trace[-2:] == [0, 1]
    return trace


def registry_snapshot(m, tmp):
    t = [0.0]
    reg = m.res.FleetRegistry(heartbeat_timeout=10.0, clock=lambda: t[0])
    reg.observe("g0", "episode", [1, 2, 3, 4])
    reg.observe("g0", "beat", {"gather_id": 0, "workers": 16})
    t[0] = 2.0
    reg.record_drops({"send_drops": 3, "disconnects": 1,
                      "unknown_verbs": 2})
    snap = reg.snapshot()
    assert snap["fleet_workers"] == 16 and snap["conn_drops"] == 4
    assert snap["fleet_eps_per_sec"] == pytest.approx(2.0)
    return snap


def chaos_monkey_kills(m, tmp):
    sup, spawned = _supervisor(m, num_slots=2)
    sup.start_all(now=0.0)
    monkey = m.res.ChaosMonkey(
        m.res.ChaosConfig(kill_prob=1.0, max_kills=1),
        rng=random.Random(0), clock=lambda: 100.0)
    trace = [monkey.maybe_kill(sup), monkey.maybe_kill(sup),
             [c.terminations for _, c in spawned]]
    sup.poll(now=101.0)
    sup.poll(now=110.0)
    trace.append((sup.respawns, sup.alive_count()))
    late = m.res.ChaosMonkey(
        m.res.ChaosConfig(kill_prob=1.0, kill_after=50.0),
        rng=FixedRng(0.0), clock=lambda: 0.0)
    trace += [late.maybe_kill(sup, now=49.0), late.maybe_kill(sup, now=50.0)]
    assert trace[:2] == [True, False] and trace[-2:] == [False, True]
    return trace


def chaos_surge(m, tmp):
    sup, spawned = _supervisor(m, num_slots=3)
    sup.start_all(now=0.0)
    monkey = m.res.ChaosMonkey(
        m.res.ChaosConfig(surge_epoch=2, surge_kills=2,
                          surge_respawn_hold=50.0),
        rng=FixedRng(0.0), clock=lambda: 0.0)
    trace = [monkey.maybe_surge(sup, now=0.0)]
    monkey.note_epoch(1)
    trace.append(monkey.maybe_surge(sup, now=0.0))
    monkey.note_epoch(2)
    trace += [monkey.maybe_surge(sup, now=0.0), monkey.surge_kill_count,
              monkey.kills, monkey.maybe_surge(sup, now=1.0),
              {s: c.terminations for s, c in spawned}]
    sup.poll(now=10.0)
    trace += [_events(sup.poll(now=40.0)),
              sorted(_events(sup.poll(now=51.0))), sup.alive_count()]
    assert trace[2] is True and trace[-1] == 3
    return trace


def learner_kill_switch(m, tmp):
    fired = []
    cfg = m.res.ChaosConfig.from_config(
        {"learner_kill_epoch": 2, "learner_kill_after_episodes": 3})
    marker = os.path.join(tmp, f"killed-{id(m)}")
    switch = m.res.LearnerKillSwitch(cfg, marker,
                                     kill=lambda: fired.append(1))
    trace = [switch.note(1, 50), switch.note(2, 50), switch.note(2, 52),
             switch.note(2, 53), list(fired), os.path.exists(marker)]
    again = m.res.LearnerKillSwitch(cfg, marker,
                                    kill=lambda: fired.append(2))
    trace += [again.armed, again.note(2, 999), list(fired)]
    assert trace[3] is True and trace[-1] == [1]
    return trace


def learner_guard_relaunches_then_trips(m, tmp):
    codes = [-9, 1, 0]
    spawned = []

    def spawn(target, args):
        spawned.append(args["train_args"].get("restart_epoch"))
        return FakeProc(codes.pop(0))

    guard = m.res.LearnerGuard(
        None, {"train_args": {"restart_epoch": 0}}, max_restarts=5,
        policy=m.res.BackoffPolicy(base=0.01, jitter=0.0),
        spawn=spawn, sleep=lambda s: None)
    trace = [guard.run(), guard.restarts, guard.tripped, spawned]
    launches = []

    def poison(target, args):
        launches.append(args["train_args"].get("restart_epoch"))
        return FakeProc(17)

    sleeps = []
    storm = m.res.LearnerGuard(
        None, {"train_args": {}}, max_restarts=2, failure_window=600.0,
        policy=m.res.BackoffPolicy(base=0.5, jitter=0.0),
        spawn=poison, clock=lambda: 100.0, sleep=sleeps.append)
    trace += [storm.run(), storm.tripped, launches, sleeps]
    from_args = m.res.LearnerGuard.from_args(
        None, {"train_args": {"max_respawns": 3, "respawn_backoff": 2.0}})
    trace += [from_args._failures.max_failures, from_args.policy.base]
    assert trace[:4] == [0, 2, False, [0, "auto", "auto"]]
    assert trace[4:7] == [17, True, [None, "auto", "auto"]]
    return trace


def gather_surge_hold(m, tmp):
    g = m.Gather.__new__(m.Gather)
    g.gather_id = 0
    g._init_surge({"chaos": {"surge_epoch": 2, "surge_hold_uploads": 30.0}})
    trace = [g._surge_pending, g._holding_uploads()]
    g._note_surge([{"role": "g", "model_id": {0: 1, 1: -1}}, None])
    trace += [g._surge_pending, g._holding_uploads()]
    g._note_surge([{"role": "g", "model_id": {0: 2, 1: 2}}])
    trace += [g._surge_pending, g._holding_uploads()]
    off = m.Gather.__new__(m.Gather)
    off._init_surge({"chaos": {"kill_prob": 1.0}})
    trace.append(off._surge_pending)
    assert trace == [True, False, True, False, False, True, False]
    return trace


def gather_backlog_drains_in_blocks(m, tmp):
    def make(backlog):
        g = m.Gather.__new__(m.Gather)
        g.gather_id = 0
        g._init_surge({})
        g.block_size = 2
        g.pending_uploads = {"episode": list(range(backlog)),
                             "result": ["r"]}
        g.pending_count = backlog + 1
        g.shipped = []
        g._ask_learner = lambda req, g=g: g.shipped.append(req) or []
        return g

    paced, drained = make(10), make(10)
    paced.flush_uploads()
    trace = [paced.pending_count, list(paced.shipped)]
    drained.flush_uploads(drain=True)
    trace += [drained.pending_count, list(drained.shipped)]
    assert trace[0] == 7 and trace[2] == 0
    return trace


SCENARIOS = [backoff_schedule, failure_window, supervisor_respawn_schedule,
             supervisor_breaker_trips, supervisor_window_ages_out,
             supervisor_drain_and_kill, supervisor_spawn_failure_and_hold,
             supervisor_clean_exit_is_a_drain, registry_expiry_and_recovery,
             registry_pardon_and_peak, registry_snapshot, chaos_monkey_kills,
             chaos_surge, learner_kill_switch,
             learner_guard_relaunches_then_trips, gather_surge_hold,
             gather_backlog_drains_in_blocks]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_matches_jax(scenario, tmp_path):
    """Exact equality of the two packages' traces."""
    port = scenario(PACKAGES["port"], str(tmp_path))
    jax = scenario(PACKAGES["jax"], str(tmp_path))
    assert port == jax


# -- ChaosConfig ----------------------------------------------------------

ACCEPTED = [
    {}, {"kill_prob": 0.2, "max_kills": 1, "infer_kill_epoch": 1},
    {"frame_drop_prob": 0.3, "frame_truncate_prob": 0.3, "seed": 7},
    {"surge_epoch": 2, "surge_kills": 1, "surge_respawn_hold": 5.0,
     "surge_hold_uploads": 3.0},
    {"learner_kill_epoch": 2, "learner_kill_after_episodes": 4},
    # the shm and serving chaos hooks (refused until they were ported)
    {"shm_tear_prob": 0.1}, {"shm_full_prob": 0.2},
    {"shm_truncate_prob": 0.1}, {"shm_stall_prob": 0.5},
    {"shm_beat_drop_prob": 0.1}, {"shm_beat_delay_prob": 0.1},
    {"serve_kill_epoch": 2},
]
REFUSED_BOTH = [
    {"bogus": 1}, {"kill_prob": 1.5}, {"frame_delay": -1.0},
    {"frame_drop_prob": 0.6, "frame_truncate_prob": 0.6},
    {"surge_epoch": -1}, {"learner_kill_epoch": -2},
    {"infer_kill_epoch": -1},
]


@pytest.mark.parametrize("raw", ACCEPTED, ids=str)
def test_chaos_config_accepts_what_jax_accepts(raw):
    port = tres.ChaosConfig.from_config(raw)
    jax = jres.ChaosConfig.from_config(raw)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    for flag in ("kills_enabled", "frames_enabled", "surges_enabled",
                 "learner_kill_enabled", "infer_kill_enabled",
                 "serve_kill_enabled", "shm_faults_enabled",
                 "shm_beat_faults_enabled"):
        assert getattr(port, flag) == getattr(jax, flag), flag
    from handyrl_tpu_torch.config import TrainConfig

    TrainConfig(chaos=raw)  # the learner's config takes every key too


@pytest.mark.parametrize("raw", REFUSED_BOTH, ids=str)
def test_chaos_config_refuses_what_jax_refuses(raw):
    with pytest.raises(ValueError):
        jres.ChaosConfig.from_config(raw)
    with pytest.raises(ValueError):
        tres.ChaosConfig.from_config(raw)


