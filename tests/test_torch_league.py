"""League-lite in the port: past-self opponents in generation jobs.

The scenarios of ``tests/test_league.py`` against the port's
``Learner`` (past seats only from retained checkpoint files, league
off and cold start, outcomes keyed by the past epoch), then:
  * the same ``random.seed`` gives the same job sequence from both
    packages' ``_assign_job`` (the calls consume Python ``random`` in
    the JAX order);
  * the worker side: a league job carries two snapshot ids, so the
    lockstep pool refuses it and the sequential path plays it, the
    worker wraps each snapshot for the service pinned to its own epoch,
    and the ``ModelCache`` LRU fetches the same snapshots as the JAX
    package's over a league schedule;
  * a short CPU ``Learner`` run with two spawned workers produces league
    episodes and reports ``league_opponent_mean`` only for past epochs
    whose checkpoint exists.
"""

import json
import os
import pickle
import random
import threading
from collections import deque

import pytest

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.learner import Learner as JaxLearner
from handyrl_tpu.worker import ModelCache as JaxModelCache
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import RolloutPool
from handyrl_tpu_torch.learner import Learner, model_path
from handyrl_tpu_torch.worker import ModelCache, Worker
from torchfix import one_torch_thread  # noqa: F401  (autouse)

LEAGUE = {"past_epochs": 3, "prob": 1.0}


def _stub(cls, make, league=LEAGUE, epoch=5, eval_rate=0.0):
    lrn = cls.__new__(cls)
    lrn.args = {"generation_opponent": dict(league)} if league else {}
    lrn.env = make({"env": "TicTacToe"})
    lrn.model_epoch = epoch
    lrn.eval_rate = eval_rate
    lrn.jobs_generated = 1
    lrn.jobs_evaluated = 1
    lrn._policy_lags = []
    lrn.trainer = None   # _assign_job asks whether Anakin is on
    return lrn


@pytest.fixture
def models_dir(tmp_path, monkeypatch):
    """Epochs 3 and 4 retained on disk; epoch 2 pruned."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("models")
    for e in (3, 4):
        with open(model_path(e), "wb") as f:
            f.write(b"snapshot")
    return tmp_path


def test_league_jobs_seat_retained_past_epochs(models_dir):
    lrn = _stub(Learner, make_env)
    random.seed(0)
    seen_past = set()
    for _ in range(30):
        job = lrn._assign_job()
        assert job["role"] == "g"
        # exactly one league seat, holding a past epoch that survives
        # on disk (epoch 2 is inside past_epochs but pruned)
        opp = [mid for p, mid in job["model_id"].items()
               if p not in job["player"]]
        assert len(opp) == 1 and opp[0] in (3, 4)
        seen_past.add(opp[0])
        assert {job["model_id"][p] for p in job["player"]} == {5}
    assert seen_past == {3, 4}


def test_league_off_and_cold_start_fall_back_to_self_play(models_dir):
    lrn = _stub(Learner, make_env, league=None)
    job = lrn._assign_job()
    assert set(job["player"]) == set(lrn.env.players())
    assert set(job["model_id"].values()) == {5}
    # league on, but the current epoch is too young for a past self
    lrn = _stub(Learner, make_env, epoch=1)
    job = lrn._assign_job()
    assert set(job["model_id"].values()) == {1}
    # league on, no retained checkpoint: self-play
    lrn = _stub(Learner, make_env)
    for e in (3, 4):
        os.remove(model_path(e))
    job = lrn._assign_job()
    assert set(job["player"]) == set(lrn.env.players())


def _intake_stub(lrn):
    lrn.generation_stats, lrn.league_stats = {}, {}
    lrn._league_epoch = 0
    lrn.episodes_received = 0
    lrn.episodes_spilled = lrn._spilled_epoch = 0
    lrn.max_policy_lag = 0
    lrn.wal = None
    lrn._kill_switch = None
    lrn.trainer = type("T", (), {"device_replay": None,
                                 "episodes": deque()})()
    return lrn


def test_league_outcomes_keyed_by_past_epoch(models_dir):
    lrn = _intake_stub(_stub(Learner, make_env))
    random.seed(1)
    job = lrn._assign_job()
    opp = next(p for p in job["model_id"] if p not in job["player"])
    past = job["model_id"][opp]
    episode = {
        "args": job,
        "outcome": {p: (1.0 if p in job["player"] else -1.0)
                    for p in job["model_id"]},
        "final_model_epoch": 5,
        "steps": 9,
    }
    lrn.feed_episodes([episode])
    # the past self's outcome lands under its epoch in league_stats,
    # never under the label it earned while it was training
    assert lrn.league_stats[past].n == 1
    assert lrn.league_stats[past].mean == pytest.approx(-1.0, abs=1e-3)
    assert past not in lrn.generation_stats
    assert lrn.generation_stats[5].n == 1
    assert lrn.generation_stats[5].mean == pytest.approx(1.0, abs=1e-3)
    assert lrn._league_epoch == 1
    # a self-play episode counts no league seat
    lrn.feed_episodes([{**episode, "args": {
        "role": "g", "player": [0, 1], "model_id": {0: 5, 1: 5}}}])
    assert lrn._league_epoch == 1 and lrn.generation_stats[5].n == 3

    record = {}
    lrn._report_generation(record)
    assert record["league_opponent_mean"] == {str(past): -1.0}


@pytest.mark.parametrize("league,eval_rate,seed", [
    ({"past_epochs": 3, "prob": 1.0}, 0.0, 0),
    ({"past_epochs": 3, "prob": 0.5}, 0.1, 1),
    ({"past_epochs": 2}, 0.3, 2),
    ({"past_epochs": 8, "prob": 0.7}, 0.1, 3),
])
def test_same_seed_same_league_jobs_as_the_jax_package(models_dir, league,
                                                       eval_rate, seed):
    port = _stub(Learner, make_env, league=league, eval_rate=eval_rate)
    jax = _stub(JaxLearner, jax_make_env, league=league,
                eval_rate=eval_rate)
    jax.trainer = None   # the JAX twin asks whether Anakin is on
    jobs = {}
    for tag, lrn in (("port", port), ("jax", jax)):
        random.seed(seed)
        jobs[tag] = [lrn._assign_job() for _ in range(60)]
        jobs[tag].append(random.random())  # the stream's position after
    assert jobs["port"] == jobs["jax"]
    roles = [j["role"] for j in jobs["port"][:-1]]
    assert roles.count("g") > 0
    assert any(len(j["player"]) == 1 and j["role"] == "g"
               for j in jobs["port"][:-1])


def test_worker_runs_league_jobs_sequentially_with_pinned_seats():
    job = {"role": "g", "player": [1], "model_id": {0: 3, 1: 5}}
    assert not RolloutPool.accepts(job)
    assert RolloutPool.accepts(
        {"role": "g", "player": [0, 1], "model_id": {0: 5, 1: 5}})

    class Model:
        module = object()
        is_recurrent = False

    class Cache:
        def __init__(self):
            self.models = {3: Model(), 5: Model()}

        def resolve(self, ids):
            return {i: self.models[i] for i in set(ids)}

    class Pipeline:
        def wrap(self, model, epoch):
            return ("served", model, epoch)

    worker = Worker.__new__(Worker)
    worker.models, worker.pipeline = Cache(), Pipeline()
    seats = worker._resolve(job)
    # each snapshot is served pinned to its own epoch: the service
    # answers the past seat only while it holds that epoch
    assert seats[0] == ("served", worker.models.models[3], 3)
    assert seats[1] == ("served", worker.models.models[5], 5)


class _SnapshotConn:
    """The learner's end of ``("model", id)`` requests: records each
    asked id and answers with a picklable stand-in."""

    def __init__(self):
        self.asked = []

    def send(self, msg):
        self.asked.append(msg[1])

    def recv(self):
        return pickle.dumps(("snapshot", self.asked[-1]))


def test_model_cache_keeps_league_epochs_warm_as_in_jax():
    schedule = [[5, 5], [5, 3], [4, 5], [5, 3], [5, 4], [6, -1],
                [3, 6], [6, 4], [6, 5], [3, 6], [6, 6]]
    asked = {}
    for tag, cls in (("port", ModelCache), ("jax", JaxModelCache)):
        conn = _SnapshotConn()
        cache = cls(conn, None)
        for ids in schedule:
            resolved = cache.resolve(ids)
            for i in ids:
                assert resolved[i] == (None if i < 0 else ("snapshot", i))
        asked[tag] = conn.asked
    assert asked["port"] == asked["jax"]
    # epochs 3-5 stay cached while they alternate: one fetch each
    assert asked["port"][:3] == [5, 3, 4]


def _args():
    train_args = {
        "turn_based_training": True, "observation": False, "gamma": 0.8,
        "forward_steps": 4, "burn_in_steps": 0, "compress_steps": 4,
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1,
        "update_episodes": 12, "batch_size": 4, "minimum_episodes": 8,
        "maximum_episodes": 200, "epochs": 4, "num_batchers": 1,
        "eval_rate": 0.1, "worker": {"num_parallel": 2}, "lambda": 0.7,
        "policy_target": "TD", "value_target": "TD", "seed": 1,
        "lockstep_episodes": 4, "metrics_path": "metrics.jsonl",
        "updates_per_epoch": 2,
        "generation_opponent": {"past_epochs": 2, "prob": 1.0},
    }
    return {"env_args": {"env": "TicTacToe"}, "train_args": train_args}


def _abort(learner):
    learner.shutdown_flag = True
    learner.worker.begin_drain()


def test_league_training_run_reports_past_epochs_only(tmp_path,
                                                      monkeypatch, capfd):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned children
    learner = Learner(_args(), device="cpu")
    watchdog = threading.Timer(150, _abort, args=(learner,))
    watchdog.start()
    try:
        learner.run()
    finally:
        watchdog.cancel()
    with open("metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [0, 1, 2, 3]
    # no past self before epoch 2; league jobs from then on
    assert records[0]["league_episodes"] == 0
    assert records[1]["league_episodes"] == 0
    assert sum(r["league_episodes"] for r in records[2:]) > 0
    assert "league_opponent_mean" not in records[1]
    for r in records[2:]:
        for key in r.get("league_opponent_mean", {}):
            past = int(key)
            assert 1 <= past < r["epoch"]
            assert os.path.exists(model_path(past))
    assert any(r.get("league_opponent_mean") for r in records[2:])
    out = capfd.readouterr().out
    assert "league stats = " in out
    assert out.count("closed worker") == 2
    assert "cuda initialized True" not in out
    assert "pipeline fallbacks 0" in out
