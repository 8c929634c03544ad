"""The port's chaos drills and guards in training, on the CPU.

  * the surge-lag drill, the twin of tests/test_resilience.py's
    ``test_chaos_surge_lag_spike_absorbed`` with its assertions: a
    scheduled surge at epoch 2 kills a gather (respawn held) and browns
    out both planes (the gathers' upload hold and the workers' shm
    backlog), so intake sees a policy-lag spike; training under IMPACT
    with ``max_policy_lag: 6`` completes every epoch, records the
    spike, sheds the stale tail, keeps ONE update-step signature
    throughout (``max_update_compiles: 1``), and every arrival is an
    shm or a spilled episode.  One change of the JAX config: 16 epochs
    instead of 12.  The port's epoch boundary is cheaper than the JAX
    learner's on a CPU, so the epochs after the surge catch up on the
    pre-surge burst at once, the held episodes carry a later epoch, and
    the lag passes the budget of 6 only four epochs later.  The learner
    runs in a child process of its own session under a deadline;
  * the serving-replica kill (``chaos.serve_kill_epoch``): the learner
    silences its frontend and announcer at the epoch, the router evicts
    the replica, ``_serving_tick`` respawns both and the announcer's
    generation moves 0 -> 1, while a client's calls through the router
    each end inside their deadline and the router's counts reconcile;
  * ``upload_backlog``: the learner's intake pops the workers' stamps
    into the epoch's deepest backlog and the run's peak.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np

from handyrl_tpu_torch.learner import Learner
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train_args(extra_train=None, epochs=2):
    """tests/test_resilience.py's ``_train_args``."""
    train = {
        "turn_based_training": True, "observation": False, "gamma": 0.8,
        "forward_steps": 4, "burn_in_steps": 0, "compress_steps": 4,
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1, "update_episodes": 12,
        "batch_size": 4, "minimum_episodes": 10, "maximum_episodes": 200,
        "epochs": epochs, "num_batchers": 1, "eval_rate": 0.1,
        "worker": {"num_parallel": 2}, "lambda": 0.7,
        "policy_target": "VTRACE", "value_target": "VTRACE", "seed": 1,
        "metrics_path": "metrics.jsonl",
    }
    train.update(extra_train or {})
    return {"env_args": {"env": "TicTacToe"}, "train_args": train,
            "worker_args": {"num_parallel": 2, "server_address": ""}}


def _records():
    with open("metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


SURGE_CHILD = textwrap.dedent("""
    import json, sys
    from handyrl_tpu_torch.learner import Learner

    learner = Learner(json.loads(sys.argv[1]), device="cpu")
    learner.run()
    monkey, sup = learner.worker._monkey, learner.worker.supervisor
    print("FACTS " + json.dumps({
        "surged": monkey.surged, "surge_kills": monkey.surge_kill_count,
        "kills": monkey.kills, "respawns": sup.respawns,
        "dead": sup.dead_count(), "peak_fleet": learner.fleet.peak_size,
        "model_epoch": learner.model_epoch,
        "failure": repr(learner.trainer.failure),
        "compiles": learner.trainer.retrace_guard.compiles,
        "episodes_received": learner.episodes_received,
        "episodes_shm": learner.episodes_shm,
        "episodes_spilled": learner.episodes_spilled}), flush=True)
""")


def test_chaos_surge_lag_spike_absorbed(tmp_path, monkeypatch):
    args = _train_args(extra_train={
        "epochs": 16, "update_episodes": 4, "minimum_episodes": 8,
        "updates_per_epoch": 1, "update_algorithm": "impact",
        "target_update_interval": 16, "max_policy_lag": 6,
        "max_update_compiles": 1, "respawn_backoff": 0.2,
        "heartbeat_timeout": 30.0,
        "worker": {"num_parallel": 2, "num_gathers": 2},
        # no pipeline section: the default (mode on) is what the drill
        # certifies, so the shm brownout is in the path
        "chaos": {"surge_epoch": 2, "surge_kills": 1,
                  "surge_respawn_hold": 1.5, "surge_hold_uploads": 8.0,
                  "seed": 7},
    }, epochs=16)
    child = subprocess.Popen(
        [sys.executable, "-c", SURGE_CHILD, json.dumps(args)],
        cwd=tmp_path, env=dict(CHILD_ENV, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = child.communicate(timeout=150)
    finally:
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        child.wait()
    assert child.returncode == 0, out[-3000:]
    facts = json.loads(out.split("FACTS ", 1)[1].splitlines()[0])
    # the surge fired once, through the supervisor; no dice-roll kills
    assert facts["surged"] and facts["surge_kills"] == 1
    assert facts["kills"] == 0 and facts["respawns"] >= 1
    # every epoch, a healthy trainer, ONE update-step signature
    assert facts["model_epoch"] == 16 and facts["failure"] == "None"
    assert facts["compiles"] == 1
    # both planes browned out
    assert "surge — holding uploads" in out
    assert "surge — holding shm episode shipping" in out
    monkeypatch.chdir(tmp_path)
    records = _records()
    assert len(records) == 16
    assert max(r["policy_lag_p95"] for r in records) >= 3, (
        [r["policy_lag_p95"] for r in records])
    assert sum(r["episodes_rejected_stale"] for r in records) > 0, (
        [r["episodes_rejected_stale"] for r in records])
    assert any("is_clip_frac" in r for r in records)
    assert any("target_net_age" in r for r in records)
    # retrace_count flat through the surge
    assert {r["retrace_count"] for r in records} == {1}
    # zero loss: every arrival rode shm or was stamped spilled
    assert facts["episodes_shm"] + facts["episodes_spilled"] == \
        facts["episodes_received"]
    assert facts["dead"] == 0 and facts["peak_fleet"] == 2
    assert records[-1]["respawns"] >= 1
    assert os.path.exists(tmp_path / "models" / "16.ckpt")


def test_serving_replica_kill_evicts_respawns_and_reconciles(
        tmp_path, monkeypatch, capfd):
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.serving import ServeClient, ServeError, ShedError

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = _train_args(extra_train={
        "epochs": 6, "update_episodes": 30, "updates_per_epoch": 4,
        "lockstep_episodes": 4, "policy_target": "TD",
        "value_target": "TD",
        "serving": {"mode": "on", "port": 0},
        "router": {"mode": "on", "port": 0, "heartbeat_interval": 0.5,
                   "heartbeat_timeout": 2.0},
        "chaos": {"serve_kill_epoch": 2}}, epochs=6)
    learner = Learner(args, device="cpu")
    runner = threading.Thread(target=learner.run, daemon=True)
    runner.start()
    env = make_env({"env": "TicTacToe"})
    env.reset()
    obs = np.stack([env.observation(0)] * 4)
    outcomes, slowest = {"ok": 0, "failed": 0}, 0.0
    client = None
    try:
        deadline = time.monotonic() + 150
        while runner.is_alive():
            assert time.monotonic() < deadline, "training never finished"
            if client is None:
                rt = learner.router_frontend
                if rt is None or rt.registry.pool_size() < 1:
                    time.sleep(0.05)
                    continue
                try:
                    client = ServeClient("127.0.0.1", rt.port,
                                         timeout=10.0)
                except OSError:          # the router closed at the end
                    continue
            t0 = time.monotonic()
            try:
                client.infer_batch(obs)
                outcomes["ok"] += 1
            except (ServeError, ShedError):
                outcomes["failed"] += 1     # typed: the pool was down
            except OSError:
                outcomes["failed"] += 1
                client.close()
                client = None
            slowest = max(slowest, time.monotonic() - t0)
            time.sleep(0.02)
    finally:
        if client is not None:
            client.close()
        runner.join(timeout=60)
    out = capfd.readouterr().out
    assert not runner.is_alive() and learner.trainer.failure is None
    assert learner.model_epoch == 6
    kill = out.index("CHAOS: killing the serving replica at epoch 2")
    evict = out.index("marked suspect", kill) if "marked suspect" in \
        out[kill:] else out.index("evicted", kill)
    respawn = out.index("registered (generation 1", kill)
    assert kill < evict < respawn
    assert learner.serve_announcer.generation == 1
    stats = learner.router_frontend.stats()
    assert stats["submitted"] == stats["ok"] + stats["shed"] + \
        stats["errors"]
    assert outcomes["ok"] >= 1
    assert slowest < 10.0 + 1.0          # no call outlived its deadline
    assert sum(r["serve_respawns"] for r in _records()[-1:]) >= 1


def test_intake_reduces_upload_backlog_per_epoch_and_run():
    learner = Learner.__new__(Learner)
    learner.episodes_spilled = learner._spilled_epoch = 0
    learner.max_policy_lag = 0
    learner.model_epoch = 3
    seen = []
    learner._note_intake = lambda episode, lag: seen.append(lag)
    learner.wal = None
    learner.generation_stats, learner.league_stats = {}, {}
    learner._league_epoch = 0
    learner.episodes_received = 0
    learner._kill_switch = None

    class _Ring:
        def __init__(self):
            self.offered = []

        def offer(self, episodes):
            self.offered.extend(episodes)

    ring = _Ring()
    learner.trainer = type("T", (), {"device_replay": ring})()

    def episode(**stamps):
        return {"args": {"player": [0], "model_id": {0: 3, 1: -1}},
                "outcome": {0: 1.0, 1: -1.0}, **stamps}

    learner.feed_episodes([episode(upload_backlog=5),
                           episode(shm_spilled=True, upload_backlog=9),
                           episode(), None])
    assert learner._upload_backlog_epoch == 9
    assert learner._upload_backlog_peak == 9
    assert learner.episodes_spilled == 1 and learner.episodes_received == 3
    # the stamps never reach the ring (or the WAL)
    assert all("upload_backlog" not in e and "shm_spilled" not in e
               for e in ring.offered)
    learner._upload_backlog_epoch = 0      # the epoch record's reset
    learner.feed_episodes([episode(upload_backlog=2)])
    assert (learner._upload_backlog_epoch,
            learner._upload_backlog_peak) == (2, 9)
