"""The port's resilience layer end to end, on the CPU, at a tiny size.

Three process-spawning runs of TicTacToe with two CPU workers and a few
update steps per epoch (as tests/test_torch_train_e2e.py has them):

  (a) ``Learner(remote=True)`` in this process and a worker machine
      (``worker_main`` in a child process) on free ports: the machine
      joins through the entry handshake, its gathers dial the worker
      port, one epoch trains, the session drains, and SIGTERM tears the
      machine down;
  (b) a learner under ``supervise_learner`` is SIGKILLed mid-epoch by
      ``chaos.learner_kill_epoch``; the guard relaunches it with
      ``restart_epoch: auto``, it replays its episode WAL into the ring
      and finishes;
  (c) ``python -m handyrl_tpu_torch --train`` with
      ``chaos.infer_kill_epoch``: the inference service is killed and
      respawned; SIGTERM after two epochs lands ``latest.ckpt`` as an
      emergency manifest entry, and the relaunch resumes the optimizer
      at that step.
"""

import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import yaml

import handyrl_tpu_torch.worker as tworker
from handyrl_tpu_torch.connection import find_free_port
from handyrl_tpu_torch.learner import Learner
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(**train):
    train_args = {
        "turn_based_training": True, "observation": False, "gamma": 0.8,
        "forward_steps": 4, "burn_in_steps": 0, "compress_steps": 4,
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1,
        "update_episodes": 15, "batch_size": 4, "minimum_episodes": 10,
        "maximum_episodes": 200, "epochs": 2, "num_batchers": 1,
        "eval_rate": 0.1, "worker": {"num_parallel": 2}, "lambda": 0.7,
        "policy_target": "TD", "value_target": "TD", "seed": 1,
        "lockstep_episodes": 4, "metrics_path": "metrics.jsonl",
        "updates_per_epoch": 4, "respawn_backoff": 0.2,
    }
    train_args.update(train)
    return {"env_args": {"env": "TicTacToe"}, "train_args": train_args,
            "worker_args": {"num_parallel": 2,
                            "server_address": "127.0.0.1"}}


def _records():
    with open("metrics.jsonl") as f:
        # a line still being written has no newline yet
        return [json.loads(line) for line in f if line.endswith("\n")]


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned children
    return tmp_path


def _abort(learner):
    learner.shutdown_flag = True
    learner.worker.begin_drain()


WORKER_MACHINE = textwrap.dedent("""
    import sys
    import handyrl_tpu_torch.worker as w

    w.ENTRY_PORT, w.WORKER_PORT = int(sys.argv[1]), int(sys.argv[2])
    w.RemoteWorkerCluster.SESSION_POLL = 0.1
    w.worker_main({"worker_args": {"num_parallel": 2,
                                   "server_address": "127.0.0.1"}},
                  ["2"])
""")


def test_remote_worker_machine_trains_an_epoch(workdir, monkeypatch):
    entry, port = find_free_port(), find_free_port()
    monkeypatch.setattr(tworker, "ENTRY_PORT", entry)
    monkeypatch.setattr(tworker, "WORKER_PORT", port)
    machine = subprocess.Popen(
        [sys.executable, "-c", WORKER_MACHINE, str(entry), str(port)],
        env=dict(CHILD_ENV, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        learner = Learner(_args(epochs=1), device="cpu", remote=True)
        assert learner.infer_service is None  # no shm across machines
        # a machine that never joins fails the test instead of hanging
        # it: the server loop ends once shut down with no connection
        watchdog = threading.Timer(120, _abort, args=(learner,))
        watchdog.start()
        try:
            learner.run()
        finally:
            watchdog.cancel()
        (record,) = _records()
        assert record["epoch"] == 0 and record["epoch_steps"] >= 1
        assert record["episodes_received"] >= 25
        assert record["fleet_size"] >= 1
    finally:
        # run() returned once every gather drained and disconnected
        machine.send_signal(signal.SIGTERM)
        try:
            out, _ = machine.communicate(timeout=30)
        finally:
            try:  # whatever of the machine outlived it
                os.killpg(machine.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    assert machine.returncode == 0, out[-3000:]
    assert out.count("closed worker") == 2, out[-3000:]
    assert "cuda initialized True" not in out
    assert "base_worker_id" in out  # the merged config came back


def test_supervised_learner_is_relaunched_and_replays_its_wal(workdir):
    proc = _run_cli(_args(epochs=2, supervise_learner=True,
                          chaos={"learner_kill_epoch": 1,
                                 "learner_kill_after_episodes": 2}))
    out = _finish(proc, timeout=150)
    assert proc.returncode == 0, out[-3000:]
    assert "CHAOS: SIGKILL of the learner at epoch 1" in out
    assert "learner guard: learner exited -9; relaunching" in out
    replayed = re.search(r"wal: replayed (\d+) of (\d+) logged", out)
    assert replayed and int(replayed.group(1)) > 0, out[-3000:]
    assert "learner guard: training finished after 1 relaunch(es)" in out
    assert "learner guard: cuda initialized False" in out
    records = _records()
    assert records[-1]["epoch"] == 1 and os.path.exists("models/2.ckpt")
    assert records[-1]["episodes_replayed"] == int(replayed.group(1))
    assert os.path.exists("models/chaos_learner_killed")


def _run_cli(config):
    with open("config.yaml", "w") as f:
        yaml.safe_dump(config, f)
    # output to a file (a pipe nobody reads can fill and block the
    # run), and a session of its own: a run cut by its deadline is
    # killed with every process it started
    with open("run.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "handyrl_tpu_torch", "--train",
             "--device", "cpu"], env=dict(CHILD_ENV, PYTHONPATH=REPO),
            stdout=log, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)


def _finish(proc, timeout):
    """The run's output; a run past its deadline is killed and fails."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        with open("run.log") as f:
            pytest.fail(f"the run passed its {timeout} s deadline:\n"
                        f"{f.read()[-3000:]}")
    finally:
        try:  # whatever of the session outlived its leader
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    with open("run.log") as f:
        return f.read()


def test_sigterm_lands_an_emergency_checkpoint_that_resumes(workdir):
    proc = _run_cli(_args(epochs=10, chaos={"infer_kill_epoch": 1}))
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline and proc.poll() is None:
        # two epochs landed, and an epoch closed after the respawn
        records = _records() if os.path.exists("metrics.jsonl") else []
        if len(records) >= 2 and records[-1].get("infer_respawns"):
            break
        time.sleep(0.1)
    proc.send_signal(signal.SIGTERM)
    out = _finish(proc, timeout=60)
    assert proc.returncode == 1, out[-3000:]
    assert "CHAOS: killing the inference service at epoch 1" in out
    assert "inference service respawned (incarnation 1)" in out
    stats = json.loads(out.split("inference service stats =")[1]
                       .splitlines()[0])
    assert stats["respawns"] == 1
    landed = re.search(r"emergency checkpoint landed \(epoch (\d+), "
                       r"step (\d+)\)", out)
    assert landed, out[-3000:]
    epoch, step = int(landed.group(1)), int(landed.group(2))
    assert epoch >= 2 and step > 0
    with open("models/manifest.json") as f:
        latest = json.load(f)["latest"]
    assert latest["emergency"] and latest["path"].endswith("latest.ckpt")
    assert (latest["epoch"], latest["steps"]) == (epoch, step)

    # relaunch: restart_epoch auto resumes the emergency point
    proc = _run_cli(_args(epochs=epoch + 1, restart_epoch="auto"))
    out = _finish(proc, timeout=120)
    assert proc.returncode == 0, out[-3000:]
    assert f"resume: epoch {epoch} from models/latest.ckpt (emergency" in out
    assert f"restored optimizer state at step {step}" in out
    assert re.search(r"wal: replayed [1-9]\d* of", out)
    record = _records()[-1]
    assert record["epoch"] == epoch and record["steps"] > step
