"""One rank per local card: the launcher behind ``--train``.

``parallel.launch`` spawns one rank per visible card when ``--train``
has no ``distributed:`` section (JAX's auto-dp over a host's devices).
Here the card count is injected through ``launch``'s ``cards`` argument
and the ranks train on the CPU over gloo:

  * JAX's auto-dp rule and its messages, each launched rank's config
    (the whole fleet on rank 0 and none on the others, the ring's
    counts in equal shares over the dp coordinates, ``update_episodes``
    whole, the launch's mark), and the one-card reduction (no spawn,
    said aloud);
  * a mesh the user set stands: ``{dp: 1}`` runs one process (JAX's
    explicit all-ones mesh), ``{tp: 2}`` spawns two ranks that train
    at tp=2, and a mesh larger than the host is JAX's error;
  * ``--train`` on TicTacToe for one epoch on two ranks, as JAX's one
    process: both exit 0, rank 0 alone writes the checkpoint and the
    metrics and runs the fleet of 3 workers, it deals the episodes in
    halves, and its one inference service dispatches over both ranks
    (``mesh_devices`` 2, the follower joining every forward); with
    ``infer_mesh: off`` that service answers unsharded and the follower
    runs none; hand-started ranks (an explicit ``distributed:``) keep a
    fleet and a service each, the JAX rule for replicas;
  * Anakin on the two ranks: each plays its half of the games;
  * a rank that dies ends the run with its exit code, and ranks asked
    for the card where there is none fail rather than train on the CPU;
  * ``supervise_learner`` guards the launch, not one process: the ranks
    get no guard of their own, and the launch's code is the guard's
    child's.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from handyrl_tpu_torch.parallel import launch
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 150
WORKER = re.compile(r"closed worker (\d+)")

CHILD = textwrap.dedent("""
    import functools, os, sys, threading

    mode, device = sys.argv[1], sys.argv[2]
    args = {
        "env_args": {"env": "TicTacToe"},
        "train_args": {
            "turn_based_training": True, "observation": False,
            "gamma": 0.8, "forward_steps": 4, "burn_in_steps": 0,
            "compress_steps": 4, "entropy_regularization": 0.1,
            "entropy_regularization_decay": 0.1, "update_episodes": 12,
            "batch_size": 8, "minimum_episodes": 4,
            "maximum_episodes": 200, "num_batchers": 1, "eval_rate": 0.1,
            "epochs": -1 if mode == "die" else 1,
            "worker": {"num_parallel": 3}, "lambda": 0.7,
            "policy_target": "TD", "value_target": "TD", "seed": 3,
            "lockstep_episodes": 4, "updates_per_epoch": 4,
            "metrics_path": "metrics.jsonl",
            "pipeline": {"mode": "on"},
        },
        "worker_args": {"num_parallel": 1, "server_address": ""},
    }
    if mode == "tp":
        args["train_args"]["mesh"] = {"tp": 2}
    if mode == "off":
        args["train_args"]["pipeline"]["infer_mesh"] = "off"
    if mode == "anakin":
        args["train_args"].update(
            updates_per_epoch=3, pipeline={"mode": "off"},
            anakin={"mode": "on", "num_envs": 16, "opponent_pool": 1})


    def rank_one_dies(args):
        # rank 1 dies mid-run with its own code; rank 0 trains on
        from handyrl_tpu_torch.learner import train_main

        if os.environ["RANK"] == "1":
            threading.Timer(8.0, os._exit, (3,)).start()
        train_main(args, device="cpu")


    def hand_started(rank, port):
        # a rank the user started: its own distributed: section and
        # directory (rank 0 alone writes), no launch
        from handyrl_tpu_torch.learner import train_main

        os.makedirs("rank%d" % rank)
        os.chdir("rank%d" % rank)
        args["train_args"]["mesh"] = {"dp": 2}
        args["train_args"]["distributed"] = {
            "coordinator_address": "127.0.0.1:%d" % port,
            "num_processes": 2, "process_id": rank}
        train_main(args, device="cpu")


    if __name__ == "__main__":  # spawn-safe: the ranks re-import
        from handyrl_tpu_torch.learner import train_main
        from handyrl_tpu_torch.parallel.launch import launch

        if mode == "hand":
            import multiprocessing as mp
            from handyrl_tpu_torch.connection import find_free_port

            port = find_free_port()
            procs = [mp.get_context("spawn").Process(
                target=hand_started, args=(r, port)) for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join()
            code = max(p.exitcode for p in procs)
        else:
            target = (rank_one_dies if mode == "die"
                      else functools.partial(train_main, device=device))
            code = launch(args, target, device=device, cards=2)
        print("LAUNCH EXIT %s" % code, flush=True)
        sys.exit(code)
""")


def _run(tmp_path, mode, device="cpu"):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    env = dict(CHILD_ENV, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, str(script), mode, device],
                            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=DEADLINE)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    return proc.returncode, out


def test_the_auto_dp_rule_and_its_messages_are_jax(capsys, monkeypatch):
    import handyrl_tpu.learner as jlearner

    class Host:
        args = {}

    for n, batch in ((1, 8), (2, 8), (4, 6), (8, 7), (3, 9)):
        capsys.readouterr()
        dp = launch.default_dp(n, batch)
        port = capsys.readouterr().out
        Host.args = {"batch_size": batch}
        monkeypatch.setattr(jlearner.jax, "device_count", lambda n=n: n)
        ref = jlearner.Trainer._default_mesh_cfg(Host)
        assert port == capsys.readouterr().out, (n, batch)
        assert dp == ref.get("dp", 1), (n, batch)


def test_fleet_split_and_rank_config():
    """A launched ``--train`` rank's config: the whole fleet on rank 0
    and none on the followers, the ring's counts in equal shares over
    the dp coordinates (``SERVER_SPLIT_COUNTS``, the remainder to the
    first), ``update_episodes`` whole, and the launch's mark."""
    args = {"train_args": {"batch_size": 8, "mesh": {"fsdp": True},
                           "minimum_episodes": 101,
                           "update_episodes": 40,
                           "worker": {"num_parallel": 5, "num_gathers": 2,
                                      "base_worker_id": 4}}}
    assert launch.fleet_size(args) == 5
    assert launch.fleet_size({"train_args": {}}) == 6   # the default
    mesh = {"dp": 2, "fsdp": True}
    made = [launch.rank_args(args, r, mesh) for r in range(2)]
    ranks = [m["train_args"] for m in made]
    assert all(launch.launched(m) for m in made)
    assert not launch.launched(args)   # a copy; the user's args unmarked
    assert all(t["distributed"] == {"auto": True} for t in ranks)
    assert all(t["mesh"] == {"dp": 2, "fsdp": True} for t in ranks)
    # rank 0 runs all 5 workers as configured, the follower none
    assert ranks[0]["worker"] == args["train_args"]["worker"]
    assert ranks[1]["worker"] == {"num_parallel": 0, "base_worker_id": 4}
    assert args["train_args"]["worker"]["num_parallel"] == 5   # a copy
    # the epoch clock whole on rank 0's intake; the rings' counts split
    assert [t["update_episodes"] for t in ranks] == [40, 40]
    assert [t["minimum_episodes"] for t in ranks] == [51, 50]
    for key in launch.SERVER_SPLIT_COUNTS:
        total = 101 if key == "minimum_episodes" else 100_000
        assert sum(t[key] for t in ranks) == total, key
    # over sp/tp: whole within one dp coordinate (ranks 0-1 are dp 0)
    tp = [launch.rank_args(args, r, {"dp": 2, "tp": 2})["train_args"]
          for r in range(4)]
    assert [t["minimum_episodes"] for t in tp] == [51, 51, 50, 50]
    assert [t["worker"]["num_parallel"] for t in tp] == [5, 0, 0, 0]
    assert launch.share_split(12, 2) == [6, 6]
    assert launch.share_split(13, 3) == [5, 4, 4]
    assert launch.share_split(1, 2) == [1, 1]   # never 0


def test_a_mesh_the_user_set_stands(capsys):
    """JAX auto-shards only when the mesh axes are unset: an explicit
    all-ones mesh is the unsharded step in one process, any other is
    launched as written, and one larger than the host is JAX's error."""
    from handyrl_tpu_torch.parallel.launch import _planned_mesh

    def plan(mesh, cards=2, batch=8):
        return _planned_mesh({"train_args": {"batch_size": batch,
                                             "mesh": mesh}}, "cpu", cards)

    assert plan({"dp": 1}) == {}
    assert "mesh (1, 1, 1) is unsharded, no spawn" in capsys.readouterr().out
    assert plan({"dp": 1, "fsdp": True}) == {}
    assert plan({"tp": 2}) == {"tp": 2}
    assert plan({"dp": 1, "tp": 2}) == {"dp": 1, "tp": 2}
    assert plan({"dp": 2, "fsdp": True}, cards=4) == {"dp": 2, "fsdp": True}
    # unset axes: JAX's auto-dp, fsdp kept
    assert plan({}) == {"dp": 2, "fsdp": False}
    assert plan({"fsdp": True}, cards=4) == {"dp": 4, "fsdp": True}
    with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
        plan({"dp": 2, "tp": 2})


def test_supervise_learner_guards_the_launch(monkeypatch):
    """``supervise_learner`` no longer keeps a host with several cards
    on one process: the guard wraps the launch (``run_group``), the
    ranks get no guard of their own and each gets the guard's
    ``restart_epoch: auto``, and a launch that fails exits with its
    code (a rank killed by a signal as a shell reports it)."""
    from handyrl_tpu_torch.parallel.launch import _planned_mesh

    guarded = {"train_args": {"batch_size": 8, "supervise_learner": True,
                              "restart_epoch": "auto"}}
    assert _planned_mesh(guarded, "cpu", 2) == {"dp": 2, "fsdp": False}
    for server in (False, True):
        ranks = [launch.rank_args(guarded, r, {"dp": 2}, server)
                 ["train_args"] for r in range(2)]
        assert all("supervise_learner" not in t for t in ranks)
        assert all(t["restart_epoch"] == "auto" for t in ranks)
    ran = []
    for code, exit_code in ((None, None), (0, None), (3, 3), (-9, 137)):
        monkeypatch.setattr(launch, "launch", lambda *a, c=code, **k: c)
        if exit_code is None:
            launch.run_group(guarded, ran.append, device="cpu", cards=2)
        else:
            with pytest.raises(SystemExit) as exc:
                launch.run_group(guarded, ran.append, device="cpu", cards=2)
            assert exc.value.code == exit_code
    assert ran == [guarded]   # in this process only when no spawn is due


def test_one_card_makes_no_spawn(capsys):
    args = {"train_args": {"batch_size": 8}}
    assert launch.launch(args, print, device="cpu", cards=1) is None
    assert "1 card(s) visible, no spawn" in capsys.readouterr().out
    # a CPU device without an injected count, an explicit card index or
    # a distributed: section never spawn
    assert launch.launch(args, print, device="cpu") is None
    assert launch.launch(args, print, device="cuda:0", cards=None) is None
    hand = {"train_args": {"batch_size": 8, "distributed": {"auto": True}}}
    assert launch.launch(hand, print, device="cpu", cards=2) is None
    # batch_size 7 has no divisor <= 2: JAX's message, one process
    odd = {"train_args": {"batch_size": 7}}
    assert launch.launch(odd, print, device="cpu", cards=2) is None
    assert "1 of 2 devices used" in capsys.readouterr().out


LOCKSTEP_STATS = re.compile(r"inference service stats = (\{.*\})")
FOLLOWER_STATS = re.compile(r"inference follower: rank 1 stats = (\{.*\})")


def _records(tmp_path):
    with open(tmp_path / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _one_process_gates(tmp_path, out, mesh_devices, group=1):
    """What a launch of two ranks shares with JAX's one process: rank 0
    runs all 3 workers and writes alone, deals every admitted episode
    once to a dp coordinate's ``group`` ranks (in halves over dp 2, to
    both under tp 2), and its one service reports ``mesh_devices``."""
    assert ("launch: 2 ranks, one per card; rank 0 runs the whole fleet "
            "of 3 workers and deals the episodes") in out
    assert "rank 1: no fleet: rank 0 runs every worker" in out
    # the fleet is rank 0's, not one per rank: 3 workers in all
    assert sorted(WORKER.findall(out)) == ["0", "1", "2"], out[-5000:]
    assert (tmp_path / "models" / "1.ckpt").exists()
    records = _records(tmp_path)
    assert [r["epoch"] for r in records] == sorted(
        {r["epoch"] for r in records})
    # the fleet's clock, JAX's: minimum_episodes 4 (2 + 2 over the dp
    # coordinates, whole under tp) + update_episodes 12
    assert records[0]["episodes_received"] >= 16
    for r in records:
        dealt = r["episodes_dealt"]
        assert abs(dealt[0] - dealt[1]) <= 1, dealt
        assert sum(dealt[::group]) == r["episodes_received"], r
        assert r["mesh_devices"] == mesh_devices
        assert r["resharding_copies"] == 0 and r["retrace_count"] == 1
        assert r["infer_resharding_copies"] == 0
        assert 0 <= r["infer_compiles"] <= 4
    assert len(LOCKSTEP_STATS.findall(out)) == 1   # one service, rank 0's
    return json.loads(LOCKSTEP_STATS.search(out).group(1))


def test_two_ranks_train_one_epoch(tmp_path):
    code, out = _run(tmp_path, "train")
    assert code == 0 and "LAUNCH EXIT 0" in out, out[-5000:]
    assert "distributed: process 0 of 2, gloo" in out
    assert "distributed: process 1 of 2, gloo" in out
    assert out.count("mesh dp=2 sp=1 tp=1 over 2 processes") == 2
    stats = _one_process_gates(tmp_path, out, mesh_devices=2)
    # the follower joined every forward rank 0 sent, with its snapshots
    follower = json.loads(FOLLOWER_STATS.search(out).group(1))
    assert follower["forwards"] == stats["lockstep_forwards"] > 0
    assert follower["snapshots"] == stats["snapshots_sent"] >= 1
    assert follower["mesh_devices"] == 2
    assert follower["infer_resharding_copies"] == 0


def test_a_launched_tp_mesh_trains_as_written(tmp_path):
    code, out = _run(tmp_path, "tp")
    assert code == 0 and "LAUNCH EXIT 0" in out, out[-5000:]
    # tp=2 on both ranks, not the dp the cards alone would give
    assert out.count("mesh dp=1 sp=1 tp=2 over 2 processes") == 2
    assert "defaulting to dp" not in out
    stats = _one_process_gates(tmp_path, out, mesh_devices=2, group=2)
    follower = json.loads(FOLLOWER_STATS.search(out).group(1))
    assert follower["forwards"] == stats["lockstep_forwards"] > 0


def test_infer_mesh_off_serves_unsharded_on_rank_0(tmp_path):
    code, out = _run(tmp_path, "off")
    assert code == 0 and "LAUNCH EXIT 0" in out, out[-5000:]
    stats = _one_process_gates(tmp_path, out, mesh_devices=1)
    assert "lockstep_forwards" not in stats
    assert "rank 1: no inference service: rank 0's answers" in out
    assert "inference follower" not in out


def test_hand_started_ranks_keep_a_fleet_and_a_service_each(tmp_path):
    """An explicit ``distributed:`` makes JAX's multi-host replicas:
    each rank runs the configured fleet and its own unsharded service,
    and deals nothing."""
    code, out = _run(tmp_path, "hand")
    assert code == 0 and "LAUNCH EXIT 0" in out, out[-5000:]
    assert "launch:" not in out
    assert out.count("inference dispatch: unsharded on this rank's "
                     "card") == 2
    assert sorted(WORKER.findall(out)) == ["0", "0", "1", "1", "2", "2"]
    assert len(LOCKSTEP_STATS.findall(out)) == 2
    assert "inference follower" not in out and "no fleet" not in out
    records = _records(tmp_path / "rank0")
    assert records and all(r["mesh_devices"] == 1 for r in records)
    assert not any("episodes_dealt" in r for r in records)
    assert not (tmp_path / "rank1" / "metrics.jsonl").exists()


def test_two_ranks_run_anakin_on_the_rank_mesh(tmp_path):
    """Launched ranks share one host: ``anakin: {mode: on}`` shards its
    16 games over dp=2 (JAX's env axis over a local mesh), and each
    record counts both ranks' games."""
    code, out = _run(tmp_path, "anakin")
    assert code == 0 and "LAUNCH EXIT 0" in out, out[-5000:]
    assert "this rank plays games [0, 8)" in out
    assert "this rank plays games [8, 16)" in out
    assert "single-process" not in out   # no multi-host fallback
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records
    for r in records:
        assert r["anakin_games"] == 16 * r["epoch_steps"]
        assert r["retrace_count"] == 1 and r["resharding_copies"] == 0


def test_a_dying_rank_ends_the_run_with_its_code(tmp_path):
    code, out = _run(tmp_path, "die")
    assert code == 3, out[-5000:]
    assert "launch: rank1 exited 3; stopping the other ranks" in out
    assert "LAUNCH EXIT 3" in out


def test_launched_ranks_never_fall_back_to_the_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    code, out = _run(tmp_path, "train", device="cuda")
    assert code == 1, out[-5000:]
    assert "CUDA is not available" in out
    assert "LAUNCH EXIT 1" in out
