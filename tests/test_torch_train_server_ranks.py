"""``--train-server`` over one host's ranks: one endpoint, one deal.

``train_server_main`` on a host with several cards launches one rank
per card (JAX's auto-dp, ``parallel/launch.py``).  Rank 0 alone binds
the entry and worker ports, admits every episode and deals it to one
rank's ring, round robin in admission order, over a localhost channel
of its own (``parallel/deal.py``).  Here the card count is injected
(``cards=2``) and the ranks train on the CPU over gloo:

  * ``rank_args`` in server mode leaves the workers and
    ``update_episodes`` whole and splits the ring's counts equally over
    the dp coordinates;
  * the deal is round robin over the dp coordinates in admission order
    (the sp/tp ranks of a coordinate get its copies), and a WAL
    replayed by a relaunched rank 0 deals every episode where it went
    live;
  * a feed whose ingest fails, or rank 0's send to a follower that
    stops reading, breaks the channel instead of wedging it;
  * the JAX package's train-server config (tests/test_distributed.py)
    on two ranks with a remote ``--worker`` machine trains one epoch:
    both ranks exit 0, one endpoint, the shares within one episode,
    the epoch at the fleet's ``minimum_episodes + update_episodes``,
    the params bitwise equal, rank 0 alone writes; under ``mesh: {tp:
    2}`` both ranks get every episode and the ring counts stay whole;
  * ranks started by hand on one host bind the ports once, and ranks
    on several hosts must be one per host;
  * a follower whose channel breaks ends the launch with its code;
  * ``supervise_learner`` relaunches the whole group once after rank 0
    is killed, the relaunch restores the optimizer and deals the WAL,
    and the run completes;
  * the two ranks' first step on their dealt rings equals one process's
    step on the rows they drew (params rtol 2e-4 / atol 2e-5, the
    sharded step's tolerance in test_torch_parallel.py).

Each spawning test runs in a session of its own under a deadline.
"""

import json
import os
import pickle
import random
import re
import signal
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.durability import EpisodeWAL
from handyrl_tpu_torch.learner import DEAD_RANK_EXIT
from handyrl_tpu_torch.parallel import deal, launch
from test_torch_losses import assert_close
from torchfix import CHILD_ENV, loss_cfg, make_episodes  # noqa: F401
from torchfix import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 150
LR = 1e-4
PARAM_RTOL, PARAM_ATOL, TOTAL_REL = 2e-4, 2e-5, 1e-4

# the ports come from the environment in every process of a run: the
# launcher's spawned ranks import this program again as __mp_main__
PORTS = """
import os
import handyrl_tpu_torch.worker as w
from handyrl_tpu_torch.learner import PARAMS_DIGEST_ENV

os.environ[PARAMS_DIGEST_ENV] = "1"   # the ranks print their digests

w.ENTRY_PORT = int(os.environ["TS_ENTRY_PORT"])
w.WORKER_PORT = int(os.environ["TS_WORKER_PORT"])
w.RemoteWorkerCluster.SESSION_POLL = 0.1
"""

SERVER = PORTS + textwrap.dedent("""
    import sys, threading

    mode = sys.argv[1]
    # tests/test_distributed.py's --train-server config (JAX)
    train = {
        "turn_based_training": True, "observation": False, "gamma": 0.8,
        "forward_steps": 4, "burn_in_steps": 0, "compress_steps": 4,
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1, "update_episodes": 12,
        "batch_size": 4, "minimum_episodes": 8, "maximum_episodes": 200,
        "epochs": 1, "num_batchers": 1, "eval_rate": 0.1,
        "worker": {"num_parallel": 2}, "lambda": 0.7,
        "policy_target": "TD", "value_target": "TD", "seed": 2,
        "lockstep_episodes": 4, "updates_per_epoch": 4,
        "metrics_path": "metrics.jsonl", "respawn_backoff": 0.2,
    }
    if mode == "tp":
        train["mesh"] = {"tp": 2}
    if mode == "guard":
        train.update(epochs=2, supervise_learner=True,
                     chaos={"learner_kill_epoch": 1,
                            "learner_kill_after_episodes": 2})
    if mode == "hand":
        train.update(epochs=-1, distributed={
            "coordinator_address": "127.0.0.1:" + sys.argv[3],
            "num_processes": 2, "process_id": int(sys.argv[2])})
    args = {"env_args": {"env": "TicTacToe"}, "train_args": train,
            "worker_args": {"num_parallel": 2,
                            "server_address": "127.0.0.1"}}


    def channel_breaks(args):
        # rank 1's end of the episode channel breaks under it
        from handyrl_tpu_torch.learner import train_server_main
        from handyrl_tpu_torch.parallel import deal

        if os.environ["RANK"] == "1":
            start = deal.EpisodeFeed.start

            def start_then_break(feed, ingest):
                start(feed, ingest)
                threading.Timer(2.0, feed.conn.sock.shutdown,
                                (2,)).start()

            deal.EpisodeFeed.start = start_then_break
        train_server_main(args, device="cpu")


    if __name__ == "__main__":  # spawn-safe: the ranks re-import
        from handyrl_tpu_torch.learner import train_server_main
        from handyrl_tpu_torch.parallel.launch import launch

        if mode == "broken":
            code = launch(args, channel_breaks, device="cpu", cards=2,
                          server=True)
            print("LAUNCH EXIT %s" % code, flush=True)
            sys.exit(code)
        train_server_main(args, device="cpu",
                          backend="gloo" if mode == "hand" else None,
                          cards=None if mode == "hand" else 2)
        print("SERVER EXIT 0", flush=True)
""")

MACHINE = PORTS + textwrap.dedent("""
    if __name__ == "__main__":
        w.worker_main({"worker_args": {"num_parallel": 2,
                                       "server_address": "127.0.0.1"}},
                      ["2"])
""")


def _port():
    """A port free now and below Linux's ephemeral range (32768 up): no
    outgoing connection of a test running in parallel is given it before
    the server binds it, as one may be given a port ``find_free_port()``
    returned (an ephemeral one) in between."""
    while True:
        port = random.randrange(20000, 32000)
        with socket.socket() as sock:
            try:
                sock.bind(("", port))
            except OSError:
                continue
        return port


def _env():
    return dict(CHILD_ENV, PYTHONPATH=REPO,
                TS_ENTRY_PORT=str(_port()), TS_WORKER_PORT=str(_port()))


def _start(tmp_path, script, argv, env, tag):
    path = tmp_path / f"{tag}.py"
    path.write_text(script)
    log = open(tmp_path / f"{tag}.log", "w")
    proc = subprocess.Popen([sys.executable, str(path), *argv],
                            cwd=tmp_path, env=env, stdout=log,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    log.close()
    return proc


def _read(tmp_path, tag):
    with open(tmp_path / f"{tag}.log") as f:
        return f.read()


def _kill(proc):
    try:  # whatever of the session outlived its leader
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            pass
    _kill(proc)


def _serve(tmp_path, mode, deadline=DEADLINE):
    """The server program in ``mode`` with a worker machine that joins
    once the entry port is up; returns (exit code, server output)."""
    env = _env()
    server = _start(tmp_path, SERVER, [mode], env, "server")
    machine = None
    try:
        t0 = time.monotonic()
        while "started entry server" not in _read(tmp_path, "server"):
            assert server.poll() is None and time.monotonic() - t0 < 60, \
                _read(tmp_path, "server")[-3000:]
            time.sleep(0.1)
        machine = _start(tmp_path, MACHINE, [], env, "machine")
        try:
            server.wait(timeout=deadline)
        except subprocess.TimeoutExpired:
            pytest.fail(f"the run passed its {deadline} s deadline:\n"
                        f"{_read(tmp_path, 'server')[-3000:]}")
    finally:
        _kill(server)
        if machine is not None:
            _stop(machine)
    return server.returncode, _read(tmp_path, "server")


def _records(tmp_path):
    with open(tmp_path / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _digests(out):
    """``{epoch: {rank: digest}}`` from the ranks' digest lines."""
    found = {}
    for rank, epoch, digest in re.findall(
            r"rank (\d+) epoch (\d+): params (\w+)", out):
        found.setdefault(int(epoch), {})[int(rank)] = digest
    return found


def test_rank_args_in_server_mode():
    args = {"train_args": {"batch_size": 8, "minimum_episodes": 101,
                           "maximum_episodes": 1000,
                           "update_episodes": 40, "restart_epoch": "auto",
                           "supervise_learner": True,
                           "worker": {"num_parallel": 5,
                                      "num_gathers": 2}},
            "worker_args": {"num_parallel": 6, "server_address": "h"}}
    ranks = [launch.rank_args(args, r, {"dp": 2}, server=True)
             for r in range(2)]
    for rank in ranks:
        train = rank["train_args"]
        assert train["distributed"] == {"auto": True}
        assert train["mesh"] == {"dp": 2}
        # no local fleet to split, and the remote machines' config as is
        assert train["worker"] == {"num_parallel": 5, "num_gathers": 2}
        assert rank["worker_args"] == args["worker_args"]
        # the fleet's epoch clock stays whole; the guard wraps the launch
        assert train["update_episodes"] == 40
        assert "supervise_learner" not in train
        assert train["restart_epoch"] == "auto"
    # the ring's counts in equal shares, the remainder to rank 0
    assert [r["train_args"]["minimum_episodes"] for r in ranks] == [51, 50]
    assert [r["train_args"]["maximum_episodes"] for r in ranks] == [500, 500]
    # the config's defaults split alike
    bare = [launch.rank_args({"train_args": {}}, r, {"dp": 3},
                             server=True)["train_args"] for r in range(3)]
    assert sum(t["minimum_episodes"] for t in bare) == 400
    assert not any("update_episodes" in t for t in bare)   # the default
    assert args["train_args"]["supervise_learner"] is True   # a copy
    # over sp/tp the counts split by dp coordinate, whole within one:
    # ranks 0-1 are dp 0, ranks 2-3 dp 1 (make_mesh lays dp major)
    tp = [launch.rank_args(args, r, {"dp": 2, "tp": 2}, server=True)
          ["train_args"] for r in range(4)]
    assert [t["minimum_episodes"] for t in tp] == [51, 51, 50, 50]
    assert [t["maximum_episodes"] for t in tp] == [500] * 4
    whole = [launch.rank_args(args, r, {"tp": 2}, server=True)
             ["train_args"] for r in range(2)]
    assert [t["minimum_episodes"] for t in whole] == [101, 101]
    assert all(t["update_episodes"] == 40 for t in whole)


class _Conn:
    """A follower's connection as the dealer sees it."""

    def __init__(self):
        self.sent = []

    def send(self, message):
        self.sent.append(message)

    def close(self):
        pass


def _dealer(world, dp=None):
    dealer = deal.EpisodeDealer(world, dp)
    dealer.conns = {r: _Conn() for r in range(1, world)}
    return dealer


def _ranks_of(dealer, own, verb):
    """``{episode id: rank}`` of what ``dealer`` handed out (the last
    rank that got it)."""
    ranks = {e["id"]: 0 for e in own}
    for rank, conn in sorted(dealer.conns.items()):
        for kind, payload in conn.sent:
            if kind == verb:
                ranks.update({e["id"]: rank for e in payload})
    return ranks


def _holders(dealer, own, verb):
    """``{episode id: sorted ranks}`` of what ``dealer`` handed out."""
    held = {e["id"]: [0] for e in own}
    for rank, conn in sorted(dealer.conns.items()):
        for kind, payload in conn.sent:
            if kind == verb:
                for e in payload:
                    held.setdefault(e["id"], []).append(rank)
    return held


def test_the_deal_is_round_robin_and_a_wal_replay_deals_alike(tmp_path):
    world, batches = 3, [[0, 1], [2], [3, 4, 5, 6], [7, 8, 9, 10]]
    wal = EpisodeWAL(str(tmp_path / "wal"))
    dealer, own = _dealer(world), []
    for batch in batches:
        episodes = [{"id": i} for i in batch]
        seqs = [wal.append(e) for e in episodes]
        own += dealer.deal(episodes, seqs)
    wal.close()
    live = _ranks_of(dealer, own, "deal")
    # round robin in admission order, from rank 0
    assert live == {i: i % world for i in range(11)}
    assert dealer.dealt == [4, 4, 3]
    assert max(dealer.dealt) - min(dealer.dealt) <= 1
    # without a WAL the dealer numbers the episodes itself, alike
    plain = _dealer(world)
    own = [e for batch in batches
           for e in plain.deal([{"id": i} for i in batch])]
    assert _ranks_of(plain, own, "deal") == live

    # a relaunched rank 0 replays the WAL through the deal: each
    # episode to the rank it went to live, then ``warm`` to each
    seqs, episodes = zip(*EpisodeWAL(str(tmp_path / "wal")).replay())
    again = _dealer(world)
    own = again.replay(episodes[4:], seqs[4:])   # the newest 7 kept
    assert _ranks_of(again, own, "replay") == {
        i: r for i, r in live.items() if i >= 4}
    assert again.replayed == [2, 3, 2] and again.warmed
    for conn in again.conns.values():
        assert conn.sent[-1] == ("warm", None)
    # the live deal goes on from the last sequence number
    assert again.deal([{"id": 11}]) == [] and again.seq == 12


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_the_deal_goes_round_the_dp_coordinates(dp, tp):
    """Batch rows shard over dp and replicate over sp/tp, so an episode
    goes to every rank of one dp coordinate (ranks ``d*tp ..``): none
    lands on a rank whose rows no step takes, and each coordinate's
    first rank, whose rows its group trains on, holds its whole share."""
    world = dp * tp
    dealer = _dealer(world, dp)
    own = dealer.deal([{"id": i} for i in range(9)])
    held = _holders(dealer, own, "deal")
    assert held == {i: list(deal.deal_ranks(i + 1, dp, tp))
                    for i in range(9)}
    assert held == {i: list(range((i % dp) * tp, (i % dp + 1) * tp))
                    for i in range(9)}
    firsts = [dealer.dealt[d * tp] for d in range(dp)]
    assert sum(firsts) == 9 and max(firsts) - min(firsts) <= 1
    assert dealer.dealt == [n for n in firsts for _ in range(tp)]
    # a WAL replay deals alike
    again = _dealer(world, dp)
    own = again.replay([{"id": i} for i in range(9)], range(1, 10))
    assert _holders(again, own, "replay") == held


def _until_closed(feed, timeout=10):
    deadline = time.monotonic() + timeout
    while feed.open and time.monotonic() < deadline:
        time.sleep(0.01)


def test_the_channel_carries_the_deal_to_a_follower():
    """Rank 0's end and a follower's over a real localhost socket: the
    replay staged before ``warm``, the live deal on the feed thread,
    ``end`` closes cleanly; a channel cut without ``end`` is
    ChannelBroken on the follower's side."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    dealer = deal.EpisodeDealer(2)
    feed = deal.EpisodeFeed.dial(port, 1)
    dealer.accept(listener, timeout=10)
    dealer.replay([{"id": i} for i in range(5)], range(1, 6))
    assert [e["id"] for e in feed.warm()] == [1, 3]
    got = []
    feed.start(got.extend)
    dealer.deal([{"id": i} for i in range(5, 9)], range(6, 10))
    dealer.close()
    _until_closed(feed)
    assert feed.finished and feed.failure is None
    assert [e["id"] for e in got] == [5, 7] and feed.received == 2
    feed.close()

    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    dealer = deal.EpisodeDealer(2)
    feed = deal.EpisodeFeed.dial(listener.getsockname()[1], 1)
    dealer.accept(listener, timeout=10)
    dealer.replay()
    feed.warm()
    feed.start(got.extend)
    dealer.conns[1].close()            # no ``end``
    _until_closed(feed)
    assert isinstance(feed.failure, deal.ChannelBroken)
    endpoint = deal.FollowerEndpoint(feed)
    assert endpoint.connection_count() == 0
    with pytest.raises(deal.ChannelBroken, match="from rank 0 broke"):
        endpoint.recv(timeout=0.1)
    feed.close()


def _pair():
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    dealer = deal.EpisodeDealer(2)
    feed = deal.EpisodeFeed.dial(listener.getsockname()[1], 1)
    dealer.accept(listener, timeout=10)
    dealer.replay()
    feed.warm()
    return dealer, feed


def test_a_failing_ingest_breaks_the_feed():
    """An ingest that raises ends the feed with its failure: the
    follower's endpoint raises it (its rank leaves as a dead rank)
    instead of counting an open feed that no longer reads."""
    dealer, feed = _pair()

    def ingest(episodes):
        raise MemoryError("ring full")

    feed.start(ingest)
    dealer.deal([{"id": 0}, {"id": 1}])
    _until_closed(feed)
    assert isinstance(feed.failure, deal.ChannelBroken)
    assert isinstance(feed.failure.__cause__, MemoryError)
    endpoint = deal.FollowerEndpoint(feed)
    assert endpoint.connection_count() == 0
    with pytest.raises(deal.ChannelBroken, match="feed failed"):
        endpoint.recv(timeout=0.1)
    dealer.close()
    feed.close()


def test_a_follower_that_stops_reading_fails_the_send(monkeypatch):
    """Rank 0's sends wait at most SEND_TIMEOUT on a follower: one that
    never reads (its feed thread gone) fills the socket, and the send
    raises ChannelBroken on rank 0 instead of blocking its server."""
    monkeypatch.setattr(deal, "SEND_TIMEOUT", 0.5)
    dealer, feed = _pair()                 # the feed never starts
    big = [{"id": i, "pad": bytes(1 << 16)} for i in range(64)]
    t0 = time.monotonic()
    with pytest.raises(deal.ChannelBroken, match="to rank 1 broke"):
        for _ in range(400):               # far past any socket buffer
            dealer.deal(big + big)
    assert time.monotonic() - t0 < 30
    dealer.close()
    feed.close()


def test_two_ranks_serve_one_endpoint_and_train_an_epoch(tmp_path):
    code, out = _serve(tmp_path, "train")
    assert code == 0 and "SERVER EXIT 0" in out, out[-5000:]
    assert ("launch: 2 ranks, one per card; rank 0 serves the worker "
            "machines and deals the episodes") in out
    assert out.count("mesh dp=2 sp=1 tp=1 over 2 processes") == 2
    # one endpoint: rank 0 listens, rank 1 binds nothing
    assert out.count("started entry server") == 1
    assert out.count("started worker server") == 1
    assert "rank 1: no worker endpoint" in out
    assert "Address already in use" not in out
    # the deal: live shares within one episode, and every episode dealt
    # to rank 1 landed there
    dealt = json.loads(re.search(r"episode deal: (\[[\d, ]+\]) live",
                                 out).group(1))
    fed = int(re.search(r"episode feed: rank 1 ingested (\d+) live",
                        out).group(1))
    assert fed == dealt[1] and abs(dealt[0] - dealt[1]) <= 1, out[-3000:]
    # the fleet's epoch: minimum_episodes 4 + 4 over the ranks plus
    # update_episodes 12, counted on rank 0's endpoint
    (record,) = _records(tmp_path)
    assert record["epoch"] == 0 and record["episodes_received"] >= 20
    assert len(record["episodes_dealt"]) == 2
    assert sum(record["episodes_dealt"]) <= record["episodes_received"]
    assert record["replay"] == "device" and record["retrace_count"] == 1
    # the replicas' parameters are one
    assert _digests(out) and all(
        len(set(by.values())) == 1 and set(by) == {0, 1}
        for by in _digests(out).values())
    # rank 0 alone writes (the ranks share the directory)
    assert (tmp_path / "models" / "1.ckpt").exists()
    assert len(_records(tmp_path)) == 1


def test_a_tp_mesh_deals_every_episode_to_both_ranks(tmp_path):
    """``mesh: {tp: 2}``: one dp coordinate, so both ranks get every
    episode (rank 0's rows, shared over tp, see all of them), the ring
    counts stay whole, and the epoch falls at minimum 8 + update 12."""
    code, out = _serve(tmp_path, "tp")
    assert code == 0 and "SERVER EXIT 0" in out, out[-5000:]
    assert out.count("mesh dp=1 sp=1 tp=2 over 2 processes") == 2
    assert out.count("started entry server") == 1
    dealt = json.loads(re.search(r"episode deal: (\[[\d, ]+\]) live",
                                 out).group(1))
    fed = int(re.search(r"episode feed: rank 1 ingested (\d+) live",
                        out).group(1))
    (record,) = _records(tmp_path)
    assert record["episodes_received"] >= 20
    assert record["episodes_dealt"] == [record["episodes_received"]] * 2
    assert dealt[0] == dealt[1] == fed >= record["episodes_received"]
    assert all(len(set(by.values())) == 1 and set(by) == {0, 1}
               for by in _digests(out).values()) and _digests(out)


def test_hand_started_ranks_on_one_host_bind_the_ports_once(tmp_path):
    env = _env()
    port = str(_port())
    ranks = [_start(tmp_path, SERVER, ["hand", str(r), port], env,
                    f"rank{r}") for r in range(2)]
    try:
        t0 = time.monotonic()
        while not ("started entry server" in _read(tmp_path, "rank0")
                   and "no worker endpoint" in _read(tmp_path, "rank1")):
            assert all(p.poll() is None for p in ranks), \
                [_read(tmp_path, f"rank{r}")[-3000:] for r in range(2)]
            assert time.monotonic() - t0 < 90
            time.sleep(0.1)
        time.sleep(1.0)
        assert all(p.poll() is None for p in ranks)
        with socket.create_connection(
                ("127.0.0.1", int(env["TS_ENTRY_PORT"])), timeout=5):
            pass   # rank 0 listens
    finally:
        for p in ranks:
            _kill(p)
    outs = [_read(tmp_path, f"rank{r}") for r in range(2)]
    assert "distributed: process 1 of 2, gloo on cpu" in outs[1]
    assert "started entry server" not in outs[1]
    assert "started worker server" not in outs[1]
    assert not any("Address already in use" in out for out in outs)


def test_ranks_across_hosts_take_one_rank_per_host(monkeypatch):
    """Across hosts each rank keeps its own endpoint (the JAX rule for
    replicas), so two ranks on one host of several would both bind the
    fixed ports: a clear error at start-up, never a second bind."""
    from handyrl_tpu_torch.learner import _check_one_rank_per_host
    from handyrl_tpu_torch.parallel import multihost as mh

    monkeypatch.setattr(mh, "_hosts", ("a", "b"))
    _check_one_rank_per_host()
    monkeypatch.setattr(mh, "_hosts", ("a", "a", "b", "b"))
    assert not mh.one_host()
    with pytest.raises(ValueError, match=r"one rank per host: ranks share "
                                         r"\['a', 'b'\]"):
        _check_one_rank_per_host()


def test_a_broken_channel_ends_the_launch_with_a_code(tmp_path):
    env = _env()
    proc = _start(tmp_path, SERVER, ["broken"], env, "server")
    try:
        proc.wait(timeout=DEADLINE)
    except subprocess.TimeoutExpired:
        pytest.fail(_read(tmp_path, "server")[-3000:])
    finally:
        _kill(proc)
    out = _read(tmp_path, "server")
    assert proc.returncode == DEAD_RANK_EXIT, out[-3000:]
    assert "episode channel from rank 0 broke" in out
    assert "rank 1 leaves as a dead rank" in out
    assert f"launch: rank1 exited {DEAD_RANK_EXIT}" in out
    assert f"LAUNCH EXIT {DEAD_RANK_EXIT}" in out


def test_supervise_learner_relaunches_the_group(tmp_path):
    code, out = _serve(tmp_path, "guard", deadline=2 * DEADLINE)
    assert code == 0 and "SERVER EXIT 0" in out, out[-5000:]
    assert "CHAOS: SIGKILL of the learner at epoch 1" in out
    # rank 0's death ends the group, and the guard relaunches all of it
    assert "launch: rank0 exited -9; stopping the other ranks" in out
    assert "learner guard: learner exited 137; relaunching" in out
    assert "learner guard: training finished after 1 relaunch(es)" in out
    assert "learner guard: cuda initialized False" in out
    assert out.count("launch: 2 ranks, one per card") == 2
    # restart_epoch: auto reached both ranks, and rank 0's train state
    # reached both through the start-up broadcast
    assert out.count("resume: epoch 1 from models/1.ckpt") == 2
    steps = _records(tmp_path)[0]["steps"]
    assert out.count(f"restored optimizer state at step {steps}") == 2
    # the WAL replay went through the deal
    replayed = re.search(r"wal: replayed (\d+) of \d+ logged episode\(s\) "
                         r"into the backlog \(dealt \[(\d+), (\d+)\]", out)
    assert replayed, out[-3000:]
    total, share0, share1 = map(int, replayed.groups())
    assert share0 + share1 == total > 0 and abs(share0 - share1) <= 1
    assert re.search(rf"episode feed: rank 1 ingested \d+ live and "
                     rf"{share1} replayed", out)
    records = _records(tmp_path)
    assert [r["epoch"] for r in records] == [0, 1]
    assert records[-1]["episodes_replayed"] == total
    assert (tmp_path / "models" / "2.ckpt").exists()
    assert all(len(set(by.values())) == 1
               for by in _digests(out).values())


STEP_CHILD = textwrap.dedent("""
    import pickle, sys, time
    import torch

    rank, port, run = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    with open(run + "/in.pkl", "rb") as f:
        job = pickle.load(f)
    from handyrl_tpu_torch.models.convert import from_flax, state_to_flax
    from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.parallel import deal
    from handyrl_tpu_torch.parallel import multihost as mh
    from handyrl_tpu_torch.parallel import (
        MeshSpec, make_mesh, make_sharded_update_step)
    from handyrl_tpu_torch.parallel.update import (
        full_state_dict, full_tensor)
    from handyrl_tpu_torch.staging import (
        DeviceReplay, make_replay_update_step)

    mh.init_distributed({"coordinator_address": "127.0.0.1:%d" % port,
                         "num_processes": 2, "process_id": rank},
                        device="cpu")
    ring = DeviceReplay(job["ring"], 64, 64 << 20, "cpu")
    fleet, end = deal.open_channel((1, 1), 2)
    episodes = job["episodes"]
    if rank == 0:
        end.replay()
        ring.offer(end.deal(episodes))
        end.close()
        share = end.dealt[0]
    else:
        end.warm()
        end.start(ring.offer)
        while end.open:
            time.sleep(0.01)
        share = end.received
    ring.ingest(max_episodes=len(episodes))
    net = TicTacToeNet()
    net.load_state_dict(from_flax(job["params"], net))
    mesh = make_mesh(MeshSpec.from_config({"dp": 2}), device_type="cpu")
    step = make_sharded_update_step(net, LossConfig.from_config(job["cfg"]),
                                    mesh, job["lr"], "float32")
    rows = []

    def keep(batch):
        rows.append({k: v.clone() for k, v in batch.items()})
        return batch

    replay_step = make_replay_update_step(ring, step, batch_size=2,
                                          seed=11 + rank, share=keep)
    metrics = replay_step(ring.device_state())
    out = {"fleet": fleet, "share": share, "ring": ring.size,
           "rows": rows[0], "total": float(metrics["total"]),
           "grads": state_to_flax({n: full_tensor(p.grad)
                                   for n, p in net.named_parameters()}, net),
           "params": state_to_flax(full_state_dict(net), net)}
    with open(run + "/out%d.pkl" % rank, "wb") as f:
        pickle.dump(out, f)
    mh.shutdown()
    print("CHILD %d DONE" % rank)
""")


def test_the_ranks_first_step_on_their_dealt_rings_is_one_process_step(
        tmp_path):
    from handyrl_tpu_torch.models.convert import (
        from_flax,
        random_flax_params,
        state_to_flax,
    )
    from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet
    from handyrl_tpu_torch.ops import update as tupdate
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.utils.tree import flatten_params

    episodes, _ = make_episodes("TicTacToe", 9, seed=5)
    cfg = loss_cfg(forward_steps=4, compress_steps=4)
    ring = {"turn_based_training": True, "observation": False,
            "forward_steps": 4, "burn_in_steps": 0,
            "transfer_dtype": "float32", "compute_dtype": "float32"}
    params = random_flax_params(TicTacToeNet(), seed=4)
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump({"episodes": episodes, "cfg": cfg, "ring": ring,
                     "params": params, "lr": LR}, f)
    port = _port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", STEP_CHILD, str(r), str(port), str(tmp_path)],
        cwd=tmp_path, env=dict(CHILD_ENV, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=DEADLINE)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for r, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"CHILD {r} DONE" in out, out[-3000:]
    ranks = []
    for r in range(2):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    # each ring holds its deal: 5 + 4 of the 9 episodes
    assert [r["share"] for r in ranks] == [5, 4]
    assert [r["ring"] for r in ranks] == [5, 4]
    assert ranks[0]["fleet"] == [2, 2]
    # one process on the rows the ranks drew, from the same params
    net = TicTacToeNet()
    net.load_state_dict(from_flax(params, net))
    step = tupdate.UpdateStep(net, LossConfig.from_config(cfg),
                              tupdate.make_optimizer(net.parameters(), LR),
                              "float32")
    rows = {k: torch.cat([r["rows"][k] for r in ranks])
            for k in ranks[0]["rows"]}
    metrics = step(rows)
    grads = state_to_flax({n: p.grad for n, p in net.named_parameters()},
                          net)
    after = state_to_flax(net.state_dict(), net)
    for rank in ranks:
        assert rank["total"] == pytest.approx(float(metrics["total"]),
                                              rel=TOTAL_REL)
        for path, value in flatten_params(grads).items():
            assert_close(flatten_params(rank["grads"])[path], value,
                         f"grad {path}")
        for path, value in flatten_params(after).items():
            np.testing.assert_allclose(
                np.asarray(flatten_params(rank["params"])[path]),
                np.asarray(value), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                err_msg=path)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        flatten_params(ranks[0]["params"]).values(),
        flatten_params(ranks[1]["params"]).values()))
