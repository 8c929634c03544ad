"""Network battles in the port: the RPC verbs, wire parity with the JAX
package, and ``--eval-server`` / ``--eval-client`` end to end.

  * Every verb of the evaluation protocol (``update`` / ``observe`` /
    ``action`` / ``outcome`` / ``quit``) round-trips between the port's
    ``NetworkAgent`` and ``NetworkAgentClient``, as
    ``tests/test_evaluation_rpc.py`` holds the JAX package's, with
    ``quit`` swallowed on a dead client.
  * Wire parity both ways, one TicTacToe game each, over socket pairs
    framed by each side's own ``FramedConnection``, clients on threads:
    the JAX ``NetworkAgent`` drives the port's clients, the port's
    drives the JAX package's.  The outcome equals the server env's own
    and each client's mirror env agrees.
  * ``python -m handyrl_tpu_torch --eval-server 4 1`` with two
    ``--eval-client`` processes on localhost (``--device cpu``, on a
    free port instead of 9876) plays 4 games; every process exits 0.
    With ``num_process`` 2 the server's spawned match children take
    over the accepted sockets (4 seats).
"""

import os
import re
import signal
import socket
import subprocess
import sys
import threading
from multiprocessing import Pipe

import pytest

from handyrl_tpu.agent import RandomAgent as JaxRandomAgent
from handyrl_tpu.connection import FramedConnection as JaxFramed
from handyrl_tpu.envs.tictactoe import Environment as JaxTicTacToe
from handyrl_tpu.evaluation import NetworkAgent as JaxNetworkAgent
from handyrl_tpu.evaluation import (
    NetworkAgentClient as JaxNetworkAgentClient,
)
from handyrl_tpu.evaluation import exec_network_match as jax_match
from handyrl_tpu_torch.agent import RandomAgent
from handyrl_tpu_torch.connection import FramedConnection, find_free_port
from handyrl_tpu_torch.envs.tictactoe import Environment as TicTacToe
from handyrl_tpu_torch.evaluation import (
    NetworkAgent,
    NetworkAgentClient,
    exec_network_match,
)
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start_client(client):
    thread = threading.Thread(target=client.run, daemon=True)
    thread.start()
    return thread


def test_every_protocol_verb_round_trips():
    server_conn, client_conn = Pipe(duplex=True)
    thread = _start_client(
        NetworkAgentClient(RandomAgent(), TicTacToe(), client_conn))
    agent = NetworkAgent(server_conn)
    env = TicTacToe()
    assert not env.reset()

    # update(reset=True): the client mirrors the fresh env
    assert agent.update(env.diff_info(0), True) is None
    for _ in range(3):
        player = env.turns()[0]
        action_str = agent.action(player)
        assert isinstance(action_str, str)
        action = env.str2action(action_str, player)
        assert action in env.legal_actions(player)
        other = [p for p in env.players() if p != player][0]
        agent.observe(other)
        assert not env.step({player: action})
        assert agent.update(env.diff_info(0), False) is None
    # outcome: acknowledged with an empty reply, not silence
    assert agent.outcome(1) is None
    # quit is fire-and-forget: no reply, and the client loop exits
    agent.quit()
    thread.join(timeout=10)
    assert not thread.is_alive(), "client did not exit on quit"


def test_quit_is_idempotent_on_dead_client():
    server_conn, client_conn = Pipe(duplex=True)
    thread = _start_client(
        NetworkAgentClient(RandomAgent(), TicTacToe(), client_conn))
    agent = NetworkAgent(server_conn)
    agent.quit()
    thread.join(timeout=10)
    assert not thread.is_alive()
    client_conn.close()
    agent.quit()  # into a closed pipe: swallowed
    agent.quit()


SIDES = {
    # server stub, match driver, client, client agent, env, framing
    "port": (NetworkAgent, exec_network_match, NetworkAgentClient,
             RandomAgent, TicTacToe, FramedConnection),
    "jax": (JaxNetworkAgent, jax_match, JaxNetworkAgentClient,
            JaxRandomAgent, JaxTicTacToe, JaxFramed),
}


@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")])
def test_wire_parity_one_game_each_way(server, client):
    stub, match, _, _, server_env_cls, server_framed = SIDES[server]
    _, _, client_cls, agent_cls, client_env_cls, client_framed = \
        SIDES[client]
    env = server_env_cls()
    seats, clients, threads, socks = {}, {}, [], []
    for p in env.players():
        a, b = socket.socketpair()
        socks += [a, b]
        clients[p] = client_cls(agent_cls(), client_env_cls(),
                                client_framed(b))
        threads.append(_start_client(clients[p]))
        seats[p] = stub(server_framed(a))
    try:
        outcome = match(env, seats)
        assert outcome is not None and outcome == env.outcome()
        assert sorted(outcome.values()) in ([-1, 1], [0, 0])
        for p, c in clients.items():
            # the mirror env, kept by the diff stream, ends where the
            # server's did
            assert c.env.terminal()
            assert c.env.outcome() == outcome
        for agent in seats.values():
            agent.quit()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        for s in socks:
            s.close()


CLI = ("import sys; from handyrl_tpu_torch import evaluation; "
       "evaluation.NETWORK_PORT = int(sys.argv[1]); "
       "from handyrl_tpu_torch.__main__ import main; "
       "sys.exit(main(sys.argv[2:]))")


def _cli(args, cwd, port, **kwargs):
    return subprocess.Popen(
        [sys.executable, "-c", CLI, str(port), *args, "--device", "cpu"],
        cwd=cwd, env=dict(CHILD_ENV, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True, **kwargs)


@pytest.mark.parametrize("num_process", [1, 2])
def test_eval_server_and_two_clients_play_four_games(tmp_path,
                                                     num_process):
    from handyrl_tpu_torch.durability import write_checksummed
    from handyrl_tpu_torch.models.convert import random_flax_params
    from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet

    os.makedirs(tmp_path / "models")
    write_checksummed(str(tmp_path / "models" / "1.ckpt"), {
        "params": random_flax_params(TicTacToeNet(), seed=0),
        "epoch": 1, "steps": 0})
    (tmp_path / "config.yaml").write_text(
        "env_args:\n    env: 'TicTacToe'\n")
    port = find_free_port()
    procs = []
    try:
        server = _cli(["--eval-server", "4", str(num_process)], tmp_path,
                      port)
        procs.append(server)
        _wait_listening_quietly(port, server)
        clients = [_cli(["--eval-client", "models/1.ckpt", "127.0.0.1"],
                        tmp_path, port) for _ in range(2)]
        procs += clients
        out = {}
        for name, proc in [("server", server), ("c0", clients[0]),
                           ("c1", clients[1])]:
            out[name] = proc.communicate(timeout=180)[0]
            assert proc.returncode == 0, (name, out[name][-3000:])
    finally:
        for proc in procs:
            # each process leads a session of its own: sweep its
            # children with it
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.communicate()
    games = sum(int(n) for n in re.findall(
        r"pattern default_\w+: win rate = [\d.]+ \((\d+) games\)",
        out["server"].split("agent 1")[0]))
    assert games == 4, out["server"][-2000:]
    seats = [int(re.search(r"network client: (\d+) seat", out[c]).group(1))
             for c in ("c0", "c1")]
    assert sum(seats) == 2 * num_process
    assert (out["c0"] + out["c1"]).count(
        "closed network client: cuda initialized False") == 2 * num_process


def _wait_listening_quietly(port, server, timeout=60):
    """Wait until the server's listener exists without taking a seat:
    the probe is a bind attempt, which fails once the server holds the
    port."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if server.poll() is not None:
            raise AssertionError(server.stdout.read())
        with socket.socket() as s:
            try:
                s.bind(("", port))
            except OSError:
                return
        time.sleep(0.1)
    raise AssertionError("the eval server never listened")
