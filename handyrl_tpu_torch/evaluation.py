"""Evaluation: online eval matches, the offline farm, network battles.

The counterpart of ``handyrl_tpu.evaluation``: the online
:class:`Evaluator` used by workers during training, the multiprocess
offline farm behind ``--eval`` (two-player seats equalized
first/second), and the network battle mode, where a server
(``--eval-server``) hosts the env and remote clients
(``--eval-client``) drive agents over TCP via the env's
``diff_info``/``update`` delta-sync protocol on port 9876.

Protocol surfaces (the JAX package's, so either package's server
plays either package's clients): the RPC verbs ``update / outcome /
action / observe / quit``, the network port, the length-framed pickle
wire of :class:`~.connection.FramedConnection`, and the result dict
``{args, result, opponent}`` consumed by the learner.  ``load_model``
reads ``.ckpt``, ``.npz`` and ``.onnx`` (the numpy runner of
:mod:`.interop`).

Device: the main process evaluates on the device its caller names;
``evaluate_mp`` children are CPU processes because ``evaluate_mp`` asks
for the CPU (:data:`CHILD_DEVICE`), as the JAX package pins its children to
the CPU backend.  A network client's match children are spawned
processes that load the model on the device the client names (default
``cuda``), each with its own CUDA context.
"""

import random
import time

import numpy as np

from .agent import Agent, RandomAgent, RuleBasedAgent
from .connection import accept_socket_connections, open_socket_connection
from .device import DEFAULT_DEVICE
from .durability import read_verified
from .environment import make_env, prepare_env
from .models import TorchModel
from .utils.tree import unflatten_params

CHILD_DEVICE = "cpu"
NETWORK_PORT = 9876


# ---------------------------------------------------------------------
# network battle plumbing
# ---------------------------------------------------------------------

class NetworkAgentClient:
    """Client side of a network battle: owns a real agent plus a mirror
    env kept in sync by the server's diff stream, and answers RPC verbs
    until told to quit."""

    def __init__(self, agent, env, conn):
        self.conn = conn
        self.agent = agent
        self.env = env

    def _on_update(self, data, reset):
        self.env.update(data, reset)
        print(self.env)
        if reset:
            # new game: recurrent agents must drop the old hidden state
            self.agent.reset(self.env, show=True)
        return None

    def _on_action(self, player):
        action = self.agent.action(self.env, player, show=True)
        return self.env.action2str(action, player)

    def _on_observe(self, player):
        return self.agent.observe(self.env, player, show=True)

    def run(self):
        while True:
            try:
                # torchlint: disable=unbounded-recv -- server-driven session: the server sends "quit" at series end, and a dead server raises here
                verb, payload = self.conn.recv()
            except (ConnectionResetError, EOFError):
                break
            if verb == "quit":
                break
            if verb == "outcome":
                print(f"outcome = {payload[0]}")
                reply = None
            elif verb == "update":
                reply = self._on_update(*payload)
            elif verb == "action":
                reply = self._on_action(*payload)
            elif verb == "observe":
                reply = self._on_observe(*payload)
            else:
                reply = getattr(self.env, verb)(*payload)
            self.conn.send(reply)


class NetworkAgent:
    """Server-side stub forwarding agent verbs to a remote client."""

    def __init__(self, conn):
        self.conn = conn

    def _call(self, verb, *payload):
        self.conn.send((verb, list(payload)))
        # torchlint: disable=unbounded-recv -- request/reply over a live match connection; a dead client raises ConnectionError instead of blocking
        return self.conn.recv()

    def update(self, data, reset):
        return self._call("update", data, reset)

    def outcome(self, outcome):
        return self._call("outcome", outcome)

    def action(self, player):
        return self._call("action", player)

    def observe(self, player):
        return self._call("observe", player)

    def quit(self):
        """End the client's session.  Fire-and-forget by protocol: the
        client breaks its recv loop without replying, so this must NOT
        wait for one."""
        try:
            self.conn.send(("quit", []))
        except (ConnectionError, OSError):
            pass  # client already gone: the session is over either way


# ---------------------------------------------------------------------
# one match
# ---------------------------------------------------------------------

def exec_match(env, agents, critic=None, show=False, game_args={}):
    """One match on a shared env instance; returns per-player outcome
    or None on env failure."""
    if env.reset(game_args):
        return None
    for agent in agents.values():
        agent.reset(env, show=show)

    while not env.terminal():
        if show:
            print(env)
        on_turn, watching = env.turns(), env.observers()
        actions = {
            p: agent.action(env, p, show=show)
            for p, agent in agents.items() if p in on_turn
        }
        for p, agent in agents.items():
            if p in watching and p not in on_turn:
                agent.observe(env, p, show=show)
        if env.step(actions):
            return None
        if show and critic is not None:
            print(f"cv = {critic.observe(env, None, show=False)}")

    if show:
        print(env)
        print(f"final outcome = {env.outcome()}")
    return env.outcome()


def exec_network_match(env, network_agents, critic=None, game_args={}):
    """One match whose agents live on remote clients, kept in sync by
    the env's diff protocol."""

    def broadcast_state(reset):
        for p, agent in network_agents.items():
            agent.update(env.diff_info(p), reset)

    if env.reset(game_args):
        return None
    broadcast_state(reset=True)

    while not env.terminal():
        on_turn, watching = env.turns(), env.observers()
        actions = {}
        for p, agent in network_agents.items():
            if p in on_turn:
                actions[p] = env.str2action(agent.action(p), p)
            elif p in watching:
                agent.observe(p)
        if env.step(actions):
            return None
        broadcast_state(reset=False)

    outcome = env.outcome()
    for p, agent in network_agents.items():
        agent.outcome(outcome[p])
    return outcome


# ---------------------------------------------------------------------
# opponents + online evaluator
# ---------------------------------------------------------------------

def build_agent(raw, env=None):
    """Instantiate a named opponent: 'random', 'rulebase[-key]'."""
    if raw == "random":
        return RandomAgent()
    if raw.startswith("rulebase"):
        key = raw.split("-")[1] if "-" in raw else None
        return RuleBasedAgent(key)
    return None


def configured_opponents(args, prefer_cli=False):
    """Opponent pool from config; resolves both the training-side
    ``eval.opponent`` and the CLI-side ``eval_args.opponent`` spelling.
    ``prefer_cli`` flips the priority for the ``--eval`` entry point."""
    keys = ["eval", "eval_args"]
    if prefer_cli:
        keys.reverse()
    raw = (
        args.get(keys[0], {}).get("opponent")
        or args.get(keys[1], {}).get("opponent")
        or ["random"]
    )
    return raw if isinstance(raw, list) else [raw]


class Evaluator:
    """Online evaluation during training: the current model in the
    trained seats vs a configured opponent in the rest."""

    def __init__(self, env, args):
        self.env = env
        self.args = args
        self.opponents = configured_opponents(args)

    def _seat(self, model, opponent):
        if model is None:
            return build_agent(opponent, self.env) or RandomAgent()
        return Agent(model, observation=self.args["observation"])

    def execute(self, models, args):
        opponent = random.choice(self.opponents)
        agents = {p: self._seat(m, opponent) for p, m in models.items()}
        outcome = exec_match(self.env, agents)
        if outcome is None:
            print("None episode in evaluation!")
            return None
        return {"args": args, "result": outcome, "opponent": opponent}


# ---------------------------------------------------------------------
# offline evaluation farm
# ---------------------------------------------------------------------

def wp_func(results):
    """Win rate over an outcome histogram (draws count half)."""
    games = sum(results.values())
    if games == 0:
        return 0.0
    wins = sum(n for outcome, n in results.items() if outcome > 0)
    draws = sum(n for outcome, n in results.items() if outcome == 0)
    return (wins + draws / 2) / games


class ResultTable:
    """Outcome histograms per agent, split by seat pattern."""

    def __init__(self, num_agents):
        self.by_pattern = [{} for _ in range(num_agents)]
        self.overall = [{} for _ in range(num_agents)]

    def add(self, players, agent_ids, pattern, outcome):
        for seat, player in enumerate(players):
            agent_id = agent_ids[seat]
            oc = outcome[player]
            histogram = self.by_pattern[agent_id].setdefault(pattern, {})
            histogram[oc] = histogram.get(oc, 0) + 1
            self.overall[agent_id][oc] = self.overall[agent_id].get(oc, 0) + 1

    def report(self):
        for agent_id, patterns in enumerate(self.by_pattern):
            print(f"agent {agent_id}")
            for pattern, histogram in patterns.items():
                print(f"    pattern {pattern}: "
                      f"win rate = {wp_func(histogram):.3f} "
                      f"({sum(histogram.values())} games)")
        for agent_id, histogram in enumerate(self.overall):
            print(f"agent {agent_id}: win rate = {wp_func(histogram):.3f}")


def _seat_plan(num_agents, num_games, pattern):
    """Yield (agent_ids, pattern_tag) per game.  Two-agent series play
    half the games with each agent moving first; larger pools are
    shuffled per game."""
    for g in range(num_games):
        if num_agents == 2:
            first = 0 if g < (num_games + 1) // 2 else 1
            tag = f"{pattern}_{'first' if first == 0 else 'second'}"
            yield [first, 1 - first], tag
        else:
            yield random.sample(range(num_agents), num_agents), pattern


def _place_agents(agents, device):
    """Move every model-backed agent's model onto ``device``."""
    for agent in agents:
        model = getattr(agent, "model", None)
        if hasattr(model, "to"):
            model.to(device)


def _match_series_child(agents, critic, env_args, index, in_queue,
                        out_queue, seed, show=False, device=None):
    """One eval process: drain the job queue, play, report outcomes.
    ``device`` moves the agents' models first (children pass the CPU;
    the in-process series keeps the caller's placement)."""
    if device is not None:
        _place_agents(agents, device)
    random.seed(seed + index)
    env = make_env({**env_args, "id": index})
    while True:
        # torchlint: disable=unbounded-recv -- the parent enqueues one None sentinel per child after the jobs, so this drain always terminates
        job = in_queue.get()
        if job is None:
            break
        game_index, agent_ids, pattern, game_args = job
        print(f"*** Game {game_index} ***")
        seats = {
            env.players()[seat]: agents[agent_id]
            for seat, agent_id in enumerate(agent_ids)
        }
        remote = isinstance(next(iter(seats.values())), NetworkAgent)
        if remote:
            outcome = exec_network_match(env, seats, critic,
                                         game_args=game_args)
        else:
            outcome = exec_match(env, seats, critic, show=show,
                                 game_args=game_args)
        out_queue.put((pattern, agent_ids, outcome))
    # series over: release remote clients so they exit their recv
    # loops instead of waiting for process teardown
    for agent in agents:
        if isinstance(agent, NetworkAgent):
            agent.quit()
    out_queue.put(None)


def evaluate_mp(env, agents, critic, env_args, args_patterns, num_process,
                num_games, seed):
    """Offline evaluation farm: ``num_process`` processes play
    ``num_games`` per pattern; outcomes land in a ResultTable, which is
    printed and returned.  ``agents[0] is None`` is the network mode:
    every seat is a remote client, accepted on :data:`NETWORK_PORT`
    (``num_process`` x seats connections, grouped by arrival)."""
    from .connection import _mp

    in_queue, out_queue = _mp.Queue(), _mp.Queue()
    print("total games = %d" % (len(args_patterns) * num_games))
    time.sleep(0.1)

    jobs = 0
    for pattern, game_args in args_patterns.items():
        for agent_ids, tag in _seat_plan(len(agents), num_games, pattern):
            in_queue.put((jobs, agent_ids, tag, game_args))
            jobs += 1

    network_mode = agents[0] is None
    if network_mode:
        per_process_agents = network_match_acception(
            num_process, env_args, len(agents), NETWORK_PORT)
    else:
        per_process_agents = [agents] * num_process

    children = []
    for i in range(num_process):
        in_queue.put(None)
        child_args = (per_process_agents[i], critic, env_args, i,
                      in_queue, out_queue, seed)
        if num_process > 1:
            proc = _mp.Process(target=_match_series_child,
                               args=child_args,
                               kwargs={"device": CHILD_DEVICE},
                               daemon=True)
            proc.start()
            children.append(proc)
            if network_mode:
                # the child holds its own duplicates of the sockets
                for agent in per_process_agents[i]:
                    agent.conn.close()
        else:
            _match_series_child(*child_args, show=True)

    table = ResultTable(len(agents))
    live_children = num_process
    while live_children > 0:
        # torchlint: disable=unbounded-recv -- every child posts a None sentinel on exit (even after env failures), so this loop always drains
        item = out_queue.get()
        if item is None:
            live_children -= 1
            continue
        pattern, agent_ids, outcome = item
        if outcome is not None:
            table.add(env.players(), agent_ids, pattern, outcome)
    for proc in children:
        proc.join(timeout=30)
    table.report()
    return table


def network_match_acception(n, env_args, num_agents, port):
    """Accept ``n * num_agents`` client connections, grouping them in
    arrival order into per-match agent lists.  Every accepted client is
    sent the env args (its handshake to start mirroring the env)."""
    matches = []
    current = []
    for conn in accept_socket_connections(port):
        if conn is None:
            continue
        conn.send(env_args)
        current.append(conn)
        if len(current) == num_agents:
            matches.append([NetworkAgent(c) for c in current])
            current = []
        if len(matches) >= n:
            break
    return matches


# ---------------------------------------------------------------------
# model loading + CLI entry points
# ---------------------------------------------------------------------

def load_model(model_path, env, device=DEFAULT_DEVICE):
    """Load a saved model for evaluation: a checkpoint of the JAX
    package's format into a :class:`TorchModel` on ``device`` (a
    ``.ckpt`` pickle ``{"params": flax tree, ...}``, checksum footer
    verified when present, or an exported ``.npz`` of flattened Flax
    params), or an ``.onnx`` file, run on the host by the numpy runner
    whatever ``device`` says."""
    if model_path.endswith(".onnx"):
        from .interop.onnx_run import OnnxModel

        return OnnxModel(model_path)
    if model_path.endswith(".npz"):
        with np.load(model_path) as archive:
            params = unflatten_params({
                key: archive[key] for key in archive.files
                if key != "__header__"
            })
    else:
        state = read_verified(model_path)
        params = (state["params"]
                  if isinstance(state, dict) and "params" in state
                  else state)
    return TorchModel.from_flax(env.net(), params, device=device)


def _resolve_agent(raw, env, device):
    """A CLI agent spec: a named opponent or a checkpoint path."""
    agent = build_agent(raw, env)
    if agent is None:
        agent = Agent(load_model(raw, env, device=device))
    return agent


def eval_main(args, argv, device=DEFAULT_DEVICE):
    """``--eval [model_path] [num_games] [num_process]``: the model
    against the configured opponent; returns the ResultTable."""
    env_args = args["env_args"]
    prepare_env(env_args)
    env = make_env(env_args)

    model_path = argv[0] if len(argv) >= 1 else "models/latest.ckpt"
    num_games = int(argv[1]) if len(argv) >= 2 else 100
    num_process = int(argv[2]) if len(argv) >= 3 else 1

    main_agent = _resolve_agent(model_path, env, device)
    print(f"evaluated files = {model_path}")

    seed = random.randrange(1 << 31)
    print(f"seed = {seed}")
    opponent = configured_opponents(args, prefer_cli=True)[0]
    agents = [main_agent] + [
        build_agent(opponent, env) or RandomAgent()
        for _ in range(len(env.players()) - 1)
    ]
    return evaluate_mp(env, agents, None, env_args, {"default": {}},
                       num_process, num_games, seed)


def eval_server_main(args, argv):
    """``--eval-server [num_games] [num_process]``: host the env and
    play ``num_games`` between remote clients; returns the
    ResultTable.  The server runs no model."""
    print("network match server mode")
    env_args = args["env_args"]
    prepare_env(env_args)
    env = make_env(env_args)

    num_games = int(argv[0]) if len(argv) >= 1 else 100
    num_process = int(argv[1]) if len(argv) >= 2 else 1

    seed = random.randrange(1 << 31)
    print(f"seed = {seed}")
    return evaluate_mp(env, [None] * len(env.players()), None, env_args,
                       {"default": {}}, num_process, num_games, seed)


def client_mp_child(env_args, model_path, conn, device=DEFAULT_DEVICE):
    """One seat of a network battle, in its own process: the model on
    ``device`` answering the server's verbs until it says quit."""
    import sys

    import torch

    env = make_env(env_args)
    model = load_model(model_path, env, device=device)
    NetworkAgentClient(Agent(model), env, conn).run()
    conn.close()
    # one write: the seats of a client share its stdout
    sys.stdout.write(f"closed network client: cuda initialized "
                     f"{torch.cuda.is_initialized()}\n")
    sys.stdout.flush()


def eval_client_main(args, argv, device=DEFAULT_DEVICE):
    """``--eval-client [model_path] [host]``: take seats at the server
    until it stops accepting, one spawned child per seat, each with the
    model on ``device``; returns the number of seats played."""
    print("network match client mode")
    from .connection import _mp

    procs, conns = [], []
    while True:
        try:
            host = argv[1] if len(argv) >= 2 else "localhost"
            conn = open_socket_connection(host, NETWORK_PORT)
            # torchlint: disable=unbounded-recv -- one-shot startup handshake: the server sends env_args immediately on accept, and a dead server raises out of the session loop
            env_args = conn.recv()
        except (EOFError, ConnectionError, OSError):
            break

        model_path = argv[0] if len(argv) >= 1 else "models/latest.ckpt"
        p = _mp.Process(target=client_mp_child,
                        args=(env_args, model_path, conn, device),
                        daemon=True)
        p.start()
        procs.append(p)
        # keep our copy open: spawned children receive the socket via
        # the resource sharer, which needs the parent fd alive
        conns.append(conn)
    for p in procs:
        p.join()
    for conn in conns:
        conn.close()
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"network client seats exited {failed}")
    print(f"network client: {len(procs)} seat(s) played")
    return len(procs)
