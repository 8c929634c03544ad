"""Game environment registry and interface contract.

API parity with the reference environment layer
(HandyRL's handyrl/environment.py:9-145): the same registry
semantics (short name or dotted module path) and the same
``BaseEnvironment`` method surface, covering turn-based and simultaneous
games, partial observability, and the delta-sync protocol used by
network battles.

Conventions, the same as the JAX package's so the two compare like
with like:
  * observations are numpy arrays (or pytrees of arrays) with
    **channel-last** (NHWC) layout; the port's nets permute to NCHW
    inside;
  * ``net()`` returns a ``torch.nn.Module`` of this package.

The registry names the same envs as the JAX package's.
"""

import importlib

# short name -> module path; any dotted path is also accepted directly,
# mirroring HandyRL's handyrl/environment.py:17-36.
ENV_REGISTRY = {
    "TicTacToe": "handyrl_tpu_torch.envs.tictactoe",
    "ParallelTicTacToe": "handyrl_tpu_torch.envs.parallel_tictactoe",
    "Geister": "handyrl_tpu_torch.envs.geister",
    "HungryGeese": "handyrl_tpu_torch.envs.kaggle.hungry_geese",
    "GRFProxy": "handyrl_tpu_torch.envs.grf_proxy",
}

# batched device twins of registered envs: modules of functions over
# (N,) games on a torch device (``init/step/observe/...``), which the
# Anakin engine (handyrl_tpu_torch.anakin) steps on the card.  The
# Python env stays the spec: a twin must match its transition, reward,
# legal and observation semantics exactly (tests/test_torch_anakin.py
# walks every reachable TicTacToe position).  Envs absent here keep
# the worker path.
DEVICE_ENV_REGISTRY = {
    "TicTacToe": "handyrl_tpu_torch.envs.tictactoe_torch",
}


def _resolve(env_args):
    name = env_args["env"]
    return importlib.import_module(ENV_REGISTRY.get(name, name))


def prepare_env(env_args):
    """Run a module-level ``prepare()`` hook if the env defines one."""
    module = _resolve(env_args)
    if hasattr(module, "prepare"):
        module.prepare()


def make_env(env_args):
    """Instantiate the ``Environment`` class of the configured env."""
    return _resolve(env_args).Environment(env_args)


def device_env_available(env_args) -> bool:
    """Whether the configured env has a registered device twin."""
    return env_args.get("env") in DEVICE_ENV_REGISTRY


def make_device_env(env_args):
    """Import the configured env's device twin (the batched
    ``init/step/observe/...`` surface the Anakin engine drives)."""
    name = env_args["env"]
    if name not in DEVICE_ENV_REGISTRY:
        raise ValueError(
            f"env {name!r} has no device twin (DEVICE_ENV_REGISTRY); "
            "Anakin mode requires one — other envs use the worker path")
    return importlib.import_module(DEVICE_ENV_REGISTRY[name])


class BaseEnvironment:
    """The framework <-> game contract.

    A game implements state transition, observation, and scoring; the
    framework drives rollout, training, and evaluation through exactly
    these methods.  Two interaction styles are supported:

      * **turn-based** games implement ``play(action, player)`` and
        ``turn()``; the default ``step`` applies each submitted action
        in sequence;
      * **simultaneous** games override ``step(actions)`` and
        ``turns()`` to report every player that must act.

    ``diff_info``/``update`` define a delta-sync protocol: a server-side
    env emits per-player deltas after each transition and mirrored
    client envs replay them, which is how network battles (and the
    mirrored-env contract test) keep distributed copies consistent
    without sharing full state.
    """

    def __init__(self, args=None):
        pass

    def __str__(self):
        return ""

    # -- lifecycle --------------------------------------------------
    def reset(self, args=None):
        """Start a new game. Return a truthy value to signal failure."""
        raise NotImplementedError()

    # -- state transition -------------------------------------------
    def play(self, action, player=None):
        """Apply one player's action (turn-based games)."""
        raise NotImplementedError()

    def step(self, actions):
        """Apply a ``{player: action}`` map for one transition."""
        for player, action in actions.items():
            if action is not None:
                self.play(action, player)

    # -- whose move -------------------------------------------------
    def turn(self):
        """The single player to move (turn-based games)."""
        return 0

    def turns(self):
        """All players that must act this transition."""
        return [self.turn()]

    def observers(self):
        """Non-acting players that should still observe (RNN models)."""
        return []

    # -- scoring ----------------------------------------------------
    def terminal(self):
        raise NotImplementedError()

    def reward(self):
        """Immediate per-player rewards for the last transition."""
        return {}

    def outcome(self):
        """Final per-player outcomes at the terminal state."""
        raise NotImplementedError()

    # -- actions & players ------------------------------------------
    def legal_actions(self, player=None):
        raise NotImplementedError()

    def players(self):
        return [0]

    # -- neural-net interface ---------------------------------------
    def observation(self, player=None):
        """Feature pytree for ``player`` (channel-last arrays)."""
        raise NotImplementedError()

    def net(self):
        """Return the torch module for this game's policy-value net."""
        raise NotImplementedError()

    # -- string encodings -------------------------------------------
    def action2str(self, action, player=None):
        return str(action)

    def str2action(self, s, player=None):
        return int(s)

    # -- delta-sync protocol ----------------------------------------
    def diff_info(self, player=None):
        return ""

    def update(self, info, reset):
        raise NotImplementedError()
