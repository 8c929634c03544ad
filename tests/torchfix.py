"""Shared fixture of the port's test modules (tests/test_torch_*.py).

The suite runs several test processes side by side, and PyTorch gives
each one an intra-op thread pool as wide as the machine: at the port
tests' small shapes those pools only contend with each other and with
the JAX tests next door.  Each port test module imports
``one_torch_thread`` (autouse) so its tests run single-threaded, and
passes :data:`CHILD_ENV` to the processes it starts; the same fixture
turns the port's process-wide telemetry off after each test.
"""

import os

import pytest
import torch

# environment for child interpreters the port tests start
CHILD_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)
    # a learner built in a test arms the process-wide telemetry with a
    # span log in the test's directory: the next test starts with it off
    from handyrl_tpu_torch import telemetry

    telemetry.configure(enabled=False)


def make_episodes(env_name, count, seed=0, observation=False,
                  compress=True, env_args=None, net=None):
    """``count`` self-play episodes of the port's env, from the port's
    ``Generator`` with a seeded random net on the CPU, so value heads
    and behavior probabilities are not constant.  ``env_args`` adds
    env keys (``max_steps`` ...); ``net`` replaces the env's net (a
    narrow one, for speed)."""
    import random

    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.generation import Generator
    from handyrl_tpu_torch.models import TorchModel

    random.seed(seed)
    env = make_env({"env": env_name, **(env_args or {})})
    model = TorchModel(net if net is not None else env.net(), device="cpu")
    model.init_params(seed=seed)
    gen = Generator(env, {"observation": observation, "gamma": 0.8,
                          "compress_steps": 4,
                          "episode_compress": compress})
    players = env.players()
    job = {"player": players, "model_id": {p: 1 for p in players}}
    episodes = []
    while len(episodes) < count:
        ep = gen.generate({p: model for p in players}, job)
        if ep is not None:
            episodes.append(ep)
    return episodes, players


def window(ep, train_start, cfg):
    """The episode slice ``Batcher.select_episode`` draws for an
    explicit training start."""
    st = max(0, train_start - cfg["burn_in_steps"])
    ed = min(train_start + cfg["forward_steps"], ep["steps"])
    cmp = cfg["compress_steps"]
    st_block, ed_block = st // cmp, (ed - 1) // cmp + 1
    return {"args": ep["args"], "outcome": ep["outcome"],
            "moment": ep["moment"][st_block:ed_block],
            "base": st_block * cmp, "start": st, "end": ed,
            "train_start": train_start, "total": ep["steps"]}


def draws(episodes, cfg, n, num_players, seed):
    """``n`` seeded ``(episode index, train start, seat)`` draws."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        i = int(rng.integers(len(episodes)))
        cands = 1 + max(0, episodes[i]["steps"] - cfg["forward_steps"])
        out.append((i, int(rng.integers(cands)),
                    int(rng.integers(num_players))))
    return out


NETS = {"TicTacToe": ("tictactoe_net", "TicTacToeNet", {}),
        # GeeseNet narrowed for the CPU: 8 filters x 2 blocks
        "HungryGeese": ("geese_net", "GeeseNet",
                        {"filters": 8, "blocks": 2}),
        # the recurrent nets narrowed: 8 filters, DRC 2 x 2 / 1 x 2
        "Geister": ("geister_net", "GeisterNet",
                    {"filters": 8, "drc_layers": 2, "drc_repeats": 2}),
        "GRFProxy": ("grf_net", "GRFNet", {"filters": 8})}


def twin_nets(env_name, seed=0):
    """``(flax module, torch module, flax params)``: the JAX package's
    net and the port's for ``env_name``, holding the same seeded
    weights.  JAX is imported here, never at module level, so the
    card-only tests can import this file without it."""
    import importlib

    from handyrl_tpu_torch.models.convert import (
        from_flax,
        random_flax_params,
    )

    mod, cls, kwargs = NETS[env_name]
    torch_net = getattr(importlib.import_module(
        f"handyrl_tpu_torch.models.{mod}"), cls)(**kwargs)
    flax_net = getattr(importlib.import_module(
        f"handyrl_tpu.models.{mod}"), cls)(**kwargs)
    params = random_flax_params(torch_net, seed=seed)
    torch_net.load_state_dict(from_flax(params, torch_net))
    return flax_net, torch_net, params


def to_torch_batch(batch):
    """A numpy batch of ``make_batch`` as CPU tensors (float32 obs,
    a dict of them for dict observations)."""
    import numpy as np

    from handyrl_tpu_torch.utils.tree import tree_map_leaves

    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items() if k != "observation"}
    out["observation"] = tree_map_leaves(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)),
        batch["observation"])
    return out


def loss_cfg(**overrides):
    cfg = {"turn_based_training": True, "observation": False,
           "burn_in_steps": 0, "lambda": 0.7, "gamma": 0.8,
           "policy_target": "TD", "value_target": "TD",
           "entropy_regularization": 0.1,
           "entropy_regularization_decay": 0.1}
    cfg.update(overrides)
    return cfg
