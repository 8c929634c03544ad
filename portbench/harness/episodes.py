"""The general episode generator: seeded episodes in the workers' wire format.

A game module under ``portbench/games/`` (named by the configuration's
``game`` key) draws one episode's planes, who is present, rewards and
the outcome.  This module adds what a self-play worker records beside
them: a behaviour policy's action and its probability, the legal-action
mask (every action is legal in both games), a value estimate, and the
discounted return; then packs the moments as a pipelined worker ships
them over shared memory: a dict of ``args``, ``steps``, ``outcome`` and
``moment``, the moments pickled (not bz2-compressed) in blocks of
``compress_steps``.

A pool's episodes are drawn once, each from its own ``numpy`` generator
seeded by ``(BASE_SEED, pool, index)``, its lengths one fixed grid; a
run's seed permutes them.  So every seed has the same episodes, the
same sizes, in an order of its own, and the same seed gives the same
order.  Drawn, a pool is kept under a fixed directory inside the
checkout, so only the first run there pays for drawing it.
"""

import hashlib
import importlib
import json
import os
import pickle

import numpy as np

FILL, STREAM, ORDER = 0, 1, 2      # the seed streams of a run
BASE_SEED = 0                      # the pools' content


def game_module(name):
    return importlib.import_module(f"portbench.games.{name}")


def length_grid(spec, count):
    """``count`` episode lengths on a fixed grid over ``spec``: an int,
    or ``[lo, hi]``, both ends included when ``count > 1``."""
    if isinstance(spec, int):
        return [spec] * count
    lo, hi = spec
    if count == 1:
        return [hi]
    return [int(round(lo + (hi - lo) * i / (count - 1)))
            for i in range(count)]


def discounted(reward, gamma):
    out = np.zeros_like(reward, dtype=np.float64)
    acc = np.zeros(reward.shape[1])
    for t in range(len(reward) - 1, -1, -1):
        acc = reward[t] + gamma * acc
        out[t] = acc
    return out.astype(np.float32)


def synthesize(game, rng, steps, gamma):
    """One episode's arrays: the game's, plus ``action`` int64,
    ``prob`` and ``value`` float32 and ``return`` float32, each
    ``(T, P)``."""
    src = game.synthesize(rng, steps)
    T, P = src["present"].shape
    logits = rng.normal(size=(T, P, game.ACTIONS))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    u = rng.random((T, P, 1))
    action = np.minimum((np.cumsum(probs, -1) < u).sum(-1),
                        game.ACTIONS - 1)
    src["action"] = action
    src["prob"] = np.take_along_axis(
        probs, action[..., None], -1)[..., 0].astype(np.float32)
    src["value"] = rng.uniform(-1.0, 1.0, (T, P)).astype(np.float32)
    src["return"] = discounted(src["reward"], gamma)
    return src


def pack(src, compress_steps):
    """The wire dict of one synthesized episode."""
    T, P = src["present"].shape
    players = list(range(P))
    moments = []
    for t in range(T):
        m = {k: {p: None for p in players} for k in (
            "observation", "selected_prob", "action_mask", "action",
            "value", "reward", "return")}
        turn = []
        for p in players:
            r = float(src["reward"][t, p])
            m["reward"][p] = r if r != 0.0 else None
            m["return"][p] = float(src["return"][t, p])
            if not src["present"][t, p]:
                continue
            turn.append(p)
            m["observation"][p] = src["obs"][t, p].astype(np.float32)
            m["selected_prob"][p] = float(src["prob"][t, p])
            m["action"][p] = int(src["action"][t, p])
            m["action_mask"][p] = np.zeros(src["n_actions"], np.float32)
            m["value"][p] = np.asarray([src["value"][t, p]], np.float32)
        m["turn"] = turn
        moments.append(m)
    return {
        "args": {"role": "g", "player": players,
                 "model_id": {p: 0 for p in players}},
        "steps": T,
        "outcome": {p: float(src["outcome"][p]) for p in players},
        "moment": [pickle.dumps(moments[lo:lo + compress_steps])
                   for lo in range(0, T, compress_steps)],
    }


def draw_pool(config, pool, count):
    """``count`` episodes of ``config``'s game, ``(wire, source)``
    lists, the lengths the grid of ``config['episode_steps']``."""
    game = game_module(config["game"])
    lengths = length_grid(config["episode_steps"], count)
    gamma = config["train_args"]["gamma"]
    cs = config["train_args"]["compress_steps"]
    wires, sources = [], []
    for i in range(count):
        rng = np.random.default_rng([BASE_SEED, pool, i])
        src = synthesize(game, rng, lengths[i], gamma)
        src["n_actions"] = game.ACTIONS
        wires.append(pack(src, cs))
        sources.append(src)
    return wires, sources


def cached_pool(config, pool, count, cache):
    """:func:`draw_pool`, read from the directory ``cache`` if it holds
    it and written there if not (``cache`` None: drawn)."""
    if cache is None:
        return draw_pool(config, pool, count)
    key = hashlib.sha256(json.dumps(
        [config, pool, count, BASE_SEED], sort_keys=True).encode())
    path = os.path.join(cache, f"{config['name']}-{pool}-{count}-"
                               f"{key.hexdigest()[:16]}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    out = draw_pool(config, pool, count)
    os.makedirs(cache, exist_ok=True)
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f, protocol=5)
    os.replace(path + ".part", path)
    return out


def make_pool(config, seed, pool, count, cache=None):
    """The pool's ``count`` episodes, ``(wire, source)`` lists, in the
    order ``(seed, ORDER, pool)`` draws."""
    wires, sources = cached_pool(config, pool, count, cache)
    order = np.random.default_rng([seed, ORDER, pool]).permutation(count)
    return [wires[i] for i in order], [sources[i] for i in order]
