"""Hungry Geese episodes as a worker records them, synthesized from a seed.

Four geese on the 7 x 11 torus move at once (seat mode).  Each step
every goose still alive is observed and acts; a dead goose has no
observation, no action and no value from then on.  An observation is
the environment's 17 binary planes, channel-last ``(7, 11, 17)``, seen
from the observing goose: planes 0-3 the head cell of each goose (one
cell each, in seat order relative to the observer), 4-7 the tail cells,
8-11 the bodies, 12-15 the previous heads, 16 the food.  The world is
drawn at random for every step (heads, bodies as torus walks, food),
so the planes keep the game's shapes and one-hot structure without
playing the game.  The episode's outcome ranks the geese by how long
they lived, as the environment does by reward: +1/3 for each goose
outlived, -1/3 for each that outlived it.  The game pays no per-step
reward.
"""

import numpy as np

ROWS, COLS, PLANES = 7, 11, 17
CELLS = ROWS * COLS
PLAYERS = 4
ACTIONS = 4
MAX_BODY = 8
_MOVES = ((-1, 0), (0, 1), (1, 0), (0, -1))


def _step(cells, direction):
    """Torus neighbour of each cell index in ``direction`` (0-3)."""
    dr = np.take([m[0] for m in _MOVES], direction)
    dc = np.take([m[1] for m in _MOVES], direction)
    r, c = np.divmod(cells, COLS)
    return ((r + dr) % ROWS) * COLS + (c + dc) % COLS


def synthesize(rng, steps):
    """One episode's per-step arrays: ``obs`` uint8 ``(T, 4, 7, 11,
    17)``, ``present`` bool ``(T, 4)`` (alive: observed and acting),
    ``reward`` float32 ``(T, 4)`` and ``outcome`` float32 ``(4,)``."""
    T = int(steps)
    death = rng.integers(1, T + 1, PLAYERS)
    death[rng.integers(PLAYERS)] = T          # the last goose lives on
    present = np.arange(T)[:, None] < death[None, :]

    head = rng.integers(0, CELLS, (T, PLAYERS))
    length = rng.integers(1, MAX_BODY + 1, (T, PLAYERS))
    body = np.empty((T, PLAYERS, MAX_BODY), np.int64)
    body[..., 0] = head
    for k in range(1, MAX_BODY):
        body[..., k] = _step(body[..., k - 1],
                             rng.integers(0, 4, (T, PLAYERS)))
    prev = _step(head, rng.integers(0, 4, (T, PLAYERS)))
    food = rng.integers(0, CELLS, (T, 2))

    planes = np.zeros((T, PLAYERS, PLANES, CELLS), np.uint8)
    t = np.arange(T)
    for viewer in range(PLAYERS):
        for goose in range(PLAYERS):
            rel = (goose - viewer) % PLAYERS
            alive = present[:, goose]
            ta = t[alive]
            planes[ta, viewer, rel, head[alive, goose]] = 1
            tails = body[alive, goose][np.arange(len(ta)),
                                       length[alive, goose] - 1]
            planes[ta, viewer, 4 + rel, tails] = 1
            for k in range(MAX_BODY):
                on = length[alive, goose] > k
                planes[ta[on], viewer, 8 + rel, body[alive, goose, k][on]] = 1
            planes[ta, viewer, 12 + rel, prev[alive, goose]] = 1
        planes[t[:, None], viewer, 16, food] = 1
    obs = np.ascontiguousarray(
        planes.reshape(T, PLAYERS, PLANES, ROWS, COLS).transpose(
            0, 1, 3, 4, 2))

    outcome = np.zeros(PLAYERS, np.float32)
    for p in range(PLAYERS):
        for q in range(PLAYERS):
            if death[p] > death[q]:
                outcome[p] += 1.0 / (PLAYERS - 1)
            elif death[p] < death[q]:
                outcome[p] -= 1.0 / (PLAYERS - 1)
    return {"obs": obs, "present": present,
            "reward": np.zeros((T, PLAYERS), np.float32),
            "outcome": outcome}
