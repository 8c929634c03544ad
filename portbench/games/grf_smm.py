"""Football episodes on the GRF super-minimap raster, synthesized from a seed.

Two players act every step (seat mode) on the Google Research Football
SMM geometry (Kurach et al., arXiv:1907.11180): a 72 x 96 field and 16
binary planes, channel-last ``(72, 96, 16)``, as the repository's
GRFProxy drill lays them out: 0-2 3 x 3 disks at the observer, the
rival and the ball; 3-4 whole planes for who holds the ball; 5 a disk
at the carrier; 6-7 the observer's and the rival's goal columns; 8-9
the field halves; 10-11 whole planes for leading and trailing; 12-15
the episode phase in four bits.  Positions, the ball and possession
follow seeded random walks; a goal (about one in 150 steps) pays +1 to
the scorer and -1 to the other.  The outcome is the sign of the final
score difference.
"""

import numpy as np

ROWS, COLS, PLANES = 72, 96, 16
PLAYERS = 2
ACTIONS = 9
SPEED = 2
GOAL_COL = (COLS - 1, 0)   # the column each player attacks
GOAL_RATE = 1.0 / 150


def _walk(rng, start, steps):
    moves = rng.integers(-1, 2, (steps, 2)) * SPEED
    pos = np.asarray(start) + np.cumsum(moves, axis=0)
    return np.stack([np.clip(pos[:, 0], 0, ROWS - 1),
                     np.clip(pos[:, 1], 0, COLS - 1)], axis=1)


def _disk(planes, t, viewer, plane, pos):
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            r = np.clip(pos[:, 0] + dr, 0, ROWS - 1)
            c = np.clip(pos[:, 1] + dc, 0, COLS - 1)
            planes[t, viewer, r, c, plane] = 1


def synthesize(rng, steps):
    """One episode's per-step arrays: ``obs`` uint8 ``(T, 2, 72, 96,
    16)``, ``present`` bool ``(T, 2)`` (always: both players act),
    ``reward`` float32 ``(T, 2)`` and ``outcome`` float32 ``(2,)``."""
    T = int(steps)
    pos = [_walk(rng, (ROWS // 2, COLS // 4), T),
           _walk(rng, (ROWS // 2, 3 * COLS // 4), T)]
    change = rng.random(T) < 0.05
    owner = np.where(change, rng.integers(-1, 2, T), -2)
    owner[0] = -1
    for t in range(1, T):               # hold until the next change
        if owner[t] == -2:
            owner[t] = owner[t - 1]
    ball = _walk(rng, (ROWS // 2, COLS // 2), T)
    for p in range(PLAYERS):
        ball[owner == p] = pos[p][owner == p]

    reward = np.zeros((T, PLAYERS), np.float32)
    goal = rng.random(T) < GOAL_RATE
    scorer = rng.integers(0, PLAYERS, T)
    reward[goal, 0] = np.where(scorer[goal] == 0, 1.0, -1.0)
    reward[goal, 1] = -reward[goal, 0]
    score = np.cumsum(reward, axis=0)   # goal difference so far

    planes = np.zeros((T, PLAYERS, ROWS, COLS, PLANES), np.uint8)
    t = np.arange(T)
    phase = (t * 16) // T
    half = COLS // 2
    for me in range(PLAYERS):
        opp = 1 - me
        _disk(planes, t, me, 0, pos[me])
        _disk(planes, t, me, 1, pos[opp])
        _disk(planes, t, me, 2, ball)
        planes[owner == me, me, :, :, 3] = 1
        planes[owner == opp, me, :, :, 4] = 1
        held = owner >= 0
        carrier = np.where(owner[:, None] == me, pos[me], pos[opp])
        _disk(planes, t[held], me, 5, carrier[held])
        planes[:, me, :, GOAL_COL[me], 6] = 1
        planes[:, me, :, GOAL_COL[opp], 7] = 1
        own, other = ((slice(0, half), slice(half, COLS))
                      if GOAL_COL[me] == COLS - 1
                      else (slice(half, COLS), slice(0, half)))
        planes[:, me, :, own, 8] = 1
        planes[:, me, :, other, 9] = 1
        planes[score[:, me] > 0, me, :, :, 10] = 1
        planes[score[:, me] < 0, me, :, :, 11] = 1
        for bit in range(4):
            planes[(phase >> bit) & 1 == 1, me, :, :, 12 + bit] = 1

    diff = score[-1, 0]
    sign = 0.0 if diff == 0 else float(np.sign(diff))
    return {"obs": planes, "present": np.ones((T, PLAYERS), bool),
            "reward": reward,
            "outcome": np.asarray([sign, -sign], np.float32)}
