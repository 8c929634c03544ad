"""Batched Tic-Tac-Toe on a torch device: the twin of
``handyrl_tpu.envs.tictactoe_jax``.

The Python env (:mod:`.tictactoe`) is the spec; this module plays N
games at once as tensors on an explicit device, so the Anakin engine
(:mod:`handyrl_tpu_torch.anakin`) can step every game of a rollout
segment on the card with no host round trip.  Where the JAX twin
``vmap``s single-game functions over a ``State`` pytree, every function
here takes and returns the batched state directly:

    state = init(n, device)                # n fresh games
    state, obs, reward, done, legal = step(state, action)

plus the read-only views ``side_to_move``, ``turn`` (acting seat
index), ``terminal``, ``legal_mask``, ``observe`` (the acting player's
planes) and ``outcome``.  Nothing here reads a value back to the host.

The JAX twin's two hardenings hold: stepping a terminal game is a
no-op, and so is an illegal action (an occupied cell), so finished or
garbage rows of a batch stay inert.  On legal actions every transition,
reward, legal mask, observation and outcome equals the Python env's
over all 5,478 reachable positions (tests/test_torch_anakin.py).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .tictactoe import FIRST, WIN_LINES

NUM_PLAYERS = 2
NUM_ACTIONS = 9
MAX_STEPS = 9               # a game always ends within 9 moves
OBS_SHAPE = (3, 3, 3)       # channel-last planes, like the Python env


class State(NamedTuple):
    """N games' complete state (the board determines the rest)."""

    cells: torch.Tensor     # (N, 9) int8: 0 empty, +1 first mover, -1 second
    count: torch.Tensor     # (N,) int32: moves played
    winner: torch.Tensor    # (N,) int8: 0 none, +1 FIRST, -1 SECOND


def init(n, device="cuda"):
    """``n`` fresh games on ``device`` (the card unless asked for the
    CPU; raises where the card is absent)."""
    device = resolve_device(device)
    return State(
        cells=torch.zeros((n, NUM_ACTIONS), dtype=torch.int8, device=device),
        count=torch.zeros((n,), dtype=torch.int32, device=device),
        winner=torch.zeros((n,), dtype=torch.int8, device=device),
    )


def side_to_move(state):
    """(N,) int8 mark of the mover (Environment.side_to_move)."""
    first = torch.full_like(state.winner, FIRST)
    return torch.where(state.count % 2 == 0, first, -first)


def turn(state):
    """(N,) int32 acting seat index: player 0 always moves first."""
    return state.count % 2


def terminal(state):
    """(N,) bool: a winner, or a full board (Environment.terminal)."""
    return (state.winner != 0) | (state.count >= MAX_STEPS)


def legal_mask(state):
    """(N, 9) bool, True on empty cells (Environment.legal_actions,
    which also ignores terminality)."""
    return state.cells == 0


def observe(state):
    """(N, 3, 3, 3) float32 planes of the acting player, channel-last:
    [all ones, my marks, opponent marks] (the Python env's
    ``observation(turn_player)``)."""
    stm = side_to_move(state)[:, None]
    board = state.cells.view(-1, 3, 3)
    mine = (state.cells == stm).view(-1, 3, 3)
    theirs = (state.cells == -stm).view(-1, 3, 3)
    return torch.stack([torch.ones_like(board, dtype=torch.float32),
                        mine.float(), theirs.float()], dim=-1)


def outcome(state):
    """(N, 2) float32 per-player scores: player 0's is the winner mark
    (+1 first-mover win, -1 loss, 0 draw), player 1's its negation."""
    w = state.winner.float()
    return torch.stack([w, -w], dim=-1)


# each win line is an arithmetic progression of cells, so a strided
# slice of the board: no index tensor has to reach the device
_LINE_SLICES = [slice(int(a), int(c) + 1, int(b - a))
                for a, b, c in WIN_LINES]


def step(state, action):
    """Apply each game's mover's mark at ``action`` ((N,) int64).

    Returns ``(state, obs, reward, done, legal)``: ``obs``/``legal``
    describe the post-move state (the next mover's view), ``reward``
    is the (N, 2) outcome on the terminating transition and zeros
    before it, ``done`` mirrors ``terminal``.  Terminal games and
    occupied target cells are no-ops."""
    stm = side_to_move(state)
    action = action.long()[:, None]
    target = state.cells.gather(1, action)[:, 0]
    valid = ~terminal(state) & (target == 0)
    played = state.cells.scatter(1, action, stm[:, None])
    cells = torch.where(valid[:, None], played, state.cells)
    # Environment.play's win check: any line summing to 3 x the mover
    marks = torch.stack([cells[:, line] for line in _LINE_SLICES],
                        dim=1).sum(dim=-1)
    won = (marks == 3 * stm[:, None]).any(dim=-1)
    new = State(cells=cells,
                count=state.count + valid.int(),
                winner=torch.where(valid & won, stm, state.winner))
    done = terminal(new)
    reward = torch.where((done & valid)[:, None], outcome(new), 0.0)
    return new, observe(new), reward, done, legal_mask(new)


def from_board(cells, device="cuda"):
    """A batched State from host boards ((9,) or (N, 9)): the board
    alone determines the move count and the winner of every reachable
    position (play stops the moment a line completes)."""
    cells = np.asarray(cells, np.int8).reshape(-1, NUM_ACTIONS)
    marks = cells[:, WIN_LINES].sum(axis=-1)
    winner = np.where((marks == 3 * FIRST).any(axis=-1), FIRST,
                      np.where((marks == -3 * FIRST).any(axis=-1),
                               -FIRST, 0)).astype(np.int8)
    device = resolve_device(device)
    return State(
        cells=torch.as_tensor(cells, device=device),
        count=torch.as_tensor(np.count_nonzero(cells, axis=-1)
                              .astype(np.int32), device=device),
        winner=torch.as_tensor(winner, device=device),
    )
