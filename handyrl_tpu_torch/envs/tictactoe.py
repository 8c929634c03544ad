"""Tic-Tac-Toe: the minimal turn-based two-player workload.

Behavioral parity with HandyRL's handyrl/envs/tictactoe.py:74-181
(same action encoding "A1".."C3", same observation planes, same
outcomes); implementation is fresh: flat 9-cell board, precomputed win
lines, channel-last observation.
"""

import random

import numpy as np

from ..environment import BaseEnvironment

# all 8 winning triples over flat cell indices (cell = row * 3 + col)
WIN_LINES = np.array(
    [
        [0, 1, 2], [3, 4, 5], [6, 7, 8],   # rows
        [0, 3, 6], [1, 4, 7], [2, 5, 8],   # cols
        [0, 4, 8], [2, 4, 6],              # diagonals
    ],
    dtype=np.int64,
)

ROWS, COLS = "ABC", "123"
FIRST, SECOND = 1, -1
GLYPH = {0: "_", FIRST: "O", SECOND: "X"}


class Environment(BaseEnvironment):
    def __init__(self, args=None):
        super().__init__(args)
        self.reset()

    def reset(self, args=None):
        self.cells = np.zeros(9, dtype=np.int64)
        self.side_to_move = FIRST
        self.winner = 0
        self.history = []

    # -- transitions -------------------------------------------------
    def play(self, action, player=None):
        self.cells[action] = self.side_to_move
        marks = self.cells[WIN_LINES].sum(axis=1)
        if np.any(marks == 3 * self.side_to_move):
            self.winner = self.side_to_move
        self.side_to_move = -self.side_to_move
        self.history.append(action)

    def turn(self):
        return self.players()[len(self.history) % 2]

    def terminal(self):
        return self.winner != 0 or len(self.history) == 9

    def outcome(self):
        score = {FIRST: [1, -1], SECOND: [-1, 1]}.get(self.winner, [0, 0])
        return {p: score[i] for i, p in enumerate(self.players())}

    def legal_actions(self, player=None):
        return np.flatnonzero(self.cells == 0).tolist()

    def players(self):
        return [0, 1]

    # -- observation (channel-last: 3x3 board, 3 planes) -------------
    def observation(self, player=None):
        """Planes: [is-turn-view, my marks, opponent marks], HWC."""
        turn_view = player is None or player == self.turn()
        mine = self.side_to_move if turn_view else -self.side_to_move
        board = self.cells.reshape(3, 3)
        planes = np.stack(
            [
                np.full((3, 3), 1.0 if turn_view else 0.0),
                board == mine,
                board == -mine,
            ],
            axis=-1,
        )
        return planes.astype(np.float32)

    def net(self):
        from ..models.tictactoe_net import TicTacToeNet

        return TicTacToeNet()

    # -- string encodings & delta sync -------------------------------
    def action2str(self, action, player=None):
        return ROWS[action // 3] + COLS[action % 3]

    def str2action(self, s, player=None):
        return ROWS.index(s[0]) * 3 + COLS.index(s[1])

    def diff_info(self, player=None):
        return self.action2str(self.history[-1]) if self.history else ""

    def update(self, info, reset):
        if reset:
            self.reset()
        else:
            self.play(self.str2action(info))

    def __str__(self):
        board = self.cells.reshape(3, 3)
        lines = ["  " + " ".join(COLS)]
        for r in range(3):
            lines.append(ROWS[r] + " " + " ".join(GLYPH[v] for v in board[r]))
        lines.append("record = " + " ".join(self.action2str(a) for a in self.history))
        return "\n".join(lines)


if __name__ == "__main__":
    e = Environment()
    for _ in range(5):
        e.reset()
        while not e.terminal():
            e.play(random.choice(e.legal_actions()))
        print(e)
        print(e.outcome())
