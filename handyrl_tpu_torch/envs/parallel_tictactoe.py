"""Simultaneous-move Tic-Tac-Toe.

Both players submit an action each transition; the env applies exactly
one of them, chosen uniformly at random.  Exercises the framework's
simultaneous-game path (``turns()`` = all players).  Behavioral parity
with HandyRL's handyrl/envs/parallel_tictactoe.py:13-74.
"""

import random

import numpy as np

from .tictactoe import Environment as TicTacToe, WIN_LINES, FIRST, SECOND, GLYPH, COLS, ROWS


class Environment(TicTacToe):
    MARKS = (FIRST, SECOND)  # player index -> mark

    def step(self, actions):
        chosen = random.choice(list(actions.keys()))
        self._apply(actions[chosen], chosen)

    def _apply(self, action, player):
        mark = self.MARKS[player]
        self.cells[action] = mark
        sums = self.cells[WIN_LINES].sum(axis=1)
        if np.any(sums == 3 * mark):
            self.winner = mark
        self.history.append((mark, action))

    def turn(self):
        return NotImplementedError()

    def turns(self):
        return self.players()

    def diff_info(self, player=None):
        if not self.history:
            return ""
        mark, action = self.history[-1]
        return self.action2str(action) + ":" + GLYPH[mark]

    def update(self, info, reset):
        if reset:
            self.reset()
        else:
            s_action, s_mark = info.split(":")
            player = "OX".index(s_mark)
            self._apply(self.str2action(s_action), player)

    def __str__(self):
        board = self.cells.reshape(3, 3)
        lines = ["  " + " ".join(COLS)]
        for r in range(3):
            lines.append(ROWS[r] + " " + " ".join(GLYPH[v] for v in board[r]))
        return "\n".join(lines)


if __name__ == "__main__":
    e = Environment()
    for _ in range(5):
        e.reset()
        while not e.terminal():
            e.step({p: random.choice(e.legal_actions(p)) for p in e.turns()})
        print(e)
        print(e.outcome())
