"""Geister: partial-observability 2-player board game (the RNN workload).

Behavioral parity with HandyRL's handyrl/envs/geister.py:169-553:
6x6 board, 8 pieces per side (4 blue "good" + 4 red "bad") with types
hidden from the opponent, a setup phase choosing one of C(8,4)=70
layouts, win by reaching a goal corner with a blue piece / capturing all
opponent blues / forcing the opponent to capture all your reds; 200-turn
draw, per-step reward -0.01, and a delta-sync protocol that discloses a
captured piece's type only to the capturing player.

Action space (214):
  moves:  a = d * 36 + x * 6 + y  (four directions over 36 cells,
          encoded in the mover's own rotated frame)    [0, 144)
  setup:  a = 144 + layout_index                        [144, 214)

Observation (channel-last, as in the JAX package's copy): ``{"scalar": (18,),
"board": (6, 6, 7)}`` — turn flags + remaining-piece-count one-hots,
and board planes (zone, own pieces, opponent pieces, own blue/red,
opponent blue/red — opponent types zeroed for players).
"""

import itertools
import random

import numpy as np

from ..environment import BaseEnvironment

BLACK, WHITE = 0, 1
BLUE, RED = 0, 1
EMPTY = -1
NUM_MOVE_ACTIONS = 4 * 36
NUM_SET_ACTIONS = 70

X_NAMES, Y_NAMES = "ABCDEF", "123456"
COLOR_NAMES, TYPE_NAMES = "BW", "BR"
PIECE_GLYPH = {EMPTY: "_", 0: "B", 1: "R", 2: "b", 3: "r", 4: "*"}

# four move directions in (x, y): up, left, right, down
DIRECTIONS = np.array([(-1, 0), (0, -1), (0, 1), (1, 0)], dtype=np.int32)

# initial placement squares per color (owner's two home rows)
HOME_SQUARES = [
    ["B2", "C2", "D2", "E2", "B1", "C1", "D1", "E1"],
    ["E5", "D5", "C5", "B5", "E6", "D6", "C6", "B6"],
]

# goal (exit) squares just off-board, per color
GOALS = np.array([[(-1, 5), (6, 5)], [(-1, 0), (6, 0)]], dtype=np.int32)

# all 70 ways to pick which 4 of the 8 home squares get blue pieces
LAYOUTS = list(itertools.combinations(range(8), 4))


def piece_of(color, ptype):
    return color * 2 + ptype


def color_of(piece):
    return EMPTY if piece == EMPTY else piece // 2


def type_of(piece):
    return EMPTY if piece == EMPTY else piece % 2


class Environment(BaseEnvironment):
    def __init__(self, args=None):
        super().__init__(args)
        self.args = args if args is not None else {}
        self.reset()

    def reset(self, args=None):
        self.board = np.full((6, 6), EMPTY, dtype=np.int32)
        self.piece_cnt = np.zeros(4, dtype=np.int32)
        self.color = BLACK
        self.turn_count = -2  # two setup actions precede the first move
        self.win_color = None
        self.record = []
        self.captured_type = None
        self.layouts = {}

    # -- coordinate helpers -----------------------------------------
    @staticmethod
    def _onboard(pos):
        return 0 <= pos[0] < 6 and 0 <= pos[1] < 6

    @staticmethod
    def _rotate(pos):
        return np.array((5 - pos[0], 5 - pos[1]), dtype=np.int32)

    @staticmethod
    def _goal(color, pos):
        return any(g[0] == pos[0] and g[1] == pos[1] for g in GOALS[color])

    def position2str(self, pos):
        if self._onboard(pos):
            return X_NAMES[pos[0]] + Y_NAMES[pos[1]]
        return "**"

    def str2position(self, s):
        if s == "**":
            return None
        return np.array((X_NAMES.find(s[0]), Y_NAMES.find(s[1])),
                        dtype=np.int32)

    # -- action encoding (mover's own rotated frame) -----------------
    def _encode_move(self, pos_from, d, color):
        if color == WHITE:
            pos_from = self._rotate(pos_from)
            d = 3 - d
        return d * 36 + pos_from[0] * 6 + pos_from[1]

    def action2from(self, a, color):
        pos1d = a % 36
        pos = np.array((pos1d // 6, pos1d % 6), dtype=np.int32)
        return self._rotate(pos) if color == WHITE else pos

    def action2direction(self, a, color):
        d = a // 36
        return 3 - d if color == WHITE else d

    def action2to(self, a, color):
        return self.action2from(a, color) + DIRECTIONS[
            self.action2direction(a, color)]

    def action2str(self, a, player=None):
        if a >= NUM_MOVE_ACTIONS:
            return "s" + str(a - NUM_MOVE_ACTIONS)
        c = player
        return (self.position2str(self.action2from(a, c))
                + self.position2str(self.action2to(a, c)))

    def str2action(self, s, player=None):
        if s[0] == "s":
            return NUM_MOVE_ACTIONS + int(s[1:])
        c = player
        pos_from = self.str2position(s[:2])
        pos_to = self.str2position(s[2:])
        if pos_to is None:
            # off-board: the unique adjacent goal square
            d = 0
            for g in GOALS[c]:
                if ((pos_from - g) ** 2).sum() == 1:
                    diff = g - pos_from
                    for d, dd in enumerate(DIRECTIONS):
                        if np.array_equal(dd, diff):
                            break
                    break
        else:
            diff = pos_to - pos_from
            for d, dd in enumerate(DIRECTIONS):
                if np.array_equal(dd, diff):
                    break
        return self._encode_move(pos_from, d, c)

    # -- transitions -------------------------------------------------
    def _set_pieces(self, color, layout):
        self.layouts[color] = layout
        if layout < 0:
            layout = random.randrange(NUM_SET_ACTIONS)
        blues = LAYOUTS[layout]
        for idx in range(8):
            ptype = BLUE if idx in blues else RED
            piece = piece_of(color, ptype)
            pos = self.str2position(HOME_SQUARES[color][idx])
            self.board[pos[0], pos[1]] = piece
            self.piece_cnt[piece] += 1
        self.color = BLACK + WHITE - self.color
        self.turn_count += 1

    def play(self, action, player=None):
        if self.turn_count < 0:
            return self._set_pieces(self.color, action - NUM_MOVE_ACTIONS)

        pos_from = self.action2from(action, self.color)
        pos_to = self.action2to(action, self.color)
        piece = self.board[pos_from[0], pos_from[1]]
        self.captured_type = None

        if not self._onboard(pos_to):
            # a blue piece exits through the goal: immediate win
            self.board[pos_from[0], pos_from[1]] = EMPTY
            self.piece_cnt[piece] -= 1
            self.win_color = self.color
        else:
            captured = self.board[pos_to[0], pos_to[1]]
            if captured != EMPTY:
                self.piece_cnt[captured] -= 1
                if self.piece_cnt[captured] == 0:
                    if type_of(captured) == BLUE:
                        # captured every opponent blue: win
                        self.win_color = self.color
                    else:
                        # captured every opponent red: loss
                        self.win_color = BLACK + WHITE - self.color
                self.captured_type = type_of(captured)
            self.board[pos_to[0], pos_to[1]] = piece
            self.board[pos_from[0], pos_from[1]] = EMPTY

        self.color = BLACK + WHITE - self.color
        self.turn_count += 1
        self.record.append(action)

        if self.turn_count >= 200 and self.win_color is None:
            self.win_color = 2  # draw

    # -- delta-sync protocol -----------------------------------------
    def diff_info(self, player=None):
        color = player
        played_color = (self.turn_count - 1) % 2
        info = {}
        if len(self.record) == 0:
            if self.turn_count > -2:
                # setup: disclose the layout only to its owner
                info["set"] = (self.layouts[played_color]
                               if color == played_color else -1)
        else:
            info["move"] = self.action2str(self.record[-1], played_color)
            if color == played_color and self.captured_type is not None:
                # the capturer learns the captured piece's type
                info["captured"] = TYPE_NAMES[self.captured_type]
        return info

    def update(self, info, reset):
        if reset:
            self.reset(info)
        elif "set" in info:
            self._set_pieces(self.color, info["set"])
        elif "move" in info:
            action = self.str2action(info["move"], self.color)
            if "captured" in info:
                # reveal the captured piece's type on the mirror board
                pos_to = self.action2to(action, self.color)
                t = TYPE_NAMES.index(info["captured"])
                self.board[pos_to[0], pos_to[1]] = piece_of(
                    BLACK + WHITE - self.color, t)
            self.play(action)

    # -- framework interface -----------------------------------------
    def turn(self):
        return self.players()[self.turn_count % 2]

    def terminal(self):
        return self.win_color is not None

    def reward(self):
        # small constant time pressure (HandyRL's geister.py:435-437)
        return {p: -0.01 for p in self.players()}

    def outcome(self):
        outcomes = [0, 0]
        if self.win_color == BLACK:
            outcomes = [1, -1]
        elif self.win_color == WHITE:
            outcomes = [-1, 1]
        return {p: outcomes[i] for i, p in enumerate(self.players())}

    def _legal_dest(self, color, ptype, pos_to):
        if self._onboard(pos_to):
            return color_of(self.board[pos_to[0], pos_to[1]]) != color
        return ptype == BLUE and self._goal(color, pos_to)

    def legal(self, action):
        if self.turn_count < 0:
            return 0 <= action - NUM_MOVE_ACTIONS < NUM_SET_ACTIONS
        if not 0 <= action < NUM_MOVE_ACTIONS:
            return False
        pos_from = self.action2from(action, self.color)
        piece = self.board[pos_from[0], pos_from[1]]
        if color_of(piece) != self.color:
            return False
        return self._legal_dest(
            self.color, type_of(piece), self.action2to(action, self.color))

    def legal_actions(self, player=None):
        if self.turn_count < 0:
            return [NUM_MOVE_ACTIONS + i for i in range(NUM_SET_ACTIONS)]
        actions = []
        for x in range(6):
            for y in range(6):
                piece = self.board[x, y]
                if piece == EMPTY or color_of(piece) != self.color:
                    continue
                pos = np.array((x, y), dtype=np.int32)
                for d in range(4):
                    if self._legal_dest(self.color, type_of(piece),
                                        pos + DIRECTIONS[d]):
                        actions.append(self._encode_move(pos, d, self.color))
        return actions

    def players(self):
        return [0, 1]

    def observation(self, player=None):
        turn_view = player is None or player == self.turn()
        color = self.color if turn_view else BLACK + WHITE - self.color
        opponent = BLACK + WHITE - color

        counts = []
        for c, t in ((color, BLUE), (color, RED),
                     (opponent, BLUE), (opponent, RED)):
            n = self.piece_cnt[piece_of(c, t)]
            counts.extend([1.0 if n == i else 0.0 for i in range(1, 5)])

        scalar = np.array(
            [1.0 if color == BLACK else 0.0, 1.0 if turn_view else 0.0]
            + counts, dtype=np.float32)

        blue_c = self.board == piece_of(color, BLUE)
        red_c = self.board == piece_of(color, RED)
        blue_o = self.board == piece_of(opponent, BLUE)
        red_o = self.board == piece_of(opponent, RED)
        zeros = np.zeros_like(self.board, dtype=bool)

        planes = np.stack([
            np.ones((6, 6), dtype=bool),
            blue_c | red_c,
            blue_o | red_o,
            blue_c,
            red_c,
            # opponent piece types are hidden from players
            blue_o if player is None else zeros,
            red_o if player is None else zeros,
        ], axis=-1).astype(np.float32)  # (6, 6, C) channel-last

        if color == WHITE:
            planes = np.rot90(planes, k=2, axes=(0, 1)).copy()
        return {"scalar": scalar, "board": planes}

    def net(self):
        from ..models.geister_net import GeisterNet

        return GeisterNet()

    def __str__(self):
        def glyph(piece):
            if piece == EMPTY:
                return PIECE_GLYPH[EMPTY]
            if self.layouts.get(color_of(piece), 0) < 0:
                return PIECE_GLYPH[4]
            return PIECE_GLYPH[piece]

        s = "  " + " ".join(Y_NAMES) + "\n"
        for x in range(6):
            s += X_NAMES[x] + " " + " ".join(
                glyph(self.board[x, y]) for y in range(6)) + "\n"
        s += "remained = B:%d R:%d b:%d r:%d\n" % tuple(self.piece_cnt)
        s += ("turn = " + str(self.turn_count).ljust(3)
              + " color = " + COLOR_NAMES[self.color])
        return s


if __name__ == "__main__":
    e = Environment()
    for _ in range(3):
        e.reset()
        while not e.terminal():
            e.play(random.choice(e.legal_actions()))
        print(e)
        print(e.outcome())
