"""GRFProxy: a football-drill env at Google-Research-Football scale.

Capability proof for BASELINE.json config #5 ("Google Research
Football, LSTM policy, large-scale distributed workers").  The real
GRF env is not a dependency of this project, so this drill reproduces
the parts of the workload that stress the FRAMEWORK, at the real
geometry:

  * (72, 96, 16) binary observation planes — the GRF SMM raster size,
    ~110 KB/step/player as uint8 wire format vs the flagship's 1.3 KB;
  * long episodes (default 1000 steps, configurable to 3000) that
    exercise ring ``t_max`` sizing, bz2 wire cost, and burn-in replay
    at GRF horizons;
  * a recurrent policy (models/grf_net.py) carrying ConvLSTM state;
  * a scripted chaser (``rule_based_action``) as the drill opponent.

The game itself is simple keepaway-to-goal: two players on a 72x96
field, a ball that is picked up by proximity, goals at the left/right
field ends; a goal scores and resets positions.  Outcome is the sign
of the final score difference.  Rules are intentionally light — the
env exists to generate GRF-shaped traffic, not to model football.
"""

import random

import numpy as np

from ..environment import BaseEnvironment

ROWS, COLS = 72, 96
PLANES = 16
NUM_AGENTS = 2
SPEED = 2            # cells per move
PICKUP = 3           # possession radius (chebyshev)
DEFAULT_STEPS = 1000

# action -> (drow, dcol): 0 stay, then 8 compass directions
MOVES = [(0, 0), (-1, 0), (-1, 1), (0, 1), (1, 1),
         (1, 0), (1, -1), (0, -1), (-1, -1)]
# player 0 attacks the right goal column, player 1 the left
GOAL_COL = {0: COLS - 1, 1: 0}


class Environment(BaseEnvironment):
    def __init__(self, args=None):
        super().__init__(args)
        self.args = args or {}
        self.max_steps = int(self.args.get("max_steps", DEFAULT_STEPS))
        self.reset()

    def reset(self, args=None):
        self.pos = {0: [ROWS // 2, COLS // 4],
                    1: [ROWS // 2, 3 * COLS // 4]}
        self.ball = [ROWS // 2, COLS // 2]
        self.owner = -1
        self.score = [0, 0]
        self.last_scores = {}
        self.step_count = 0
        return False

    # -- simultaneous transition -------------------------------------
    def turns(self):
        return [0, 1]

    def step(self, actions):
        self.last_scores = {}
        for p in (0, 1):
            dr, dc = MOVES[actions.get(p) or 0]
            pos = self.pos[p]
            pos[0] = min(ROWS - 1, max(0, pos[0] + dr * SPEED))
            pos[1] = min(COLS - 1, max(0, pos[1] + dc * SPEED))
        if self.owner >= 0:
            self.ball = list(self.pos[self.owner])
        # possession: closest player within the pickup radius; on an
        # exact tie the ball stays loose (symmetric)
        dists = {p: max(abs(self.pos[p][0] - self.ball[0]),
                        abs(self.pos[p][1] - self.ball[1]))
                 for p in (0, 1)}
        if self.owner < 0:
            close = [p for p in (0, 1) if dists[p] <= PICKUP]
            if len(close) == 1:
                self.owner = close[0]
            elif len(close) == 2 and dists[0] != dists[1]:
                self.owner = 0 if dists[0] < dists[1] else 1
        else:
            rival = 1 - self.owner
            if (dists[rival] <= PICKUP
                    and dists[rival] < dists[self.owner]):
                self.owner = rival
        # goal: the owner carries the ball over the attacked column
        if self.owner >= 0 \
                and self.ball[1] == GOAL_COL[self.owner]:
            scorer = self.owner
            self.score[scorer] += 1
            self.last_scores = {scorer: 1.0, 1 - scorer: -1.0}
            self.reset_positions()
        self.step_count += 1

    def reset_positions(self):
        self.pos = {0: [ROWS // 2, COLS // 4],
                    1: [ROWS // 2, 3 * COLS // 4]}
        self.ball = [ROWS // 2, COLS // 2]
        self.owner = -1

    # -- scoring ----------------------------------------------------
    def terminal(self):
        return self.step_count >= self.max_steps

    def reward(self):
        return dict(self.last_scores)

    def outcome(self):
        diff = self.score[0] - self.score[1]
        s = 0.0 if diff == 0 else (1.0 if diff > 0 else -1.0)
        return {0: s, 1: -s}

    # -- actions & players ------------------------------------------
    def legal_actions(self, player=None):
        return list(range(len(MOVES)))

    def players(self):
        return [0, 1]

    # -- scripted opponent ------------------------------------------
    def rule_based_action(self, player, key=None):
        """Chase the ball; with possession, run at the goal."""
        me = self.pos[player]
        target = ([me[0], GOAL_COL[player]]
                  if self.owner == player else self.ball)

        def sign(v):
            return 0 if v == 0 else (1 if v > 0 else -1)

        want = (sign(target[0] - me[0]), sign(target[1] - me[1]))
        for a, move in enumerate(MOVES):
            if move == want:
                return a
        return 0

    # -- neural-net interface ---------------------------------------
    def observation(self, player=None):
        """16 binary planes at GRF SMM geometry, channel-last and
        integer-valued (uint8 wire eligible): my/opp/ball position
        disks, possession flags, carried flag, goal columns, field
        halves, score-lead flags, and 4 binary-coded phase planes."""
        if player is None:
            player = 0
        me, opp = player, 1 - player
        planes = np.zeros((ROWS, COLS, PLANES), np.float32)

        def disk(plane, pos, r=1):
            r0, r1 = max(0, pos[0] - r), min(ROWS, pos[0] + r + 1)
            c0, c1 = max(0, pos[1] - r), min(COLS, pos[1] + r + 1)
            planes[r0:r1, c0:c1, plane] = 1.0

        disk(0, self.pos[me])
        disk(1, self.pos[opp])
        disk(2, self.ball)
        if self.owner == me:
            planes[:, :, 3] = 1.0
        elif self.owner == opp:
            planes[:, :, 4] = 1.0
        if self.owner >= 0:
            disk(5, self.pos[self.owner])
        planes[:, GOAL_COL[me], 6] = 1.0
        planes[:, GOAL_COL[opp], 7] = 1.0
        half = COLS // 2
        if GOAL_COL[me] == COLS - 1:
            planes[:, :half, 8] = 1.0
            planes[:, half:, 9] = 1.0
        else:
            planes[:, half:, 8] = 1.0
            planes[:, :half, 9] = 1.0
        if self.score[me] > self.score[opp]:
            planes[:, :, 10] = 1.0
        elif self.score[me] < self.score[opp]:
            planes[:, :, 11] = 1.0
        phase = (self.step_count * 16) // max(1, self.max_steps)
        for bit in range(4):
            if (phase >> bit) & 1:
                planes[:, :, 12 + bit] = 1.0
        return planes

    def net(self):
        from ..models.grf_net import GRFNet

        return GRFNet()

    # -- delta-sync protocol ----------------------------------------
    def diff_info(self, player=None):
        return {
            "pos": {p: list(v) for p, v in self.pos.items()},
            "ball": list(self.ball),
            "owner": self.owner,
            "score": list(self.score),
            "last": dict(self.last_scores),
            "step": self.step_count,
        }

    def update(self, info, reset):
        self.pos = {int(p): list(v) for p, v in info["pos"].items()}
        self.ball = list(info["ball"])
        self.owner = info["owner"]
        self.score = list(info["score"])
        self.last_scores = dict(info["last"])
        self.step_count = info["step"]

    def __str__(self):
        return (f"step {self.step_count} score {self.score} "
                f"ball {self.ball} owner {self.owner}")


if __name__ == "__main__":
    e = Environment({"max_steps": 200})
    while not e.terminal():
        e.step({0: e.rule_based_action(0),
                1: random.choice(e.legal_actions(1))})
    print(e, e.outcome())
