"""Hungry Geese: 4-player simultaneous survival game (flagship workload).

Capability parity with HandyRL's handyrl/envs/kaggle/hungry_geese.py
(which wraps ``kaggle_environments``).  That package is not a
dependency here, so the game itself is implemented natively with the
Kaggle rules: a 7x11 torus, four geese moving simultaneously, food
growth, reversal deaths, body/head collisions, starvation every
``HUNGER_RATE`` steps, and a 200-step episode cap.  Rewards order by
(survival step, length), and the outcome is the reference's pairwise
rank scoring: 1st +1.0, 2nd +1/3, 3rd -1/3, 4th -1.0
(reference hungry_geese.py:168-180).

Observation parity (reference hungry_geese.py:206-232): 17 planes of
7x11 — per-player head / tail-tip / whole-body / previous-head (rotated
so the observing player is plane 0) + food — emitted channel-last
(7, 11, 17).

Transition semantics follow the official ``kaggle_environments``
interpreter (tests/test_geese_rules_golden.py pins them step by step):
moves + eat/tail-pop first, then the every-40th-step hunger pop, then
collision resolution on the position histogram (head-on kills all
heads involved; pass-through swaps are legal because only the final
histogram is consulted), reversal kills only geese with a body
(len > 1).  Deliberate divergences, both ranking-equivalent: the
reward step-weight is CELLS + 1 = 78 instead of the official
max_length + 1 = 100 (any survival-step edge still dominates any
length edge, since lengths are < 78), and food/start cells draw from
this module's seeded ``random`` stream rather than the Kaggle
runner's.
"""

import random

import numpy as np

from ...environment import BaseEnvironment

ROWS, COLS = 7, 11
CELLS = ROWS * COLS
NUM_AGENTS = 4
HUNGER_RATE = 40
MIN_FOOD = 2
EPISODE_STEPS = 200
# survival step dominates length in the ranking reward
REWARD_STEP = CELLS + 1

ACTIONS = ["NORTH", "SOUTH", "WEST", "EAST"]
DIRECTIONS = [(-1, 0), (1, 0), (0, -1), (0, 1)]
OPPOSITE = {0: 1, 1: 0, 2: 3, 3: 2}


def translate(pos, action):
    x, y = divmod(pos, COLS)
    dx, dy = DIRECTIONS[action]
    return ((x + dx) % ROWS) * COLS + (y + dy) % COLS


class Environment(BaseEnvironment):
    def __init__(self, args=None):
        super().__init__(args)
        self.args = args or {}
        self.reset()

    def reset(self, args=None):
        starts = random.sample(range(CELLS), NUM_AGENTS)
        self.geese = [[s] for s in starts]
        self.food = set()
        self.statuses = ["ACTIVE"] * NUM_AGENTS
        self.rewards = [0] * NUM_AGENTS
        self.last_actions = {}
        self.prev_heads = [None] * NUM_AGENTS
        self.step_count = 0
        self._spawn_food()
        self._sync_rewards()

    def _occupied(self):
        return {pos for goose in self.geese for pos in goose}

    def _spawn_food(self):
        free = list(set(range(CELLS)) - self._occupied() - self.food)
        random.shuffle(free)
        while len(self.food) < MIN_FOOD and free:
            self.food.add(free.pop())

    def _sync_rewards(self):
        for p in range(NUM_AGENTS):
            if self.statuses[p] == "ACTIVE":
                self.rewards[p] = (
                    (self.step_count + 1) * REWARD_STEP + len(self.geese[p]))

    # -- simultaneous transition -------------------------------------
    def step(self, actions):
        self.prev_heads = [
            goose[0] if goose else None for goose in self.geese]
        new_heads = {}

        for p in self.turns():
            action = actions.get(p)
            if action is None:
                action = 0
            goose = self.geese[p]
            if (p in self.last_actions
                    and action == OPPOSITE[self.last_actions[p]]
                    and len(goose) > 1):
                # reversing your neck is death — but a length-1 goose
                # has no neck and may double back (official
                # interpreter: "Check action direction on any goose
                # with a body (longer than 1)")
                self.statuses[p] = "DONE"
                self.geese[p] = []
                continue
            self.last_actions[p] = action
            head = translate(goose[0], action)
            new_heads[p] = head
            goose.insert(0, head)
            if head in self.food:
                self.food.discard(head)  # grow: keep the tail
            else:
                goose.pop()

        # starvation: everyone sheds a tail segment every HUNGER_RATE steps
        if (self.step_count + 1) % HUNGER_RATE == 0:
            for p in list(new_heads):
                if self.geese[p]:
                    self.geese[p].pop()
                if not self.geese[p]:
                    self.statuses[p] = "DONE"
                    new_heads.pop(p)

        # collisions: a head sharing any occupied cell dies (head-to-head
        # kills every goose involved)
        cell_count = {}
        for goose in self.geese:
            for pos in goose:
                cell_count[pos] = cell_count.get(pos, 0) + 1
        for p, head in new_heads.items():
            if cell_count.get(head, 0) > 1:
                self.statuses[p] = "DONE"
        for p in range(NUM_AGENTS):
            if self.statuses[p] == "DONE":
                self.geese[p] = []

        self.step_count += 1
        self._sync_rewards()
        self._spawn_food()

        active = [p for p in range(NUM_AGENTS)
                  if self.statuses[p] == "ACTIVE"]
        if len(active) <= 1 or self.step_count >= EPISODE_STEPS - 1:
            for p in active:
                self.statuses[p] = "DONE"

    # -- framework interface -----------------------------------------
    def turns(self):
        return [p for p in self.players() if self.statuses[p] == "ACTIVE"]

    def terminal(self):
        return all(s != "ACTIVE" for s in self.statuses)

    def outcome(self):
        outcomes = {p: 0.0 for p in self.players()}
        for p in self.players():
            for q in self.players():
                if p == q:
                    continue
                if self.rewards[p] > self.rewards[q]:
                    outcomes[p] += 1 / (NUM_AGENTS - 1)
                elif self.rewards[p] < self.rewards[q]:
                    outcomes[p] -= 1 / (NUM_AGENTS - 1)
        return outcomes

    def legal_actions(self, player=None):
        return list(range(len(ACTIONS)))

    def players(self):
        return list(range(NUM_AGENTS))

    def action2str(self, a, player=None):
        return ACTIONS[a]

    def str2action(self, s, player=None):
        return ACTIONS.index(s)

    # -- delta-sync protocol -----------------------------------------
    def diff_info(self, player=None):
        return {
            "geese": [list(g) for g in self.geese],
            "food": sorted(self.food),
            "statuses": list(self.statuses),
            "rewards": list(self.rewards),
            "last_actions": dict(self.last_actions),
            "prev_heads": list(self.prev_heads),
            "step": self.step_count,
        }

    def update(self, info, reset):
        self.geese = [list(g) for g in info["geese"]]
        self.food = set(info["food"])
        self.statuses = list(info["statuses"])
        self.rewards = list(info["rewards"])
        self.last_actions = dict(info["last_actions"])
        self.prev_heads = list(info["prev_heads"])
        self.step_count = info["step"]

    # -- rule-based opponent (greedy, reference hungry_geese.py:189) --
    def rule_based_action(self, player, key=None):
        goose = self.geese[player]
        if not goose:
            return 0
        head = goose[0]
        occupied = self._occupied()
        banned = (OPPOSITE[self.last_actions[player]]
                  if player in self.last_actions else None)

        def food_distance(pos):
            if not self.food:
                return 0
            x, y = divmod(pos, COLS)
            dists = []
            for f in self.food:
                fx, fy = divmod(f, COLS)
                dx = min(abs(fx - x), ROWS - abs(fx - x))
                dy = min(abs(fy - y), COLS - abs(fy - y))
                dists.append(dx + dy)
            return min(dists)

        best_action, best_score = 0, float("inf")
        for a in range(4):
            if a == banned:
                continue
            pos = translate(head, a)
            score = food_distance(pos)
            if pos in occupied and pos != goose[-1]:
                score += 1000  # likely fatal
            if score < best_score:
                best_action, best_score = a, score
        return best_action

    # -- neural-net interface ----------------------------------------
    def observation(self, player=None):
        if player is None:
            player = 0
        planes = np.zeros((17, CELLS), dtype=np.float32)
        for p, goose in enumerate(self.geese):
            rel = (p - player) % NUM_AGENTS
            if goose:
                planes[0 + rel, goose[0]] = 1.0
                planes[4 + rel, goose[-1]] = 1.0
                for pos in goose:
                    planes[8 + rel, pos] = 1.0
            if self.prev_heads[p] is not None:
                planes[12 + rel, self.prev_heads[p]] = 1.0
        for pos in self.food:
            planes[16, pos] = 1.0
        # (17, 77) -> (7, 11, 17) channel-last
        return planes.reshape(17, ROWS, COLS).transpose(1, 2, 0).copy()

    def net(self):
        from ...models.geese_net import GeeseNet

        return GeeseNet()

    def __str__(self):
        grid = ["."] * CELLS
        for pos in self.food:
            grid[pos] = "f"
        glyphs = "ABCD"
        for p, goose in enumerate(self.geese):
            for pos in goose:
                grid[pos] = glyphs[p].lower()
            if goose:
                grid[goose[0]] = glyphs[p]
        lines = ["step %d" % self.step_count]
        for x in range(ROWS):
            lines.append("".join(grid[x * COLS:(x + 1) * COLS]))
        lines.append(" ".join(
            str(len(g) or "-") for g in self.geese))
        return "\n".join(lines)


if __name__ == "__main__":
    e = Environment()
    for _ in range(3):
        e.reset()
        while not e.terminal():
            e.step({p: random.choice(e.legal_actions(p))
                    for p in e.turns()})
        print(e)
        print(e.outcome())
