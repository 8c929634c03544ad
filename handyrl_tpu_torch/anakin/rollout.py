"""The Anakin engine: fused on-device rollout + batch + update.

The counterpart of ``handyrl_tpu.anakin.rollout``.  The JAX package
compiles one segment's rollout and the update into one donated XLA
program; here one fused step is an eager sequence of library calls on
the training device, and the host only enqueues them:

  * ``num_envs`` self-play games advance in lockstep as tensors of the
    env's device twin (the env axis is the step's batch dimension);
  * one segment unrolls ``unroll_length`` (>= the env's MAX_STEPS)
    steps of observe -> forward -> masked sampling -> env step.  Every
    game resets at segment start and finishes inside it, so each env
    row becomes one complete-episode batch row in ``make_batch``'s
    turn-based layout (full window, outcome bootstrap on the tail);
  * the env axis factors into ``opponent_pool + 1`` equal groups:
    group 0 is pure self-play, group k plays the learner seat against
    frozen snapshot k (a Python loop over K modules).  The learner seat
    alternates per game and per segment, and opponent moves record the
    opponent's behaviour probabilities, so the importance correction
    stays exact;
  * the segment's records assemble into a batch on the device and go
    straight into :class:`..ops.update.UpdateStep` (loss, backward,
    clip, fused Adam).

No step reads a value back to the host: the frame count stays a device
tensor until the trainer's one metrics copy per epoch.  Sampling is the
Gumbel-max form of a categorical draw (the JAX package's
``jax.random.categorical``) from one ``torch.Generator`` on the device;
jax.random and torch streams differ, so a test replays the JAX draws
through ``rollout``'s ``actions`` seam instead.
"""

import copy

import torch

from ..batch import ILLEGAL
from ..ops.update import make_apply_fn
from .config import AnakinConfig

_TINY = torch.finfo(torch.float32).tiny


class AnakinEngine:
    """Owns the rollout geometry and builds the fused step over an
    :class:`..ops.update.UpdateStep` (the live module, the optimizer
    and, under IMPACT, the target module).

    ``pool`` (the list of frozen snapshot modules) is an argument of the
    fused step, read-only inside it and refreshed only at epoch
    boundaries (:meth:`refresh_pool`)."""

    def __init__(self, device_env, update_step, cfg: AnakinConfig,
                 compute_dtype="float32", seed=0):
        module, loss_cfg = update_step.module, update_step.cfg
        if hasattr(module, "init_hidden"):
            raise ValueError(
                "anakin mode supports feed-forward nets only (the "
                "fused rollout carries no hidden state yet)")
        if not loss_cfg.turn_based_training or loss_cfg.observation:
            raise ValueError(
                "anakin mode requires turn_based_training: true and "
                "observation: false (the fused batch layout is the "
                "turn-gathered one)")
        if loss_cfg.burn_in_steps:
            raise ValueError(
                "anakin mode requires burn_in_steps: 0 (segments are "
                "whole episodes; there is no replayed warmup window)")
        self.env = device_env
        self.update_step = update_step
        self.compute_dtype = compute_dtype
        self.seed = int(seed)
        self.device = next(module.parameters()).device
        self.num_envs = cfg.num_envs
        self.unroll = cfg.unroll_length or int(device_env.MAX_STEPS)
        if self.unroll < int(device_env.MAX_STEPS):
            raise ValueError(
                f"anakin.unroll_length {self.unroll} < the env's "
                f"MAX_STEPS {int(device_env.MAX_STEPS)}: segments are "
                "episode-aligned, so every game must be able to finish "
                "inside one segment")
        self.K = cfg.opponent_pool          # frozen snapshots
        self.group = self.num_envs // (self.K + 1)
        self.players = int(device_env.NUM_PLAYERS)
        self.num_actions = int(device_env.NUM_ACTIONS)

    # -- carry and pool (once per run / per epoch) ---------------------

    def init_carry(self, start_step=0):
        """The fused step's carry: one generator on the device, seeded
        from the config seed and the resumed step count (a restart
        continues on a fresh, reproducible stream), and the segment
        counter."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed * 1_000_003 + int(start_step))
        return {"generator": generator, "seg": int(start_step)}

    def init_pool(self, module):
        """``opponent_pool`` frozen copies of ``module`` (every snapshot
        starts as "now"; epoch boundaries shift history in)."""
        pool = []
        for _ in range(self.K):
            snap = copy.deepcopy(module)
            snap.requires_grad_(False)
            pool.append(snap)
        return pool

    def refresh_pool(self, pool, module):
        """Epoch boundary: the newest snapshot into slot 0, the oldest
        out.  The oldest slot's module is overwritten with a COPY of
        the live parameters (Adam updates those in place, so a slot
        aliasing them would play the current policy) and moved to the
        front."""
        if not pool:
            return pool
        oldest = pool[-1]
        with torch.no_grad():
            oldest.load_state_dict(module.state_dict())
        return [oldest] + list(pool[:-1])

    # -- one segment ---------------------------------------------------

    def rollout(self, module, pool, carry, actions=None):
        """One segment: reset -> ``unroll`` steps -> batch, with
        ``module`` playing the learner (and, in group 0, both) seats.

        Returns ``(batch, new_carry, frames)``: ``batch`` in
        ``make_batch``'s turn-based layout (each env row one complete
        episode, the padded tail carrying the outcome bootstrap),
        ``frames`` the committed env transitions as a device scalar.
        ``actions``, a (T, N) tensor, replaces the sampled actions (a
        test seam: it replays another rollout's draws)."""
        env = self.env
        N, T, P, A = (self.num_envs, self.unroll, self.players,
                      self.num_actions)
        dev, G = self.device, self.group
        generator, seg = carry["generator"], carry["seg"]
        apply = make_apply_fn(module, self.compute_dtype)
        pool_apply = [make_apply_fn(m, self.compute_dtype) for m in pool]
        # the learner's seat alternates per game AND per segment, so
        # both seats see both roles whatever the group layout
        learner_seat = (torch.arange(N, device=dev) + seg) % 2
        states = env.init(N, dev)
        recs = {k: [] for k in ("obs", "prob", "act", "amask", "value",
                                "seat", "active")}
        for t in range(T):
            active = ~env.terminal(states)
            obs = env.observe(states)                     # (N, 3, 3, 3)
            legal = env.legal_mask(states)                # (N, A)
            seat = env.turn(states)                       # (N,)
            out = apply(obs)
            policy, value = out["policy"], out["value"]
            if pool_apply:
                # group k > 0 plays its frozen snapshot on the
                # opponent seat; group 0's opponent is the live policy
                opp = [fn(obs[G * (k + 1):G * (k + 2)])
                       for k, fn in enumerate(pool_apply)]
                is_learner = (seat == learner_seat)[:, None]
                policy = torch.where(is_learner, policy, torch.cat(
                    [policy[:G]] + [o["policy"] for o in opp]))
                value = torch.where(is_learner, value, torch.cat(
                    [value[:G]] + [o["value"] for o in opp]))
            # the masked behaviour policy of agent.masked_logits:
            # illegal entries REPLACED by -ILLEGAL, then a temperature-1
            # softmax draw with the drawn probability recorded
            masked = torch.where(legal, policy, -float(ILLEGAL))
            if actions is None:
                u = torch.rand((N, A), generator=generator, device=dev)
                gumbel = -torch.log(-torch.log(u.clamp_min(_TINY)))
                action = (masked + gumbel).argmax(dim=-1)
            else:
                action = actions[t].to(dev).long()
            prob = torch.softmax(masked, dim=-1).gather(
                1, action[:, None])[:, 0]
            states = env.step(states, action)[0]
            # inactive rows carry make_batch's padding: zero obs,
            # action and value, prob 1.0, all-ILLEGAL mask
            recs["obs"].append(torch.where(
                active.view(N, 1, 1, 1), obs, 0.0))
            recs["prob"].append(torch.where(active, prob, 1.0))
            recs["act"].append(torch.where(active, action, 0).int())
            recs["amask"].append(torch.where(
                active[:, None] & legal, 0.0, float(ILLEGAL)))
            recs["value"].append(torch.where(active, value[:, 0], 0.0))
            recs["seat"].append(seat)
            recs["active"].append(active)
        recs = {k: torch.stack(v, dim=1) for k, v in recs.items()}

        active = recs["active"]                            # (N, T)
        ep_len = active.sum(dim=1)                         # (N,)
        outcome = env.outcome(states)                      # (N, P)
        seat_oh = (recs["seat"][..., None]
                   == torch.arange(P, device=dev)).float()  # (N, T, P)
        act_mask = active.float()
        turn_mask = seat_oh * act_mask[..., None]          # (N, T, P)
        # the acting player's value on their seat row; the padded tail
        # bootstraps every seat with the final outcome
        v_rows = torch.where(active[..., None],
                             seat_oh * recs["value"][..., None],
                             outcome[:, None, :])          # (N, T, P)
        t_idx = torch.arange(T, device=dev, dtype=torch.float32)
        progress = torch.where(active, t_idx / ep_len.float()[:, None],
                               1.0)
        zeros_p = torch.zeros((N, T, P, 1), device=dev)
        batch = {
            "observation": recs["obs"][:, :, None],        # (N,T,1,...)
            "selected_prob": recs["prob"][..., None, None],
            "action": recs["act"][..., None, None],
            "action_mask": recs["amask"][:, :, None, :],
            "value": v_rows[..., None],
            "reward": zeros_p,
            "return": zeros_p,
            "outcome": outcome[:, None, :, None],
            "episode_mask": act_mask[..., None, None],
            "turn_mask": turn_mask[..., None],
            "observation_mask": turn_mask[..., None],
            "progress": progress[..., None],
        }
        new_carry = {"generator": generator, "seg": seg + 1}
        return batch, new_carry, ep_len.sum()

    def make_fused_step(self):
        """``step(carry, pool=(), actions=None) -> (metrics, carry)``:
        one segment's rollout under ``torch.no_grad()`` by the live
        module, then one ``UpdateStep`` on its batch (which refreshes
        the IMPACT target module when it has one).  ``metrics`` holds
        the update's device scalars plus ``anakin_frames`` (committed
        env transitions) and ``anakin_games`` (completed games)."""
        update = self.update_step
        games = torch.full((), float(self.num_envs), device=self.device)

        def step(carry, pool=(), actions=None):
            with torch.no_grad():
                batch, carry, frames = self.rollout(
                    update.module, pool, carry, actions)
            metrics = update(batch)
            metrics.update(anakin_frames=frames.float(),
                           anakin_games=games)
            return metrics, carry

        return step
