"""Forward prediction and loss composition — the learner's math.

The counterpart of ``handyrl_tpu.ops.losses``:
  * feed-forward nets run one flattened forward over ``(B*T*P, ...)``;
    recurrent nets step over T with observation-mask hidden blending,
    turn-based hidden gathering and gradient-free burn-in;
  * losses: TD/MC/UPGO/V-Trace targets on detached values, importance
    ratios clipped at ``rho_clip``/``c_clip``, two-player zero-sum value
    symmetrization, terminal outcome bootstrap, entropy regularization
    decayed by episode progress;
  * ``update_algorithm: impact`` computes the ratios against a target
    network's policy and swaps the policy loss for a two-sided
    surrogate clip.

Where the JAX package calls ``lax.stop_gradient`` this module detaches
(or, for the burn-in steps of a recurrent net, runs under
``torch.no_grad()``).  The JAX package's ``lax.scan`` over time is a
Python loop here.
"""

import contextlib
from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..utils.tree import tree_map_leaves
from .targets import compute_target

# reference defaults for the importance-ratio clips; the live values
# come from LossConfig (rho_clip / c_clip surface them as config keys)
CLIP_RHO = 1.0
CLIP_C = 1.0


class LossConfig(NamedTuple):
    """Static training hyper-parameters (a copy of the JAX twin's)."""

    turn_based_training: bool
    observation: bool
    burn_in_steps: int
    lambda_: float
    gamma: float
    policy_target: str
    value_target: str
    entropy_regularization: float
    entropy_regularization_decay: float
    rho_clip: float = CLIP_RHO
    c_clip: float = CLIP_C
    # "standard" = live-policy ratios + score-function policy loss;
    # "impact" = target-network ratios + clipped surrogate objective
    update_algorithm: str = "standard"
    surrogate_clip: float = 0.2
    # target-network refresh cadence (impact only): hard sync every
    # `target_update_interval` optimizer steps, or Polyak averaging
    # with `target_update_tau` when > 0 (tau wins if both are set)
    target_update_interval: int = 0
    target_update_tau: float = 0.0

    @classmethod
    def from_config(cls, cfg) -> "LossConfig":
        return cls(
            turn_based_training=bool(cfg["turn_based_training"]),
            observation=bool(cfg["observation"]),
            burn_in_steps=int(cfg["burn_in_steps"]),
            lambda_=float(cfg["lambda"]),
            gamma=float(cfg["gamma"]),
            policy_target=str(cfg["policy_target"]),
            value_target=str(cfg["value_target"]),
            entropy_regularization=float(cfg["entropy_regularization"]),
            entropy_regularization_decay=float(
                cfg["entropy_regularization_decay"]),
            rho_clip=float(cfg.get("rho_clip", CLIP_RHO) or CLIP_RHO),
            c_clip=float(cfg.get("c_clip", CLIP_C) or CLIP_C),
            update_algorithm=str(
                cfg.get("update_algorithm", "standard") or "standard"),
            surrogate_clip=float(cfg.get("surrogate_clip", 0.2) or 0.2),
            target_update_interval=int(
                cfg.get("target_update_interval", 0) or 0),
            target_update_tau=float(
                cfg.get("target_update_tau", 0.0) or 0.0),
        )


def _flatten_lead(tree, n):
    return tree_map_leaves(
        lambda a: a.reshape((-1,) + tuple(a.shape[n:])), tree)


def forward_prediction(apply_fn: Callable, hidden, batch,
                       cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """Run the net over a ``(B, T, P_in, ...)`` batch ->
    ``(B, T, P_in/P, ...)`` float32 outputs, masked.

    ``apply_fn(obs, hidden)`` is the net's forward on ``(N, ...)``
    observation leaves (see :func:`..ops.update.make_apply_fn`).
    ``hidden`` is the initial ``(B, P, ...)`` recurrent state or None.

    A recurrent net runs step by step over T (the JAX package's
    ``lax.scan``): the carried hidden is zeroed where the player did
    not observe, so an episode start inside the window restarts the
    recurrence; the net's new hidden is written into the observed
    seats only; the first ``burn_in_steps`` steps run under
    ``torch.no_grad()``, the JAX package's ``stop_gradient`` on their
    outputs and next hidden."""
    observations = batch["observation"]
    B, T, P_in = batch["action"].shape[:3]
    if hidden is None:
        out = apply_fn(_flatten_lead(observations, 3), None)
        outputs = {k: v.reshape((B, T, P_in) + v.shape[1:])
                   for k, v in out.items() if v is not None}
    else:
        outputs, _ = recurrent_scan(apply_fn, hidden, batch, cfg)

    # mask heads: policy by turn, scalar heads by observation
    result = {}
    for k, o in outputs.items():
        if k == "policy":
            o = o * batch["turn_mask"]  # may broadcast P_in -> P
            if o.shape[2] > P_in:
                # turn-alternating batch: collapse back to the acting seat
                o = o.sum(dim=2, keepdim=True)
            result[k] = o - batch["action_mask"]
        else:
            result[k] = o * batch["observation_mask"]
    return result


def recurrent_scan(apply_fn, hidden, batch, cfg):
    """The recurrent net stepped over the batch's T steps from the
    ``(B, P, ...)`` state ``hidden``: ``(outputs, hidden after step
    T)``, the outputs ``(B, T, P_in, ...)`` and not yet masked."""
    observations = batch["observation"]
    omask_full = batch["observation_mask"]  # (B, T, P, 1)
    B, T, P_in = batch["action"].shape[:3]
    # the single acting seat in turn-based mode, every player otherwise
    gather_turn = cfg.turn_based_training and not cfg.observation
    P_model = 1 if gather_turn else omask_full.shape[2]
    steps = []
    for t in range(T):
        burn = t < cfg.burn_in_steps
        with torch.no_grad() if burn else contextlib.nullcontext():
            omask_t = omask_full[:, t]  # (B, P, 1)

            def mask_like(h):
                return omask_t.reshape(
                    omask_t.shape[:2] + (1,) * (h.ndim - 2))

            h_masked = {k: h * mask_like(h) for k, h in hidden.items()}
            if gather_turn:
                # only the turn player's hidden is non-zero: the P-sum
                # gathers it into the single acting seat
                h_in = {k: h.sum(dim=1) for k, h in h_masked.items()}
            else:
                h_in = _flatten_lead(h_masked, 2)  # (B*P, ...)
            obs_t = tree_map_leaves(lambda a: a[:, t], observations)
            out = apply_fn(_flatten_lead(obs_t, 2), h_in)
            next_hidden = out.pop("hidden")
            steps.append({k: v.reshape((B, P_in) + v.shape[1:])
                          for k, v in out.items() if v is not None})
            # write the new hidden into observed seats only
            hidden = {
                k: h * (1 - mask_like(h)) + next_hidden[k].reshape(
                    (B, P_model) + next_hidden[k].shape[1:]) * mask_like(h)
                for k, h in hidden.items()}
    return ({k: torch.stack([o[k] for o in steps], dim=1)
             for k in steps[0]}, hidden)


def _huber(x):
    """Smooth-L1 with delta=1 (matches F.smooth_l1_loss)."""
    absx = x.abs()
    return torch.where(absx < 1.0, 0.5 * x * x, absx - 0.5)


def _masked_entropy(logits, dim=-1):
    """Categorical entropy that is exact-zero-safe for -1e32 masked
    logits (softmax underflows to exactly 0, and 0 * finite = 0)."""
    lsm = F.log_softmax(logits, dim=dim)
    p = lsm.exp()
    return -(p * lsm.clamp(-1e32, 0.0)).sum(dim=dim)


def compose_losses(outputs, log_selected_policies, total_advantages,
                   targets, batch, cfg: LossConfig, policy_loss=None):
    """Combine policy / value / return / entropy losses (summed, not
    averaged — the lr schedule normalizes by the data-count EMA).

    ``policy_loss`` (per-element, pre-mask) replaces the default
    score-function term when given (the IMPACT surrogate)."""
    tmasks = batch["turn_mask"]
    omasks = batch["observation_mask"]

    losses = {}
    dcnt = tmasks.sum()

    if policy_loss is None:
        policy_loss = -log_selected_policies * total_advantages
    losses["p"] = (policy_loss * tmasks).sum()
    if "value" in outputs:
        losses["v"] = (((outputs["value"] - targets["value"]) ** 2)
                       * omasks).sum() / 2
    if "return" in outputs:
        losses["r"] = (_huber(outputs["return"] - targets["return"])
                       * omasks).sum()

    entropy = _masked_entropy(outputs["policy"]) * tmasks.sum(-1)  # (B,T,P)
    losses["ent"] = entropy.sum()

    base_loss = losses["p"] + losses.get("v", 0.0) + losses.get("r", 0.0)
    decay_weight = 1.0 - batch["progress"] * (
        1.0 - cfg.entropy_regularization_decay)
    entropy_loss = (entropy * decay_weight).sum() * -cfg.entropy_regularization
    losses["total"] = base_loss + entropy_loss
    return losses, dcnt


def _log_selected(log_policy, actions, emasks):
    return torch.take_along_dim(log_policy, actions.long(), dim=-1) * emasks


def compute_loss(apply_fn: Callable, batch, hidden, cfg: LossConfig,
                 target_apply_fn=None):
    """Full forward + target computation + loss composition.

    With ``cfg.update_algorithm == "impact"`` and ``target_apply_fn``
    given, a second (gradient-free) forward through the target network
    provides the correction policy and the bootstrap values."""
    impact = cfg.update_algorithm == "impact" and target_apply_fn is not None
    outputs = forward_prediction(apply_fn, hidden, batch, cfg)
    tgt_outputs = None
    if impact:
        with torch.no_grad():
            tgt_outputs = forward_prediction(
                target_apply_fn, hidden, batch, cfg)
    if cfg.burn_in_steps > 0:
        b = cfg.burn_in_steps
        batch = {k: v[:, b:] if v.shape[1] > 1 else v
                 for k, v in batch.items() if k != "observation"}
        outputs = {k: v[:, b:] for k, v in outputs.items()}
        if tgt_outputs is not None:
            tgt_outputs = {k: v[:, b:] for k, v in tgt_outputs.items()}

    actions = batch["action"]
    emasks = batch["episode_mask"]
    omasks = batch["observation_mask"]
    tmasks = batch["turn_mask"]
    value_target_masks, return_target_masks = omasks, omasks

    log_selected_b = (
        torch.log(batch["selected_prob"].clamp(1e-16, 1.0)) * emasks)
    log_policy = F.log_softmax(outputs["policy"], dim=-1)
    log_selected_t = _log_selected(log_policy, actions, emasks)
    log_selected_g = None
    if impact:
        log_selected_g = _log_selected(
            F.log_softmax(tgt_outputs["policy"], dim=-1), actions, emasks)

    # importance-sampling ratios (behavior -> correction policy),
    # clipped at rho_clip/c_clip: the live learner policy, or (IMPACT)
    # the target network's
    if impact:
        log_rhos = log_selected_g - log_selected_b
    else:
        log_rhos = log_selected_t.detach() - log_selected_b
    # +/-20 keeps exp finite on a badly stale batch; the ratios are
    # clipped to rho_clip/c_clip right below
    rhos = torch.exp(log_rhos.clamp(-20.0, 20.0))
    clipped_rhos = rhos.clamp(0.0, cfg.rho_clip)
    cs = rhos.clamp(0.0, cfg.c_clip)

    if impact:
        # IMPACT bootstraps targets from the TARGET network's heads
        outputs_nograd = dict(tgt_outputs)
    else:
        outputs_nograd = {k: v.detach() for k, v in outputs.items()}

    if "value" in outputs_nograd:
        values_nograd = outputs_nograd["value"]
        if cfg.turn_based_training and values_nograd.shape[2] == 2:
            # two-player zero-sum: average own value with the negated
            # opponent view wherever either observed
            values_opp = -torch.flip(values_nograd, dims=(2,))
            omasks_opp = torch.flip(omasks, dims=(2,))
            values_nograd = (
                values_nograd * omasks + values_opp * omasks_opp
            ) / (omasks + omasks_opp + 1e-8)
            value_target_masks = (omasks + omasks_opp).clamp(0.0, 1.0)
        # beyond the terminal step the target is the final outcome
        outputs_nograd["value"] = (
            values_nograd * emasks + batch["outcome"] * (1 - emasks))

    targets, advantages = {}, {}
    value_args = (
        outputs_nograd.get("value", None), batch["outcome"], None,
        cfg.lambda_, 1.0, clipped_rhos, cs, value_target_masks)
    return_args = (
        outputs_nograd.get("return", None), batch["return"],
        batch["reward"], cfg.lambda_, cfg.gamma, clipped_rhos, cs,
        return_target_masks)

    targets["value"], advantages["value"] = compute_target(
        cfg.value_target, *value_args)
    targets["return"], advantages["return"] = compute_target(
        cfg.value_target, *return_args)
    if cfg.policy_target != cfg.value_target:
        _, advantages["value"] = compute_target(cfg.policy_target,
                                                *value_args)
        _, advantages["return"] = compute_target(cfg.policy_target,
                                                 *return_args)

    denom = tmasks.sum() + 1e-8
    if impact:
        # surrogate objective: maximize min(r*A, clip(r, 1-eps, 1+eps)*A)
        # of the current/target ratio r
        adv = sum(advantages.values())
        ratio = torch.exp(
            (log_selected_t - log_selected_g).clamp(-20.0, 20.0))
        eps = cfg.surrogate_clip
        surrogate = torch.minimum(
            ratio * adv, ratio.clamp(1.0 - eps, 1.0 + eps) * adv)
        clip_frac = (((ratio - 1.0).abs() > eps) * tmasks).sum() / denom
        losses, dcnt = compose_losses(
            outputs, log_selected_t, None, targets, batch, cfg,
            policy_loss=-surrogate)
    else:
        total_advantages = clipped_rhos * sum(advantages.values())
        # how often the rho clip engaged: the off-policy pressure signal
        clip_frac = ((rhos > cfg.rho_clip) * tmasks).sum() / denom
        losses, dcnt = compose_losses(
            outputs, log_selected_t, total_advantages, targets, batch,
            cfg)
    losses["clip_frac"] = clip_frac
    return losses, dcnt
