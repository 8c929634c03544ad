"""Value-target / advantage estimators as reverse recurrences over time.

The counterpart of ``handyrl_tpu.ops.targets``: Monte Carlo, TD(lambda),
UPGO and V-Trace (IMPALA, arXiv:1802.01561), plus IMPACT's dispatch
entry.  The JAX package runs each backward recursion as one reverse
``lax.scan``; here it is a Python loop over time on tensors, which on
the card launches a few elementwise kernels per step.

Array layout: ``(B, T, P, 1)`` (batch, time, player, channel), time on
dim 1.  The inputs are detached values (the losses call these on
``no_grad`` outputs), so nothing here needs a backward.
"""

import torch


def _reverse_scan(step_fn, init, xs):
    """Run ``step_fn(carry, x_t)`` backward over dim 1 of every tensor
    in ``xs`` and stack the carries in forward time order, appending
    ``init`` as the final step (the ``lax.scan(..., reverse=True)``
    output of the JAX twin, concatenated with ``init``)."""
    steps = xs[0].shape[1]
    carry, ys = init, [None] * steps
    for t in range(steps - 1, -1, -1):
        carry = step_fn(carry, [x[:, t] for x in xs])
        ys[t] = carry
    return torch.stack(ys + [init], dim=1)


def monte_carlo(values, returns):
    """Targets are the observed returns themselves."""
    return returns, returns - values


def temporal_difference(values, returns, rewards, lambda_, gamma):
    """TD(lambda) targets via backward recursion:

      G_t = r_t + gamma * ((1 - lambda_{t+1}) * V_{t+1} + lambda_{t+1} * G_{t+1})

    with ``G_{T-1} = returns_{T-1}``.
    """
    rewards = torch.zeros_like(values) if rewards is None else rewards

    def step(g_next, x):
        v_next, r, lam = x
        return r + gamma * ((1.0 - lam) * v_next + lam * g_next)

    targets = _reverse_scan(
        step, returns[:, -1],
        (values[:, 1:], rewards[:, :-1], lambda_[:, 1:]))
    return targets, targets - values


def upgo(values, returns, rewards, lambda_, gamma):
    """UPGO targets: bootstrap through the better of the next value and
    the lambda-blended continuation."""
    rewards = torch.zeros_like(values) if rewards is None else rewards

    def step(g_next, x):
        v_next, r, lam = x
        return r + gamma * torch.maximum(
            v_next, (1.0 - lam) * v_next + lam * g_next)

    targets = _reverse_scan(
        step, returns[:, -1],
        (values[:, 1:], rewards[:, :-1], lambda_[:, 1:]))
    return targets, targets - values


def vtrace(values, returns, rewards, lambda_, gamma, rhos, cs):
    """V-Trace targets and advantages (IMPALA, arXiv:1802.01561).

    ``rhos``/``cs`` are the clipped importance ratios; the correction
    term ``vs - V`` accumulates backward scaled by ``gamma * lambda * c``.
    """
    rewards = torch.zeros_like(values) if rewards is None else rewards
    values_next = torch.cat([values[:, 1:], returns[:, -1:]], dim=1)
    deltas = rhos * (rewards + gamma * values_next - values)

    def step(acc, x):
        delta, lam, c = x
        return delta + gamma * lam * c * acc

    vs_minus_v = _reverse_scan(
        step, deltas[:, -1],
        (deltas[:, :-1], lambda_[:, 1:], cs[:, :-1]))
    vs = vs_minus_v + values
    vs_next = torch.cat([vs[:, 1:], returns[:, -1:]], dim=1)
    advantages = rewards + gamma * vs_next - values
    return vs, advantages


def impact(values, returns, rewards, lambda_, gamma, rhos, cs):
    """IMPACT targets (arXiv:1912.00167): the V-Trace recursion driven
    by target-network importance ratios (the losses choose which policy
    produced ``rhos``/``cs``)."""
    return vtrace(values, returns, rewards, lambda_, gamma, rhos, cs)


def compute_target(algorithm, values, returns, rewards, lmb, gamma,
                   rhos, cs, masks):
    """Dispatch to a target estimator, blending lambda with the
    observation mask (unobserved steps pass through with lambda = 1)."""
    if values is None:
        # no baseline head: fall back to Monte-Carlo returns
        return returns, returns

    if algorithm == "MC":
        return monte_carlo(values, returns)

    lambda_ = lmb + (1.0 - lmb) * (1.0 - masks)

    if algorithm == "TD":
        return temporal_difference(values, returns, rewards, lambda_, gamma)
    if algorithm == "UPGO":
        return upgo(values, returns, rewards, lambda_, gamma)
    if algorithm == "VTRACE":
        return vtrace(values, returns, rewards, lambda_, gamma, rhos, cs)
    if algorithm == "IMPACT":
        return impact(values, returns, rewards, lambda_, gamma, rhos, cs)
    raise ValueError(f"unknown target algorithm {algorithm!r}")
