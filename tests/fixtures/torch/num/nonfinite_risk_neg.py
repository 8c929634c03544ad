"""NEG: every producer is clamped or its denominator carries an eps."""
import torch


def policy_loss(p, adv):
    # clamped away from zero before the log, as the port's losses
    # clamp selected_prob
    return -(torch.log(p.clamp(1e-16, 1.0)) * adv).sum()


def mean_loss(x, tmasks):
    return (x * tmasks).sum() / (tmasks.sum() + 1e-8)


def ratio(logr):
    return logr.clamp(-20.0, 20.0).exp()


def norms(grads):
    squares = torch.stack([g.norm() ** 2 for g in grads])
    return squares.sqrt()  # a sum of squares is never negative
