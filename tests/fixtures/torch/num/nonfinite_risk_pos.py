"""POS: log of an unclamped probability in loss code."""
import torch


def policy_loss(p, adv):
    # log(0) is -inf: one zero probability and the loss is nonfinite,
    # which poisons every parameter in one step
    return -(torch.log(p) * adv).sum()


def mean_loss(x, tmasks):
    return (x * tmasks).sum() / tmasks.sum()  # torch-only: empty mask


def ratio(logr):
    return logr.exp()  # torch-only: the method spelling, unclamped
