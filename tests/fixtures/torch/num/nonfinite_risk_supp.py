"""SUPP: the domain is guaranteed upstream, suppressed with a reason."""
import torch


def policy_loss(p, adv):
    # torchlint: disable=nonfinite-risk -- p exits a floored softmax and cannot be exactly zero
    return -(torch.log(p) * adv).sum()
