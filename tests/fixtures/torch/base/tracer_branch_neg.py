"""Fixture: static (shape/dtype/None) guards and device-side selection
inside compiled code — all legal."""

import torch


@torch.compile
def shape_guard(x):
    if x.ndim >= 2 and x.shape[0] > 1:  # shapes are static
        return torch.sum(x, dim=0)
    return x


@torch.compile
def none_guard(x, hidden=None):
    if hidden is None:  # identity guards are static
        return x
    return x + hidden


def eager_branch(x, mode):
    if x.sum() > 0:  # eager code, not compiled or captured
        return x * 2
    return x


@torch.compile
def device_select(x):
    return torch.where(x > 0, x, -x)  # value-dependent, but on the card
