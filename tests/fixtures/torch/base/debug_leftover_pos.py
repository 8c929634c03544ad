"""Fixture: debug calls left in the code."""

import torch


@torch.compile
def step(x):
    torch.autograd.set_detect_anomaly(True)
    return x * 2


def inspect(x):
    breakpoint()
    return x
