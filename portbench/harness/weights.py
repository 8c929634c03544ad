"""Seeded initial weights, made on the device in one draw.

Every convolution and linear weight, and every bias of one, is uniform
in ``+-1/sqrt(fan_in)`` (PyTorch's default bound); GroupNorm starts at
scale 1 and shift 0.  All random numbers come from ONE ``torch.rand``
call on a generator of the device, seeded by the run's seed, in
float32, the type the trainer keeps its parameters in.  The benchmark
hands the same tensors to the program and, as a host copy, to the
reference.
"""

import math

import torch
from torch import nn


def init_state(module, seed, device):
    """``{name: float32 tensor on device}`` for ``module``'s
    parameters, in ``state_dict`` names."""
    plan = []                                   # (name, shape, bound)
    for prefix, sub in module.named_modules():
        stem = f"{prefix}." if prefix else ""
        if isinstance(sub, nn.GroupNorm):
            plan.append((stem + "weight", sub.weight.shape, None))
            plan.append((stem + "bias", sub.bias.shape, 0.0))
        elif isinstance(sub, (nn.Conv2d, nn.Linear)):
            fan_in = sub.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            plan.append((stem + "weight", sub.weight.shape, bound))
            if sub.bias is not None:
                plan.append((stem + "bias", sub.bias.shape, bound))
    names = {n for n, _ in module.named_parameters()}
    if names != {n for n, _, _ in plan}:
        raise ValueError(f"unplanned parameters: "
                         f"{sorted(names ^ {n for n, _, _ in plan})}")
    drawn = [p for p in plan if p[2]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    u = torch.rand(total, generator=gen, device=device)
    state, lo = {}, 0
    for name, shape, bound in plan:
        if bound is None:
            state[name] = torch.ones(shape, device=device)
        elif bound == 0.0:
            state[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            state[name] = ((u[lo:lo + n] * 2.0 - 1.0) * bound).view(shape)
            lo += n
    return state
