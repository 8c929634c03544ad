"""Fixture: correct generator discipline — seed once, or fold the loop
index into the seed, and pass the generator to every draw."""

import torch


def seeded_draws(seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(3, generator=g)
    b = torch.randn(3, generator=g)
    return a + b


def loop_fold(seed, steps):
    g = torch.Generator()
    out = []
    for i in range(steps):
        g.manual_seed(seed * 1_000_003 + i)  # a fresh seed per step
        out.append(torch.rand(3, generator=g))
    return out


def seed_once(seed, steps):
    g = torch.Generator()
    g.manual_seed(seed)
    return [torch.randint(0, 9, (3,), generator=g) for _ in range(steps)]


def host_random(rng, n):
    import numpy as np
    return np.random.default_rng(rng).normal(size=n)  # numpy: not torch
