"""Fixture: intentional reseed, suppressed with a reason."""

import torch


def antithetic(seed, steps):
    g = torch.Generator()
    out = []
    for _ in range(steps):
        # torchlint: disable=rng-reseed -- every step wants the identical draw
        g.manual_seed(seed)
        out.append(torch.rand(3, generator=g))
    return out
