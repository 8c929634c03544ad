"""Fixture: draws off the global stream, and a per-iteration reseed."""

import torch


def double_draw(seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(3, generator=g)
    b = torch.randn(3)  # the global stream: the seed does not fix it
    return a + b


def loop_consume(seed, steps):
    g = torch.Generator()
    out = []
    for _ in range(steps):
        out.append(torch.rand(3, generator=g.manual_seed(seed)))
    return out


def param_consume(generator):
    noise = torch.randn(3, generator=generator)
    scale = torch.rand(())  # the generator parameter left out
    return noise * scale
