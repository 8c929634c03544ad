"""Fixture: compile and capture patterns that redo work every call."""

import torch


def inline_compile(xs):
    out = []
    for x in xs:
        # fresh wrapper + fresh cache per iteration, compiled inline
        out.append(torch.compile(lambda a: a + 1)(x))
    return out


def scale(x, factors):
    return x * sum(factors)


# (no counterpart of the JAX fixture's non-hashable static argument
# and non-literal static options: torch.compile has no static argnums;
# a graph built per iteration is the torch-only case instead)


def capture_per_step(x, steps):
    for _ in range(steps):
        graph = torch.cuda.CUDAGraph()  # torch-only: a capture per step
        with torch.cuda.graph(graph):
            y = x * 2
    return y
