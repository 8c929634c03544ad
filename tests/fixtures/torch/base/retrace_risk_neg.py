"""Fixture: compile once, capture once, replay inside the loop."""

import torch


def scale(x, factors):
    return x * sum(factors)


_scale_compiled = torch.compile(scale)


def apply(xs):
    out = []
    for x in xs:
        out.append(_scale_compiled(x, (1, 2, 3)))
    return out


def replay(x, steps):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * 2
    for _ in range(steps):
        graph.replay()
    return y
