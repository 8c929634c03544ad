"""Fixture: Python control flow on tensor values inside compiled or
captured code."""

import torch


@torch.compile
def relu_branch(x):
    if x > 0:  # a tensor in a Python if
        return x
    return -x


def clip_loop(y):
    while y.sum() > 1.0:  # a tensor in a Python while, via the call graph
        y = y * 0.5
    return y


def step(x):
    return clip_loop(x * 2)


update = torch.compile(step)


@torch.compile
def pick(x, flag):
    return x if flag else -x  # a traced value in a conditional expression


def capture(graph, x):
    with torch.cuda.graph(graph):
        if x.max() > 1:  # torch-only: a branch baked into the capture
            x = x / 2
    return x
