"""Fixture: suppressed tensor branch (a graph break accepted in a debug
harness)."""

import torch


@torch.compile
def debug_clip(x):
    # torchlint: disable=tracer-branch -- debug harness; the graph break is accepted
    if x > 10:
        return x * 0
    return x
