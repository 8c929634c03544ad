"""Fixture: suppressed inline compile (one-off cold path)."""

import torch


def relayout_once(buffers):
    # torchlint: disable=retrace-risk -- runs once per ring growth; shapes differ each time anyway
    return torch.compile(lambda t: t.contiguous())(buffers)
