"""Fixture: intentional per-iteration sync, suppressed with a reason."""

import torch


def make_step():
    return torch.compile(lambda p, b: (p, b.sum()))


def epoch_with_early_stop(params, batches, tol):
    step = make_step()
    for batch in batches:
        params, loss = step(params, batch)
        # torchlint: disable=host-sync -- early-stop check needs the value each step
        if float(loss) < tol:
            break
    return params
