"""Fixture: per-step device->host syncs in an epoch loop — the pattern
the learner's metric aggregation must avoid."""

import numpy as np
import torch


def make_step():
    return torch.compile(lambda p, b: (p, {"loss": b.sum()}))


def epoch_float_sync(params, batches):
    step = make_step()
    metrics = []
    for batch in batches:
        params, m = step(params, batch)
        metrics.append(m)
    # one blocking copy per step's metrics dict:
    return params, sum(float(m["loss"]) for m in metrics)


def epoch_item_sync(params, batches):
    step = make_step()
    total = 0.0
    for batch in batches:
        params, m = step(params, batch)
        total += m["loss"].item()  # blocking sync inside the hot loop
    return params, total


def epoch_cpu_sync(params, batches):
    step = make_step()
    out = []
    for batch in batches:
        params, m = step(params, batch)
        out.append(m["loss"].cpu())  # copy per iteration
    return params, out


class Trainer:
    def __init__(self, device):
        self.weight = torch.zeros(4, device=device)

    def epoch(self, batches):
        acc = []
        for batch in batches:
            loss = (self.weight * batch).sum()
            acc.append(np.asarray(loss))  # sync per step
        return acc


def wait_each_step(batches):
    for batch in batches:
        torch.cuda.synchronize()  # torch-only: an explicit wait per step
