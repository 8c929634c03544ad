"""Fixture: device metrics accumulated on the card, copied ONCE per
epoch — the fixed learner pattern."""

import numpy as np
import torch


def make_step():
    return torch.compile(lambda p, b: (p, {"loss": b.sum()}))


def epoch(params, batches):
    step = make_step()
    metrics = []
    for batch in batches:
        params, m = step(params, batch)
        metrics.append(m["loss"])  # device values stay on the card
    losses = torch.stack(metrics).cpu().numpy()  # ONE copy per epoch
    total = sum(float(x) for x in losses)
    return params, total


def host_loop(rows):
    # float()/np.asarray on plain host data in loops is fine, and so
    # is a tensor built on the CPU
    cpu = [torch.zeros(3) for _ in rows]
    return [float(np.asarray(r).mean()) for r in rows] + [
        t.sum().item() for t in cpu]
