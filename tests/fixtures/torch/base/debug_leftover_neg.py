"""Fixture: ordinary host-side printing is not a debug leftover, and
switching anomaly detection off is not either."""

import torch


@torch.compile
def step(x):
    return x * 2


def report(epoch, loss):
    torch.autograd.set_detect_anomaly(False)
    print(f"epoch {epoch}: loss = {loss:.3f}")  # host logging is fine
