"""Fixture: suppressed anomaly detection (a sanctioned debug hook)."""

import torch


def step(model, batch):
    # torchlint: disable=debug-leftover -- NaN tripwire, enabled by a debug config flag
    with torch.autograd.detect_anomaly():
        return model(batch).sum().backward()
