"""Fixture: suppressed inplace-alias (the live view is the point)."""

import torch


def watch_training(model, batch):
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
    live = model.state_dict()
    model(batch).sum().backward()
    optimizer.step()
    # torchlint: disable=inplace-alias -- a live view of the weights, read after the step on purpose
    return live
