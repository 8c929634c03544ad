"""Fixture: reading weights aliased before an in-place update."""

import torch


def make_optimizer(model):
    return torch.optim.Adam(model.parameters())


def use_after_step(model, batch):
    optimizer = make_optimizer(model)
    weights = model.state_dict()  # no clone: the live parameters
    model(batch).sum().backward(), optimizer.step()
    norm = sum(w.norm() for w in weights.values())  # updated values
    return norm


def serve_in_loop(model, optimizer, batches, conn):
    weights = model.state_dict()
    for batch in batches:
        conn.send(weights)  # from the second iteration: updated weights
        optimizer.step()
    return batch
