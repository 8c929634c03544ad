"""Fixture: the snapshot idioms — clone where the name is bound, or
bind after the update."""

import copy

import torch


def snapshot_before_step(model, batch):
    optimizer = torch.optim.Adam(model.parameters())
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    model(batch).sum().backward()
    optimizer.step()
    return weights  # the pre-step copy, as intended


def serve_each_step(model, optimizer, batches, conn):
    for batch in batches:
        optimizer.step()
        conn.send(copy.deepcopy(model.state_dict()))  # bound after


def norm_before_step(model, optimizer):
    params = list(model.parameters())
    norm = sum(p.norm() for p in params)  # read BEFORE the update
    optimizer.step()
    return norm
