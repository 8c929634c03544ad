"""Fixture: collectives whose execution depends on dist.get_rank() —
the multi-rank hang shapes (branch, early exit, interprocedural
divergence through a helper's return value)."""

import torch
import torch.distributed as dist


def is_primary():
    return dist.get_rank() == 0


def checkpoint_sync(state):
    if is_primary():  # peers never enter the broadcast: a hang
        dist.broadcast(state, src=0)
    return state


def report_metrics(metrics):
    if dist.get_rank() != 0:
        return None
    # peers already returned: rank 0 waits here forever
    return dist.all_reduce(metrics)


def orelse_exit(state):
    primary = dist.get_rank() == 0
    if primary:
        pass
    else:
        return state
    # equivalent early-exit shape, exit in the ELSE branch: only
    # rank 0 reaches the broadcast
    return dist.broadcast(state, src=0)


class Learner:
    def __init__(self):
        self.primary = dist.get_rank() == 0

    def save(self, weights):
        if self.primary:
            return weights.full_tensor()  # torch-only: a DTensor gather
        return None
