"""Fixture: suppressed divergent-control (a rescue path that is
documented to run on every rank despite the guard's look)."""

import torch.distributed as dist


def rescue(state, peers_know_to_enter):
    if dist.get_rank() == 0 and peers_know_to_enter:
        # torchlint: disable=divergent-control -- peers mirror this branch via the out-of-band flag above
        dist.broadcast(state, src=0)
    return state
