"""Fixture: the safe control-word idiom — a rank-dependent VALUE flows
into a collective every rank runs unconditionally, and control flow
branches only on the synchronized result."""

import torch
import torch.distributed as dist


def sync_code(code):
    word = torch.tensor([int(code)], dtype=torch.int32)
    dist.broadcast(word, src=0)
    return int(word[0])


def epoch_control(update_flag):
    code = 0
    if dist.get_rank() == 0 and update_flag:
        code = 1  # a divergent value is fine: the collective still runs
    code = sync_code(code)
    if code == 1:  # branching on the synchronized result is fine
        return "epoch-end"
    return "step"


def primary_only_io(record, rank):
    if rank == 0:
        print(record)  # host-side work under a divergent branch is fine
    return record
