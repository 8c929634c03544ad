"""Fixture: the placement rides behind an explicit divisibility check
(and symbolic placements stay quiet)."""

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=("dp", "sp"))


def shard_batch(mesh, batch, sp_size):
    placements = (Shard(0), Shard(1))
    if batch.shape[1] % sp_size == 0:
        return distribute_tensor(batch, mesh, placements)
    return batch


def shard_opaque(mesh, batch, placements):
    # the placements are the caller's problem: unresolvable, quiet
    return distribute_tensor(batch, mesh, placements)


def split_time(x, sp):
    # the `if dim % n: raise` spelling counts as a guard too
    if x.shape[1] % sp:
        raise ValueError("the window must divide sp")
    return x.shape[1] // sp
