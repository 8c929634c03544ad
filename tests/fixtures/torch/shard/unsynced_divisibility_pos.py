"""Fixture: a dim placed onto dp/sp with no static divisibility guard
anywhere in the function."""

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=("dp", "sp"))


def shard_batch(mesh, batch):
    placements = (Shard(0), Shard(1))
    # nothing proves batch.shape divides by the dp/sp axis sizes
    return distribute_tensor(batch, mesh, placements)


def split_time(x, sp):
    return x.shape[1] // sp  # torch-only: the hand-made time split
