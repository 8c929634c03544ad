"""Fixture: a placements tuple that splits one dim twice, or misfits."""

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=("dp", "tp"))


def bad_placements():
    return (Shard(0), Shard(0))


def wrong_length():
    return (Shard(0), Replicate(), Replicate())
