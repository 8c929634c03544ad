"""Fixture: each tensor dim on at most one mesh dim, one entry per axis."""

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=("dp", "tp"))


def batch_placements():
    return (Shard(0), Replicate())


def two_dims():
    return (Shard(0), Shard(1))


def replicated():
    return (Replicate(),) * 2
