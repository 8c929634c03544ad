"""Fixture: a reduction over an axis the enclosing local_map never
shards, and a collective with no group (WORLD) under a 2-axis mesh."""

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

AXES = ("dp", "tp")


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=AXES)


def grad_sum(mesh, g):
    # the local_map below only shards dp: summing over tp multiplies
    # replicated values by the tp axis size
    return dist.all_reduce(g, group=mesh.get_group("tp"))


def make_step(mesh):
    return local_map(grad_sum, out_placements=None,
                     in_placements=(None, (Shard(0), Replicate())))


def stray_sum(x):
    # no group=: WORLD, every rank of both axes
    return dist.all_reduce(x)
