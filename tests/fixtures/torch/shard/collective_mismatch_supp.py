"""Fixture: suppressed collective-mismatch (an intentional sum over a
replicated axis, e.g. to materialize an axis-size factor)."""

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

AXES = ("dp", "tp")


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=AXES)


def grad_sum(mesh, g):
    # torchlint: disable=collective-mismatch -- deliberate: the sum of a replicated value IS the tp size
    return dist.all_reduce(g, group=mesh.get_group("tp"))


def make_step(mesh):
    return local_map(grad_sum, out_placements=None,
                     in_placements=(None, (Shard(0), Replicate())))
