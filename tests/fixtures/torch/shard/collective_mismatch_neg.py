"""Fixture: collectives over exactly the axes their local_map shards
(including through an interprocedural hop), each with its group."""

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard
from torch.distributed.tensor.experimental import local_map

AXES = ("dp", "tp")


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=AXES)


def grad_sum(mesh, g):
    return dist.all_reduce(g, group=mesh.get_group(AXES.index("dp")))


def step_body(mesh, g):
    return grad_sum(mesh, g)  # reached from the local_map entry below


def make_step(mesh):
    return local_map(step_body, out_placements=None,
                     in_placements=(None, (Shard(0), Shard(1))))


def make_opaque_step(mesh, placements):
    # in_placements unresolvable: the body's collectives are not judged
    return local_map(grad_sum, out_placements=None,
                     in_placements=placements)


class Reducer:
    def __init__(self, mesh):
        self.dp_group = mesh.get_group("dp")

    def reduce(self, vec):
        dist.all_reduce(vec, group=self.dp_group)
        return vec
