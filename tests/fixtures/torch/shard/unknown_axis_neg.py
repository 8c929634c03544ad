"""Fixture: every axis name is one the mesh declares (including through
the module-level AXES constant)."""

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

AXES = ("dp", "tp")


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=AXES)


def axis_size(mesh, name):
    return mesh.size(mesh.mesh_dim_names.index(name))


def groups(mesh):
    return (mesh.get_group("dp"), mesh["tp"], axis_size(mesh, "tp"),
            AXES.index("dp"))


def grad_sum(mesh, g):
    return dist.all_reduce(g, group=mesh.get_group("dp"))
