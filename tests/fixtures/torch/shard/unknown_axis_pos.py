"""Fixture: axis names that the constructed mesh never declares."""

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# the port's mesh names its axes once, in one tuple

AXES = ("dp", "tp")


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=AXES)


def batch_group(mesh):
    # "data" is not an axis of the mesh built above
    return mesh.get_group("data")


def loss_sum(mesh, x):
    # "model" is not a mesh axis either
    return dist.all_reduce(x, group=mesh.get_group(AXES.index("model")))
