"""Fixture: suppressed unknown-axis (the group belongs to an external
mesh the analyzer cannot see)."""

from torch.distributed.device_mesh import init_device_mesh

AXES = ("dp", "tp")


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=AXES)


def batch_group(mesh):
    # torchlint: disable=unknown-axis -- the caller passes its externally built mesh
    return mesh.get_group("data")
