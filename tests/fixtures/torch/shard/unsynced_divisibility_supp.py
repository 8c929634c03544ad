"""Fixture: suppressed unsynced-divisibility (divisibility enforced by
the config validator at start-up, not at the placement site)."""

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=("dp", "sp"))


def shard_batch(mesh, batch):
    placements = (Shard(0), Shard(1))
    # torchlint: disable=unsynced-divisibility -- batch geometry validated against the mesh in config load
    return distribute_tensor(batch, mesh, placements)
