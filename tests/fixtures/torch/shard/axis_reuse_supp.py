"""Fixture: suppressed axis-reuse."""

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=("dp", "tp"))


def nested_split():
    # torchlint: disable=axis-reuse -- DTensor's nested split is wanted here, and this layout never reaches Layout.spec
    return (Shard(0), Shard(0))
