"""Fixture: suppressed implicit-reshard (a one-time re-layout at
start-up, not on the hot path)."""

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=("dp", "tp"))


def restore_step(mesh, params, batch):
    rep = (Replicate(), Replicate())
    dp = (Shard(0), Replicate())
    step = local_map(lambda p, b: (p, b.sum()), out_placements=None,
                     in_placements=(dp, rep), redistribute_inputs=True)
    params = distribute_tensor(params, mesh, rep)
    # torchlint: disable=implicit-reshard -- one-time checkpoint restore; the copy is off the hot path
    return step(params, batch)
