"""Fixture: call-site placements agree with the step's in_placements
(or are unknown, which stays quiet)."""

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map


def make_mesh():
    return init_device_mesh("cuda", (2, 1), mesh_dim_names=("dp", "tp"))


def train_step(mesh, params, batch):
    rep = (Replicate(), Replicate())
    dp = (Shard(0), Replicate())
    step = local_map(lambda p, b: (p, b.sum()), out_placements=None,
                     in_placements=(rep, dp))
    params = distribute_tensor(params, mesh, rep)  # matches [0]
    return step(params, batch)                    # batch unknown: quiet


def serve_step(mesh, params, obs, layout):
    fwd = local_map(lambda p, o: (p * o).sum(), out_placements=None,
                    in_placements=(None, layout))
    obs = obs.redistribute(mesh, layout)  # symbolic: quiet
    return fwd(params, obs)
