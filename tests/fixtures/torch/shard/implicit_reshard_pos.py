"""Fixture: feeding a local_map step a tensor placed differently from
its declared in_placements — a redistribution copy on every call."""

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
                     in_placements=(dp, rep), redistribute_inputs=True)
    params = distribute_tensor(params, mesh, rep)  # the step wants dp
    return step(params, batch)


def replicated():
    """The struct-of-shardings builder of the JAX fixture has no
    counterpart here; single-layout builders do, and their return
    summaries carry the placements to the call sites below."""
    return (Replicate(), Replicate())


def rows():
    # builder summaries: the layouts come back through the calls
    return (Shard(0), Replicate())


def serve_step(mesh, params, obs):
    rep = replicated()
    fwd = local_map(lambda p, o: (p * o).sum(), out_placements=None,
                    in_placements=(rep, rows()),
                    redistribute_inputs=True)
    obs = distribute_tensor(obs, mesh, replicated())  # wants rows()
    return fwd(params, obs)
