"""fsdp together with tp: four gloo ranks at dp2 x tp2 with ``fsdp``.

GeeseNet 128 x 2 is the net ``__graft_entry__.py`` trains with both
rules engaged: its stem kernel shards its output features over tp, and
each block kernel shards on both axes (tp on its output features, dp on
its input features).  One spawn of four CPU ranks runs two sharded
steps; they must match

  * the port's one-process step on the whole batch, and
  * the JAX package's ``make_sharded_update_step`` on a 2 x 2 virtual
    mesh, from the same converted weights,

at JAX's own tolerance (params rtol 2e-4 / atol 2e-5, ``total`` rel
1e-4; test_parallel.py:228-235), with ``grad_norm`` equal (the gradients
are summed over dp, never averaged).  Every leaf's placements, before
and after the steps and on its Adam moments, are the JAX package's
``param_sharding`` spec for the 2-D mesh; ``full_state_dict`` gathers
over both axes.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from handyrl_tpu.parallel import mesh as jmesh
from handyrl_tpu_torch.connection import find_free_port
from handyrl_tpu_torch.models.convert import (
    _to_flax_shape,
    flax_layout,
    random_flax_params,
    torch_axis,
)
from test_torch_parallel import (
    GEESE,
    _batches,
    _close,
    _flat,
    _geese,
    _jax_sharded,
    _one_process,
    _padded,
)
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = {"dp": 2, "tp": 2, "fsdp": True}
NET = {"filters": 128, "blocks": 2}
SEED = 60
TOTAL_REL = 1e-4
WORLD = 4

CHILD = textwrap.dedent("""
    import pickle, sys
    import torch
    from torch.distributed.tensor import DTensor

    rank, world, port, run = map(str, sys.argv[1:5])
    rank, world, port = int(rank), int(world), int(port)
    torch.set_num_threads(1)
    with open(run + "/in.pkl", "rb") as f:
        job = pickle.load(f)
    from handyrl_tpu_torch.models.convert import from_flax, state_to_flax
    from handyrl_tpu_torch.models.geese_net import GeeseNet
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.parallel import multihost as mh
    from handyrl_tpu_torch.parallel import (
        MeshSpec, make_mesh, make_sharded_update_step)
    from handyrl_tpu_torch.parallel.mesh import AXES
    from handyrl_tpu_torch.parallel.update import full_state_dict

    mh.init_distributed({"coordinator_address": "127.0.0.1:%d" % port,
                         "num_processes": world, "process_id": rank},
                        device="cpu")

    def spec(t):
        out = [None] * t.dim()
        if isinstance(t, DTensor):
            for name, p in zip(AXES, t.placements):
                if p.is_shard():
                    out[p.dim] = name
        return tuple(out)

    mesh_spec = MeshSpec.from_config(job["mesh"])
    mesh = make_mesh(mesh_spec, device_type="cpu")
    net = GeeseNet(**job["net"])
    net.load_state_dict(from_flax(job["params"], net))
    step = make_sharded_update_step(
        net, LossConfig.from_config(job["cfg"]), mesh, job["lr"],
        "float32", fsdp=True)
    rec = {"before": {n: spec(p) for n, p in net.named_parameters()},
           "metrics": []}
    coord = mesh.get_local_rank(0)
    for batch in job["batches"]:
        rows = batch["action"].shape[0] // mesh_spec.dp
        local = {k: v[coord * rows:(coord + 1) * rows]
                 for k, v in batch.items()}
        rec["metrics"].append({k: float(v) for k, v in step(local).items()})
    rec["after"] = {n: spec(p) for n, p in net.named_parameters()}
    rec["moments"] = {n: (spec(step.optimizer.state[p]["exp_avg"]),
                          spec(step.optimizer.state[p]["exp_avg_sq"]))
                      for n, p in net.named_parameters()}
    rec["local"] = {n: tuple(p.to_local().shape)
                    for n, p in net.named_parameters()
                    if isinstance(p, DTensor)}
    rec["params"] = state_to_flax(full_state_dict(net), net)
    rec["opt"] = {i: {k: tuple(v.shape) for k, v in s.items()}
                  for i, s in step.optimizer_state()["state"].items()}
    with open(run + "/out%d.pkl" % rank, "wb") as f:
        pickle.dump(rec, f)
    mh.shutdown()
    print("CHILD %d DONE" % rank)
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of four gloo ranks (a 150 s deadline)."""
    run = tmp_path_factory.mktemp("four_ranks")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batches = _batches()
    finally:
        torch.set_num_threads(threads)
    from test_torch_parallel import LR

    job = {"lr": LR, "mesh": MESH, "net": NET, "cfg": GEESE,
           "params": _geese(NET, SEED)[2], "batches": batches}
    with open(run / "in.pkl", "wb") as f:
        pickle.dump(job, f)
    port = find_free_port()
    env = dict(CHILD_ENV, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(rank), str(WORLD), str(port),
         str(run)], cwd=run, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(WORLD)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=150)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"CHILD {rank} DONE" in out, \
            out[-3000:]
    recs = []
    for rank in range(WORLD):
        with open(run / f"out{rank}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    return recs, batches


def test_four_ranks_match_one_process_and_jax(four_ranks):
    recs, batches = four_ranks
    one = _one_process(NET, GEESE, batches, SEED)
    ref = _jax_sharded(MESH, NET, GEESE, batches, SEED)
    for rec in recs:
        for k in range(len(batches)):
            assert rec["metrics"][k]["total"] == pytest.approx(
                one["metrics"][k]["total"], rel=TOTAL_REL)
            assert rec["metrics"][k]["total"] == pytest.approx(
                ref["totals"][k], rel=TOTAL_REL)
            for key in ("dcnt", "grad_norm"):
                assert rec["metrics"][k][key] == pytest.approx(
                    one["metrics"][k][key], rel=1e-4), (k, key)
        _close(rec["params"], one["params"], "dp2 x tp2 fsdp vs one process")
        _close(rec["params"], ref["params"], "dp2 x tp2 fsdp vs JAX")


def test_every_leaf_is_laid_out_as_jax_lays_it(four_ranks):
    """Placements equal JAX's ``param_sharding`` on the 2-D mesh, leaf
    for leaf, before and after the steps and on both Adam moments; the
    block kernels shard on both axes."""
    from handyrl_tpu_torch.models.geese_net import GeeseNet

    recs, _ = four_ranks
    net = GeeseNet(**NET)
    jm = jmesh.make_mesh(jmesh.MeshSpec(dp=2, tp=2),
                         devices=jax.devices()[:4])
    jflat = _flat(jmesh.param_sharding(jm, random_flax_params(net),
                                       fsdp=True))
    both = []
    for path, name, kind in flax_layout(net):
        shape = tuple(net.state_dict()[name].shape)
        want = [None] * len(shape)
        for axis, entry in enumerate(_padded(
                jflat[path].spec, len(_to_flax_shape(shape, kind)))):
            want[torch_axis(kind, axis)] = entry
        want = tuple(want)
        for rec in recs:
            assert rec["before"][name] == rec["after"][name] == want, name
            assert rec["moments"][name] == (want, want), name
        if "dp" in want and "tp" in want:
            both.append(name)
            local = list(shape)
            for axis, entry in enumerate(want):
                if entry:
                    local[axis] //= 2
            assert all(rec["local"][name] == tuple(local) for rec in recs)
    assert both == ["blocks.0.conv.weight", "blocks.1.conv.weight"]
    assert recs[0]["before"]["stem.conv.weight"][0] == "tp"
    # the checkpoint's moments are gathered over both axes
    shapes = [tuple(p.shape) for p in net.parameters()]
    for rec in recs:
        for i, s in rec["opt"].items():
            assert s["exp_avg"] == s["exp_avg_sq"] == shapes[int(i)]
