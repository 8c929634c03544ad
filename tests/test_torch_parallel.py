"""The port's parallel layer against the JAX package's.

  * ``MeshSpec`` and the mesh-size contract raise and warn as JAX's;
  * ``param_sharding`` shards the same logical axis of the same leaves
    as the JAX package's on the conftest's virtual devices (GeeseNet
    32x12 and 128 filters, GeisterNet, and test_parallel.py's shape
    dicts), at dp=4 x tp=2 with and without ``fsdp``;
    ``inference_shardings`` keeps the contract;
  * two gloo processes run the sharded update step, one step and then a
    second, under dp=2, dp=2 + fsdp, tp=2 (128 filters, one block),
    sp=2 and IMPACT under dp=2 + fsdp.  Each matches the port's
    one-process step on the whole batch and the JAX package's
    ``make_sharded_update_step``
    on a mesh of the same shape, from the same converted weights, at
    JAX's own tolerance (params rtol 2e-4 / atol 2e-5, ``total`` rel
    1e-4, test_parallel.py:228-235);
  * the reduced gradients equal the one-process gradients (a mean over
    the two ranks would halve them), and so does ``grad_norm``.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.models import TPUModel
from handyrl_tpu.ops import update as jupdate
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.parallel import mesh as jmesh
from handyrl_tpu.parallel import make_sharded_update_step as jax_sharded
from handyrl_tpu_torch.connection import find_free_port
from handyrl_tpu_torch.models.convert import (
    _to_flax_shape,
    flax_layout,
    from_flax,
    random_flax_params,
    state_to_flax,
    torch_axis,
)
from handyrl_tpu_torch.ops import update as tupdate
from handyrl_tpu_torch.ops.losses import LossConfig
from handyrl_tpu_torch.parallel import (
    MeshSpec,
    inference_shardings,
    param_sharding,
)
from handyrl_tpu_torch.parallel.mesh import check_mesh_size
from handyrl_tpu_torch.parallel.update import opt_state_sharding
from handyrl_tpu_torch.utils.tree import flatten_params
from test_torch_losses import assert_close
from torchfix import (  # noqa: F401  (one_torch_thread: autouse)
    CHILD_ENV,
    draws,
    loss_cfg,
    make_episodes,
    one_torch_thread,
    to_torch_batch,
    window,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Adam divides each element's gradient by its own RMS, so an element
# whose gradient sits at float32 rounding level moves by up to ~lr in
# either package, whichever way the rounding went (at lr 1e-3, 2 of the
# 147,456 elements of a 128-filter kernel land 1.3e-4 apart from JAX's).
# At lr 1e-4 such an element stays inside the atol below.
LR = 1e-4
PARAM_RTOL, PARAM_ATOL, TOTAL_REL = 2e-4, 2e-5, 1e-4


# -- the mesh and its layout rules ------------------------------------------

def test_mesh_spec_and_size_contract_match_jax(capsys):
    spec = MeshSpec.from_config({"dp": 4, "tp": 2})
    jspec = jmesh.MeshSpec.from_config({"dp": 4, "tp": 2})
    assert spec.size == jspec.size == 8
    assert spec.shape() == jspec.shape() == (4, 1, 2)
    assert MeshSpec.from_config({"dp": 2, "fsdp": True}).fsdp
    for bad in ({"bogus": 2}, {"dp": 2, "pp": 2}):
        with pytest.raises(ValueError) as port:
            MeshSpec.from_config(bad)
        with pytest.raises(ValueError) as ref:
            jmesh.MeshSpec.from_config(bad)
        assert str(port.value) == str(ref.value)
    # too big for the world: JAX's message, word for word
    with pytest.raises(ValueError) as port:
        check_mesh_size(MeshSpec(dp=4), 2)
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(jmesh.MeshSpec(dp=4), devices=jax.devices()[:2])
    assert str(port.value) == str(ref.value)
    # a mesh that does not tile the world warns as JAX does
    capsys.readouterr()
    check_mesh_size(MeshSpec(dp=3), 8)
    port_out = capsys.readouterr().out
    jmesh.make_mesh(jmesh.MeshSpec(dp=3), devices=jax.devices()[:8])
    assert port_out == capsys.readouterr().out
    assert "3 of 8 devices" in port_out and "`mesh:`" in port_out
    check_mesh_size(MeshSpec(dp=4), 8)
    assert "WARNING" not in capsys.readouterr().out


def _flat(tree, prefix=""):
    """``{"a/b": leaf}`` of a nested dict, leaves untouched."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _nets():
    """The port's GeeseNet 32x12, a 128-filter GeeseNet, GeisterNet."""
    from handyrl_tpu_torch.models.geese_net import GeeseNet
    from handyrl_tpu_torch.models.geister_net import GeisterNet

    return [GeeseNet(), GeeseNet(filters=128, blocks=2), GeisterNet()]


@pytest.mark.parametrize("fsdp", [False, True])
def test_param_sharding_shards_the_same_leaf_axes_as_jax(fsdp):
    jm = jmesh.make_mesh(jmesh.MeshSpec(dp=4, tp=2),
                         devices=jax.devices()[:8])
    spec = MeshSpec(dp=4, tp=2)
    engaged = {"dp": 0, "tp": 0}
    for net in _nets():
        flax_tree = random_flax_params(net)
        jflat = _flat(jmesh.param_sharding(jm, flax_tree, fsdp=fsdp))
        port = param_sharding(spec, net, fsdp=fsdp)
        assert set(port) == set(net.state_dict())
        for path, name, kind in flax_layout(net):
            shape = tuple(net.state_dict()[name].shape)
            fshape = _to_flax_shape(shape, kind)
            want = [None] * len(shape)
            for axis, entry in enumerate(_padded(jflat[path].spec,
                                                 len(fshape))):
                want[torch_axis(kind, axis)] = entry
            got = port[name].spec(len(shape))
            assert got == tuple(want), (type(net).__name__, name, got, want)
            for axis_name in ("dp", "tp"):
                engaged[axis_name] += axis_name in got
        # Adam's moments follow their parameter; the count replicates
        moments = opt_state_sharding(port, spec)
        assert moments["exp_avg"] == moments["exp_avg_sq"] == port
        assert moments["step"].is_fully_replicated
    # the 128-filter net engages tp; fsdp engages dp
    assert engaged["tp"] > 0
    assert (engaged["dp"] > 0) == fsdp


@pytest.mark.parametrize("fsdp", [False, True])
def test_param_sharding_shape_dicts_match_jax(fsdp):
    """The shape dicts of tests/test_parallel.py, rule by rule."""
    jm = jmesh.make_mesh(jmesh.MeshSpec(dp=4, tp=2),
                         devices=jax.devices()[:8])
    trees = [
        {"dense": {"kernel": np.zeros((64, 256)), "bias": np.zeros((256,))},
         "conv": {"kernel": np.zeros((3, 3, 32, 128))},
         "head": {"kernel": np.zeros((32, 9))}},
        {"at_floor": np.zeros((64, 128)), "below_floor": np.zeros((64, 126)),
         "indivisible": np.zeros((64, 129)), "rank1": np.zeros((256,)),
         "scalar": np.zeros(())},
        {"conv": {"kernel": np.zeros((3, 3, 64, 64)),
                  "bias": np.zeros((64,))},
         "wide": {"kernel": np.zeros((64, 256))}},
    ]
    for tree in trees:
        want = _flat(jmesh.param_sharding(jm, tree, fsdp=fsdp))
        got = _flat(param_sharding(MeshSpec(dp=4, tp=2), tree, fsdp=fsdp))
        for path, leaf in _flat(tree).items():
            nd = np.ndim(leaf)
            assert got[path].spec(nd) == _padded(want[path].spec, nd), path
    lowered = param_sharding(MeshSpec(dp=4, tp=2),
                             {"small": np.zeros((8, 32))}, min_tp_dim=32)
    assert lowered["small"].spec(2) == (None, "tp")


def test_inference_shardings_contract():
    params = {"wide": np.zeros((64, 256)), "bias": np.zeros((256,))}
    sh = inference_shardings(MeshSpec(dp=4, tp=2), params)
    assert sh.params["wide"].spec(2) == (None, "tp")
    assert sh.params["bias"].is_fully_replicated
    assert sh.obs.spec(3) == ("dp", None, None)
    assert sh.out.spec(1) == ("dp",)
    assert "dp" in inference_shardings(MeshSpec(dp=4, tp=2), params,
                                       fsdp=True).params["wide"].spec(2)
    one = inference_shardings(MeshSpec(), params)
    assert all(lay.is_fully_replicated for lay in one.params.values())


# -- two ranks over gloo: the sharded step ------------------------------------

GEESE = loss_cfg(turn_based_training=False)
IMPACT = loss_cfg(turn_based_training=False, update_algorithm="impact",
                  policy_target="VTRACE", value_target="TD",
                  target_update_tau=0.1)
SCENARIOS = [
    # name, mesh, net kwargs, loss config
    ("dp", {"dp": 2}, {"filters": 32, "blocks": 2}, GEESE),
    ("fsdp", {"dp": 2, "fsdp": True}, {"filters": 32, "blocks": 2}, GEESE),
    ("tp", {"tp": 2}, {"filters": 128, "blocks": 1}, GEESE),
    ("sp", {"sp": 2}, {"filters": 32, "blocks": 2}, GEESE),
    ("impact", {"dp": 2, "fsdp": True}, {"filters": 32, "blocks": 2},
     IMPACT),
]

CHILD = textwrap.dedent("""
    import pickle, sys
    import torch
    from torch.distributed.tensor import DTensor

    rank, port, run = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    with open(run + "/in.pkl", "rb") as f:
        job = pickle.load(f)
    from handyrl_tpu_torch.models.convert import from_flax, state_to_flax
    from handyrl_tpu_torch.models.geese_net import GeeseNet
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.parallel import multihost as mh
    from handyrl_tpu_torch.parallel import (
        MeshSpec, make_mesh, make_sharded_update_step)
    from handyrl_tpu_torch.parallel.update import (
        full_state_dict, full_tensor)

    mh.init_distributed({"coordinator_address": "127.0.0.1:%d" % port,
                         "num_processes": 2, "process_id": rank},
                        device="cpu")

    def layout(t):
        return str(tuple(t.placements)) if isinstance(t, DTensor) else ""

    def net_of(kwargs, params):
        net = GeeseNet(**kwargs)
        net.load_state_dict(from_flax(params, net))
        return net

    out = {}
    for name, mesh_cfg, kwargs, cfg in job["scenarios"]:
        spec = MeshSpec.from_config(mesh_cfg)
        mesh = make_mesh(spec, device_type="cpu")
        net = net_of(kwargs, job["params"][name])
        impact = cfg.get("update_algorithm") == "impact"
        target = net_of(kwargs, job["target"][name]) if impact else None
        step = make_sharded_update_step(
            net, LossConfig.from_config(cfg), mesh, job["lr"], "float32",
            target_module=target, shard_time=spec.sp > 1, fsdp=spec.fsdp)
        rec = {"before": {n: layout(p) for n, p in net.named_parameters()},
               "metrics": []}
        coord = mesh.get_local_rank(0)  # this rank's dp coordinate
        for k, batch in enumerate(job["batches"]):
            rows = batch["action"].shape[0] // spec.dp
            local = {key: (v if key == "observation" else
                           v[coord * rows:(coord + 1) * rows])
                     for key, v in batch.items()}
            local["observation"] = batch["observation"][
                coord * rows:(coord + 1) * rows]
            if k == 0:
                step.loss_and_grads(local)
                rec["grads"] = state_to_flax(
                    {n: full_tensor(p.grad)
                     for n, p in net.named_parameters()}, net)
            metrics = step(local)
            rec["metrics"].append({key: float(v)
                                   for key, v in metrics.items()})
        rec["after"] = {n: layout(p) for n, p in net.named_parameters()}
        rec["moments"] = {
            n: layout(step.optimizer.state[p]["exp_avg"])
            for n, p in net.named_parameters()}
        rec["params"] = state_to_flax(full_state_dict(net), net)
        if target is not None:
            rec["target_layout"] = {n: layout(p)
                                    for n, p in target.named_parameters()}
            rec["target"] = state_to_flax(full_state_dict(target), target)
        out[name] = rec
    if rank == 0:
        with open(run + "/out.pkl", "wb") as f:
            pickle.dump(out, f)
    mh.shutdown()
    print("CHILD %d DONE" % rank)
""")


def _batches():
    """Two seeded HungryGeese batches of 4 windows x 8 steps (seat
    mode): rows split 2 + 2 under dp=2; T = 8 splits 4 + 4 under sp=2.
    The episodes come from a narrow net (8 filters x 2 blocks): any
    behaviour policy serves, and it plays them ~5x faster."""
    from handyrl_tpu_torch.batch import make_batch
    from handyrl_tpu_torch.models.geese_net import GeeseNet

    cfg = dict(GEESE, forward_steps=8, compress_steps=4)
    out = []
    for seed in range(2):
        episodes, players = make_episodes("HungryGeese", 4, seed=seed + 100,
                                          net=GeeseNet(8, 2))
        picks = draws(episodes, cfg, 4, len(players), seed)
        out.append(to_torch_batch(make_batch(
            [window(episodes[i], t, cfg) for i, t, _ in picks], cfg)))
    return out


def _geese(kwargs, seed):
    from handyrl_tpu.models.geese_net import GeeseNet as JGeese
    from handyrl_tpu_torch.models.geese_net import GeeseNet

    net = GeeseNet(**kwargs)
    params = random_flax_params(net, seed=seed)
    net.load_state_dict(from_flax(params, net))
    return JGeese(**kwargs), net, params


def _one_process(kwargs, cfg, batches, seed):
    """The port's unsharded step on the whole batch."""
    _, net, _ = _geese(kwargs, seed)
    target = _geese(kwargs, seed + 1)[1] \
        if cfg.get("update_algorithm") == "impact" else None
    step = tupdate.UpdateStep(net, LossConfig.from_config(cfg),
                              tupdate.make_optimizer(net.parameters(), LR),
                              "float32", target_module=target)
    metrics = []
    for k, batch in enumerate(batches):
        if k == 0:
            step.loss_and_grads(batch)
            grads = state_to_flax({n: p.grad for n, p in
                                   net.named_parameters()}, net)
        metrics.append({key: float(v) for key, v in step(batch).items()})
    return {"params": state_to_flax(net.state_dict(), net),
            "grads": grads, "metrics": metrics,
            "target": None if target is None
            else state_to_flax(target.state_dict(), target)}


def _jax_sharded(mesh_cfg, kwargs, cfg, batches, seed):
    """The JAX package's sharded step on a mesh of the same shape."""
    flax_net, _, params = _geese(kwargs, seed)
    tparams = _geese(kwargs, seed + 1)[2]
    spec = jmesh.MeshSpec.from_config(mesh_cfg)
    mesh = jmesh.make_mesh(spec, devices=jax.devices()[:spec.size])
    opt = jupdate.make_optimizer(1.0)
    state = jupdate.set_learning_rate(opt.init(params), LR)
    step = jax_sharded(TPUModel(flax_net), JaxLossConfig.from_config(cfg),
                       opt, mesh, params, shard_time=spec.sp > 1,
                       compute_dtype="float32", fsdp=spec.fsdp)
    impact = cfg.get("update_algorithm") == "impact"
    totals = []
    for batch in batches:
        jb = jax.tree.map(lambda t: np.asarray(t), batch)
        if impact:
            params, state, metrics, tparams = step(params, state, jb,
                                                   tparams)
        else:
            params, state, metrics = step(params, state, jb)
        totals.append(float(metrics["total"]))
    return {"params": jax.tree.map(np.asarray, params), "totals": totals}


def _close(a, b, what):
    for path, value in flatten_params(b).items():
        np.testing.assert_allclose(
            np.asarray(flatten_params(a)[path]), np.asarray(value),
            rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=f"{what}: {path}")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two gloo ranks runs every scenario (a 150 s
    deadline; ~5 s of work)."""
    run = tmp_path_factory.mktemp("two_ranks")
    # a module fixture runs before the autouse one_torch_thread: without
    # this, torch's 8-thread pool spins against the suite's other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batches = _batches()
    finally:
        torch.set_num_threads(threads)
    job = {"lr": LR, "scenarios": SCENARIOS, "params": {}, "target": {},
           "batches": batches}
    for i, (name, _, kwargs, _) in enumerate(SCENARIOS):
        job["params"][name] = _geese(kwargs, 10 * i)[2]
        job["target"][name] = _geese(kwargs, 10 * i + 1)[2]
    with open(run / "in.pkl", "wb") as f:
        pickle.dump(job, f)
    port = find_free_port()
    env = dict(CHILD_ENV, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(rank), str(port), str(run)],
        cwd=run, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
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
    with open(run / "out.pkl", "rb") as f:
        return pickle.load(f), batches


@pytest.mark.parametrize("index", range(len(SCENARIOS)),
                         ids=[s[0] for s in SCENARIOS])
def test_two_ranks_match_one_process_and_jax(two_ranks, index):
    results, batches = two_ranks
    name, mesh_cfg, kwargs, cfg = SCENARIOS[index]
    rec = results[name]
    one = _one_process(kwargs, cfg, batches, 10 * index)
    ref = _jax_sharded(mesh_cfg, kwargs, cfg, batches, 10 * index)
    for k in range(len(batches)):
        assert rec["metrics"][k]["total"] == pytest.approx(
            one["metrics"][k]["total"], rel=TOTAL_REL)
        assert rec["metrics"][k]["total"] == pytest.approx(
            ref["totals"][k], rel=TOTAL_REL)
        for key in ("dcnt", "grad_norm"):
            assert rec["metrics"][k][key] == pytest.approx(
                one["metrics"][k][key], rel=1e-4), (k, key)
    _close(rec["params"], one["params"], f"{name} vs one process")
    _close(rec["params"], ref["params"], f"{name} vs JAX")
    if one["target"] is not None:
        _close(rec["target"], one["target"], f"{name} target")


def test_gradients_are_summed_not_averaged(two_ranks):
    """Each dp rank holds half the rows: the reduced gradient must be
    the whole batch's (a mean would be half of it)."""
    results, batches = two_ranks
    for index in (0, 1):   # dp, dp + fsdp
        name, _, kwargs, cfg = SCENARIOS[index]
        one = _one_process(kwargs, cfg, batches[:1], 10 * index)
        got = flatten_params(results[name]["grads"])
        for path, value in flatten_params(one["grads"]).items():
            assert_close(got[path], value, f"{name} grad {path}")
        assert results[name]["metrics"][0]["grad_norm"] == pytest.approx(
            one["metrics"][0]["grad_norm"], rel=1e-4)


def test_layouts_through_the_step(two_ranks):
    results, _ = two_ranks
    # fsdp: parameters and their Adam moments hold a dp Shard
    fsdp = results["fsdp"]
    sharded = [n for n, lay in fsdp["after"].items() if "Shard" in lay]
    assert sharded and all("Shard" in fsdp["moments"][n] for n in sharded)
    assert all(not lay for n, lay in fsdp["after"].items()
               if n not in sharded)       # small leaves stay plain
    # tp on 128 filters: the conv kernels shard before and after the step
    tp = results["tp"]
    kernels = [n for n in tp["before"] if n.endswith("conv.weight")]
    for n in kernels:
        assert "Shard(dim=0)" in tp["before"][n] == tp["after"][n]
        assert tp["moments"][n] == tp["after"][n]
    assert not tp["before"]["policy.weight"]
    # dp alone shards nothing
    assert not any(results["dp"]["after"].values())
    # IMPACT: the target is laid out exactly like the live net
    impact = results["impact"]
    assert impact["target_layout"] == impact["after"]
    assert any("Shard" in lay for lay in impact["after"].values())
