"""Sharded inference dry run over gloo ranks.

The twin of ``scripts/multichip_infer_dryrun.py``: the batched
inference forward of :class:`..pipeline.InferenceService` runs over a
rank mesh, every rank calling ``_forward`` in lockstep with the same
observations (each forwards its dp rows; the outputs come back over
dp).  With ``--ranks N`` (a power of two, at least 4; default 8):

  * dp N/2 x tp 2 with ``fsdp`` on a 128-filter GeeseNet: tp-sharded
    and fsdp-sharded parameter leaves must exist, and the output must
    match the unsharded forward within ``TP_ATOL``;
  * dp N and dp N with ``fsdp`` against the unsharded forward, within
    ``DP_ATOL`` (see below);
  * a one-rank mesh, bit-identical to the mesh-less dispatch;
  * hot swap and a routed (resolver-served) snapshot through the same
    guarded forward: ``infer_compiles`` unchanged, resharding copies 0,
    each snapshot placed once on the param layouts;
  * one request through the real ``submit`` -> ``step`` -> ``deliver``
    window (the serving tier's network plane).

JAX asserts the dp legs bit-exact: XLA's CPU convolution computes a row
the same way at any batch size.  The CPU's oneDNN picks its blocking by
batch size, and cuDNN its algorithm: a rank's 4-row forward and the
16-row reference differ in the last bits (2.4e-6 at dp4 on a CPU and
on an H100 in strict float32; 8-row ranks on a CPU came out bitwise),
so ``DP_ATOL`` bounds the dp legs and the JSON says whether they came
out bitwise.  The one-rank
leg, at equal batch size, is asserted bitwise.

Usage (from the repo root; ranks share the card over gloo with
``--device cuda``):

    python -m handyrl_tpu_torch.scripts.multichip_infer_dryrun \\
        [--ranks 8] [--blocks 2] [--device cpu]

Progress lines first, then ONE JSON line; exit 0 when every assertion
held.
"""

import argparse
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

# one reassociated reduction per tp-partitioned contraction, as in the
# JAX script
TP_ATOL = 5e-5
# a dp rank's rows forwarded at another batch size (module docstring)
DP_ATOL = 1e-5
FILTERS = 128
DEADLINE = 600


class _Seat:
    """Network-plane seat duck (the frontend's seat shape): captures
    the delivered reply so the window can be driven synchronously."""

    def __init__(self, example):
        from ..utils.tree import tree_structure

        self.cid = 0
        self.treedef = tree_structure(example)
        self.drop_warned = False
        self.delivered = None

    def deliver(self, seq, epoch, outputs):
        self.delivered = (seq, epoch, outputs)
        return True


def _max_diff(out, ref):
    return max(float(np.max(np.abs(np.asarray(out[k]) - np.asarray(ref[k]))))
               for k in ref if ref[k] is not None)


def _bit_equal(out, ref):
    return all(np.array_equal(np.asarray(out[k]), np.asarray(ref[k]))
               for k in ref if ref[k] is not None)


def _setup(blocks, device):
    """The seeded net, 16 observations and the unsharded reference.  On
    the card in strict float32: TF32 convolutions and matmuls round to
    10 mantissa bits, and a sharded and an unsharded forward pick their
    algorithms apart (1.4e-4 at dp4 on an H100 with TF32 on)."""
    from ..environment import make_env

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..models import TorchModel
    from ..models.geese_net import GeeseNet

    env = make_env({"env": "HungryGeese"})
    random.seed(7)  # the geese's start cells: the same on every rank
    env.reset()
    model = TorchModel(GeeseNet(filters=FILTERS, blocks=blocks),
                       device=device)
    model.init_params(seed=0)
    obs0 = np.asarray(env.observation(env.players()[0]), np.float32)
    rng = np.random.RandomState(7)
    obs = np.stack([obs0] * 16) \
        + rng.rand(16, *obs0.shape).astype(np.float32) * 0.2
    return model, obs0, obs, model.inference_batch(obs)


def _snapshot(model, scale):
    from ..models import TorchModel
    from ..models.wrapper import build_module

    snap = TorchModel(build_module(model.spec, "cpu"), device="cpu")
    snap.load_params({k: v * scale for k, v in model.params.items()})
    return snap


def rank_main(blocks, device):
    """One rank (the launcher's ``RANK``/``WORLD_SIZE`` variables): the
    mesh legs over the whole group."""
    from ..parallel import MeshSpec, make_mesh
    from ..parallel import multihost as mh
    from ..pipeline import InferenceService, PipelineConfig

    mh.init_distributed({"auto": True}, device=device, backend="gloo")
    rank, world = mh.process_index(), mh.process_count()
    device = mh.rank_device({"auto": True}, device)
    kind = torch.device(device).type
    model, obs0, obs, ref = _setup(blocks, device)
    pcfg = PipelineConfig.from_config({"mode": "on", "batch_window": 0.0})
    out = {}

    def say(line):
        if rank == 0:
            print(line, flush=True)

    # -- dp x tp2 + fsdp, the headline geometry --------------------------
    dp = world // 2
    mesh = make_mesh(MeshSpec(dp=dp, tp=2), device_type=kind)
    svc = InferenceService(model, pcfg, epoch=1, device=device, mesh=mesh,
                           fsdp=True)
    got = svc._forward(model, obs)
    placements = [lay.placements for lay in svc._infer_sh.params.values()]
    tp_leaves = sum(p[2].is_shard() for p in placements)
    fsdp_leaves = sum(p[0].is_shard() for p in placements)
    assert tp_leaves > 0, "tp rule never sharded a param leaf"
    assert fsdp_leaves > 0, "fsdp rule never sharded a param leaf"
    diff = _max_diff(got, ref)
    assert diff <= TP_ATOL, (f"dp{dp}xtp2 dispatch drifted {diff} > "
                             f"{TP_ATOL} from the unsharded forward")
    placed = model._infer_placed[1][1].values()
    assert any(hasattr(t, "placements") for t in placed), \
        "no placed param leaf is actually distributed"
    assert svc.stats()["mesh_devices"] == world
    out.update(tp_sharded_leaves=tp_leaves, fsdp_sharded_leaves=fsdp_leaves,
               tp_fsdp_max_diff=diff)
    say(f"dp{dp}xtp2+fsdp: {tp_leaves} tp-sharded / {fsdp_leaves} "
        f"fsdp-sharded leaves, max diff {diff:.2e} OK")

    # -- hot swap + routing through the SAME guarded forward -------------
    compiles = svc.retrace_guard.compiles
    snap2 = _snapshot(model, 1.0)
    svc.set_model(snap2, 2)
    svc._adopt_model()
    assert _max_diff(svc._forward(snap2, obs), ref) <= TP_ATOL
    routed = _snapshot(model, 0.5)
    svc.model_resolver = lambda epoch: routed
    rmodel, repoch = svc._routed(1)
    assert rmodel is routed and repoch == 1
    svc._forward(rmodel, obs)
    assert hasattr(routed, "_infer_placed"), \
        "routed snapshot was not placed onto the param shardings"
    assert svc.retrace_guard.compiles == compiles, (
        f"snapshot swap/routing added a signature: "
        f"{svc.retrace_guard.compiles} != {compiles}")
    assert svc.shard_guard.copies == 0, (
        f"{svc.shard_guard.copies} resharding copies: a snapshot landed "
        f"on the wrong layout")
    out.update(infer_compiles=svc.retrace_guard.compiles,
               infer_resharding_copies=svc.shard_guard.copies,
               param_loads=svc.param_loads)
    say(f"hot-swap + routed snapshot: {compiles} signature(s) per "
        f"geometry, 0 resharding copies OK")

    # -- the real batching window (submit -> step -> deliver) ------------
    seat = _Seat(obs0)
    assert svc.submit(seat, 1, 16, [obs], epoch=None)
    assert svc.step(), "the window never dispatched"
    assert seat.delivered is not None, "no reply delivered"
    _seq, epoch, outputs = seat.delivered
    assert epoch == 2 and outputs["policy"].shape[0] == 16
    assert svc.retrace_guard.compiles == compiles
    out["window_dispatches"] = int(svc.batches)
    say("submit->step->deliver window dispatch OK")
    svc.close()

    # -- dp N and dp N + fsdp --------------------------------------------
    for fsdp in (False, True):
        mesh = make_mesh(MeshSpec(dp=world), device_type=kind)
        svc = InferenceService(model, pcfg, epoch=1, device=device,
                               mesh=mesh, fsdp=fsdp)
        got = svc._forward(model, obs)
        diff = _max_diff(got, ref)
        name = f"dp{world}{'+fsdp' if fsdp else ''}"
        assert diff <= DP_ATOL, f"{name} drifted {diff} > {DP_ATOL}"
        out[f"dp{'_fsdp' if fsdp else ''}_max_diff"] = diff
        out[f"dp{'_fsdp' if fsdp else ''}_bitwise"] = _bit_equal(got, ref)
        svc.close()
    say(f"dp{world} / dp{world}+fsdp: within {DP_ATOL} of the unsharded "
        f"forward OK (max diff {out['dp_max_diff']:.2e} / "
        f"{out['dp_fsdp_max_diff']:.2e})")
    mh.shutdown()
    return out


def one_rank_leg(port, blocks, device):
    """A one-rank mesh is bit-identical to the mesh-less dispatch."""
    from ..parallel import MeshSpec, make_mesh
    from ..parallel import multihost as mh
    from ..pipeline import InferenceService, PipelineConfig

    mh.init_distributed({"coordinator_address": f"127.0.0.1:{port}",
                         "num_processes": 1, "process_id": 0},
                        device=device, backend="gloo")
    try:
        model, _obs0, obs, ref = _setup(blocks, device)
        pcfg = PipelineConfig.from_config({"mode": "on",
                                           "batch_window": 0.0})
        bare = InferenceService(model, pcfg, epoch=1, device=device)
        plain = bare._forward(model, obs)
        bare.close()
        one = InferenceService(
            model, pcfg, epoch=1, device=device,
            mesh=make_mesh(MeshSpec(dp=1),
                           device_type=torch.device(device).type))
        got = one._forward(model, obs)
        one.close()
        assert _bit_equal(got, plain), \
            "one-rank mesh is not bit-identical to the mesh-less dispatch"
        assert _bit_equal(plain, ref), \
            "the service's forward is not the model's own"
    finally:
        mh.shutdown()
    print("one-rank mesh: bit-identical OK", flush=True)
    return {"single_rank_bitwise": True}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--blocks", type=int, default=2)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--rank", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.ranks < 4 or args.ranks & (args.ranks - 1):
        parser.error("--ranks must be a power of two >= 4")
    if args.rank:
        torch.set_num_threads(1)
        out = rank_main(args.blocks, args.device)
        print("RESULT " + json.dumps(out), flush=True)
        return 0

    from ..device import resolve_device

    resolve_device(args.device)
    t0 = time.perf_counter()
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        WORLD_SIZE=str(args.ranks), MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(port))
    cmd = [sys.executable, "-m", "handyrl_tpu_torch.scripts."
           "multichip_infer_dryrun", "--ranks", str(args.ranks), "--blocks",
           str(args.blocks), "--device", args.device, "--rank"]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK="0"),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(args.ranks)]
    texts = []
    try:
        for proc in procs:
            texts.append(proc.communicate(
                timeout=max(1.0, DEADLINE - (time.perf_counter() - t0)))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for line in texts[0].splitlines():
        if not line.startswith("RESULT "):
            print(line, flush=True)
    if failed:
        for r in failed:
            print(f"rank {r} exited {procs[r].returncode}:\n"
                  f"{texts[r][-3000:]}", flush=True)
        return 1
    out = {"metric": "multichip_infer_dryrun", "ranks": args.ranks,
           "device": args.device, "blocks": args.blocks}
    out.update(json.loads(next(line[7:] for line in texts[0].splitlines()
                               if line.startswith("RESULT "))))
    out.update(one_rank_leg(_free_port(), args.blocks, args.device))
    out["ok"] = True
    out["wall_s"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
