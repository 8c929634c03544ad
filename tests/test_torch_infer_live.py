"""The live inference service across two ranks against JAX's meshed
service.

Rank 0's ``InferenceService`` and one ``ServiceFollower`` (two gloo CPU
ranks, spawned in a session of their own under a deadline) answer a
fixed request sequence through the real window (``submit`` -> the
service thread -> ``deliver``): buckets 8, 16, 8 and 32, a hot swap, a
pin to the older snapshot (a model object of its own, as the learner's
resolver loads one), a chaos kill and respawn, and the pin again.  JAX's
``InferenceService`` answers the same sequence from the same weights
(``models/convert.py``) and the same seeded observations, on a mesh over
two of conftest's virtual CPU devices.  Three layouts: ``{dp: 2}`` and
``{dp: 2}`` with fsdp on GeeseNet 32x2 (its 3x3 kernels pass fsdp's
4,096-element floor), and ``{dp: 1, tp: 2}`` on GeeseNet 128x1 (128
output features: ``min_tp_dim`` shards its kernels).  Per layout:

  * every reply within the dry run's DP_ATOL 1e-5 (dp) or TP_ATOL 5e-5
    (tp) of JAX's, and the layout the port's service placed shards the
    leaves the layout names;
  * the follower joined exactly the forwards rank 0 sent (one per
    dispatch), and received every snapshot rank 0 sent;
  * ``infer_compiles`` and ``infer_resharding_copies`` are JAX's;
  * the STOP word ends the follower with no collective left pending:
    its thread is gone, and both ranks then meet on every group of the
    service's and on the default group before tearing them down.

One more case: a ``max_batch`` the dp axis does not divide disarms the
mesh (JAX's pow2 rule and warning); no group is built, rank 0 answers
unsharded as JAX's service does, and the follower stays idle.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from handyrl_tpu.parallel import mesh as jmesh
from handyrl_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from handyrl_tpu.pipeline.service import InferenceService as JaxService
from handyrl_tpu_torch.scripts.multichip_infer_dryrun import DP_ATOL, TP_ATOL
from test_torch_serving import _geese, _geese_obs
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 150
# (what, first obs row, rows, epoch pin): rows 8, 13, 5 and 32 pad to
# the buckets 8, 16, 8 and 32
SEQUENCE = (("ask", 0, 8, None), ("ask", 8, 13, None), ("ask", 21, 5, None),
            ("ask", 0, 32, None), ("swap",), ("ask", 32, 8, None),
            ("ask", 40, 16, 1), ("kill",), ("ask", 8, 8, None),
            ("ask", 16, 5, 1))
ASKS = sum(step[0] == "ask" for step in SEQUENCE)

CHILD = textwrap.dedent("""
    import multiprocessing as mp
    import pickle
    import sys
    import time

    import torch


    class Seat:
        # the serving frontend's seat shape: keeps the delivered reply
        def __init__(self, example):
            from handyrl_tpu_torch.utils.tree import tree_structure

            self.cid = 0
            self.treedef = tree_structure(example)
            self.drop_warned = False
            self.delivered = None

        def deliver(self, seq, epoch, part):
            self.delivered = (seq, epoch, part)
            return True


    def ask(svc, seat, seq, obs, pin):
        seat.delivered = None
        assert svc.submit(seat, seq, len(obs), [obs], epoch=pin)
        deadline = time.monotonic() + 60
        while seat.delivered is None:
            if svc.failure is not None or time.monotonic() > deadline:
                raise RuntimeError("no reply (%r)" % svc.failure)
            time.sleep(0.001)
        return seat.delivered


    def leader(svc, data):
        models = data["models"]
        svc.model_resolver = lambda epoch: models["pin1"] if epoch == 1 \\
            else None
        svc.snapshot_cache = data.get("snapshot_cache", 0)
        seat = Seat(data["obs"][0])
        svc.start()
        replies = []
        for step in data["sequence"]:
            if step[0] == "swap":
                svc.set_model(models["live2"], 2)
            elif step[0] == "kill":
                svc.inject_kill()
                svc._thread.join(30)
                assert not svc.alive
                svc.set_model(models["live2"], 2)   # as the learner does
                svc.respawn()
            else:
                _, lo, rows, pin = step
                seq, epoch, part = ask(svc, seat, len(replies),
                                       data["obs"][lo:lo + rows], pin)
                replies.append((epoch, part))
        svc.close()   # STOP to the follower
        placements = [lay.placements for lay in
                      (svc._infer_sh.params.values() if svc._infer_sh
                       else ())]
        return {"replies": replies, "stats": svc.stats(),
                "tp_leaves": sum(p[2].is_shard() for p in placements),
                "dp_leaves": sum(p[0].is_shard() for p in placements)}


    def rank_main(rank, port, data_path, out_path):
        torch.set_num_threads(1)
        import torch.distributed as dist

        from handyrl_tpu_torch.parallel import MeshSpec, make_mesh
        from handyrl_tpu_torch.parallel import multihost as mh
        from handyrl_tpu_torch.pipeline import PipelineConfig
        from handyrl_tpu_torch.pipeline.service import (
            InferenceService, ServiceFollower, ServiceGroups,
            mesh_bucket_floor)

        with open(data_path, "rb") as f:
            data = pickle.load(f)
        mh.init_distributed({"coordinator_address": "127.0.0.1:%d" % port,
                             "num_processes": 2, "process_id": rank},
                            device="cpu")
        spec = MeshSpec.from_config(data["mesh"])
        train_mesh = make_mesh(spec, device_type="cpu")
        cfg = PipelineConfig.from_config(data["pipeline"])
        # the learner's rule: the service's own groups on every rank,
        # unless JAX's pow2 rule disarms the mesh
        groups = None
        if mesh_bucket_floor(spec.dp, cfg.max_batch) is not None:
            groups = ServiceGroups(train_mesh, "cpu")
        out = {"groups": groups is not None}
        if rank == 0:
            svc = InferenceService(
                data["models"]["live1"], cfg, epoch=1, device="cpu",
                mesh=None if groups else train_mesh, fsdp=spec.fsdp,
                lockstep=groups)
            out.update(leader(svc, data))
        elif groups is not None:
            follower = ServiceFollower(groups, device="cpu", fsdp=spec.fsdp)
            follower.start()
            follower.join(120)
            out.update(alive=follower.alive, failure=follower.failure,
                       stats=follower.stats())
        # nothing pending: every group of the service's still meets
        if groups is not None:
            dist.barrier(group=groups.words)
            for dim in range(3):
                one = torch.ones(1)
                dist.all_reduce(one, group=groups.mesh.get_group(dim))
                out.setdefault("met", []).append(float(one))
        dist.barrier()
        mh.shutdown()
        with open(out_path % rank, "wb") as f:
            pickle.dump(out, f)


    if __name__ == "__main__":   # spawn-safe: the ranks re-import
        from handyrl_tpu_torch.connection import find_free_port

        port = find_free_port()
        ranks = [mp.get_context("spawn").Process(
            target=rank_main, args=(r, port, sys.argv[1], sys.argv[2]))
            for r in range(2)]
        for p in ranks:
            p.start()
        for p in ranks:
            p.join()
        sys.exit(max(p.exitcode for p in ranks))
""")


def _run_ranks(tmp_path, data):
    """The two ranks on ``data``; each rank's result."""
    with open(tmp_path / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    out = str(tmp_path / "rank%d.pkl")
    proc = subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "data.pkl"), out],
        cwd=tmp_path, env=dict(CHILD_ENV, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        text = proc.communicate(timeout=DEADLINE)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    assert proc.returncode == 0, text[-5000:]
    results = []
    for rank in range(2):
        with open(out % rank, "rb") as f:
            results.append(pickle.load(f))
    return results, text


class _JaxSeat:
    def __init__(self, example):
        self.cid = 0
        self.treedef = None
        self.example = example
        self.drop_warned = False
        self.delivered = None

    def deliver(self, seq, epoch, part):
        self.delivered = (seq, epoch, part)
        return True


def _jax_replies(models, obs, mesh, raw, fsdp):
    """The sequence through JAX's service, driven a window at a time
    (a kill changes no reply and no count of JAX's)."""
    ref = JaxService(models["live1"], JaxPipelineConfig.from_config(raw),
                     epoch=1, mesh=mesh, fsdp=fsdp)
    ref.model_resolver = lambda epoch: models["pin1"] if epoch == 1 \
        else None
    seat = _JaxSeat(obs[0])
    replies = []
    try:
        for step in SEQUENCE:
            if step[0] == "swap":
                ref.set_model(models["live2"], 2)
            elif step[0] == "ask":
                _, lo, rows, pin = step
                assert ref.submit(seat, len(replies), rows,
                                  [obs[lo:lo + rows]], epoch=pin)
                assert ref.step()
                replies.append(seat.delivered[1:])
        return replies, ref.stats()
    finally:
        ref.close()


def _models(filters, blocks):
    """JAX's and the port's snapshots from the same weights: epoch 1,
    epoch 2, and epoch 1 again as a model object of its own."""
    jax_models, port_models = {}, {}
    for name, seed in (("live1", 0), ("live2", 5), ("pin1", 0)):
        jax_models[name], port_models[name] = _geese(
            seed=seed, filters=filters, blocks=blocks)
    return jax_models, port_models


LAYOUTS = {
    "dp": ({"dp": 2}, (32, 2), DP_ATOL),
    "dp_fsdp": ({"dp": 2, "fsdp": True}, (32, 2), DP_ATOL),
    "tp": ({"dp": 1, "tp": 2}, (128, 1), TP_ATOL),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_live_service_across_two_ranks_is_jax_meshed(layout, tmp_path):
    mesh_cfg, (filters, blocks), atol = LAYOUTS[layout]
    raw = {"mode": "on", "batch_window": 0.0}
    jax_models, port_models = _models(filters, blocks)
    obs = _geese_obs(64, seed=11)
    (leader, follower), text = _run_ranks(tmp_path, {
        "mesh": mesh_cfg, "pipeline": raw, "models": port_models,
        "obs": obs, "sequence": SEQUENCE, "snapshot_cache": 1})
    spec = jmesh.MeshSpec(dp=mesh_cfg.get("dp", 1),
                          tp=mesh_cfg.get("tp", 1))
    jm = jmesh.make_mesh(spec, devices=jax.devices()[:2])
    want, jstats = _jax_replies(jax_models, obs, jm, raw,
                                mesh_cfg.get("fsdp", False))
    assert len(leader["replies"]) == len(want) == ASKS
    for i, ((epoch, got), (jepoch, ref)) in enumerate(
            zip(leader["replies"], want)):
        assert epoch == jepoch, i
        for key in ref:
            if ref[key] is None:
                continue
            np.testing.assert_allclose(got[key], np.asarray(ref[key]),
                                       rtol=0, atol=atol,
                                       err_msg=f"reply {i} {key}")
    # the layout is real: the leaves it names are sharded
    if layout == "tp":
        assert leader["tp_leaves"] > 0
    if layout == "dp_fsdp":
        assert leader["dp_leaves"] > 0
    stats = leader["stats"]
    assert stats["mesh_devices"] == jstats["mesh_devices"] == 2
    # one forward joined per dispatch sent, every snapshot received
    assert follower["failure"] is None and not follower["alive"]
    assert follower["stats"]["forwards"] == stats["lockstep_forwards"] \
        == stats["batches"] == ASKS
    # room for the live snapshot and one routed (snapshot_cache 1): the
    # live two and the pin's own object go once each (the pin evicts
    # epoch 1's live object), and after the respawn's set_model the
    # follower still holds epoch 2's and the pin's
    assert follower["stats"]["snapshots"] == stats["snapshots_sent"] == 3
    assert stats["respawns"] == 1
    for key in ("infer_compiles", "infer_resharding_copies"):
        assert stats[key] == jstats[key], (key, stats[key], jstats[key])
    assert stats["infer_compiles"] == 3   # the buckets 8, 16, 32
    assert follower["stats"]["infer_compiles"] == 3
    # no collective pending: both ranks met on every group afterwards
    assert leader["met"] == follower["met"] == [
        float(n) for n in (spec.dp, 1, spec.tp)]


def test_a_disarmed_mesh_leaves_the_follower_idle(tmp_path, capsys):
    """``max_batch`` 9 does not divide over dp 2: JAX's warning on rank
    0 alone, no group, rank 0 answers unsharded, the follower idle."""
    raw = {"mode": "on", "batch_window": 0.0, "max_batch": 9}
    jax_models, port_models = _models(8, 2)
    obs = _geese_obs(16, seed=12)
    sequence = (("ask", 0, 8, None), ("swap",), ("ask", 8, 5, None))
    (leader, follower), text = _run_ranks(tmp_path, {
        "mesh": {"dp": 2}, "pipeline": raw, "models": port_models,
        "obs": obs, "sequence": sequence})
    assert text.count("WARNING: inference mesh disarmed: dp=2") == 1
    assert not leader["groups"] and not follower["groups"]
    assert set(follower) == {"groups"}   # no follower thread was built
    assert leader["stats"]["mesh_devices"] == 1
    assert "lockstep_forwards" not in leader["stats"]
    capsys.readouterr()
    jm = jmesh.make_mesh(jmesh.MeshSpec(dp=2), devices=jax.devices()[:2])
    ref = JaxService(jax_models["live1"], JaxPipelineConfig.from_config(raw),
                     epoch=1, mesh=jm)
    try:
        assert ref._mesh is None   # JAX disarms it alike
        assert "inference mesh disarmed: dp=2" in capsys.readouterr().out
        first = ref._forward(jax_models["live1"], obs[:8])
    finally:
        ref.close()
    np.testing.assert_allclose(leader["replies"][0][1]["policy"],
                               np.asarray(first["policy"]), rtol=0,
                               atol=DP_ATOL)


class _Link:
    """A scripted stand-in for ``ServiceGroups``: no process group, a
    one-rank layout, the words a follower reads, and a send that fails
    on demand."""

    def __init__(self, words=(), fail_on=None):
        from handyrl_tpu_torch.parallel import MeshSpec

        self.mesh = MeshSpec(dp=1)
        self.words = list(words)
        self.sent = []
        self.fail_on = fail_on

    def recv(self):
        return self.words.pop(0)

    def send(self, word, payload=None):
        if word[0] == self.fail_on:
            raise RuntimeError("a peer left the group")
        self.sent.append(word)


@pytest.mark.parametrize("words,why", [
    ([((1, 7, 8), None)], "snapshot 7, which rank 0 never sent"),
    ([((9, 0, 0), None)], "unknown lockstep word 9"),
    ([((0, 0, 0), None)], None)])
def test_a_follower_out_of_protocol_fails_loudly(words, why):
    """A FORWARD with a snapshot the follower was never sent, or a word
    it does not know, ends it with ``LockstepBroken`` (the learner then
    ends the rank); STOP ends it cleanly."""
    from handyrl_tpu_torch.pipeline.service import (
        LockstepBroken,
        ServiceFollower,
    )

    follower = ServiceFollower(_Link(words), device="cpu")
    follower.start()
    follower.join(30)
    assert not follower.alive
    if why is None:
        assert follower.failure is None
    else:
        assert isinstance(follower.failure, LockstepBroken)
        assert why in str(follower.failure)


def test_a_leader_that_dies_sending_is_broken_and_sends_no_stop():
    """A word that fails to go out kills the loop mid-stream:
    ``lockstep_broken`` (no respawn can rejoin the followers), and
    ``stop`` then sends no STOP into the broken stream."""
    from handyrl_tpu_torch.pipeline import PipelineConfig
    from handyrl_tpu_torch.pipeline.service import LOAD, InferenceService

    _, first = _geese(seed=0)
    _, second = _geese(seed=1)
    link = _Link(fail_on=LOAD)
    svc = InferenceService(first, PipelineConfig.from_config(
        {"mode": "on"}), epoch=1, device="cpu", lockstep=link)
    try:
        svc.set_model(second, 2)   # placed at the loop's next pass
        svc.start()
        svc._thread.join(30)
        assert not svc.alive and svc.lockstep_broken
    finally:
        svc.close()
    assert link.sent == []   # no STOP after the broken LOAD
