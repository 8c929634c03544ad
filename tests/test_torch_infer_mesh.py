"""The inference service's guards and its mesh path against the JAX
service's.

  * ``infer_compiles`` and ``infer_resharding_copies``: the same bucket
    sequence, hot swap and routed snapshot through both packages'
    services give the same counts, in ``stats()`` and in
    ``epoch_stats()`` (one signature per bucket geometry, never one per
    snapshot; 0 copies), and the guards survive ``respawn()``;
    ``mesh_devices`` is 1 without a mesh;
  * the bucket-floor rule: a ``dp`` the pow2 buckets cannot honour
    disarms the mesh with the JAX warning, word for word, and a pow2
    ``dp`` above the floor raises it, as JAX does;
  * a one-rank mesh (a one-rank gloo group) dispatches bit-identically
    to the mesh-less service;
  * the sharded dry run (``scripts/multichip_infer_dryrun.py``'s twin)
    at reduced depth, four gloo ranks: dp2 x tp2 with fsdp, dp4, dp4
    with fsdp, the one-rank leg, hot swap, routing and the window;
  * ``plot_metrics`` plots a record carrying the service's guard keys.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from handyrl_tpu.parallel import mesh as jmesh
from handyrl_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from handyrl_tpu.pipeline.service import InferenceService as JaxService
from handyrl_tpu_torch.connection import find_free_port
from handyrl_tpu_torch.parallel import MeshSpec, make_mesh
from handyrl_tpu_torch.parallel import multihost as mh
from handyrl_tpu_torch.pipeline import InferenceService, PipelineConfig
from handyrl_tpu_torch.scripts import plot_metrics
from test_torch_serving import _geese, _geese_obs
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = {"mode": "on", "batch_window": 0.0}
BUCKETS = (8, 8, 16, 8, 32, 16, 64)


def _services(**kw):
    jmodel, tmodel = _geese(seed=0)
    port = InferenceService(tmodel, PipelineConfig.from_config(RAW),
                            epoch=1, device="cpu", **kw)
    ref = JaxService(jmodel, JaxPipelineConfig.from_config(RAW), epoch=1,
                     **kw)
    return (port, tmodel), (ref, jmodel)


def _counts(svc):
    return svc.retrace_guard.compiles, svc.shard_guard.copies


def test_guard_counts_match_the_jax_service():
    (port, tmodel), (ref, jmodel) = _services()
    try:
        obs = _geese_obs(64, seed=1)
        trail = []
        for rows in BUCKETS:
            got = port._forward(tmodel, obs[:rows])
            want = ref._forward(jmodel, obs[:rows])
            np.testing.assert_allclose(got["policy"], want["policy"],
                                       rtol=1e-4, atol=1e-5)
            trail.append((_counts(port), _counts(ref)))
        # a hot swap and a routed snapshot ride the same forward
        jsnap, tsnap = _geese(seed=5)
        port.set_model(tsnap, 2)
        ref.set_model(jsnap, 2)
        port._adopt_model()
        ref._adopt_model()
        port._forward(tsnap, obs[:8])
        ref._forward(jsnap, obs[:8])
        jrouted, trouted = _geese(seed=6)
        port.model_resolver = lambda epoch: trouted
        ref.model_resolver = lambda epoch: jrouted
        port._forward(port._routed(1)[0], obs[:16])
        ref._forward(ref._routed(1)[0], obs[:16])
        trail.append((_counts(port), _counts(ref)))
        for mine, theirs in trail:
            assert mine == theirs, trail
        assert _counts(port) == (4, 0)   # the buckets 8, 16, 32, 64
        stats, jstats = port.stats(), ref.stats()
        for key in ("infer_compiles", "infer_resharding_copies",
                    "mesh_devices"):
            assert stats[key] == jstats[key], key
        assert stats["mesh_devices"] == 1
        epoch, jepoch = port.epoch_stats(), ref.epoch_stats()
        for key in ("infer_compiles", "infer_resharding_copies"):
            assert epoch[key] == jepoch[key], key
        # the guards belong to the service: a respawned loop keeps them
        port.start()
        port.inject_kill()
        port._thread.join(timeout=10)
        port.respawn()
        port._forward(tsnap, obs[:8])
        assert _counts(port) == (4, 0)
    finally:
        port.close()
        ref.close()


def test_a_moved_argument_counts_a_resharding_copy():
    """An argument whose device moves after the first call is a copy
    per call, in the epoch delta; ``max_reshard`` turns it into an
    error at the offending call, as the JAX guard's budget does."""
    import torch

    from handyrl_tpu_torch.analysis.guards import ShardingContractError

    _, tmodel = _geese(seed=0)
    svc = InferenceService(tmodel, PipelineConfig.from_config(RAW),
                           epoch=1, device="cpu", max_reshard=1)
    try:
        obs = torch.from_numpy(_geese_obs(8, seed=2))
        fwd = svc._ensure_forward(tmodel)
        module, params = svc._placed(tmodel)
        fwd(module, params, obs)
        assert svc.epoch_stats()["infer_resharding_copies"] == 0
        # two leaves on another device: 2 copies, past the budget of 1
        moved = {k: (v.to("meta") if i < 2 else v)
                 for i, (k, v) in enumerate(params.items())}
        with pytest.raises(ShardingContractError, match="inference_batch"):
            fwd(module, moved, obs)
        assert svc.shard_guard.copies == 2
    finally:
        svc.close()


@pytest.mark.parametrize("dp,max_batch", [(3, 256), (8, 12), (16, 256),
                                          (4, 256)])
def test_the_bucket_floor_rule_and_its_warning_are_jax(dp, max_batch,
                                                       capsys):
    raw = dict(RAW, max_batch=max_batch)
    _, tmodel = _geese(seed=0)
    port = InferenceService(tmodel, PipelineConfig.from_config(raw),
                            epoch=1, device="cpu", mesh=MeshSpec(dp=dp))
    mine = capsys.readouterr().out
    port.close()
    if dp <= len(jax.devices()):
        jmodel, _ = _geese(seed=0)
        jm = jmesh.make_mesh(jmesh.MeshSpec(dp=dp),
                             devices=jax.devices()[:dp])
        capsys.readouterr()
        ref = JaxService(jmodel, JaxPipelineConfig.from_config(raw),
                         epoch=1, mesh=jm)
        theirs = capsys.readouterr().out
        ref.close()
        assert [line for line in mine.splitlines() if "mesh" in line] == \
            [line for line in theirs.splitlines() if "mesh" in line]
        assert (port._mesh is None) == (ref._mesh is None)
        assert port._bucket_floor == ref._bucket_floor
    armed = dp in (4, 16)
    assert (port._mesh is not None) == armed
    assert port._bucket_floor == (16 if dp == 16 else 8)
    if not armed:
        assert (f"WARNING: inference mesh disarmed: dp={dp} does not "
                f"divide the pow2 batch buckets") in mine


def test_a_one_rank_mesh_is_bit_identical_to_no_mesh():
    _, tmodel = _geese(seed=3)
    obs = _geese_obs(16, seed=4)
    cfg = PipelineConfig.from_config(RAW)
    bare = InferenceService(tmodel, cfg, epoch=1, device="cpu")
    want = bare._forward(tmodel, obs)
    bare.close()
    mh.init_distributed({"coordinator_address": "127.0.0.1:%d"
                         % find_free_port(), "num_processes": 1,
                         "process_id": 0}, device="cpu")
    try:
        svc = InferenceService(tmodel, cfg, epoch=1, device="cpu",
                               mesh=make_mesh(MeshSpec(dp=1),
                                              device_type="cpu"))
        got = svc._forward(tmodel, obs)
        assert svc.stats()["mesh_devices"] == 1
        svc.close()
    finally:
        mh.shutdown()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_the_sharded_dry_run_at_reduced_depth(tmp_path):
    """The dry run's twin over four gloo ranks, one block (~10 s)."""
    proc = subprocess.run(
        [sys.executable, "-m", "handyrl_tpu_torch.scripts."
         "multichip_infer_dryrun", "--ranks", "4", "--blocks", "1"],
        cwd=tmp_path, env=dict(CHILD_ENV, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["ranks"] == 4
    assert out["tp_sharded_leaves"] > 0 and out["fsdp_sharded_leaves"] > 0
    assert out["infer_compiles"] == 1 and out["infer_resharding_copies"] == 0
    assert out["single_rank_bitwise"] and out["window_dispatches"] == 1
    assert "dp2xtp2+fsdp" in proc.stdout


def test_plot_metrics_plots_the_service_guard_keys(tmp_path, capsys):
    """A record carrying the service's guard keys, as the learner
    writes it, parses and plots (``*_inference.png``)."""
    _, tmodel = _geese(seed=0)
    svc = InferenceService(tmodel, PipelineConfig.from_config(RAW),
                           epoch=1, device="cpu")
    try:
        obs = _geese_obs(16, seed=1)
        records = []
        for epoch, rows in enumerate((8, 16, 8)):
            svc._forward(tmodel, obs[:rows])
            records.append(dict(svc.epoch_stats(), epoch=epoch,
                                mesh_devices=svc.mesh_devices))
    finally:
        svc.close()
    path = tmp_path / "metrics.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    epochs = plot_metrics.parse_jsonl(str(path))
    xs = [e["epoch"] for e in epochs]
    assert plot_metrics.series(xs, epochs, "infer_compiles") == \
        [(0, 1), (1, 2), (2, 2)]
    assert plot_metrics.series(xs, epochs, "infer_resharding_copies") == \
        [(0, 0), (1, 0), (2, 0)]
    pytest.importorskip("matplotlib")
    plot_metrics.plot(epochs, str(tmp_path / "run"))
    assert (tmp_path / "run_inference.png").exists()
    capsys.readouterr()
