"""The port's multi-process learner: ranks of a gloo process group.

CPU twins of tests/test_multihost.py, one process per rank (the port's
idiom: one process per card):

  * ``local_batch_size`` and the ``distributed:`` checks raise the JAX
    package's errors;
  * the control word and the start-up broadcast across two processes:
    rank 0's word wins every round, and ``broadcast_train_state``
    carries rank 0's tensors, its optimizer tree and ``steps = 2**40 +
    3`` exactly;
  * the twin of test_multihost.py's two-process learner: TicTacToe,
    global batch 8 (4 rows per rank), ``mesh: {dp: 2}``, 1 epoch, with
    the device ring and with the host batcher path, ``fsdp`` on the
    ring, and ``tp: 2`` (one dp group: both ranks take rank 0's rows).  Both ranks exit 0 and print the same loss line, rank 0's
    directory alone holds ``models/1.ckpt`` and ``train_state.ckpt``,
    its records carry ``resharding_copies`` 0 and one step signature,
    and the JAX package loads the checkpoint.  Each run has a 150 s
    deadline.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from handyrl_tpu_torch.connection import find_free_port
from handyrl_tpu_torch.parallel import multihost as mh
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 150


def test_local_batch_size_and_config_errors_match_jax(monkeypatch):
    import jax

    from handyrl_tpu.parallel import multihost as jmh

    assert mh.local_batch_size(8) == 8   # one process
    monkeypatch.setattr(mh, "process_count", lambda: 3)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    assert mh.local_batch_size(9) == jmh.local_batch_size(9) == 3
    with pytest.raises(ValueError) as port:
        mh.local_batch_size(8)
    with pytest.raises(ValueError) as ref:
        jmh.local_batch_size(8)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError) as port:
        mh.init_distributed({"hosts": 2})
    with pytest.raises(ValueError) as ref:
        jmh.init_distributed({"hosts": 2})
    assert str(port.value) == str(ref.value)
    assert mh.init_distributed({}) is False and not mh.process_index()
    with pytest.raises(ValueError, match="process_id"):
        mh.init_distributed({"num_processes": 2}, device="cpu")


def _spawn(script, args, cwds, timeout=DEADLINE):
    """Run ``script`` once per rank (argv: rank, then ``args``), each
    in its own directory; returns the outputs, killing stragglers."""
    env = dict(CHILD_ENV, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(rank)] + list(args),
        cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for rank, cwd in enumerate(cwds)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:   # no orphan blocked in a collective
            if proc.poll() is None:
                proc.kill()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    return outs


COLLECTIVES = textwrap.dedent("""
    import json, sys
    import torch
    from handyrl_tpu_torch.parallel import multihost as mh

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    assert mh.init_distributed({"coordinator_address": "127.0.0.1:%d" % port,
                                "num_processes": 2, "process_id": rank},
                               device="cpu")
    words = [mh.sync_epoch_code(code if rank == 0 else 99 - code)
             for code in (mh.STEP, mh.STEP, mh.EPOCH_END, mh.STOP)]
    params = {"w": torch.full((3, 2), float(rank + 1)),
              "b": torch.arange(4, dtype=torch.float32) * (rank + 1)}
    opt = {"state": {0: {"exp_avg": [1.5, 2.5]}}} if rank == 0 else None
    params, opt, steps, ema = mh.broadcast_train_state(
        params, opt, 2 ** 40 + 3 if rank == 0 else 0,
        123.25 if rank == 0 else -1.0)
    print("RESULT " + json.dumps({
        "rank": rank, "primary": mh.is_primary(), "count":
        mh.process_count(), "words": words, "steps": steps, "ema": ema,
        "w": params["w"].tolist(), "b": params["b"].tolist(), "opt": opt}))
    mh.shutdown()
""")


def test_control_word_and_train_state_broadcast(tmp_path):
    outs = _spawn(COLLECTIVES, [str(find_free_port())], [tmp_path] * 2)
    results = [json.loads(out.split("RESULT ", 1)[1].splitlines()[0])
               for out in outs]
    for rank, r in enumerate(results):
        assert r["rank"] == rank and r["count"] == 2
        assert r["primary"] == (rank == 0)
        assert r["words"] == [mh.STEP, mh.STEP, mh.EPOCH_END, mh.STOP]
        assert r["steps"] == 2 ** 40 + 3          # exact past 2^24
        assert r["ema"] == 123.25
        assert r["w"] == [[1.0, 1.0]] * 3
        assert r["b"] == [0.0, 1.0, 2.0, 3.0]
        assert r["opt"] == {"state": {"0": {"exp_avg": [1.5, 2.5]}}} \
            or r["opt"] == {"state": {0: {"exp_avg": [1.5, 2.5]}}}


LEARNER = textwrap.dedent("""
    import json, sys

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    device_replay, mesh = sys.argv[3], json.loads(sys.argv[4])
    args = {
        "env_args": {"env": "TicTacToe"},
        "train_args": {
            "turn_based_training": True, "observation": False,
            "gamma": 0.8, "forward_steps": 4, "burn_in_steps": 0,
            "compress_steps": 4, "entropy_regularization": 0.1,
            "entropy_regularization_decay": 0.1, "update_episodes": 10,
            "batch_size": 8,          # global: 4 rows per rank
            "minimum_episodes": 8, "maximum_episodes": 200,
            "epochs": 1, "num_batchers": 1, "eval_rate": 0.1,
            "worker": {"num_parallel": 1}, "lambda": 0.7,
            "policy_target": "TD", "value_target": "TD", "seed": 3,
            "lockstep_episodes": 4, "updates_per_epoch": 4,
            "metrics_path": "metrics.jsonl",
            "device_replay": device_replay, "mesh": mesh,
            "distributed": {"coordinator_address": "127.0.0.1:%d" % port,
                            "num_processes": 2, "process_id": rank},
        },
        "worker_args": {"num_parallel": 1, "server_address": ""},
    }

    if __name__ == "__main__":  # spawn-safe: the workers re-import
        from handyrl_tpu_torch.learner import train_main

        train_main(args, device="cpu")
        print("CHILD %d DONE" % rank)
""")


@pytest.mark.parametrize("device_replay,mesh", [
    ("on", {"dp": 2}),
    ("off", {"dp": 2}),
    ("on", {"dp": 2, "fsdp": True}),
    # dp=1: both ranks train on rank 0's rows (they share them), so the
    # unreduced loss lines agree only if the rows really are shared
    ("on", {"tp": 2}),
])
def test_two_process_learner(tmp_path, device_replay, mesh):
    script = tmp_path / "child.py"
    script.write_text(LEARNER)
    cwds = [tmp_path / f"rank{r}" for r in range(2)]
    for cwd in cwds:
        cwd.mkdir()
    env = dict(CHILD_ENV, PYTHONPATH=REPO)
    port = str(find_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), port, device_replay,
         json.dumps(mesh)], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for rank, cwd in enumerate(cwds)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=DEADLINE)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    losses = []
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
        assert f"CHILD {rank} DONE" in out and "updated model(" in out
        assert "distributed: process %d of 2, gloo" % rank in out
        # the intake counter's "100 200 ..." may precede a loss line
        losses.append(re.findall(r"loss = .*", out))
    # the all-reduced loss metric agrees across the ranks
    assert losses[0] and losses[0] == losses[1], losses
    # rank 0 alone owns the checkpoint dir and the metrics
    models0, models1 = cwds[0] / "models", cwds[1] / "models"
    assert (models0 / "1.ckpt").exists()
    assert (models0 / "train_state.ckpt").exists()
    assert not (models1 / "1.ckpt").exists()
    assert not (models1 / "train_state.ckpt").exists()
    assert not (cwds[1] / "metrics.jsonl").exists()
    with open(cwds[0] / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records and all(r["resharding_copies"] == 0 for r in records)
    assert all(r["retrace_count"] == 1 for r in records)
    assert all(r["replay"] == ("device" if device_replay == "on"
                               else "host") for r in records)

    # the JAX package loads rank 0's checkpoint
    from handyrl_tpu.environment import make_env as jax_make_env
    from handyrl_tpu.evaluation import load_model as jax_load_model

    jenv = jax_make_env({"env": "TicTacToe"})
    jmodel = jax_load_model(str(models0 / "1.ckpt"), jenv)
    jenv.reset()
    out = jmodel.inference(jenv.observation(jenv.players()[0]))
    assert np.isfinite(out["policy"]).all()
