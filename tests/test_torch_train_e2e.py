"""End-to-end local training of the port, on the CPU.

The port's ``Learner`` runs TicTacToe with two spawned CPU workers and
tiny settings (as tests/test_train_e2e.py has them for the JAX
package): jobs, model serving, the shm pipeline, episode intake, the
replay ring, update steps, checkpoints and shutdown, with the runtime
guards armed by default (every guard key in every record).  Then:
  * the port's checkpoint is read by the JAX package's ``load_model``
    and its forward agrees with the port's on the same file (1e-5);
  * a restart resumes at the checkpointed epoch with the optimizer
    state restored and trains one more epoch;
  * the host batcher path (``device_replay: off``) trains an epoch;
  * the snapshot a learner serves at epoch N is a copy: the trainer's
    next steps, which update the live parameters in place, leave it
    unchanged bit for bit.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import load_model as port_load_model
from handyrl_tpu_torch.learner import Learner, Trainer
from handyrl_tpu_torch.models import TorchModel
from torchfix import make_episodes, one_torch_thread  # noqa: F401


def _args(**train):
    train_args = {
        "turn_based_training": True, "observation": False, "gamma": 0.8,
        "forward_steps": 4, "burn_in_steps": 0, "compress_steps": 4,
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1,
        "update_episodes": 15, "batch_size": 4, "minimum_episodes": 10,
        "maximum_episodes": 200, "epochs": 2, "num_batchers": 1,
        "eval_rate": 0.1, "worker": {"num_parallel": 2}, "lambda": 0.7,
        "policy_target": "TD", "value_target": "TD", "seed": 1,
        "lockstep_episodes": 4, "metrics_path": "metrics.jsonl",
        # a few steps per epoch: an uncapped trainer would spin a core
        # for the whole run, starving the suite's other processes
        "updates_per_epoch": 4,
    }
    train_args.update(train)
    return {"env_args": {"env": "TicTacToe"}, "train_args": train_args}


GUARD_KEYS = ("retrace_count", "host_transfers", "numerics_contract_breaks",
              "weak_upcasts", "nonfinite_steps", "stall_events",
              "lock_contention_sec", "lock_order_inversions", "fd_count",
              "thread_count", "shm_segments", "resource_growth",
              "upload_backlog")


def _records():
    with open("metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned children
    return tmp_path


def test_two_epochs_then_restart_and_jax_reads_the_checkpoint(workdir,
                                                               capfd):
    Learner(_args(), device="cpu").run()
    records = _records()
    assert [r["epoch"] for r in records] == [0, 1]
    for r in records:
        assert r["replay"] == "device" and r["replay_device"] == "cpu"
        assert r["epoch_steps"] >= 1 and r["nonfinite_steps"] == 0
        assert all(np.isfinite(r[k]) for k in ("p", "v", "ent", "total"))
        # the runtime guards are on by default: every key the JAX
        # learner writes, the sharding guard's included
        for key in GUARD_KEYS:
            assert key in r, key
        assert r["resharding_copies"] == 0
        assert r["stall_events"] == r["lock_order_inversions"] == 0
        assert r["numerics_contract_breaks"] == r["weak_upcasts"] == 0
        assert r["upload_backlog"] == 0
    # one update-step signature, flat after epoch 1
    assert [r["retrace_count"] for r in records] == [1, 1]
    assert os.path.exists("models/1.ckpt") and os.path.exists(
        "models/2.ckpt")
    out = capfd.readouterr().out
    assert out.count("closed worker") == 2
    assert "cuda initialized True" not in out
    assert "pipeline fallbacks 0" in out
    steps = records[-1]["steps"]

    # the JAX package reads the port's checkpoint, and both forwards
    # agree on it
    from handyrl_tpu.environment import make_env as jax_make_env
    from handyrl_tpu.evaluation import load_model as jax_load_model

    jenv, env = jax_make_env({"env": "TicTacToe"}), make_env(
        {"env": "TicTacToe"})
    jmodel = jax_load_model("models/2.ckpt", jenv)
    model = port_load_model("models/2.ckpt", env, device="cpu")
    env.reset()
    obs = env.observation(env.players()[0])
    jout, out2 = jmodel.inference(obs), model.inference(obs)
    for key in ("policy", "value"):
        assert np.isfinite(jout[key]).all()
        np.testing.assert_allclose(out2[key], np.asarray(jout[key]),
                                   rtol=0, atol=1e-5)

    # restart at epoch 2: resumes the optimizer, trains one more epoch
    Learner(_args(epochs=3, restart_epoch=2), device="cpu").run()
    out = capfd.readouterr().out
    assert f"restored optimizer state at step {steps}" in out
    records = _records()
    assert records[-1]["epoch"] == 2 and records[-1]["steps"] > steps
    assert os.path.exists("models/3.ckpt")


def test_host_batcher_path_trains_an_epoch(workdir, capfd):
    Learner(_args(epochs=1, device_replay="off", prefetch_batches=3,
                  transfer_threads=1), device="cpu").run()
    out = capfd.readouterr().out
    assert "WARNING: device_replay is off" in out
    # the steps took their batches from the device prefetcher
    assert "device prefetch: 3 batches deep from 1 threads onto cpu" in out
    (record,) = _records()
    assert record["replay"] == "host" and record["epoch_steps"] >= 1
    assert 0 <= record["queue_depth"] <= 3 + 8
    assert np.isfinite(record["total"])


def test_served_snapshot_is_unchanged_by_the_next_steps(workdir):
    """ROADMAP C1's twin: torch updates the live parameters in place,
    so a snapshot aliasing them would serve torn weights silently."""
    args = _args(minimum_episodes=4, updates_per_epoch=3)["train_args"]
    args["env"] = {"env": "TicTacToe"}
    model = TorchModel(make_env(args["env"]).net(), device="cpu")
    model.init_params(seed=0)
    trainer = Trainer(args, model, device="cpu")
    episodes, _ = make_episodes("TicTacToe", 6, seed=2)
    trainer.device_replay.offer(episodes)
    trainer.device_replay.ingest()

    trainer.update_flag = True
    served = trainer.train()                     # epoch N's snapshot
    blob = pickle.dumps(served)                  # what _serve_model ships
    frozen = {k: v.clone() for k, v in served.module.state_dict().items()}
    live = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    trainer.train()                              # the next steps
    assert any(not torch.equal(live[k], v)
               for k, v in trainer.module.state_dict().items())
    for k, v in served.module.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    assert pickle.dumps(served) == blob
    assert all(v.data_ptr() not in {p.data_ptr()
                                    for p in trainer.module.parameters()}
               for v in served.module.state_dict().values())
