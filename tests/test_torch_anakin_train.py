"""The port's Learner in Anakin mode, end to end on the CPU.

A real ``Learner`` with one spawned eval worker and a 150 s watchdog:
  * epochs close on the trainer's step clock (``updates_per_epoch``),
    not on episode intake;
  * every job the fleet is given is an evaluation;
  * each record carries ``anakin_frames`` / ``anakin_games`` and their
    per-second rates, and the step accounting (``batch_wait_sec``,
    ``device_step_sec``, ``queue_depth``, ``mfu``, ``achieved_tflops``,
    ``arithmetic_intensity``, ``roofline_verdict``);
  * the JAX package reads the last checkpoint and its forward agrees
    with the port's on it (1e-5);
  * a fused step that raises shuts the learner down instead of leaving
    it serving a frozen model (the JAX package's twin);
and, at the trainer: the snapshot served at epoch N is a copy that the
next fused steps leave unchanged bit for bit (ROADMAP C1's twin).
"""

import json
import pickle
import threading

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.config import Config
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import load_model as port_load_model
from handyrl_tpu_torch.learner import Learner, Trainer
from handyrl_tpu_torch.models import TorchModel
from torchfix import one_torch_thread  # noqa: F401

UPDATES = 8
PERF_KEYS = ("batch_wait_sec", "device_step_sec", "queue_depth", "mfu",
             "achieved_tflops", "arithmetic_intensity", "roofline_verdict")


def _args(**train):
    train_args = {
        "turn_based_training": True, "observation": False, "gamma": 0.8,
        "forward_steps": 8, "burn_in_steps": 0, "compress_steps": 4,
        "entropy_regularization": 0.05,
        "entropy_regularization_decay": 0.1,
        "update_episodes": 50, "batch_size": 32, "minimum_episodes": 10,
        "maximum_episodes": 200, "epochs": 3, "num_batchers": 1,
        "eval_rate": 0.1, "worker": {"num_parallel": 1}, "lambda": 0.7,
        "policy_target": "TD", "value_target": "TD", "seed": 3,
        "lockstep_episodes": 4, "metrics_path": "metrics.jsonl",
        "updates_per_epoch": UPDATES,
        "anakin": {"mode": "on", "num_envs": 32, "opponent_pool": 1},
    }
    train_args.update(train)
    return {"env_args": {"env": "TicTacToe"}, "train_args": train_args}


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned children
    return tmp_path


def _abort(learner):
    learner.shutdown_flag = True
    learner.worker.begin_drain()


def _run(learner):
    watchdog = threading.Timer(150, _abort, args=(learner,))
    watchdog.start()
    try:
        learner.run()
    finally:
        watchdog.cancel()


def test_anakin_learner_epochs_jobs_metrics_and_checkpoint(workdir, capfd):
    learner = Learner(_args(), device="cpu")
    assert learner.trainer.anakin is not None
    assert learner._assign_job()["role"] == "e"
    jobs = []
    assign = learner._assign_job

    def recording():
        job = assign()
        jobs.append(job)
        return job

    learner._assign_job = recording
    _run(learner)
    with open("metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert [r["steps"] for r in records] == [UPDATES, 2 * UPDATES,
                                             3 * UPDATES]
    assert all(r["episodes_received"] == 0 for r in records)
    assert all(job["role"] == "e" for job in jobs)
    for r in records:
        assert r["epoch_steps"] == UPDATES and r["nonfinite_steps"] == 0
        assert r["anakin_games"] == 32 * UPDATES
        assert 5 * 32 * UPDATES <= r["anakin_frames"] <= 9 * 32 * UPDATES
        assert r["anakin_frames_per_sec"] > 0
        assert r["anakin_games_per_sec"] > 0
        assert "replay" not in r
        for key in PERF_KEYS:
            assert key in r, key
        assert r["device_step_sec"] > 0 and r["achieved_tflops"] > 0
        assert r["mfu"] is None                 # no peak for the CPU
        assert r["queue_depth"] == 0 and r["batch_wait_sec"] == 0.0
        assert r["roofline_verdict"] == "unknown"
        for key in ("policy_lag_mean", "policy_lag_p95", "policy_lag_max"):
            assert r[key] == 0.0
    out = capfd.readouterr().out
    assert "anakin mode: 32 on-device games x 9-step segments, " \
           "opponent pool 1" in out
    assert "cuda initialized True" not in out

    from handyrl_tpu.environment import make_env as jax_make_env
    from handyrl_tpu.evaluation import load_model as jax_load_model

    jenv, env = jax_make_env({"env": "TicTacToe"}), make_env(
        {"env": "TicTacToe"})
    jmodel = jax_load_model("models/3.ckpt", jenv)
    model = port_load_model("models/3.ckpt", env, device="cpu")
    env.reset()
    obs = env.observation(env.players()[0])
    jout, out = jmodel.inference(obs), model.inference(obs)
    for key in ("policy", "value"):
        assert np.isfinite(jout[key]).all()
        np.testing.assert_allclose(out[key], np.asarray(jout[key]),
                                   rtol=0, atol=1e-5)


def test_a_failed_fused_step_shuts_the_learner_down(workdir, capfd):
    learner = Learner(_args(epochs=5, updates_per_epoch=5), device="cpu")
    real_step = learner.trainer._anakin_step
    calls = {"n": 0}

    def dying_step(*args):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("injected device failure")
        return real_step(*args)

    learner.trainer._anakin_step = dying_step
    runner = threading.Thread(target=_run, args=(learner,), daemon=True)
    runner.start()
    runner.join(timeout=120)
    assert not runner.is_alive(), "learner.run() hung after the loop died"
    assert isinstance(learner.trainer.failure, RuntimeError)
    assert learner.shutdown_flag and learner.model_epoch == 0
    assert "ERROR: anakin trainer thread failed" in capfd.readouterr().out


def test_served_snapshot_and_pool_are_unchanged_by_the_next_steps(workdir):
    """Torch updates the live parameters in place: a snapshot or an
    opponent slot aliasing them would change under the next steps."""
    args = Config.from_dict(_args()).train_args.to_dict()
    args["env"] = {"env": "TicTacToe"}
    model = TorchModel(make_env(args["env"]).net(), device="cpu")
    model.init_params(seed=0)
    trainer = Trainer(args, model, device="cpu")
    trainer.update_flag = True
    served = trainer.train()                     # epoch N's snapshot
    blob = pickle.dumps(served)
    frozen = {k: v.clone() for k, v in served.module.state_dict().items()}
    pool = {k: v.clone()
            for k, v in trainer.anakin_pool[0].state_dict().items()}
    live = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    trainer.train()                              # the next fused step
    assert any(not torch.equal(live[k], v)
               for k, v in trainer.module.state_dict().items())
    for k, v in served.module.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    assert pickle.dumps(served) == blob
    # each boundary copies the live parameters into the pool's slot 0
    assert all(torch.equal(v, live[k]) for k, v in pool.items())
    assert all(torch.equal(v, trainer.module.state_dict()[k])
               for k, v in trainer.anakin_pool[0].state_dict().items())
    ptrs = {p.data_ptr() for p in trainer.module.parameters()}
    assert not any(v.data_ptr() in ptrs
                   for v in served.module.state_dict().values())
    assert not any(p.data_ptr() in ptrs
                   for p in trainer.anakin_pool[0].parameters())
