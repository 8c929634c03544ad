"""The port's telemetry reductions and memory trim against the JAX
package's.

  * ``summarize_lags`` equals the JAX package's on seeded lag lists;
  * a learner's epoch record carries ``policy_lag_{mean,p95,max}`` over
    the episodes it ADMITTED that epoch (rejected stale arrivals are
    counted apart), and the list starts over each epoch;
  * ``target_net_age`` follows the JAX trainer's formula in its three
    modes (Polyak, hard interval, frozen), from a real trainer epoch;
  * ``epoch_metrics`` equals the JAX cost model's for the same FLOPs,
    peaks and seconds; the H100 row, ``PerfConfig``'s errors and the
    FLOP harvest on a step's first call per input shape;
  * the host replay path's memory-pressure trim (ROADMAP C10) keeps
    what the JAX package's ``ReplayBuffer`` keeps under the same faked
    ``psutil.virtual_memory``, and warns once.
"""

import json
import random
import signal
import types
import warnings
from collections import deque

import numpy as np
import pytest
import torch

from handyrl_tpu import learner as jlearner
from handyrl_tpu.telemetry import costmodel as jcost
from handyrl_tpu.telemetry import summarize_lags as jax_summarize_lags
from handyrl_tpu_torch import learner as tlearner
from handyrl_tpu_torch.config import Config
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.telemetry import CostModel, PerfConfig, costmodel
from handyrl_tpu_torch.telemetry import summarize_lags
from torchfix import make_episodes, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", range(6))
def test_summarize_lags_equals_jax(seed):
    rng = np.random.default_rng(seed)
    lags = [int(x) for x in rng.integers(0, 6, int(rng.integers(0, 40)))]
    assert summarize_lags(lags) == jax_summarize_lags(lags)


def _learner_args(**train):
    train_args = {
        "turn_based_training": True, "observation": False, "gamma": 0.8,
        "forward_steps": 4, "burn_in_steps": 0, "compress_steps": 4,
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1,
        "update_episodes": 15, "batch_size": 4, "minimum_episodes": 10,
        "maximum_episodes": 200, "epochs": 3, "num_batchers": 1,
        "eval_rate": 0.1, "worker": {"num_parallel": 1}, "lambda": 0.7,
        "policy_target": "TD", "value_target": "TD", "seed": 1,
        "metrics_path": "metrics.jsonl", "pipeline": {"mode": "off"},
        "wal_enabled": False, "updates_per_epoch": 2,
    }
    train_args.update(train)
    return {"env_args": {"env": "TicTacToe"}, "train_args": train_args}


def test_learner_records_the_lags_of_admitted_episodes(tmp_path,
                                                       monkeypatch):
    """Epoch 4, budget 2: episodes from snapshots 0-4 arrive; lags 3 and
    4 are rejected, lags 0-2 admitted and reduced into the record."""
    monkeypatch.chdir(tmp_path)
    learner = tlearner.Learner(_learner_args(max_policy_lag=2),
                               device="cpu")
    try:
        learner.model_epoch = 4
        episodes, _ = make_episodes("TicTacToe", 10, seed=3)
        gens = [4, 4, 3, 2, 0, 1, 3, 2, 4, 2]
        for ep, gen in zip(episodes, gens):
            ep["gen_model_epoch"] = gen
        learner.feed_episodes(episodes)
        learner.trainer.request_shutdown()  # no trainer thread runs
        learner.update()
        learner.feed_episodes(episodes[:2])     # snapshot 4 at epoch 5
        learner.update()
    finally:
        signal.signal(signal.SIGTERM, learner._sigterm_prev)
        if learner.infer_service is not None:
            learner.infer_service.close()
    with open("metrics.jsonl") as f:
        first, second = [json.loads(line) for line in f]
    admitted = [4 - g for g in gens if 4 - g <= 2]
    lag_keys = ("policy_lag_mean", "policy_lag_p95", "policy_lag_max")
    assert {k: first[k] for k in lag_keys} == jax_summarize_lags(admitted)
    assert first["episodes_rejected_stale"] == len(gens) - len(admitted)
    # the first epoch's lags are gone; snapshot 4's episodes lag 1 now
    assert {k: second[k] for k in lag_keys} == jax_summarize_lags([1, 1])
    assert second["episodes_rejected_stale"] == 0


def _jax_target_net_age(steps, interval, tau):
    """The JAX trainer's formula (handyrl_tpu/learner.py, Trainer.train:
    the Polyak horizon, the steps since the last hard sync, or the run
    length for a frozen target)."""
    if tau > 0.0:
        return round(1.0 / tau, 1)
    elif interval > 0:
        return steps % interval
    return steps


@pytest.mark.parametrize("interval,tau", [(0, 0.25), (3, 0.0), (2, 0.5),
                                          (0, 0.0)])
def test_target_net_age_follows_the_jax_formula(interval, tau, tmp_path,
                                                monkeypatch):
    """Four one-step epochs of an IMPACT trainer in Anakin mode (it
    needs no episodes): each record's age is the JAX formula's."""
    monkeypatch.chdir(tmp_path)
    raw = _learner_args(update_algorithm="impact", policy_target="IMPACT",
                        value_target="IMPACT", target_update_interval=1,
                        anakin={"mode": "on", "num_envs": 8})
    args = Config.from_dict(raw).train_args.to_dict()
    # the mode under test (the config refuses a frozen target, 0 and 0)
    args.update(env={"env": "TicTacToe"}, target_update_interval=interval,
                target_update_tau=tau)
    model = TorchModel(make_env(args["env"]).net(), device="cpu")
    model.init_params(seed=0)
    trainer = tlearner.Trainer(args, model, device="cpu")
    ages = []
    for _ in range(4):
        trainer.update_flag = True      # raised already: one step
        trainer.train()
        ages.append(trainer.last_metrics["target_net_age"])
    assert ages == [_jax_target_net_age(steps, interval, tau)
                    for steps in (1, 2, 3, 4)]


def test_epoch_metrics_equal_the_jax_cost_model():
    cfg = {"peak_tflops": 123.0, "peak_hbm_gbs": 456.0}
    port = CostModel(PerfConfig.from_config(cfg), kind="cpu")
    ref = jcost.CostModel(jcost.PerfConfig.from_config(cfg), kind="cpu")
    for label, flops in (("anakin_step", 3.7e9), ("replay_step", 1.2e12)):
        port._programs[label] = {"flops": flops, "harvests": 1}
        ref._programs[label] = {"flops": flops, "bytes": 0.0,
                                "harvests": 1}
        for sec, steps in ((0.5, 100), (2.25, 7), (0.0, 3), (1.0, 0)):
            assert port.epoch_metrics(label, sec, steps) == \
                ref.epoch_metrics(label, sec, steps)
    for label in ("update_step", "nothing"):
        assert port.epoch_metrics(label, 1.0, 3) == \
            ref.epoch_metrics(label, 1.0, 3)
    # no override: the H100 row, and nothing on the CPU
    assert costmodel.resolve_peaks(None, "NVIDIA H100 80GB HBM3") == (
        989.0, 3350.0)
    assert CostModel(kind="").epoch_metrics("x", 1.0, 1)["mfu"] is None
    assert costmodel.device_kind("cpu") == ""


@pytest.mark.parametrize("raw", [
    {}, {"peak_tflops": 10}, {"cost_analysis": False},
    {"peak_tflops": -1}, {"peak_hbm_gbs": -2}, {"bogus": 1},
])
def test_perf_config_accepts_and_refuses_as_jax(raw):
    def verdict(cls):
        try:
            cfg = cls.from_config(raw)
        except ValueError as exc:
            return str(exc)
        return vars(cfg)

    assert verdict(PerfConfig) == verdict(jcost.PerfConfig)


def test_harvest_counts_flops_once_per_shape():
    net = torch.nn.Linear(8, 4)
    model = CostModel(PerfConfig(peak_tflops=1.0))
    calls = []

    def step(x):
        calls.append(x.shape)
        net(x).sum().backward()
        return x.shape[0]

    assert model.call("step", step, torch.ones(16, 8)) == 16
    # forward 2*16*8*4 and the weight gradient's as many (the input
    # needs no gradient)
    prog = model.program("step")
    assert prog["flops"] == 2 * 2 * 16 * 8 * 4 and prog["harvests"] == 1
    # the same traced call counts the bytes its aten ops moved: at
    # least the input, the weight and its gradient once each
    assert prog["bytes"] >= 4 * (16 * 8 + 2 * 8 * 4)
    model.call("step", step, torch.ones(16, 8))
    assert model.program("step")["harvests"] == 1
    model.call("step", step, torch.ones(32, 8))     # a new geometry
    prog32 = model.program("step")
    assert prog32["flops"] == 2 * 2 * 32 * 8 * 4
    assert prog32["harvests"] == 2 and prog32["bytes"] > prog["bytes"]
    assert len(calls) == 3
    off = CostModel(PerfConfig(cost_analysis=False))
    off.call("step", step, torch.ones(4, 8))
    assert off.program("step") is None


class _Memory:
    def __init__(self, percent):
        self.percent = percent

    def virtual_memory(self):
        return types.SimpleNamespace(percent=self.percent)


@pytest.mark.parametrize("percent", [50.0, 95.0, 96.5, 99.9])
def test_memory_trim_keeps_what_the_jax_replay_buffer_keeps(percent,
                                                            monkeypatch):
    monkeypatch.setattr(tlearner, "psutil", _Memory(percent))
    monkeypatch.setattr(jlearner, "psutil", _Memory(percent))
    random.seed(percent)
    items = [random.random() for _ in range(300)]
    port = tlearner.ReplayBuffer(1000)
    ref = jlearner.ReplayBuffer(deque(maxlen=1000), 1000)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for lo in range(0, 300, 40):
            port.extend(items[lo:lo + 40])
            ref.extend(items[lo:lo + 40])
            assert list(port) == list(ref.episodes)
    assert len(port) == (300 if percent <= 95 else len(ref.episodes))
    if percent > 95:
        assert len(port) < 300
    port_warnings = [w for w in caught if "memory usage" in str(w.message)]
    assert len(port_warnings) == (2 if percent > 95 else 0)  # one each
    # the cap still holds without pressure
    capped = tlearner.ReplayBuffer(5)
    monkeypatch.setattr(tlearner, "psutil", None)
    capped.extend(range(12))
    assert list(capped) == list(range(7, 12))
