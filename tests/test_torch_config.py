"""The port's config, manifest and restart resolution against the JAX
package's.

  * the shipped ``config.yaml`` and a handful of variants parse to the
    same ``train_args`` dict in both packages (keys, defaults, derived
    values), and both refuse the same malformed values;
  * ``mesh`` and ``distributed`` parse as in the JAX package, and an
    unknown mesh axis or distributed key is refused with the JAX
    package's message; ``anakin`` and ``perf`` parse
    and refuse as in the JAX package; the resilience keys (every
    ``chaos`` key, ``supervise_learner``, the WAL) and the guard
    switches parse as in the JAX package, and ``generation_opponent`` (league-lite)
    is accepted and refused as the JAX package does;
  * checkpoints the port writes and indexes resolve to the same resume
    point in both packages, auto and explicit, intact and corrupt;
  * an IMPACT trainer's optimizer and target network survive a
    save/restore round trip.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from handyrl_tpu import config as jconfig
from handyrl_tpu import durability as jdur
from handyrl_tpu_torch import config as tconfig
from handyrl_tpu_torch import durability as tdur
from torchfix import make_episodes, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shipped():
    with open(os.path.join(REPO, "config.yaml")) as f:
        return yaml.safe_load(f)


VARIANTS = {
    "shipped": {},
    "geese": {"turn_based_training": False, "compute_dtype": "float32"},
    "impact": {"update_algorithm": "impact", "target_update_tau": 0.1,
               "value_target": "VTRACE", "rho_clip": 2.0},
    "pipeline-off": {"pipeline": {"mode": "off"}, "device_replay": "off",
                     "restart_epoch": "auto", "worker": {"num_parallel": 40}},
    "league": {"generation_opponent": {"past_epochs": 3, "prob": 0.5}},
    "anakin": {"anakin": {"mode": "on", "num_envs": 1024,
                          "opponent_pool": 3}},
    "perf": {"perf": {"peak_tflops": 989.0, "cost_analysis": False}},
    "resilience": {"supervise_learner": True, "wal_flush_interval": 0.5,
                   "wal_keep_episodes": 300, "preempt_grace_seconds": 3.0,
                   "max_respawns": 1, "heartbeat_timeout": 10.0,
                   "chaos": {"kill_prob": 0.2, "max_kills": 1,
                             "infer_kill_epoch": 1,
                             "learner_kill_epoch": 2}},
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_train_args_match_jax(name):
    raw = _shipped()
    raw["train_args"].update(VARIANTS[name])
    jcfg = jconfig.Config.from_dict(raw)
    tcfg = tconfig.Config.from_dict(raw)
    assert tcfg.train_args.to_dict() == jcfg.train_args.to_dict()
    assert tcfg.worker_args == tcfg.worker_args.__class__(
        **vars(jcfg.worker_args))
    assert tcfg.train_args.effective_eval_rate == \
        jcfg.train_args.effective_eval_rate
    assert tcfg.train_args.batch_steps == jcfg.train_args.batch_steps


@pytest.mark.parametrize("bad", [
    {"policy_target": "BOGUS"}, {"forward_steps": 0},
    {"eval_rate": 1.5}, {"transfer_dtype": "int4"},
    {"restart_epoch": -1}, {"update_algorithm": "impact"},
    {"surrogate_clip": 1.0}, {"device_replay": "maybe"},
    {"no_such_key": 1}, {"pipeline": {"mode": "sideways"}},
    {"anakin": {"mode": "sometimes"}}, {"anakin": {"num_envs": 0}},
    {"anakin": {"mode": "on"}, "updates_per_epoch": 0},
    {"perf": {"mode": "on"}}, {"perf": {"peak_tflops": -1.0}},
])
def test_both_packages_refuse_the_same_values(bad):
    raw = _shipped()
    raw["train_args"].update(bad)
    with pytest.raises(ValueError):
        jconfig.Config.from_dict(raw)
    with pytest.raises(ValueError):
        tconfig.Config.from_dict(raw)


@pytest.mark.parametrize("key,value", [
    ("mesh", {"dp": 2}), ("distributed", {"num_processes": 2}),
    ("mesh", {"dp": 1, "tp": 2}),
])
def test_unported_layers_are_refused(key, value):
    """The parallel layer is ported, so nothing of it is refused any
    more (the name is the refusal test's, kept): its keys parse as in
    JAX."""
    raw = _shipped()
    raw["train_args"][key] = value
    port = tconfig.Config.from_dict(raw).train_args.to_dict()
    jax = jconfig.Config.from_dict(raw).train_args.to_dict()
    assert port[key] == jax[key] == value


@pytest.mark.parametrize("key,value", [
    ("mesh", {"dp": 2, "pp": 2}), ("distributed", {"hosts": 2}),
])
def test_bad_parallel_keys_are_refused_as_in_jax(key, value):
    from handyrl_tpu.parallel.mesh import MeshSpec
    from handyrl_tpu.parallel.multihost import init_distributed

    raw = _shipped()
    raw["train_args"][key] = value
    with pytest.raises(ValueError) as port:
        tconfig.Config.from_dict(raw)
    with pytest.raises(ValueError) as ref:
        (MeshSpec.from_config if key == "mesh" else init_distributed)(value)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("key,value", [
    ("chaos", {"shm_tear_prob": 0.1}), ("chaos", {"serve_kill_epoch": 2}),
    ("max_update_compiles", 1), ("max_nonfinite_steps", 2),
    ("max_fd_growth", 64), ("stall_watchdog", False),
    ("sharding_contract_guard", False),
])
def test_ported_keys_parse_as_in_jax(key, value):
    """The shm/serving chaos keys and the guard switches: accepted, and
    the parsed train_args equal the JAX package's."""
    raw = _shipped()
    raw["train_args"][key] = value
    port = tconfig.Config.from_dict(raw).train_args.to_dict()
    jax = jconfig.Config.from_dict(raw).train_args.to_dict()
    assert port[key] == jax[key] == value


@pytest.mark.parametrize("value", [
    {}, {"past_epochs": 1}, {"past_epochs": 8, "prob": 0.5},
    {"past_epochs": 3, "prob": 1.0}, {"past_epochs": 2, "prob": 1e-3},
    {"past_epochs": 0}, {"past_epochs": 3, "prob": 0.0},
    {"past_epochs": 3, "prob": 1.5}, {"past_epochs": 3, "prob": -0.1},
    {"bogus": 1}, {"prob": 0.5}, {"past_epochs": 2, "extra": True},
])
def test_generation_opponent_is_validated_as_in_jax(value):
    def verdict(module):
        raw = _shipped()
        raw["train_args"]["generation_opponent"] = dict(value)
        try:
            cfg = module.Config.from_dict(raw)
        except ValueError as exc:
            assert "not ported" not in str(exc)
            return "refused"
        return cfg.train_args.to_dict()["generation_opponent"]

    assert verdict(tconfig) == verdict(jconfig)


def _write(models, epoch, steps=10):
    path = os.path.join(models, f"{epoch}.ckpt")
    digest = tdur.write_checksummed(
        path, {"params": {"w": np.full(3, epoch, np.float32)},
               "epoch": epoch, "steps": steps})
    tdur.CheckpointManifest(models).commit(epoch, path, digest, steps,
                                           train_state_digest=f"ts{epoch}")
    return path


def _same(requested, models):
    t = tdur.resolve_restart(models, requested)
    j = jdur.resolve_restart(models, requested)
    assert (t.epoch, t.source, t.train_state_digest) == \
        (j.epoch, j.source, j.train_state_digest)
    assert (t.model_file or "") == (j.model_file or "")
    return t


def test_resume_points_match_jax(tmp_path):
    models = str(tmp_path / "models")
    os.makedirs(models)
    assert _same(0, models).source == "fresh"
    assert _same("auto", models).source == "fresh"
    for epoch in (1, 2, 3):
        _write(models, epoch)
    point = _same("auto", models)
    assert (point.epoch, point.source) == (3, "manifest")
    assert _same(2, models).source == "requested"
    # corrupt epoch 3: auto and an explicit request fall back to 2
    with open(os.path.join(models, "3.ckpt"), "r+b") as f:
        f.seek(20)
        f.write(b"\x00\xff\x00")
    assert not tdur.verify_file(os.path.join(models, "3.ckpt"))
    assert _same("auto", models).epoch == 2
    point = _same(3, models)
    assert (point.epoch, point.source) == (2, "fallback")
    for epoch in (1, 2):
        os.remove(os.path.join(models, f"{epoch}.ckpt"))
    with pytest.raises(tdur.CorruptCheckpointError):
        tdur.resolve_restart(models, 3)


def test_impact_trainer_state_round_trips(tmp_path, monkeypatch):
    """An IMPACT trainer's Adam moments, step count, lr EMA and target
    network come back from ``train_state.ckpt`` on restart."""
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.learner import Trainer
    from handyrl_tpu_torch.models import TorchModel

    monkeypatch.chdir(tmp_path)
    raw = _shipped()
    raw["train_args"].update(
        batch_size=4, forward_steps=4, maximum_episodes=16,
        update_algorithm="impact", target_update_tau=0.5)
    args = tconfig.Config.from_dict(raw).train_args.to_dict()
    args["env"] = {"env": "TicTacToe"}
    model = TorchModel(make_env(args["env"]).net(), device="cpu")
    model.init_params(seed=0)
    trainer = Trainer(args, model, device="cpu")
    episodes, _ = make_episodes("TicTacToe", 4, seed=1)
    trainer.device_replay.offer(episodes)
    trainer.device_replay.ingest()
    trainer.update_flag = True
    trainer.train()                      # epoch 1 lands train_state.ckpt
    resumed = Trainer(dict(args, restart_epoch=1), model, device="cpu")
    assert resumed.steps == trainer.steps >= 1
    assert resumed.update_step.count == trainer.steps
    assert resumed.data_cnt_ema == trainer.data_cnt_ema
    for a, b in zip(trainer.target_module.state_dict().values(),
                    resumed.target_module.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(trainer.module.parameters(),
                    resumed.module.parameters()):
        sa, sb = trainer.optimizer.state[p], resumed.optimizer.state[q]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    assert resumed.optimizer.param_groups[0]["lr"] == \
        trainer.optimizer.param_groups[0]["lr"]
