"""The port's recurrent training path against the JAX package's, on the CPU.

  * Two float32 update steps on Geister batches (turn mode, burn-in 4)
    through the port's ``UpdateStep`` and the JAX ``make_update_step``
    from the same weights: the first step's gradients, each step's loss,
    gradient norm and ``dcnt``, and every parameter's move
    (test_torch_update.py's bounds).
  * The bf16 step: every output of the forward, the new hidden state
    included, comes back float32, so the carry between steps is float32;
    parameters and Adam state stay float32.
  * One epoch of ``Learner`` on Geister (narrow GeisterNet, burn-in 2)
    with two spawned CPU workers, under a deadline: the inference
    service never answers the recurrent net (the workers infer on their
    CPUs), and the JAX package reads the checkpoint and gives the same
    forward, hidden state included.
"""

import json
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.models import TPUModel
from handyrl_tpu.models.geister_net import GeisterNet as FlaxGeisterNet
from handyrl_tpu.ops import update as jupdate
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.losses import compute_loss as jax_compute_loss
from handyrl_tpu_torch.durability import read_verified
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.learner import Learner
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models.convert import state_to_flax
from handyrl_tpu_torch.models.geister_net import GeisterNet
from handyrl_tpu_torch.ops import update as tupdate
from handyrl_tpu_torch.ops.losses import LossConfig
from handyrl_tpu_torch.utils.tree import flatten_params, tree_leaves
from test_torch_losses import assert_close
from test_torch_recurrent import _mode_batch
from torchfix import one_torch_thread, to_torch_batch, twin_nets  # noqa: F401

LR = 1e-3
NARROW = {"filters": 8, "drc_layers": 2, "drc_repeats": 2}


def test_recurrent_update_steps_match_make_update_step():
    batches = [_mode_batch("geister-turn", 4, seed=s) for s in range(2)]
    raw = batches[0][0]
    flax_net, net, params = twin_nets("Geister", seed=0)
    jcfg = JaxLossConfig.from_config(raw)
    jmodel = TPUModel(flax_net)
    jopt = jupdate.make_optimizer(1.0)
    jstate = jupdate.set_learning_rate(jopt.init(params), LR)
    jstep = jupdate.make_update_step(jmodel, jcfg, jopt, "float32")
    japply = jupdate.make_apply_fn(jmodel, "float32")

    opt = tupdate.make_optimizer(net.parameters(), 1.0)
    tupdate.set_learning_rate(opt, LR)
    step = tupdate.UpdateStep(net, LossConfig.from_config(raw), opt,
                              "float32")
    jparams = params
    for k, (_, batch) in enumerate(batches):
        jb = jax.tree.map(jnp.asarray, batch)
        B, P = batch["value"].shape[0], batch["value"].shape[2]

        def jloss(p):
            losses, _ = jax_compute_loss(japply, p, jb,
                                         jmodel.init_hidden([B, P]), jcfg)
            return losses["total"]

        jgrad = flatten_params(jax.grad(jloss)(jparams))
        before = flatten_params(state_to_flax(net.state_dict(), net))
        tb = to_torch_batch(batch)
        if k == 0:
            step.loss_and_grads(tb)
            tgrad = flatten_params(state_to_flax(
                {n: p.grad for n, p in net.named_parameters()}, net))
            for path in jgrad:
                assert_close(tgrad[path], jgrad[path], f"grad {path}")
        metrics = step(tb)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        for key in ("total", "grad_norm", "dcnt", "nonfinite"):
            assert_close(metrics[key], jm[key], f"step {k}: {key}")
        after = flatten_params(state_to_flax(net.state_dict(), net))
        jafter = flatten_params(jparams)
        for path in jgrad:
            moved = np.abs(jgrad[path]) > 1e-6
            np.testing.assert_allclose(
                (after[path] - before[path])[moved],
                (np.asarray(jafter[path]) - before[path])[moved],
                rtol=0, atol=0.05 * LR, err_msg=f"step {k}: delta {path}")


def test_bf16_recurrent_step_keeps_a_float32_carry():
    raw, batch = _mode_batch("geister-turn", 4)
    _, net, _ = twin_nets("Geister", seed=0)
    tb = to_torch_batch(batch)
    apply_fn = tupdate.make_apply_fn(net, "bfloat16")
    obs = {k: v[:, 0, 0] for k, v in tb["observation"].items()}
    hidden = net.init_hidden((obs["board"].shape[0],))
    out = apply_fn(obs, hidden)
    assert all(t.dtype == torch.float32 for t in tree_leaves(out))
    assert sorted(out["hidden"]) == ["c0", "c1", "h0", "h1"]
    opt = tupdate.make_optimizer(net.parameters(), LR)
    metrics = tupdate.UpdateStep(net, LossConfig.from_config(raw), opt,
                                 "bfloat16")(tb)
    assert float(metrics["nonfinite"]) == 0.0
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(s["exp_avg"].dtype == torch.float32
               for s in opt.state.values())


def _args():
    train_args = {
        "turn_based_training": True, "observation": False, "gamma": 0.8,
        "forward_steps": 4, "burn_in_steps": 2, "compress_steps": 4,
        "entropy_regularization": 0.1,
        "entropy_regularization_decay": 0.1,
        "update_episodes": 8, "batch_size": 4, "minimum_episodes": 6,
        "maximum_episodes": 200, "epochs": 1, "num_batchers": 1,
        "eval_rate": 0.1, "worker": {"num_parallel": 2}, "lambda": 0.7,
        "policy_target": "TD", "value_target": "TD", "seed": 1,
        "lockstep_episodes": 4, "metrics_path": "metrics.jsonl",
        "updates_per_epoch": 3,
    }
    return {"env_args": {"env": "Geister"}, "train_args": train_args}


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned children
    return tmp_path


def _abort(learner):
    learner.shutdown_flag = True
    learner.worker.begin_drain()


def test_geister_trains_an_epoch_and_jax_reads_the_checkpoint(workdir,
                                                               capfd):
    learner = Learner(_args(), net=GeisterNet(**NARROW), device="cpu")
    watchdog = threading.Timer(150, _abort, args=(learner,))
    watchdog.start()
    try:
        learner.run()
    finally:
        watchdog.cancel()
    with open("metrics.jsonl") as f:
        (record,) = [json.loads(line) for line in f]
    assert record["epoch"] == 0 and record["epoch_steps"] >= 1
    assert record["replay"] == "device" and record["nonfinite_steps"] == 0
    assert all(np.isfinite(record[k]) for k in ("p", "v", "r", "total"))
    out = capfd.readouterr().out
    assert out.count("closed worker") == 2
    assert "cuda initialized True" not in out
    # the recurrent net is never wrapped by the service: no row served,
    # no fallback, every forward on the workers' CPUs
    assert out.count("pipeline fallbacks 0, served rows 0") == 2
    stats = json.loads(out.split("inference service stats =")[1]
                       .splitlines()[0])
    assert stats["rows_served"] == 0

    # the JAX package reads the port's Flax-format checkpoint
    params = read_verified("models/1.ckpt")["params"]
    jmodel = TPUModel(FlaxGeisterNet(**NARROW), params)
    model = TorchModel.from_flax(GeisterNet(**NARROW), params, device="cpu")
    env = make_env({"env": "Geister"})
    env.reset()
    obs = env.observation(env.players()[0])
    jout = jmodel.inference(obs, jmodel.init_hidden())
    tout = model.inference(obs, model.init_hidden())
    for key in ("policy", "value", "return"):
        np.testing.assert_allclose(tout[key], np.asarray(jout[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    for key, value in jout["hidden"].items():
        np.testing.assert_allclose(tout["hidden"][key], np.asarray(value),
                                   rtol=0, atol=1e-5, err_msg=key)
    assert pickle.loads(pickle.dumps(model)).is_recurrent
    assert os.path.exists("models/train_state.ckpt")
