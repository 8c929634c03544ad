"""The port's update step against the JAX package's ``make_update_step``.

Three float32 steps on both sides from the same weights and batches:
  * the first step's gradients agree within rtol 1e-4 (floor 1e-5 x
    the tensor's largest magnitude, as in test_torch_losses.py);
  * Adam's first and second moments agree within rtol 1e-4 after each
    step (same floor);
  * each step moves every parameter by the same amount within 0.05 x
    lr wherever that step's JAX gradient exceeds 1e-6 (Adam normalizes
    an element's step to about lr, so this is a 5 % bound on it);
  * ``grad_norm``, the loss and ``nonfinite`` are the JAX step's.
The clip, the learning rate, the nonfinite flag and the IMPACT target
refresh have cases of their own.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.models import TPUModel
from handyrl_tpu.ops import update as jupdate
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.losses import compute_loss as jax_compute_loss
from handyrl_tpu_torch.models.convert import state_to_flax
from handyrl_tpu_torch.ops import update as tupdate
from handyrl_tpu_torch.ops.losses import LossConfig
from handyrl_tpu_torch.utils.tree import flatten_params
from test_torch_losses import CASES, assert_close, case_batch
from torchfix import loss_cfg, one_torch_thread, to_torch_batch, twin_nets  # noqa: F401

LR = 1e-3
STEPS = 3


def _adam_state(opt_state):
    """optax ScaleByAdamState inside the injected chain."""
    for sub in opt_state.inner_state:
        if hasattr(sub, "mu"):
            return sub
    raise AssertionError("no Adam state in the optax chain")


def _torch_moments(step, net):
    opt = step.optimizer
    by_name = dict(net.named_parameters())
    mu = state_to_flax({n: opt.state[p]["exp_avg"]
                        for n, p in by_name.items()}, net)
    nu = state_to_flax({n: opt.state[p]["exp_avg_sq"]
                        for n, p in by_name.items()}, net)
    return flatten_params(mu), flatten_params(nu)


@pytest.mark.parametrize("name", ["ttt-td", "geese-td", "ttt-impact"])
def test_three_steps_match_make_update_step(name):
    env_name, overrides = CASES[name]
    raw = loss_cfg(**overrides)
    impact = raw.get("update_algorithm") == "impact"
    batches = [case_batch(env_name, raw, seed=s) for s in range(STEPS)]
    flax_net, net, params = twin_nets(env_name, seed=0)
    _, target_net, tparams = twin_nets(env_name, seed=1)

    jcfg = JaxLossConfig.from_config(raw)
    jmodel = TPUModel(flax_net)
    jopt = jupdate.make_optimizer(1.0)
    jstate = jupdate.set_learning_rate(jopt.init(params), LR)
    jstep = jupdate.make_update_step(jmodel, jcfg, jopt, "float32")
    japply = jupdate.make_apply_fn(jmodel, "float32")

    opt = tupdate.make_optimizer(net.parameters(), 1.0)
    tupdate.set_learning_rate(opt, LR)
    assert all(g["lr"] == LR for g in opt.param_groups)
    step = tupdate.UpdateStep(net, LossConfig.from_config(raw), opt,
                              "float32",
                              target_module=target_net if impact else None)

    jparams = params
    for k, batch in enumerate(batches):
        jb = jax.tree.map(jnp.asarray, batch)

        def jloss(p):
            losses, _ = jax_compute_loss(
                japply, p, jb, None, jcfg,
                target_params=tparams if impact else None)
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
        if impact:
            jparams, jstate, jm, tparams = jstep(jparams, jstate, jb,
                                                 tparams)
        else:
            jparams, jstate, jm = jstep(jparams, jstate, jb)
        for key in ("total", "grad_norm", "dcnt", "nonfinite"):
            assert_close(metrics[key], jm[key], f"step {k}: {key}")

        jmu = flatten_params(_adam_state(jstate).mu)
        jnu = flatten_params(_adam_state(jstate).nu)
        tmu, tnu = _torch_moments(step, net)
        after = flatten_params(state_to_flax(net.state_dict(), net))
        jafter = flatten_params(jparams)
        for path in jmu:
            assert_close(tmu[path], jmu[path], f"step {k}: mu {path}")
            assert_close(tnu[path], jnu[path], f"step {k}: nu {path}")
            moved = np.abs(jgrad[path]) > 1e-6
            tdelta = (after[path] - before[path])[moved]
            jdelta = (np.asarray(jafter[path]) - before[path])[moved]
            np.testing.assert_allclose(tdelta, jdelta, rtol=0,
                                       atol=0.05 * LR,
                                       err_msg=f"step {k}: delta {path}")
        if impact:
            tflat = flatten_params(state_to_flax(target_net.state_dict(),
                                                 target_net))
            for path, value in flatten_params(tparams).items():
                assert_close(tflat[path], value, f"step {k}: target {path}")
    assert float(metrics["grad_norm"]) > tupdate.GRAD_CLIP_NORM


@pytest.mark.parametrize("norm", [2.0, 8.0])
def test_clip_scales_only_above_four(norm, monkeypatch):
    """optax clip_by_global_norm: grads scale by 4/norm only where the
    norm is at least 4.0; the reported grad_norm is the raw one."""
    net = torch.nn.Linear(3, 2, bias=False)
    opt = tupdate.make_optimizer(net.parameters(), 1.0)
    step = tupdate.UpdateStep(net, LossConfig.from_config(loss_cfg()),
                              opt, "float32")
    raw = torch.full((2, 3), norm / 6 ** 0.5)

    def fake_loss(batch):
        net.weight.grad = raw.clone()
        zero = torch.zeros(())
        return {"total": zero}, zero

    monkeypatch.setattr(step, "loss_and_grads", fake_loss)
    w_before = net.weight.detach().clone()
    metrics = step({})
    assert float(metrics["grad_norm"]) == pytest.approx(norm, rel=1e-6)
    clipped = raw * min(1.0, tupdate.GRAD_CLIP_NORM / norm)
    # Adam's first moment after one step is (1 - b1) x (the clipped
    # grad + the L2 term on the weights before the step)
    got = opt.state[net.weight]["exp_avg"] / 0.1
    want = clipped + tupdate.WEIGHT_DECAY * w_before
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def test_nonfinite_step_is_flagged_and_not_skipped():
    raw = loss_cfg()
    batch = case_batch("TicTacToe", raw)
    batch["selected_prob"] = batch["selected_prob"].copy()
    batch["selected_prob"][0, 0, 0, 0] = np.nan
    flax_net, net, params = twin_nets("TicTacToe")
    opt = tupdate.make_optimizer(net.parameters(), LR)
    step = tupdate.UpdateStep(net, LossConfig.from_config(raw), opt)
    metrics = step(to_torch_batch(batch))
    jopt = jupdate.make_optimizer(LR)
    jstep = jupdate.make_update_step(
        TPUModel(flax_net), JaxLossConfig.from_config(raw), jopt,
        "float32")
    _, _, jm = jstep(params, jopt.init(params),
                     jax.tree.map(jnp.asarray, batch))
    assert float(metrics["nonfinite"]) == float(jm["nonfinite"]) == 1.0
    # like the JAX step, the update is applied anyway
    assert not all(torch.isfinite(p).all() for p in net.parameters())


@pytest.mark.parametrize("interval,tau", [(3, 0.0), (0, 0.25), (2, 0.5),
                                          (0, 0.0)])
def test_refresh_target_matches_jax(interval, tau):
    raw = loss_cfg(update_algorithm="impact",
                   target_update_interval=interval, target_update_tau=tau)
    _, net, params = twin_nets("TicTacToe", seed=0)
    _, target, tparams = twin_nets("TicTacToe", seed=1)
    jcfg, tcfg = JaxLossConfig.from_config(raw), LossConfig.from_config(raw)
    for count in range(1, 5):
        tparams = jupdate.refresh_target(
            params, tparams, types.SimpleNamespace(count=jnp.asarray(count)),
            jcfg)
        tupdate.refresh_target(net, target, count, tcfg)
        got = flatten_params(state_to_flax(target.state_dict(), target))
        for path, value in flatten_params(tparams).items():
            np.testing.assert_allclose(got[path], np.asarray(value),
                                       rtol=0, atol=1e-7)


def test_bf16_forward_keeps_float32_outputs_and_state():
    raw = loss_cfg()
    batch = to_torch_batch(case_batch("TicTacToe", raw))
    _, net, _ = twin_nets("TicTacToe")
    out = tupdate.make_apply_fn(net, "bfloat16")(
        batch["observation"].reshape(-1, 3, 3, 3))
    assert all(v.dtype == torch.float32 for v in out.values())
    opt = tupdate.make_optimizer(net.parameters(), LR)
    metrics = tupdate.UpdateStep(net, LossConfig.from_config(raw), opt,
                                 "bfloat16")(batch)
    assert float(metrics["nonfinite"]) == 0.0
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(s["exp_avg"].dtype == torch.float32
               for s in opt.state.values())
    with pytest.raises(ValueError, match="compute_dtype"):
        tupdate.make_apply_fn(net, "float16")
