"""The port's ``compute_loss`` against the JAX package's.

Same converted weights, same batch (the port's ``make_batch``, proven
equal to JAX's in test_torch_batch.py): every loss component, ``dcnt``,
``clip_frac`` and every parameter's gradient (``jax.grad`` against
``backward()``) agree within rtol 1e-4.  An absolute floor of 1e-5
times the largest magnitude of the compared tensor covers elements
that cancel to near zero, where float32 summation order dominates.
TicTacToe covers turn mode (P_in = 1, two-player value
symmetrization), narrow GeeseNet seat mode (one seat per row), both
under the standard and the IMPACT update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.models import TPUModel
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.losses import compute_loss as jax_compute_loss
from handyrl_tpu.ops.update import make_apply_fn as jax_apply_fn
from handyrl_tpu_torch.batch import make_batch
from handyrl_tpu_torch.models.convert import state_to_flax
from handyrl_tpu_torch.ops.losses import LossConfig, compute_loss
from handyrl_tpu_torch.ops.update import make_apply_fn
from handyrl_tpu_torch.utils.tree import flatten_params
from torchfix import (  # noqa: F401
    draws,
    loss_cfg,
    make_episodes,
    one_torch_thread,
    to_torch_batch,
    twin_nets,
    window,
)

RTOL, FLOOR = 1e-4, 1e-5

CASES = {
    # name: (env, loss-config overrides)
    "ttt-td": ("TicTacToe", {}),
    "ttt-vtrace-upgo": ("TicTacToe", {"policy_target": "UPGO",
                                      "value_target": "VTRACE",
                                      "rho_clip": 0.8, "c_clip": 1.5}),
    "ttt-mc": ("TicTacToe", {"policy_target": "MC", "value_target": "MC"}),
    "ttt-impact": ("TicTacToe", {"update_algorithm": "impact",
                                 "policy_target": "IMPACT",
                                 "value_target": "IMPACT",
                                 "target_update_interval": 2}),
    "geese-td": ("HungryGeese", {"turn_based_training": False}),
    "geese-impact": ("HungryGeese", {"turn_based_training": False,
                                     "update_algorithm": "impact",
                                     "policy_target": "VTRACE",
                                     "value_target": "TD",
                                     "target_update_tau": 0.1}),
}


def case_batch(env_name, cfg, seed=0, n=6):
    # episodes from another net than the one trained: off-policy data,
    # so no importance ratio sits at 1 +- a rounding error, where
    # clip_frac's `rho > rho_clip` would flip on the last ulp
    cfg = dict(cfg, forward_steps=8, compress_steps=4)
    episodes, players = make_episodes(env_name, 4, seed=seed + 100)
    picks = draws(episodes, cfg, n, len(players), seed)
    return make_batch([window(episodes[i], t, cfg) for i, t, _ in picks],
                      cfg)


def assert_close(t, j, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, what
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=FLOOR * scale,
                               err_msg=what)


def both_losses(name, seed=0):
    env_name, overrides = CASES[name]
    raw = loss_cfg(**overrides)
    batch = case_batch(env_name, raw, seed=seed)
    flax_net, torch_net, params = twin_nets(env_name, seed=seed)
    impact = raw.get("update_algorithm") == "impact"
    _, torch_target, tparams = twin_nets(env_name, seed=seed + 1)

    jcfg = JaxLossConfig.from_config(raw)
    japply = jax_apply_fn(TPUModel(flax_net), "float32")
    jbatch = jax.tree.map(jnp.asarray, batch)

    def jloss(p):
        losses, dcnt = jax_compute_loss(
            japply, p, jbatch, None, jcfg,
            target_params=tparams if impact else None)
        return losses["total"], (losses, dcnt)

    jgrads, (jlosses, jdcnt) = jax.grad(jloss, has_aux=True)(params)

    tcfg = LossConfig.from_config(raw)
    tlosses, tdcnt = compute_loss(
        make_apply_fn(torch_net, "float32"), to_torch_batch(batch), None,
        tcfg, target_apply_fn=(make_apply_fn(torch_target, "float32")
                               if impact else None))
    tlosses["total"].backward()
    tgrads = state_to_flax(
        {n: p.grad for n, p in torch_net.named_parameters()}, torch_net)
    return (jlosses, jdcnt, jgrads), (tlosses, tdcnt, tgrads)


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_and_grads_match_jax(name):
    (jl, jd, jg), (tl, td, tg) = both_losses(name)
    assert sorted(jl) == sorted(tl)
    for key in jl:
        assert_close(tl[key].detach(), jl[key], f"{name}: loss {key}")
    assert float(td) == float(jd)
    jflat, tflat = flatten_params(jg), flatten_params(tg)
    assert sorted(jflat) == sorted(tflat)
    for path in jflat:
        assert_close(tflat[path], jflat[path], f"{name}: grad {path}")
    # the loss is not degenerate: real gradient everywhere
    assert all(np.abs(g).max() > 0 for g in tflat.values())


def test_turn_mode_policy_reads_only_the_acting_seat():
    """Illegal actions carry -1e32 after the mask and never win the
    softmax; the entropy stays finite."""
    raw = loss_cfg()
    batch = case_batch("TicTacToe", raw)
    _, net, _ = twin_nets("TicTacToe")
    tb = to_torch_batch(batch)
    losses, _ = compute_loss(make_apply_fn(net), tb, None,
                             LossConfig.from_config(raw))
    assert all(torch.isfinite(v) for v in losses.values())
    assert tb["observation"].shape[2] == 1  # P_in = 1 in turn mode
