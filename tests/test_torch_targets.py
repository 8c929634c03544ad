"""The port's target estimators against the JAX package's.

Every algorithm of ``handyrl_tpu.ops.targets`` and its port run on the
same seeded float32 ``(B, T, P, 1)`` inputs; outputs agree to 1e-6
(float32 arithmetic in the same order, the scan unrolled as a loop).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.ops import targets as jt
from handyrl_tpu_torch.ops import targets as tt
from torchfix import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-6
B, T, P = 3, 7, 2


def _inputs(seed, steps=T):
    rng = np.random.default_rng(seed)
    shape = (B, steps, P, 1)
    return {
        "values": rng.uniform(-1, 1, shape).astype(np.float32),
        "returns": rng.uniform(-1, 1, shape).astype(np.float32),
        "rewards": rng.uniform(-0.5, 0.5, shape).astype(np.float32),
        "rhos": rng.uniform(0.2, 1.5, shape).astype(np.float32),
        "cs": rng.uniform(0.2, 1.5, shape).astype(np.float32),
        "masks": (rng.random(shape) < 0.7).astype(np.float32),
    }


def _both(fn_name, *args):
    def conv(to):
        return [to(a) if isinstance(a, np.ndarray) else a for a in args]

    jout = getattr(jt, fn_name)(*conv(jnp.asarray))
    tout = getattr(tt, fn_name)(*conv(torch.from_numpy))
    return [np.asarray(a) for a in jout], [a.numpy() for a in tout]


def _close(jout, tout):
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


@pytest.mark.parametrize("algorithm", ["MC", "TD", "UPGO", "VTRACE",
                                       "IMPACT"])
@pytest.mark.parametrize("lmb,gamma", [(0.7, 1.0), (0.0, 0.8),
                                       (1.0, 0.95), (0.3, 0.5)])
@pytest.mark.parametrize("with_rewards", [True, False])
def test_compute_target_matches_jax(algorithm, lmb, gamma, with_rewards):
    x = _inputs(seed=len(algorithm) * 100 + int(lmb * 10))
    rewards = x["rewards"] if with_rewards else None
    jout = jt.compute_target(
        algorithm, jnp.asarray(x["values"]), jnp.asarray(x["returns"]),
        None if rewards is None else jnp.asarray(rewards), lmb, gamma,
        jnp.asarray(x["rhos"]), jnp.asarray(x["cs"]),
        jnp.asarray(x["masks"]))
    tout = tt.compute_target(
        algorithm, torch.from_numpy(x["values"]),
        torch.from_numpy(x["returns"]),
        None if rewards is None else torch.from_numpy(rewards), lmb, gamma,
        torch.from_numpy(x["rhos"]), torch.from_numpy(x["cs"]),
        torch.from_numpy(x["masks"]))
    _close([np.asarray(a) for a in jout], [a.numpy() for a in tout])


@pytest.mark.parametrize("fn_name", ["temporal_difference", "upgo"])
@pytest.mark.parametrize("steps", [1, 2, T])
def test_recursions_with_explicit_lambda(fn_name, steps):
    x = _inputs(seed=steps, steps=steps)
    lam = np.random.default_rng(9).uniform(0, 1, x["values"].shape
                                           ).astype(np.float32)
    _close(*_both(fn_name, x["values"], x["returns"], x["rewards"], lam,
                  0.9))


@pytest.mark.parametrize("fn_name", ["vtrace", "impact"])
@pytest.mark.parametrize("clip", [0.5, 1.0, 2.0])
def test_vtrace_with_non_unit_clips(fn_name, clip):
    x = _inputs(seed=int(clip * 10))
    rhos = np.clip(x["rhos"], 0, clip)
    cs = np.clip(x["cs"], 0, clip / 2)
    lam = np.full_like(x["values"], 0.8)
    _close(*_both(fn_name, x["values"], x["returns"], x["rewards"], lam,
                  0.9, rhos, cs))


def test_no_baseline_falls_back_to_returns():
    x = _inputs(seed=3)
    out = tt.compute_target("TD", None, torch.from_numpy(x["returns"]),
                            None, 0.7, 1.0, None, None, None)
    assert all(np.array_equal(o.numpy(), x["returns"]) for o in out)
    with pytest.raises(ValueError, match="unknown target"):
        tt.compute_target("BOGUS", torch.zeros(1, 2, 1, 1),
                          torch.zeros(1, 2, 1, 1), None, 0.7, 1.0,
                          None, None, torch.ones(1, 2, 1, 1))
