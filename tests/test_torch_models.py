"""The port's nets against their Flax twins, on converted weights.

Same seeded Flax ``init``, the same observations (real env states made
from a fixed ``random`` seed), through ``module.apply`` and through the
port's module after ``convert.from_flax``.  Tolerance: ``atol=1e-5`` in
float32 on the CPU — the two frameworks sum the convolutions and the
GroupNorm statistics in different orders, which moves the last bits of
logits of magnitude ~1-10 (measured max 4e-6 at full width), and
nothing larger is expected from the same arithmetic.
"""

import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.models.geese_net import GeeseNet as FlaxGeeseNet
from handyrl_tpu.models.tictactoe_net import TicTacToeNet as FlaxTicTacToeNet
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.models.blocks import pick_num_groups
from handyrl_tpu_torch.models.convert import from_flax, random_flax_params
from handyrl_tpu_torch.models.geese_net import GeeseNet
from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet
from torchfix import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5

NETS = {
    "geese_8x2": (FlaxGeeseNet, GeeseNet, {"filters": 8, "blocks": 2},
                  "HungryGeese"),
    "geese_32x12": (FlaxGeeseNet, GeeseNet, {}, "HungryGeese"),
    "tictactoe": (FlaxTicTacToeNet, TicTacToeNet, {}, "TicTacToe"),
}


def _observations(env_name, batch, seed=0):
    """``batch`` real observations: seeded resets and random steps."""
    random.seed(seed)
    env = make_env({"env": env_name})
    obs = []
    for i in range(batch):
        env.reset()
        for _ in range(3 + i):
            if env.terminal():
                break
            env.step({p: random.choice(env.legal_actions(p))
                      for p in env.turns()})
        obs.append(env.observation(env.players()[i % len(env.players())]))
    return np.stack(obs)


def _flax_params(flax_cls, kwargs, obs, seed):
    init = jax.jit(flax_cls(**kwargs).init)
    params = init(jax.random.PRNGKey(seed), obs)["params"]
    return jax.tree.map(np.asarray, params)


def _flax_apply(flax_cls, kwargs, params, obs):
    return jax.jit(flax_cls(**kwargs).apply)({"params": params}, obs)


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_matches_flax_on_converted_weights(name):
    flax_cls, torch_cls, kwargs, env_name = NETS[name]
    obs = _observations(env_name, batch=2)
    params = _flax_params(flax_cls, kwargs, obs, seed=3)
    ref = _flax_apply(flax_cls, kwargs, params, obs)

    module = torch_cls(**kwargs)
    module.load_state_dict(from_flax(params, module))
    with torch.inference_mode():
        out = module(torch.from_numpy(obs))
    for key in ("policy", "value"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(NETS))
def test_numpy_param_tree_matches_flax_init_tree(name):
    """The seeded numpy tree (what the chip smoke uses without JAX)
    yields exactly the tree, shapes and dtypes of Flax ``init``."""
    flax_cls, torch_cls, kwargs, env_name = NETS[name]
    obs = _observations(env_name, batch=1)
    ref = jax.eval_shape(flax_cls(**kwargs).init, jax.random.PRNGKey(0),
                         obs)["params"]
    built = random_flax_params(torch_cls(**kwargs), seed=5)
    assert jax.tree.structure(built) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(built), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # same seed -> same values; another seed -> other values
    again = random_flax_params(torch_cls(**kwargs), seed=5)
    other = random_flax_params(torch_cls(**kwargs), seed=6)
    for a, b, c in zip(jax.tree.leaves(built), jax.tree.leaves(again),
                       jax.tree.leaves(other)):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


def test_numpy_built_params_give_the_flax_forward():
    """A numpy-built tree drives the Flax net and the port's net to the
    same outputs (scale/bias drawn around 1/0, so a swap would show)."""
    obs = _observations("HungryGeese", batch=2, seed=1)
    module = GeeseNet(filters=8, blocks=2)
    params = random_flax_params(module, seed=2)
    ref = _flax_apply(FlaxGeeseNet, {"filters": 8, "blocks": 2}, params,
                      obs)
    module.load_state_dict(from_flax(params, module))
    with torch.inference_mode():
        out = module(torch.from_numpy(obs))
    for key in ("policy", "value"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=ATOL)


def test_converter_raises_on_missing_or_extra_key():
    module = GeeseNet(filters=8, blocks=2)
    params = random_flax_params(module, seed=0)

    missing = {k: v for k, v in params.items() if k != "Dense_1"}
    with pytest.raises(KeyError, match="Dense_1/kernel"):
        from_flax(missing, module)

    extra = dict(params, Dense_2={"kernel": np.zeros((8, 1), np.float32)})
    with pytest.raises(KeyError, match="Dense_2/kernel"):
        from_flax(extra, module)

    deeper = random_flax_params(GeeseNet(filters=8, blocks=3), seed=0)
    with pytest.raises(KeyError, match="TorusConv_3"):
        from_flax(deeper, module)


def test_converter_raises_on_shape_mismatch():
    module = GeeseNet(filters=8, blocks=2)
    wide = random_flax_params(GeeseNet(filters=16, blocks=2), seed=0)
    with pytest.raises(ValueError, match="does not match"):
        from_flax(wide, module)


def test_group_count_and_epsilon_follow_flax():
    assert pick_num_groups(32) == 8
    assert pick_num_groups(12) == 6
    assert pick_num_groups(7) == 7
    norm = GeeseNet().stem.norm
    assert norm.num_groups == 8 and norm.eps == 1e-6
