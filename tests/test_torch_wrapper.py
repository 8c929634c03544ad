"""TorchModel / RandomModel against TPUModel, on the same weights.

Tolerance for the forward comparisons: ``atol=1e-5`` in float32 on the
CPU, for the reason stated in test_torch_models.py (summation order).
Pickle round trips on one device compare exactly: the same module on
the same inputs runs the same arithmetic.
"""

import pickle
import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.models import TPUModel
from handyrl_tpu.models.geese_net import GeeseNet as FlaxGeeseNet
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.models import (
    RandomModel,
    TorchModel,
    load_params,
    snapshot_params,
)
from handyrl_tpu_torch.models.geese_net import GeeseNet
from handyrl_tpu_torch.utils.tree import softmax_np
from torchfix import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5


def _geese_batch(n, seed=0):
    random.seed(seed)
    env = make_env({"env": "HungryGeese"})
    obs = []
    while len(obs) < n:
        env.reset()
        for _ in range(4):
            env.step({p: random.randrange(4) for p in env.turns()})
            if env.terminal():
                break
        obs.extend(env.observation(p) for p in env.players())
    return np.stack(obs[:n])


def _pair(seed=0):
    """A TPUModel and a CPU TorchModel holding the same weights."""
    env = make_env({"env": "HungryGeese"})
    jax_model = TPUModel(FlaxGeeseNet(filters=8, blocks=2))
    jax_model.init_params(env.observation(0), seed=seed)
    params = jax.tree.map(np.asarray, jax_model.params)
    torch_model = TorchModel.from_flax(GeeseNet(filters=8, blocks=2),
                                       params, device="cpu")
    return jax_model, torch_model


def test_inference_and_batch_match_tpumodel():
    jax_model, torch_model = _pair(seed=4)
    batch = _geese_batch(6)
    ref = jax_model.inference_batch(batch)
    out = torch_model.inference_batch(batch)
    for key in ("policy", "value"):
        assert out[key].shape == np.asarray(ref[key]).shape
        assert out[key].dtype == np.float32
        np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=ATOL)

    single = torch_model.inference(batch[3])
    ref_single = jax_model.inference(batch[3])
    assert single["policy"].shape == (4,) and single["value"].shape == (1,)
    for key in ("policy", "value"):
        np.testing.assert_allclose(single[key], ref_single[key],
                                   rtol=0, atol=ATOL)
    assert torch_model.init_hidden() is None
    assert not torch_model.is_recurrent


def test_pickle_round_trip_rebuilds_on_the_cpu():
    _, model = _pair(seed=5)
    blob = pickle.dumps(model)
    # numpy params and the module spec travel, never tensors
    assert b"torch._utils" not in blob
    clone = pickle.loads(blob)
    assert clone.device == torch.device("cpu")
    assert next(clone.module.parameters()).device.type == "cpu"
    assert clone.spec == model.spec
    batch = _geese_batch(4, seed=1)
    np.testing.assert_array_equal(clone.inference_batch(batch)["policy"],
                                  model.inference_batch(batch)["policy"])


def test_snapshot_params_round_trip_and_seeded_init():
    _, model = _pair(seed=6)
    state = load_params(snapshot_params(model.module.state_dict()))
    assert all(isinstance(v, np.ndarray) for v in state.values())
    other = TorchModel(GeeseNet(filters=8, blocks=2), device="cpu")
    other.init_params(seed=99)
    batch = _geese_batch(2, seed=2)
    assert not np.array_equal(other.inference_batch(batch)["policy"],
                              model.inference_batch(batch)["policy"])
    other.load_params(state)
    np.testing.assert_array_equal(other.inference_batch(batch)["policy"],
                                  model.inference_batch(batch)["policy"])
    # the same seed gives the same net
    a = TorchModel(GeeseNet(filters=8, blocks=2), device="cpu")
    b = TorchModel(GeeseNet(filters=8, blocks=2), device="cpu")
    a.init_params(seed=3)
    b.init_params(seed=3)
    np.testing.assert_array_equal(a.inference_batch(batch)["value"],
                                  b.inference_batch(batch)["value"])


def test_random_model_is_uniform():
    _, model = _pair()
    env = make_env({"env": "HungryGeese"})
    rnd = RandomModel(model, env.observation(0))
    out = rnd.inference(env.observation(1))
    assert set(out) == {"policy", "value"}
    np.testing.assert_array_equal(softmax_np(out["policy"]),
                                  np.full(4, 0.25, np.float32))
    batch = rnd.inference_batch(_geese_batch(5))
    assert batch["policy"].shape == (5, 4) and not batch["policy"].any()
    assert batch["value"].shape == (5, 1)


def test_default_device_is_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchModel(GeeseNet(filters=8, blocks=2))
