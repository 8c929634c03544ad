"""Checkpoints of the JAX package through the port's ``--eval`` path.

A checkpoint written by ``handyrl_tpu.durability.write_checksummed``
(pickle + sha256 footer) from Flax params loads through the port's
``load_model`` and gives the JAX ``load_model``'s outputs within
``atol=1e-5`` (the forward tolerance of test_torch_models.py).  The
full-width GeeseNet is what ``HungryGeese``'s ``net()`` returns, so
these run at 32 filters x 12 blocks.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from handyrl_tpu.durability import read_verified as jax_read_verified
from handyrl_tpu.durability import write_checksummed as jax_write_checksummed
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.evaluation import load_model as jax_load_model
from handyrl_tpu.models import TPUModel
from handyrl_tpu.utils.tree import flatten_params
from handyrl_tpu_torch.durability import (
    CorruptCheckpointError,
    read_verified,
    write_checksummed,
)
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import (
    Evaluator,
    ResultTable,
    _seat_plan,
    eval_main,
    evaluate_mp,
    load_model,
)
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models.geese_net import GeeseNet
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5


@pytest.fixture(scope="module")
def flax_params():
    env = jax_make_env({"env": "HungryGeese"})
    env.reset()
    model = TPUModel(env.net())
    model.init_params(env.observation(0), seed=17)
    return model.params  # jax.Array leaves, straight off the device


def _batch(n=4, seed=0):
    random.seed(seed)
    env = make_env({"env": "HungryGeese"})
    obs = []
    for _ in range(n):
        env.reset()
        env.step({p: random.randrange(4) for p in env.turns()})
        obs.append(env.observation(0))
    return np.stack(obs)


def _assert_same_outputs(path):
    ours = load_model(path, make_env({"env": "HungryGeese"}), device="cpu")
    theirs = jax_load_model(path, jax_make_env({"env": "HungryGeese"}))
    batch = _batch()
    out = ours.inference_batch(batch)
    ref = theirs.inference_batch(jnp.asarray(batch))
    for key in ("policy", "value"):
        np.testing.assert_allclose(out[key], np.asarray(ref[key]),
                                   rtol=0, atol=ATOL)


def test_jax_checkpoint_loads_with_the_jax_outputs(tmp_path, flax_params):
    """The learner's format: numpy leaves (its snapshots convert them
    on the host) in plain dicts, plus steps and epoch."""
    path = str(tmp_path / "1.ckpt")
    state = {"params": jax.tree.map(np.asarray, flax_params), "steps": 7,
             "epoch": 1}
    jax_write_checksummed(path, state)
    _assert_same_outputs(path)
    assert read_verified(path)["steps"] == 7


def test_checkpoint_with_device_array_leaves_loads_without_jax(
        tmp_path, flax_params):
    """A params tree pickled straight off the device holds jax.Array
    leaves; the port's reader resolves them to numpy."""
    path = str(tmp_path / "dev.ckpt")
    jax_write_checksummed(path, {"params": flax_params, "steps": 0,
                                 "epoch": 0})
    state = read_verified(path)
    leaves = jax.tree.leaves(state["params"])
    assert leaves and all(type(v) is np.ndarray for v in leaves)
    _assert_same_outputs(path)


def test_npz_export_loads_with_the_jax_outputs(tmp_path, flax_params):
    path = str(tmp_path / "model.npz")
    np.savez(path, **flatten_params(jax.tree.map(np.asarray, flax_params)))
    _assert_same_outputs(path)


def test_checkpoint_format_round_trips_between_packages(tmp_path):
    ours = str(tmp_path / "ours.ckpt")
    state = {"params": {"a": np.arange(3.0)}, "epoch": 2}
    digest = write_checksummed(ours, state)
    assert len(digest) == 64
    np.testing.assert_array_equal(jax_read_verified(ours)["params"]["a"],
                                  state["params"]["a"])
    assert read_verified(ours, expect_digest=digest)["epoch"] == 2
    with pytest.raises(CorruptCheckpointError, match="manifest digest"):
        read_verified(ours, expect_digest="0" * 64)


def test_corrupt_and_empty_checkpoints_raise(tmp_path):
    path = str(tmp_path / "c.ckpt")
    write_checksummed(path, {"params": {"w": np.ones(64)}})
    with open(path, "r+b") as f:
        f.seek(40)
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CorruptCheckpointError, match="checksum footer"):
        read_verified(path)
    empty = str(tmp_path / "e.ckpt")
    open(empty, "wb").close()
    with pytest.raises(CorruptCheckpointError, match="zero-length"):
        read_verified(empty)


def test_eval_main_plays_hungry_geese_against_random(tmp_path, flax_params,
                                                     capsys):
    path = str(tmp_path / "latest.ckpt")
    write_checksummed(path, {"params": jax.tree.map(np.asarray,
                                                    flax_params)})
    args = {"env_args": {"env": "HungryGeese"}}
    table = eval_main(args, [path, "4", "1"], device="cpu")
    games = sum(table.overall[0].values())
    assert games == 4
    assert "agent 0: win rate" in capsys.readouterr().out


def test_evaluate_mp_children_play_on_the_cpu(tmp_path, flax_params,
                                              monkeypatch):
    """Two spawned children rebuild the pickled model on the CPU."""
    from handyrl_tpu_torch.agent import Agent, RandomAgent

    monkeypatch.setenv("OMP_NUM_THREADS", CHILD_ENV["OMP_NUM_THREADS"])
    path = str(tmp_path / "m.ckpt")
    write_checksummed(path, {"params": jax.tree.map(np.asarray,
                                                    flax_params)})
    env = make_env({"env": "HungryGeese"})
    agents = [Agent(load_model(path, env, device="cpu"))] + [
        RandomAgent() for _ in range(3)]
    table = evaluate_mp(env, agents, None, {"env": "HungryGeese"},
                        {"default": {}}, num_process=2, num_games=4,
                        seed=5)
    assert sum(table.overall[0].values()) == 4


def test_seat_plan_and_result_table():
    plan = list(_seat_plan(2, 4, "p"))
    assert [ids for ids, _ in plan] == [[0, 1], [0, 1], [1, 0], [1, 0]]
    assert plan[0][1] == "p_first" and plan[-1][1] == "p_second"
    table = ResultTable(2)
    table.add([0, 1], [0, 1], "p_first", {0: 1, 1: -1})
    table.add([0, 1], [1, 0], "p_second", {0: 0, 1: 0})
    assert table.overall[0] == {1: 1, 0: 1}


def test_onnx_models_are_not_ported_yet(tmp_path):
    """``.onnx`` models load since the interop slice: ``load_model``
    returns the numpy runner's ``OnnxModel``, whose outputs equal the
    port's forward of the exported net (1e-5, exact float32 both)."""
    from handyrl_tpu_torch.interop import OnnxModel, export_onnx

    env = make_env({"env": "HungryGeese"})
    env.reset()
    model = TorchModel(GeeseNet(filters=8, blocks=2), device="cpu")
    model.init_params(seed=2)
    obs = env.observation(0)
    path = os.path.join(tmp_path, "m.onnx")
    export_onnx(model, obs, path)
    loaded = load_model(path, env, device="cpu")
    assert isinstance(loaded, OnnxModel)
    assert loaded.init_hidden() is None
    out, ref = loaded.inference(obs), model.inference(obs)
    assert out["hidden"] is None
    for key in ("policy", "value"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-5,
                                   atol=1e-5)


def test_online_evaluator_plays_the_model_against_the_opponent():
    random.seed(3)
    model = TorchModel(GeeseNet(filters=8, blocks=2), device="cpu")
    model.init_params(seed=0)
    env = make_env({"env": "HungryGeese"})
    evaluator = Evaluator(env, {"observation": False,
                                "eval": {"opponent": ["rulebase"]}})
    job = {"role": "e", "player": [0], "model_id": {0: 1}}
    result = evaluator.execute({0: model, 1: None, 2: None, 3: None}, job)
    assert result["opponent"] == "rulebase"
    assert result["args"] is job
    assert set(result["result"]) == {0, 1, 2, 3}
