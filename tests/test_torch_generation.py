"""The port's rollout engines against the JAX package's, step by step.

Both engines consume Python's ``random`` in the same order (env
resets, food spawns, action draws), so with the same seed and the same
weights they must play the same games: identical actions and
observations at every step, and recorded behavior probabilities and
values within ``1e-5`` (the forward tolerance of
test_torch_models.py, carried through a float32 softmax).  The
recurrent GeisterNet plays through both engines with its hidden state
carried, with and without ``observation``.
"""

import bz2
import pickle
import random

import jax
import numpy as np
import pytest

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import Generator as JaxGenerator
from handyrl_tpu.generation import RolloutPool as JaxRolloutPool
from handyrl_tpu.models import TPUModel
from handyrl_tpu.models.geese_net import GeeseNet as FlaxGeeseNet
from handyrl_tpu.models.geister_net import GeisterNet as FlaxGeisterNet
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import Generator, RolloutPool
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models.geese_net import GeeseNet
from handyrl_tpu_torch.models.geister_net import GeisterNet
from torchfix import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
ARGS = {"observation": False, "gamma": 0.8, "compress_steps": 4,
        "eval": {"opponent": ["random"]}}


def _models(env_name, flax_net, torch_net, seed=0):
    env = jax_make_env({"env": env_name})
    env.reset()
    jax_model = TPUModel(flax_net)
    jax_model.init_params(env.observation(env.players()[0]), seed=seed)
    params = jax.tree.map(np.asarray, jax_model.params)
    return jax_model, TorchModel.from_flax(torch_net, params, device="cpu")


def _run_pool(pool_cls, env_factory, model, k, n, seed,
              env_args=None, args=ARGS):
    random.seed(seed)
    envs = [env_factory(env_args or {"env": "HungryGeese"})
            for _ in range(k)]
    pool = pool_cls(envs, args)
    players = envs[0].players()
    job = {"role": "g", "player": players,
           "model_id": {p: 1 for p in players}}
    models = {p: model for p in players}
    while pool.has_free_slot():
        pool.assign(job, models)
    episodes = []
    while len(episodes) < n:
        for verb, payload in pool.step():
            assert verb == "episode" and payload is not None
            episodes.append(payload)
            pool.assign(job, models)
    return episodes


def _moments(episode):
    return [m for blob in episode["moment"]
            for m in pickle.loads(bz2.decompress(blob))]


def _assert_same_episodes(ours, theirs):
    assert len(ours) == len(theirs)
    steps = 0
    for a, b in zip(ours, theirs):
        assert a["steps"] == b["steps"]
        assert a["outcome"] == b["outcome"]
        assert a["args"] == b["args"]
        for ma, mb in zip(_moments(a), _moments(b)):
            assert ma["turn"] == mb["turn"]
            assert ma["action"] == mb["action"]
            assert ma["reward"] == mb["reward"]
            for p, obs in ma["observation"].items():
                if obs is None:
                    assert mb["observation"][p] is None
                    continue
                for x, y in zip(jax.tree.leaves(obs),
                                jax.tree.leaves(mb["observation"][p]),
                                strict=True):
                    np.testing.assert_array_equal(x, y)
                np.testing.assert_allclose(
                    ma["selected_prob"][p], mb["selected_prob"][p],
                    rtol=0, atol=TOL)
                np.testing.assert_allclose(ma["value"][p], mb["value"][p],
                                           rtol=0, atol=TOL)
                np.testing.assert_array_equal(ma["action_mask"][p],
                                              mb["action_mask"][p])
            for p, ret in ma["return"].items():
                np.testing.assert_allclose(ret, mb["return"][p], rtol=1e-12)
            steps += 1
    return steps


def test_rollout_pool_plays_the_jax_pools_games():
    jax_model, torch_model = _models(
        "HungryGeese", FlaxGeeseNet(filters=8, blocks=2),
        GeeseNet(filters=8, blocks=2), seed=2)
    ours = _run_pool(RolloutPool, make_env, torch_model, k=4, n=6, seed=21)
    theirs = _run_pool(JaxRolloutPool, jax_make_env, jax_model, k=4, n=6,
                       seed=21)
    assert _assert_same_episodes(ours, theirs) > 20
    for ep in ours:
        assert ep["final_model_epoch"] == ep["gen_model_epoch"] == 1


def test_generator_plays_the_jax_generators_games():
    jax_model, torch_model = _models(
        "HungryGeese", FlaxGeeseNet(filters=8, blocks=2),
        GeeseNet(filters=8, blocks=2), seed=3)
    job = {"player": [0, 1, 2, 3], "model_id": {p: 1 for p in range(4)}}
    episodes = []
    for env_factory, gen_cls, model in (
            (make_env, Generator, torch_model),
            (jax_make_env, JaxGenerator, jax_model)):
        random.seed(31)
        env = env_factory({"env": "HungryGeese"})
        gen = gen_cls(env, ARGS)
        episodes.append([gen.execute({p: model for p in range(4)}, job)
                         for _ in range(2)])
    assert _assert_same_episodes(*episodes) > 5


# the recurrent net, narrowed: the pool carries a (K*P, ...) hidden
# state, advances only the rows that observed, zeroes a slot's rows when
# a new episode enters it; the Generator carries one per seat
RECURRENT = {
    "Geister": ({"env": "Geister"}, FlaxGeisterNet, GeisterNet,
                {"filters": 8, "drc_layers": 2, "drc_repeats": 2}),
}


@pytest.mark.parametrize("observation", [False, True])
@pytest.mark.parametrize("name", sorted(RECURRENT))
def test_recurrent_rollout_pool_plays_the_jax_pools_games(name,
                                                          observation):
    env_args, flax_cls, torch_cls, kwargs = RECURRENT[name]
    jax_model, torch_model = _models(env_args["env"], flax_cls(**kwargs),
                                     torch_cls(**kwargs), seed=4)
    args = dict(ARGS, observation=observation)
    runs = [_run_pool(pool_cls, factory, model, k=3, n=4, seed=41,
                      env_args=env_args, args=args)
            for pool_cls, factory, model in (
                (RolloutPool, make_env, torch_model),
                (JaxRolloutPool, jax_make_env, jax_model))]
    assert _assert_same_episodes(*runs) > 40


@pytest.mark.parametrize("name", sorted(RECURRENT))
def test_recurrent_generator_plays_the_jax_generators_games(name):
    env_args, flax_cls, torch_cls, kwargs = RECURRENT[name]
    jax_model, torch_model = _models(env_args["env"], flax_cls(**kwargs),
                                     torch_cls(**kwargs), seed=5)
    episodes = []
    for env_factory, gen_cls, model in (
            (make_env, Generator, torch_model),
            (jax_make_env, JaxGenerator, jax_model)):
        random.seed(51)
        env = env_factory(env_args)
        players = env.players()
        job = {"player": players, "model_id": {p: 1 for p in players}}
        gen = gen_cls(env, ARGS)
        episodes.append([gen.execute({p: model for p in players}, job)
                         for _ in range(2)])
    assert _assert_same_episodes(*episodes) > 20
