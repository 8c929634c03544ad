"""The port's Anakin path against the JAX package's, on the CPU.

  * the batched torch TicTacToe equals the Python env (the spec) and
    the JAX twin ``tictactoe_jax`` over every one of the 5,478
    reachable positions, exactly: cells, move count, winner, terminal,
    legal mask, acting seat, observation, outcome, and every legal
    transition's reward, done flag, observation and legal mask;
  * its two hardenings (a terminal step and an occupied cell are
    no-ops), the registry, and ``AnakinConfig`` / the engine's layout
    checks refusing what the JAX package refuses;
  * the rollout batch against JAX ``AnakinEngine._rollout`` with the
    JAX draws injected through ``rollout``'s ``actions`` seam (jax.random
    and torch streams cannot be matched), pure self-play and one frozen
    opponent: discrete fields exact, ``selected_prob`` and ``value``
    within 1e-5 (float32 forwards of two frameworks);
  * the batch semantics of ``make_batch`` on a sampled rollout,
    determinism, the carry advancing the stream, the opponent axis
    really playing the pool;
  * ``refresh_pool``: newest in, oldest out, each slot a copy that the
    next fused steps leave unchanged bit for bit;
  * one fused update against JAX ``make_update_core`` on the same
    batch, standard and IMPACT, within test_torch_update.py's bounds
    (loss metrics and Adam moments rtol 1e-4 with a floor of 1e-5 x the
    largest magnitude; each parameter's step within 0.05 x lr wherever
    the JAX step's Adam input exceeds 1e-6: a rollout batch's gradient
    norm reaches ~500, so the clip scales the raw gradient by ~1e-2 and
    the Adam input is the clipped gradient plus the L2 term, which is
    what Adam normalizes);
  * the Trainer's ``auto`` fallbacks and ``on`` errors.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.anakin import AnakinConfig as JaxAnakinConfig
from handyrl_tpu.anakin import AnakinEngine as JaxAnakinEngine
from handyrl_tpu.config import Config as JaxConfig
from handyrl_tpu.environment import make_jax_env
from handyrl_tpu.envs import tictactoe_jax as jxttt
from handyrl_tpu.models import TPUModel
from handyrl_tpu.ops import update as jupdate
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu_torch.anakin import AnakinConfig, AnakinEngine
from handyrl_tpu_torch.config import Config
from handyrl_tpu_torch.environment import (
    device_env_available,
    make_device_env,
    make_env,
)
from handyrl_tpu_torch.envs import tictactoe as pyttt
from handyrl_tpu_torch.envs import tictactoe_torch as tttt
from handyrl_tpu_torch.learner import Trainer
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models.convert import state_to_flax
from handyrl_tpu_torch.ops.losses import LossConfig
from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer
from handyrl_tpu_torch.utils.tree import flatten_params
from test_torch_losses import assert_close
from torchfix import loss_cfg, one_torch_thread, twin_nets  # noqa: F401

REACHABLE_POSITIONS = 5478
PROB_VALUE_ATOL = 1e-5
LR = 1e-3


def _clone(env):
    e = pyttt.Environment()
    e.cells = env.cells.copy()
    e.side_to_move = env.side_to_move
    e.winner = env.winner
    e.history = list(env.history)
    return e


VIEWS = ("terminal", "legal_mask", "turn", "observe", "outcome")


def _views(fns, state):
    """Every read-only view of a batched state, and the state itself."""
    out = {name: fns[name](state) for name in VIEWS}
    out.update(cells=state.cells, count=state.count, winner=state.winner)
    return out


# jitted: unjitted, each vmapped op would compile on its own
_jax_views = jax.jit(functools.partial(
    _views, {name: jax.vmap(getattr(jxttt, name)) for name in VIEWS}))


def test_env_matches_python_and_jax_envs_over_every_reachable_state():
    """Breadth-first over the whole reachable space: the Python env
    expands the spec, the torch env steps every (state, legal action)
    pair as one batch, and the JAX twin steps the same pairs."""
    step_j = jax.jit(jax.vmap(jxttt.step))
    envs = [pyttt.Environment()]
    state = tttt.init(1, "cpu")
    jstate = jax.tree.map(lambda a: a[None],
                          jxttt.init(jax.random.PRNGKey(0)))
    total = 0
    for _depth in range(10):
        if not envs:
            break
        total += len(envs)
        port = {k: v.numpy() for k, v in _views(
            {name: getattr(tttt, name) for name in VIEWS}, state).items()}
        jaxv = jax.device_get(_jax_views(jstate))
        for key in port:
            np.testing.assert_array_equal(port[key], jaxv[key], key)
        for i, e in enumerate(envs):
            assert np.array_equal(port["cells"][i], e.cells)
            assert port["count"][i] == len(e.history)
            assert bool(port["terminal"][i]) == e.terminal()
            assert (np.flatnonzero(port["legal_mask"][i]).tolist()
                    == e.legal_actions())
            assert np.array_equal(port["observe"][i], e.observation(None))
            if e.terminal():
                oc = e.outcome()
                assert port["outcome"][i].tolist() == [oc[0], oc[1]]
            else:
                assert int(port["turn"][i]) == e.turn()

        pair_idx, pair_act, children = [], [], []
        for i, e in enumerate(envs):
            if e.terminal():
                continue
            for a in e.legal_actions():
                child = _clone(e)
                child.play(a)
                pair_idx.append(i)
                pair_act.append(a)
                children.append(child)
        if not children:
            break
        idx = torch.as_tensor(pair_idx)
        parents = tttt.State(*(f[idx] for f in state))
        actions = torch.as_tensor(pair_act)
        new, obs, reward, done, legal = tttt.step(parents, actions)
        jparents = jax.tree.map(lambda a: a[np.asarray(pair_idx)], jstate)
        jout = step_j(jparents, jnp.asarray(pair_act, jnp.int32),
                      jax.random.split(jax.random.PRNGKey(0), len(pair_act)))
        for name, got, want in zip(
                ("cells", "count", "winner", "obs", "reward", "done",
                 "legal"),
                (new.cells, new.count, new.winner, obs, reward, done, legal),
                (jout[0].cells, jout[0].count, jout[0].winner) + jout[1:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          name)
        seen, keep, next_envs = set(), [], []
        for j, child in enumerate(children):
            assert bool(done[j]) == child.terminal()
            assert np.array_equal(obs[j].numpy(), child.observation(None))
            assert np.flatnonzero(legal[j].numpy()).tolist() == \
                child.legal_actions()
            oc = child.outcome() if child.terminal() else {0: 0, 1: 0}
            assert reward[j].tolist() == [oc[0], oc[1]]
            board = child.cells.tobytes()
            if board not in seen:
                seen.add(board)
                keep.append(j)
                next_envs.append(child)
        jstate = jax.tree.map(lambda a: a[np.asarray(keep)], jout[0])
        keep = torch.as_tensor(keep)
        state = tttt.State(*(f[keep] for f in new))
        envs = next_envs
    assert total == REACHABLE_POSITIONS


def test_env_hardenings_are_inert():
    """A terminal game and an occupied cell step as no-ops, with no
    reward delivered again (the JAX twin's contract)."""
    s = tttt.step(tttt.init(1, "cpu"), torch.tensor([4]))[0]
    again = tttt.step(s, torch.tensor([4]))[0]          # occupied
    assert all(torch.equal(a, b) for a, b in zip(s, again))
    term = tttt.from_board([1, 1, 1, -1, -1, 0, 0, 0, 0], device="cpu")
    assert bool(tttt.terminal(term)[0])
    t2, _, reward, done, _ = tttt.step(term, torch.tensor([5]))
    assert bool(done[0]) and reward.abs().sum() == 0
    assert all(torch.equal(a, b) for a, b in zip(term, t2))


def test_registry_exposes_the_device_twin():
    assert device_env_available({"env": "TicTacToe"})
    assert not device_env_available({"env": "HungryGeese"})
    assert make_device_env({"env": "TicTacToe"}) is tttt
    with pytest.raises(ValueError, match="device twin"):
        make_device_env({"env": "HungryGeese"})


ANAKIN_CONFIGS = [
    {}, {"mode": "on", "num_envs": 64, "opponent_pool": 3},
    {"mode": "auto", "unroll_length": 12}, {"mode": "off"},
    {"mode": "sometimes"}, {"mode": "on", "num_envs": 0}, {"nope": 1},
    {"mode": "on", "num_envs": 64, "opponent_pool": 2},
    {"mode": "on", "unroll_length": -1}, {"opponent_pool": -1},
]


@pytest.mark.parametrize("raw", ANAKIN_CONFIGS, ids=str)
def test_anakin_config_accepts_and_refuses_as_jax(raw):
    def verdict(cls):
        try:
            cfg = cls.from_config(raw)
        except ValueError as exc:
            return "refused: " + str(exc)
        return dataclasses.asdict(cfg), cfg.enabled

    assert verdict(AnakinConfig) == verdict(JaxAnakinConfig)


@pytest.mark.parametrize("updates", [0, 10])
def test_anakin_requires_step_driven_epochs(updates):
    raw = {"env_args": {"env": "TicTacToe"},
           "train_args": {"anakin": {"mode": "on"},
                          "updates_per_epoch": updates}}

    def verdict(config):
        try:
            config.from_dict(raw)
        except ValueError as exc:
            return str(exc)
        return "ok"

    assert verdict(Config) == verdict(JaxConfig)
    assert (verdict(Config) == "ok") == (updates > 0)


def _engine(num_envs=32, opponent_pool=0, seed=0, raw=None, net=None,
            **acfg):
    raw = raw or loss_cfg()
    if net is None:
        _, net, _ = twin_nets("TicTacToe", seed=seed)
    opt = make_optimizer(net.parameters(), LR)
    step = UpdateStep(net, LossConfig.from_config(raw), opt, "float32")
    cfg = AnakinConfig.from_config(dict(
        {"mode": "on", "num_envs": num_envs,
         "opponent_pool": opponent_pool}, **acfg))
    return AnakinEngine(tttt, step, cfg, seed=seed)


@pytest.mark.parametrize("overrides,unroll,match", [
    ({"turn_based_training": False}, 0, "turn_based_training"),
    ({"observation": True}, 0, "observation"),
    ({"burn_in_steps": 2}, 0, "burn_in"),
    ({}, 4, "episode-aligned"),
])
def test_engine_layout_validation_matches_jax(overrides, unroll, match):
    raw = loss_cfg(**overrides)
    flax_net, _, params = twin_nets("TicTacToe")
    acfg = {"unroll_length": unroll}
    with pytest.raises(ValueError, match=match) as port:
        _engine(8, raw=raw, **acfg)
    with pytest.raises(ValueError, match=match) as ref:
        JaxAnakinEngine(
            make_jax_env({"env": "TicTacToe"}), TPUModel(flax_net, params),
            JaxLossConfig.from_config(raw), jupdate.make_optimizer(LR),
            JaxAnakinConfig.from_config(dict(
                {"mode": "on", "num_envs": 8}, **acfg)))
    assert str(port.value) == str(ref.value)


def test_engine_refuses_a_recurrent_net():
    from handyrl_tpu_torch.models.geister_net import GeisterNet

    with pytest.raises(ValueError, match="feed-forward"):
        _engine(8, net=GeisterNet(filters=8, drc_layers=1, drc_repeats=1))


def _jax_rollout(num_envs, opponent_pool, seed=0):
    """The JAX engine's segment 0 on twin_nets(seed) weights (and
    twin_nets(seed + 7) as every frozen opponent)."""
    flax_net, _, params = twin_nets("TicTacToe", seed=seed)
    engine = JaxAnakinEngine(
        make_jax_env({"env": "TicTacToe"}), TPUModel(flax_net, params),
        JaxLossConfig.from_config(loss_cfg()), jupdate.make_optimizer(LR),
        JaxAnakinConfig.from_config(
            {"mode": "on", "num_envs": num_envs,
             "opponent_pool": opponent_pool}), seed=seed)
    pool = ()
    if opponent_pool:
        _, _, opp = twin_nets("TicTacToe", seed=seed + 7)
        pool = jax.tree.map(lambda a: jnp.stack([a] * opponent_pool), opp)
    batch, _, frames = jax.jit(engine._rollout)(
        jax.tree.map(jnp.asarray, params), pool, engine.init_carry(0))
    return jax.device_get(batch), int(frames)


def _actions(jbatch):
    """The JAX rollout's draws as the (T, N) actions seam."""
    return torch.from_numpy(
        np.ascontiguousarray(jbatch["action"][:, :, 0, 0].T))


DISCRETE = ("observation", "action", "action_mask", "episode_mask",
            "turn_mask", "observation_mask", "outcome", "progress",
            "reward", "return")


@pytest.mark.parametrize("opponent_pool", [0, 1])
def test_rollout_matches_the_jax_rollout_with_its_draws(opponent_pool):
    jbatch, jframes = _jax_rollout(64, opponent_pool)
    engine = _engine(64, opponent_pool)
    pool = []
    if opponent_pool:
        _, opp, _ = twin_nets("TicTacToe", seed=7)
        pool = engine.init_pool(opp)
    with torch.no_grad():
        batch, carry, frames = engine.rollout(
            engine.update_step.module, pool, engine.init_carry(0),
            _actions(jbatch))
    assert int(frames) == jframes and carry["seg"] == 1
    assert set(batch) == set(jbatch)
    for key in batch:
        got, want = batch[key].numpy(), np.asarray(jbatch[key])
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if key in DISCRETE:
            np.testing.assert_array_equal(got, want, key)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=PROB_VALUE_ATOL, err_msg=key)


def _sampled(engine, carry, pool=()):
    with torch.no_grad():
        return engine.rollout(engine.update_step.module, pool, carry)


def test_rollout_batch_has_make_batch_semantics():
    """Each env row is one complete episode in the turn-based layout:
    one acting seat per committed step, make_batch's padding on the
    tail (outcome-bootstrapped values, prob 1.0, all-illegal masks,
    progress 1.0), zero-sum outcomes (test_anakin.py's checks)."""
    engine = _engine(64)
    b, _, frames = _sampled(engine, engine.init_carry(0))
    b = {k: v.numpy() for k, v in b.items()}
    em = b["episode_mask"][..., 0, 0]
    tm = b["turn_mask"]
    lens = em.sum(axis=1)
    assert int(frames) == int(em.sum())
    assert np.array_equal(tm.sum(axis=2)[..., 0], em)
    assert np.array_equal(tm, b["observation_mask"])
    assert lens.min() >= 5 and lens.max() <= 9
    seat_idx = tm.argmax(axis=2)[..., 0]
    oc = b["outcome"][:, 0, :, 0]
    assert set(np.unique(oc)) <= {-1.0, 0.0, 1.0}
    assert np.allclose(oc.sum(axis=1), 0.0)
    for g, L in enumerate(lens.astype(int)):
        assert np.array_equal(seat_idx[g, :L], np.arange(L) % 2)
        assert em[g, :L].all() and not em[g, L:].any()
        assert np.allclose(b["progress"][g, :L, 0], np.arange(L) / L)
        if L < engine.unroll:
            assert np.allclose(b["value"][g, L:, :, 0], oc[g][None, :])
            assert (b["selected_prob"][g, L:] == 1.0).all()
            assert (b["action_mask"][g, L:] >= 1e31).all()
            assert (b["progress"][g, L:] == 1.0).all()
    assert (b["selected_prob"] > 0).all() and (b["selected_prob"] <= 1).all()


def test_rollout_is_deterministic_and_the_carry_advances_the_stream():
    engine = _engine(32)
    b1, c1, _ = _sampled(engine, engine.init_carry(0))
    b2, _, _ = _sampled(engine, engine.init_carry(0))
    assert all(torch.equal(b1[k], b2[k]) for k in b1)
    b3, c3, _ = _sampled(engine, c1)
    assert c3["seg"] == 2
    assert not all(torch.equal(b1[k], b3[k]) for k in b1)
    # a resumed run starts another stream
    b4, _, _ = _sampled(engine, engine.init_carry(5))
    assert not torch.equal(b1["action"], b4["action"])


def test_opponent_pool_policies_actually_act():
    """A zero net (uniform policy) frozen into the pool: on the pool
    group every opponent-seat move records 1 / (empty cells), while the
    learner seat keeps the live net's policy."""
    engine = _engine(32, opponent_pool=1)
    zero = engine.init_pool(engine.update_step.module)
    with torch.no_grad():
        for p in zero[0].parameters():
            p.zero_()
    b, _, _ = _sampled(engine, engine.init_carry(0), zero)
    em = b["episode_mask"][..., 0, 0].numpy()
    seat = b["turn_mask"].argmax(dim=2)[..., 0].numpy()
    prob = b["selected_prob"][..., 0, 0].numpy()
    uniform_hits = nonuniform = 0
    for g in range(engine.group, engine.num_envs):
        for t in range(int(em[g].sum())):
            u = 1.0 / (9 - t)
            if seat[g, t] != g % 2:       # segment 0: learner seat g % 2
                assert abs(prob[g, t] - u) < 1e-5, (g, t, prob[g, t])
                uniform_hits += 1
            elif abs(prob[g, t] - u) > 1e-4:
                nonuniform += 1
    assert uniform_hits > 30 and nonuniform > 10


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_refresh_pool_newest_in_oldest_out_and_each_slot_a_copy():
    engine = _engine(30, opponent_pool=2)
    live = engine.update_step.module
    with torch.no_grad():
        for p in live.parameters():
            p.fill_(7.0)
    pool = engine.init_pool(live)
    with torch.no_grad():
        for p in live.parameters():
            p.fill_(1.0)
    pool = engine.refresh_pool(pool, live)
    assert len(pool) == 2
    assert all((p == 1.0).all() for p in pool[0].parameters())  # newest
    assert all((p == 7.0).all() for p in pool[1].parameters())  # shifted
    frozen = [_state(m) for m in pool]
    # the next fused steps update the live tensors in place; no slot
    # may follow them
    step, carry = engine.make_fused_step(), engine.init_carry(0)
    for _ in range(2):
        _, carry = step(carry, pool)
    assert not all((p == 1.0).all() for p in live.parameters())
    for module, before in zip(pool, frozen):
        for k, v in module.state_dict().items():
            assert torch.equal(v, before[k]), k
    ptrs = {p.data_ptr() for p in live.parameters()}
    assert not any(p.data_ptr() in ptrs
                   for m in pool for p in m.parameters())


def _adam_state(opt_state):
    for sub in opt_state.inner_state:
        if hasattr(sub, "mu"):
            return sub
    raise AssertionError("no Adam state in the optax chain")


@pytest.mark.parametrize("algorithm", ["standard", "impact"])
def test_fused_update_matches_make_update_core(algorithm):
    """One fused step (the port's rollout with the JAX draws, then
    UpdateStep) against JAX ``make_update_core`` on the JAX rollout's
    batch, from the same weights."""
    impact = algorithm == "impact"
    raw = loss_cfg(**({"update_algorithm": "impact",
                       "policy_target": "IMPACT", "value_target": "IMPACT",
                       "target_update_interval": 2} if impact else {}))
    jbatch, _ = _jax_rollout(32, 0, seed=3)
    flax_net, net, params = twin_nets("TicTacToe", seed=3)
    _, target_net, tparams = twin_nets("TicTacToe", seed=4)

    jopt = jupdate.make_optimizer(LR)
    core = jax.jit(jupdate.make_update_core(
        TPUModel(flax_net), JaxLossConfig.from_config(raw), jopt,
        "float32"))
    jb = jax.tree.map(jnp.asarray, jbatch)
    jparams = jax.tree.map(jnp.asarray, params)
    out = (core(jparams, jopt.init(jparams), jb, tparams) if impact
           else core(jparams, jopt.init(jparams), jb))
    jafter, jstate, jm = out[:3]

    opt = make_optimizer(net.parameters(), LR)
    step = UpdateStep(net, LossConfig.from_config(raw), opt, "float32",
                      target_module=target_net if impact else None)
    engine = AnakinEngine(tttt, step, AnakinConfig.from_config(
        {"mode": "on", "num_envs": 32}), seed=3)
    before = flatten_params(state_to_flax(net.state_dict(), net))
    metrics, carry = engine.make_fused_step()(
        engine.init_carry(0), (), _actions(jbatch))
    assert carry["seg"] == 1
    assert float(metrics["anakin_games"]) == 32
    assert float(metrics["anakin_frames"]) == float(
        jbatch["episode_mask"].sum())
    for key in ("total", "p", "v", "ent", "grad_norm", "dcnt", "nonfinite"):
        assert_close(metrics[key], jm[key], key)
    after = flatten_params(state_to_flax(net.state_dict(), net))
    by_name = dict(net.named_parameters())
    mu = flatten_params(state_to_flax(
        {n: opt.state[p]["exp_avg"] for n, p in by_name.items()}, net))
    nu = flatten_params(state_to_flax(
        {n: opt.state[p]["exp_avg_sq"] for n, p in by_name.items()}, net))
    jmu = flatten_params(_adam_state(jstate).mu)
    jnu = flatten_params(_adam_state(jstate).nu)
    jafter = flatten_params(jafter)
    for path in jmu:
        assert_close(mu[path], jmu[path], f"mu {path}")
        assert_close(nu[path], jnu[path], f"nu {path}")
        # after one step mu = (1 - b1) x Adam's input
        moved = np.abs(np.asarray(jmu[path])) / (1 - 0.9) > 1e-6
        np.testing.assert_allclose(
            (after[path] - before[path])[moved],
            (np.asarray(jafter[path]) - before[path])[moved],
            rtol=0, atol=0.05 * LR, err_msg=path)
    if impact:
        jtarget = flatten_params(out[3])
        tflat = flatten_params(state_to_flax(target_net.state_dict(),
                                             target_net))
        for path, value in jtarget.items():
            assert_close(tflat[path], value, f"target {path}")


def _trainer_args(env, **train):
    raw = {"env_args": {"env": env},
           "train_args": dict(
               {"batch_size": 16, "minimum_episodes": 4,
                "maximum_episodes": 64, "updates_per_epoch": 4,
                "compute_dtype": "float32"}, **train)}
    args = Config.from_dict(raw).train_args.to_dict()
    args["env"] = {"env": env}
    return args


def _model(env):
    model = TorchModel(make_env({"env": env}).net(), device="cpu")
    model.init_params(seed=0)
    return model


@pytest.mark.parametrize("env,train,match", [
    ("HungryGeese", {"turn_based_training": False}, "device twin"),
    ("TicTacToe", {"observation": True}, "observation"),
])
def test_trainer_auto_falls_back_and_on_raises(env, train, match,
                                               tmp_path, monkeypatch):
    """``auto`` keeps the worker path (the device ring here) when the
    env has no device twin or the layout does not fit; ``on`` raises."""
    monkeypatch.chdir(tmp_path)
    args = _trainer_args(env, anakin={"mode": "auto", "num_envs": 8},
                         **train)
    trainer = Trainer(args, _model(env), device="cpu")
    assert trainer.anakin is None and trainer.device_replay is not None
    args["anakin"] = {"mode": "on", "num_envs": 8}
    with pytest.raises(ValueError, match=match):
        Trainer(args, _model(env), device="cpu")


def test_trainer_in_anakin_mode_builds_no_feed(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = _trainer_args("TicTacToe", anakin={"mode": "on", "num_envs": 8,
                                              "opponent_pool": 1})
    trainer = Trainer(args, _model("TicTacToe"), device="cpu")
    assert trainer.anakin is not None
    assert trainer.device_replay is None and trainer.batcher is None
    assert len(trainer.anakin_pool) == 1
