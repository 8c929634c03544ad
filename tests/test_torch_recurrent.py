"""The port's recurrent path against the JAX package's, on the CPU.

  * ``ConvLSTMCell``, ``DRC``, ``GeisterNet`` and ``GRFNet``: forwards
    and new hidden states equal Flax's on converted weights within
    1e-5 (test_torch_models.py's tolerance; 5e-5 at the GRF raster,
    see ``GRF_ATOL``), from a non-zero hidden state.  GeisterNet also at full width (32 filters, DRC 3 x 3);
    GRFNet at the true (72, 96, 16) raster, where Flax's SAME padding
    at stride 2 is asymmetric (a symmetric pad is shown to fail the
    same comparison).  ``to_flax`` round-trips and the numpy-built
    tree is Flax ``init``'s.
  * ``forward_prediction``, ``compute_loss`` and every gradient equal
    the JAX ones (test_torch_losses.py's bounds: rtol 1e-4, floor 1e-5
    of the tensor's largest magnitude; 1e-4 at the GRF raster, see
    ``GRF_FLOOR``) for Geister in turn mode,
    Geister with ``observation: True`` and GRFProxy in seat mode, each
    with ``burn_in_steps`` 0 and 4.
  * Burn-in, as tests/test_burn_in.py holds it for the JAX package: a
    window's training steps give the values of a plain window over the
    same steps, and no gradient reaches the burn-in prefix's hidden.
  * The env copies play the JAX envs' games from the same ``random``
    seed, and a port env mirrors a JAX env through ``diff_info`` /
    ``update``.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.models import TPUModel
from handyrl_tpu.models.recurrent import DRC as FlaxDRC
from handyrl_tpu.models.recurrent import ConvLSTMCell as FlaxCell
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.losses import compute_loss as jax_compute_loss
from handyrl_tpu.ops.losses import forward_prediction as jax_forward
from handyrl_tpu.ops.update import make_apply_fn as jax_apply_fn
from handyrl_tpu_torch.batch import make_batch
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models import grf_net
from handyrl_tpu_torch.models.convert import (
    from_flax,
    random_flax_params,
    state_to_flax,
    to_flax,
)
from handyrl_tpu_torch.models.geister_net import GeisterNet
from handyrl_tpu_torch.models.grf_net import GRFNet
from handyrl_tpu_torch.models.recurrent import DRC, ConvLSTMCell
from handyrl_tpu_torch.ops.losses import LossConfig, compute_loss
from handyrl_tpu_torch.ops.losses import forward_prediction
from handyrl_tpu_torch.ops.update import make_apply_fn
from handyrl_tpu_torch.utils.tree import flatten_params, tree_map_leaves
from test_torch_losses import FLOOR, RTOL
from torchfix import (  # noqa: F401
    draws,
    loss_cfg,
    make_episodes,
    one_torch_thread,
    to_torch_batch,
    twin_nets,
    window,
)

ATOL = 1e-5


def _rng_hidden(zeros, seed):
    """A non-zero hidden state shaped like ``zeros``, so the hidden path
    of every gate carries signal."""
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in zeros.items()}


def _cell_params(flax_module, x, h, c, seed):
    return jax.tree.map(np.asarray, flax_module.init(
        jax.random.PRNGKey(seed), x, h, c)["params"])


def _load_cell(cell, conv):
    cell.conv.weight.data = torch.from_numpy(np.ascontiguousarray(
        np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)))
    cell.conv.bias.data = torch.from_numpy(np.array(conv["bias"]))


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_convlstm_cell_matches_flax():
    rng = np.random.default_rng(0)
    x, h, c = (rng.standard_normal((2, 5, 7, s)).astype(np.float32)
               for s in (6, 4, 4))
    flax_cell = FlaxCell(hidden_dim=4)
    params = _cell_params(flax_cell, x, h, c, seed=1)
    ref_h, ref_c = flax_cell.apply({"params": params}, x, h, c)
    cell = ConvLSTMCell(6, 4)
    _load_cell(cell, params["Conv_0"])
    with torch.no_grad():
        out_h, out_c = cell(_nchw(x), _nchw(h), _nchw(c))
    for got, ref in ((out_h, ref_h), (out_c, ref_c)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), rtol=0, atol=ATOL)


def test_drc_matches_flax():
    """3 layers x 2 repeats: layer i > 0 reads layer i - 1's fresh h."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 6, 5)).astype(np.float32)
    drc = DRC(3, 5, 4, num_repeats=2)
    hidden = _rng_hidden(DRC.initial_state(3, (6, 6), 4, (3,)), 2)
    flax_drc = FlaxDRC(num_layers=3, hidden_dim=4, num_repeats=2)
    params = jax.tree.map(np.asarray, flax_drc.init(
        jax.random.PRNGKey(3), x, hidden)["params"])
    ref_h, ref_hidden = flax_drc.apply({"params": params}, x, hidden)
    for i, cell in enumerate(drc.cells):
        _load_cell(cell, params[f"ConvLSTMCell_{i}"]["Conv_0"])
    with torch.no_grad():
        out_h, out_hidden = drc(_nchw(x), tree_map_leaves(
            torch.from_numpy, hidden))
    np.testing.assert_allclose(out_h.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_h), rtol=0, atol=ATOL)
    assert sorted(out_hidden) == sorted(ref_hidden)
    for k, v in ref_hidden.items():
        assert tuple(out_hidden[k].shape) == v.shape
        np.testing.assert_allclose(out_hidden[k].numpy(), np.asarray(v),
                                   rtol=0, atol=ATOL, err_msg=k)


def _observations(env_name, batch, seed=0, env_args=None):
    """``batch`` real observations: seeded resets and random steps."""
    random.seed(seed)
    env = make_env({"env": env_name, **(env_args or {})})
    obs = []
    for i in range(batch):
        env.reset()
        for _ in range(3 + 5 * i):
            if env.terminal():
                break
            env.step({p: random.choice(env.legal_actions(p))
                      for p in env.turns()})
        obs.append(env.observation(env.players()[i % len(env.players())]))
    return jax.tree.map(lambda *a: np.stack(a), *obs)


# At the GRF raster the first GroupNorm normalizes single-channel
# groups of 1,728 sparse cells to values up to ~6.6; there torch's
# float32 CPU kernel errs 1.1e-4 against a float64 run of the port
# (Flax's float32 ~1e-5), which reaches the new hidden state as 2.6e-5.
# The symmetric-padding fault moves the outputs by more than 1e-3.
GRF_ATOL = 5e-5

NETS = {
    # name: (env, port class, kwargs, batch, atol)
    "geister_8_2x2": ("Geister", GeisterNet,
                      {"filters": 8, "drc_layers": 2, "drc_repeats": 2}, 3,
                      ATOL),
    "geister_32_3x3": ("Geister", GeisterNet, {}, 2, ATOL),
    "grf_8": ("GRFProxy", GRFNet, {"filters": 8}, 2, GRF_ATOL),
}


def _flax_twin(module):
    import importlib

    mod = importlib.import_module(
        f"handyrl_tpu.models.{type(module).__module__.split('.')[-1]}")
    return getattr(mod, type(module).__name__)(**module.config)


def _both_forwards(module, obs, hidden, seed=3):
    params = random_flax_params(module, seed=seed)
    module.load_state_dict(from_flax(params, module))
    ref = _flax_twin(module).apply({"params": params}, obs, hidden)
    with torch.no_grad():
        out = module(tree_map_leaves(torch.from_numpy, obs),
                     tree_map_leaves(torch.from_numpy, hidden))
    return ref, out


def _assert_forward_equal(ref, out, atol):
    assert sorted(ref) == sorted(out)
    for key in ref:
        if key == "hidden":
            assert sorted(ref[key]) == sorted(out[key])
            for k, v in ref[key].items():
                np.testing.assert_allclose(
                    out[key][k].numpy(), np.asarray(v), rtol=0,
                    atol=atol, err_msg=f"hidden {k}")
        else:
            assert tuple(out[key].shape) == ref[key].shape, key
            np.testing.assert_allclose(out[key].numpy(),
                                       np.asarray(ref[key]), rtol=0,
                                       atol=atol, err_msg=key)


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_and_hidden_match_flax(name):
    env_name, cls, kwargs, batch, atol = NETS[name]
    module = cls(**kwargs)
    obs = _observations(env_name, batch)
    ref, out = _both_forwards(
        module, obs, _rng_hidden(module.init_hidden((batch,)), 4))
    _assert_forward_equal(ref, out, atol)
    if env_name == "Geister":
        assert out["policy"].shape == (batch, 214)
        assert set(out) == {"policy", "value", "return", "hidden"}


def test_grf_symmetric_stride2_padding_fails_the_parity_check(monkeypatch):
    """``nn.Conv2d(stride=2, padding=1)`` gives the same (36, 48) and
    (18, 24) shapes as Flax's SAME but reads other pixels: patched in,
    the (72, 96) forward leaves Flax's by far more than the tolerance."""
    assert grf_net.same_pad(72) == (0, 1) and grf_net.same_pad(96) == (0, 1)
    assert grf_net.same_pad(7) == (1, 1)
    module = GRFNet(filters=8)
    obs = _observations("GRFProxy", 2)
    hidden = _rng_hidden(module.init_hidden((2,)), 4)
    monkeypatch.setattr(grf_net, "same_pad", lambda size: (1, 1))
    ref, out = _both_forwards(module, obs, hidden)
    assert out["policy"].shape == ref["policy"].shape
    worst = max(float(np.abs(out[k].numpy() - np.asarray(ref[k])).max())
                for k in ("policy", "value"))
    assert worst > 20 * GRF_ATOL
    with pytest.raises(AssertionError):
        _assert_forward_equal(ref, out, GRF_ATOL)


@pytest.mark.parametrize("name", sorted(NETS))
def test_param_tree_and_round_trip_match_flax(name):
    env_name, cls, kwargs, _, _ = NETS[name]
    module = cls(**kwargs)
    obs = _observations(env_name, 1)
    flax_net = _flax_twin(module)
    ref = jax.eval_shape(flax_net.init, jax.random.PRNGKey(0), obs,
                         flax_net.init_hidden((1,)))["params"]
    built = random_flax_params(module, seed=5)
    assert jax.tree.structure(built) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(built), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    module.load_state_dict(from_flax(built, module))
    back = flatten_params(to_flax(module))
    for path, value in flatten_params(built).items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)


def test_converter_raises_on_a_missing_cell_or_a_wrong_shape():
    module = GeisterNet(filters=8, drc_layers=2, drc_repeats=2)
    params = random_flax_params(module, seed=0)
    deeper = random_flax_params(
        GeisterNet(filters=8, drc_layers=3, drc_repeats=2), seed=0)
    with pytest.raises(KeyError, match="ConvLSTMCell_2"):
        from_flax(deeper, module)
    params["DRC_0"].pop("ConvLSTMCell_1")
    with pytest.raises(KeyError, match="ConvLSTMCell_1"):
        from_flax(params, module)
    wide = random_flax_params(
        GeisterNet(filters=16, drc_layers=2, drc_repeats=2), seed=0)
    with pytest.raises(ValueError, match="does not match"):
        from_flax(wide, module)


def test_wrapper_carries_numpy_hidden_state():
    module = GeisterNet(filters=8, drc_layers=2, drc_repeats=2)
    model = TorchModel(module, device="cpu")
    model.init_params(seed=1)
    assert model.is_recurrent
    h0 = model.init_hidden()
    assert all(isinstance(v, np.ndarray) and v.shape == (6, 6, 8)
               and v.dtype == np.float32 and not v.any()
               for v in h0.values())
    batch = model.init_hidden([3])
    assert all(v.shape == (3, 6, 6, 8) for v in batch.values())
    obs = _observations("Geister", 3)
    out = model.inference_batch(obs, batch)
    assert out["policy"].shape == (3, 214)
    assert sorted(out["hidden"]) == ["c0", "c1", "h0", "h1"]
    assert all(v.dtype == np.float32 and v.shape == (3, 6, 6, 8)
               and v.any() for v in out["hidden"].values())
    one = model.inference(jax.tree.map(lambda a: a[1], obs),
                          jax.tree.map(lambda a: a[1], batch))
    np.testing.assert_allclose(one["policy"], out["policy"][1], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(one["hidden"]["c1"], out["hidden"]["c1"][1],
                               rtol=0, atol=ATOL)


# ---------------------------------------------------------------------
# forward_prediction, compute_loss and gradients against the JAX ones
# ---------------------------------------------------------------------

# The floor of the comparison, x the tensor's largest magnitude.  At
# the GRF raster the JAX package's own float32 outputs, losses and
# gradients lie up to 2.3e-5, 3.4e-5 and 5.4e-5 of their scale from a
# float64 run of the port (the ConvLSTM carries the first GroupNorm's
# rounding through every step), so the floor there is 1e-4; the port's
# float32 run uses up to 0.57 of that bound.
GRF_FLOOR = 1e-4

MODES = {
    # name: (env, loss overrides, episode observation flag, env args,
    #        floor)
    "geister-turn": ("Geister", {}, False, {}, FLOOR),
    "geister-observation": ("Geister", {"observation": True}, True, {},
                            FLOOR),
    "grf-seat": ("GRFProxy", {"turn_based_training": False,
                              "policy_target": "UPGO"}, False,
                 {"max_steps": 24}, GRF_FLOOR),
}
_EPISODES = {}


def _episodes(mode):
    if mode not in _EPISODES:
        env_name, _, observation, env_args, _ = MODES[mode]
        _, net, _ = twin_nets(env_name, seed=50)
        _EPISODES[mode] = make_episodes(env_name, 3, seed=7,
                                        observation=observation,
                                        env_args=env_args, net=net)
    return _EPISODES[mode]


def _mode_batch(mode, burn_in, forward_steps=6, n=4, seed=0):
    env_name, overrides, _, _, _ = MODES[mode]
    raw = loss_cfg(**overrides, burn_in_steps=burn_in)
    cfg = dict(raw, forward_steps=forward_steps, compress_steps=4)
    episodes, players = _episodes(mode)
    picks = draws(episodes, cfg, n, len(players), seed)
    # start the first window at step 1: the burn-in prefix then begins
    # before the episode (padded, observation mask 0)
    picks[0] = (picks[0][0], 1, picks[0][2])
    return raw, make_batch([window(episodes[i], t, cfg)
                            for i, t, _ in picks], cfg)


def _both_losses(mode, burn_in):
    raw, batch = _mode_batch(mode, burn_in)
    flax_net, torch_net, params = twin_nets(MODES[mode][0], seed=1)
    B, P = batch["value"].shape[0], batch["value"].shape[2]
    jcfg = JaxLossConfig.from_config(raw)
    japply = jax_apply_fn(TPUModel(flax_net), "float32")
    jbatch = jax.tree.map(jnp.asarray, batch)
    jhidden = flax_net.init_hidden((B, P))

    def jloss(p):
        losses, dcnt = jax_compute_loss(japply, p, jbatch, jhidden, jcfg)
        return losses["total"], (losses, dcnt)

    jgrads, (jlosses, jdcnt) = jax.grad(jloss, has_aux=True)(params)
    jout = jax_forward(japply, params, jhidden, jbatch, jcfg)

    tcfg = LossConfig.from_config(raw)
    tapply = make_apply_fn(torch_net, "float32")
    tbatch = to_torch_batch(batch)
    with torch.no_grad():
        tout = forward_prediction(tapply, torch_net.init_hidden((B, P)),
                                  tbatch, tcfg)
    tlosses, tdcnt = compute_loss(tapply, tbatch,
                                  torch_net.init_hidden((B, P)), tcfg)
    tlosses["total"].backward()
    tgrads = state_to_flax(
        {n: p.grad for n, p in torch_net.named_parameters()}, torch_net)
    return (jout, jlosses, jdcnt, jgrads), (tout, tlosses, tdcnt, tgrads)


@pytest.mark.parametrize("burn_in", [0, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_recurrent_losses_and_grads_match_jax(mode, burn_in):
    (jo, jl, jd, jg), (to, tl, td, tg) = _both_losses(mode, burn_in)
    floor = MODES[mode][4]

    def close(t, j, what):
        t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
        assert t.shape == j.shape, what
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=floor * scale,
                                   err_msg=f"{mode}: {what}")

    assert sorted(jo) == sorted(to)
    for key in jo:
        close(to[key], jo[key], f"output {key}")
    assert sorted(jl) == sorted(tl)
    for key in jl:
        close(tl[key].detach(), jl[key], f"loss {key}")
    assert float(td) == float(jd)
    jflat, tflat = flatten_params(jg), flatten_params(tg)
    assert sorted(jflat) == sorted(tflat)
    for path in jflat:
        close(tflat[path], jflat[path], f"grad {path}")
    # real gradient reaches the recurrent cells
    assert all(np.abs(g).max() > 0 for p, g in tflat.items()
               if "ConvLSTMCell" in p)


# ---------------------------------------------------------------------
# burn-in semantics (tests/test_burn_in.py, for the port)
# ---------------------------------------------------------------------

BURN_IN, TRAIN_STEPS = 3, 5


def _window_batch(episode, burn_in, forward, start, cfg_over=None):
    cfg = dict(loss_cfg(burn_in_steps=burn_in), forward_steps=forward,
               compress_steps=4, **(cfg_over or {}))
    train_start = start + burn_in
    sel = window(episode, train_start, cfg)
    return cfg, to_torch_batch(make_batch([sel], cfg))


def _burn_setup():
    episodes, _ = _episodes("geister-turn")
    episode = max(episodes, key=lambda e: e["steps"])
    assert episode["steps"] > BURN_IN + TRAIN_STEPS + 2
    _, net, _ = twin_nets("Geister", seed=2)
    return net, episode


def test_burn_in_window_gives_the_plain_windows_values():
    net, episode = _burn_setup()
    apply_fn = make_apply_fn(net, "float32")
    start = 2
    cfg_b, batch_b = _window_batch(episode, BURN_IN, TRAIN_STEPS, start)
    cfg_p, batch_p = _window_batch(episode, 0, BURN_IN + TRAIN_STEPS, start)
    B, P = batch_b["value"].shape[0], batch_b["value"].shape[2]
    out_b = forward_prediction(apply_fn, net.init_hidden((B, P)), batch_b,
                               LossConfig.from_config(cfg_b))
    out_p = forward_prediction(apply_fn, net.init_hidden((B, P)), batch_p,
                               LossConfig.from_config(cfg_p))
    for key in ("policy", "value", "return"):
        np.testing.assert_allclose(out_b[key].detach().numpy(),
                                   out_p[key].detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    # the burn-in steps' outputs carry no graph; the training steps do
    assert out_b["value"].requires_grad
    grads = torch.autograd.grad(out_b["value"][:, :BURN_IN].sum(),
                                list(net.parameters()), allow_unused=True)
    assert all(g is None or not g.any() for g in grads)


def test_burn_in_blocks_gradient_to_the_initial_hidden():
    net, episode = _burn_setup()
    apply_fn = make_apply_fn(net, "float32")
    start = 2

    def hidden_grad(burn_in):
        forward = TRAIN_STEPS if burn_in else BURN_IN + TRAIN_STEPS
        cfg, batch = _window_batch(episode, burn_in, forward, start)
        B, P = batch["value"].shape[0], batch["value"].shape[2]
        hidden0 = {k: (v + 0.1).requires_grad_()
                   for k, v in net.init_hidden((B, P)).items()}
        out = forward_prediction(apply_fn, hidden0, batch,
                                 LossConfig.from_config(cfg))
        # the value heads: the masked policy carries -1e32 entries
        loss = sum((v[:, burn_in:] ** 2).sum() for k, v in out.items()
                   if k != "policy")
        if not loss.requires_grad:
            return 0.0
        grads = torch.autograd.grad(loss, list(hidden0.values()),
                                    allow_unused=True)
        return float(sum(g.abs().sum() for g in grads if g is not None))

    assert hidden_grad(BURN_IN) == 0.0
    assert hidden_grad(0) > 1e-4


# ---------------------------------------------------------------------
# the env copies
# ---------------------------------------------------------------------

ENVS = {"Geister": {}, "ParallelTicTacToe": {},
        "GRFProxy": {"max_steps": 60}}


def _play(factory, name, env_args, games, seed):
    """A trace of ``games`` random games: per step every player's
    observation and legal actions, the actions, rewards; the outcome."""
    random.seed(seed)
    env = factory({"env": name, **env_args})
    trace = []
    for _ in range(games):
        env.reset()
        while not env.terminal():
            step = {"turns": list(env.turns())}
            for p in env.players():
                step[("obs", p)] = env.observation(p)
                step[("legal", p)] = list(env.legal_actions(p))
            actions = {p: random.choice(env.legal_actions(p))
                       for p in env.turns()}
            env.step(actions)
            step.update(actions=actions, reward=env.reward())
            trace.append(step)
        trace.append({"outcome": env.outcome()})
    return trace


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_copy_plays_the_jax_envs_games(name):
    ours = _play(make_env, name, ENVS[name], 3, seed=5)
    theirs = _play(jax_make_env, name, ENVS[name], 3, seed=5)
    assert len(ours) == len(theirs) > 10
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            if key[0] == "obs":
                ja, jb = jax.tree.leaves(a[key]), jax.tree.leaves(b[key])
                assert jax.tree.structure(a[key]) == jax.tree.structure(
                    b[key])
                for x, y in zip(ja, jb):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            else:
                assert a[key] == b[key], key


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_copy_mirrors_the_jax_env_through_diff_info(name):
    """A port env fed the JAX env's ``diff_info`` deltas sees what the
    JAX env shows each player: legal actions and observations."""
    random.seed(9)
    env = jax_make_env({"env": name, **ENVS[name]})
    mirrors = {p: make_env({"env": name, **ENVS[name]})
               for p in env.players()}
    for _ in range(3):
        env.reset()
        for p, m in mirrors.items():
            m.update(env.diff_info(p), True)
        while not env.terminal():
            actions = {}
            for p in env.turns():
                assert mirrors[p].legal_actions(p) == env.legal_actions(p)
                action = random.choice(mirrors[p].legal_actions(p))
                actions[p] = env.str2action(
                    mirrors[p].action2str(action, p), p)
            env.step(actions)
            for p, m in mirrors.items():
                m.update(env.diff_info(p), False)
                if not env.terminal():
                    for x, y in zip(jax.tree.leaves(m.observation(p)),
                                    jax.tree.leaves(env.observation(p))):
                        np.testing.assert_array_equal(x, y)
