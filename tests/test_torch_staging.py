"""The port's device replay ring against the JAX package's.

  * ``gather`` on injected ``(slots, tstarts, seats)`` equals the JAX
    ``DeviceReplay._gather_batch`` in all three modes (turn, seat,
    all) and with each observation wire dtype, exactly (the bf16
    observations compared as their float32 values), also for Geister's
    dict observations with burn-in 4 and the GRF raster in seat mode;
    after a T_max growth (Geister) and under the byte budget (GRF);
  * FIFO eviction, T_max growth and the byte budget;
  * a batched ingest leaves the ring bit-identical to single appends;
  * a chi-squared check of the on-device draw: triangular recency over
    the ring, uniform window start, uniform seat.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from handyrl_tpu.staging import DeviceReplay as JaxReplay
from handyrl_tpu_torch.models.geister_net import GeisterNet
from handyrl_tpu_torch.models.grf_net import GRFNet
from handyrl_tpu_torch.staging import DeviceReplay, make_replay_update_step
from handyrl_tpu_torch.utils.tree import tree_leaves
from torchfix import draws, make_episodes, one_torch_thread  # noqa: F401

MODES = {"turn": ("TicTacToe", True, False),
         "all": ("TicTacToe", True, True),
         "seat": ("HungryGeese", False, False),
         # the recurrent workloads: dict observations with burn-in 4, and
         # the GRF raster in seat mode
         "geister": ("Geister", True, False),
         "grf": ("GRFProxy", False, False)}
BURN_IN = {"turn": 2, "geister": 4, "grf": 4}
ENV_ARGS = {"grf": {"max_steps": 24}}


def _cfg(mode, transfer="bfloat16", compute="bfloat16", burn_in=0):
    _, turn_based, observation = MODES[mode]
    return {"turn_based_training": turn_based, "observation": observation,
            "forward_steps": 8, "burn_in_steps": burn_in,
            "compress_steps": 4, "transfer_dtype": transfer,
            "compute_dtype": compute}


def _ring(cfg, episodes, capacity=None, batch=8, max_bytes=1 << 30):
    replay = DeviceReplay(cfg, capacity or len(episodes) + 2, max_bytes,
                          device="cpu")
    replay.offer(episodes)
    replay.ingest(max_episodes=len(episodes), batch=batch)
    return replay


def _as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("transfer,compute", [("bfloat16", "bfloat16"),
                                              ("float32", "float32"),
                                              ("uint8", "bfloat16")])
def test_gather_equals_jax(mode, transfer, compute):
    cfg = _cfg(mode, transfer, compute, burn_in=BURN_IN.get(mode, 0))
    episodes, players = _episodes(mode, 5 if mode != "seat" else 3, seed=1,
                                  observation=cfg["observation"])
    picks = draws(episodes, cfg, 16, len(players), seed=2)
    ring = _ring(cfg, episodes)
    jring = JaxReplay(cfg, capacity=len(episodes) + 2, max_bytes=1 << 30)
    jring.offer(episodes)
    jring.ingest(max_episodes=len(episodes))
    tb = _assert_gathers_equal(ring, jring, picks)
    for leaf in tree_leaves(tb["observation"]):
        assert leaf.dtype == getattr(torch, compute)


_EPISODES = {}


def _episodes(mode, count, seed, observation=False):
    """Cached per process: the rings only read the episodes.  The
    recurrent workloads' episodes come from narrow nets (8 filters);
    GRF's ship as raw pickle blocks (bz2 of its rasters is slow)."""
    key = (mode, count, seed, observation)
    if key not in _EPISODES:
        net = None
        if mode == "geister":
            net = GeisterNet(filters=8, drc_layers=2, drc_repeats=2)
        elif mode == "grf":
            net = GRFNet(filters=8)
        _EPISODES[key] = make_episodes(
            MODES[mode][0], count, seed=seed, observation=observation,
            env_args=ENV_ARGS.get(mode), net=net, compress=mode != "grf")
    episodes, players = _EPISODES[key]
    return list(episodes), players


def _assert_gathers_equal(ring, jring, picks):
    """The port's gather and the JAX ring's on the same ``(slot,
    train start, seat)`` picks: every channel and observation leaf
    equal, exactly.  Returns the port's batch."""
    slots, tstarts, seats = (np.asarray(c) for c in zip(*picks))
    jb = jring._sample_fn(jring.buffers, jnp.asarray(slots, jnp.int32),
                          jnp.asarray(tstarts, jnp.int32),
                          jnp.asarray(seats, jnp.int32))
    tb = ring.gather(*(torch.from_numpy(c.astype(np.int64))
                       for c in (slots, tstarts, seats)))
    assert sorted(jb) == sorted(tb)
    for key in jb:
        jleaves, tleaves = tree_leaves(jb[key]), tree_leaves(tb[key])
        assert len(jleaves) == len(tleaves), key
        for j, t in zip(jleaves, tleaves):
            j, t = _as_np(j), _as_np(t)
            assert j.shape == t.shape, key
            np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=key)
    return tb


def test_geister_gather_after_growth_equals_jax():
    """Dict observations, burn-in 4 (windows that start before step 0
    pad with observation mask 0), and a ring that grew T_max while it
    held an episode, against a JAX ring that never grew."""
    cfg = _cfg("geister", burn_in=4)
    episodes, players = _episodes("geister", 5, seed=3)
    episodes.sort(key=lambda e: e["steps"])
    ring = DeviceReplay(cfg, 8, 1 << 30, device="cpu")
    ring.offer(episodes[:1])
    ring.ingest()
    t_before = ring.t_max
    ring.offer(episodes[1:])
    ring.ingest()
    assert ring.growths >= 1 and ring.t_max > t_before
    jring = JaxReplay(cfg, capacity=8, max_bytes=1 << 30)
    jring.offer(episodes)
    jring.ingest(max_episodes=len(episodes))
    picks = draws(episodes, cfg, 16, len(players), seed=4)
    picks[:2] = [(0, 0, 0), (len(episodes) - 1, 1, 0)]
    tb = _assert_gathers_equal(ring, jring, picks)
    assert sorted(tb["observation"]) == ["board", "scalar"]
    assert float(tb["observation_mask"][0, :4].sum()) == 0.0


def test_grf_gather_under_the_byte_budget_equals_jax():
    """uint8 GRF rasters in seat mode, the ring capped by
    ``device_replay_mb``: it keeps the newest episodes, as a JAX ring
    of the capped capacity does."""
    cfg = _cfg("grf", transfer="uint8", burn_in=4)
    episodes, players = _episodes("grf", 5, seed=1)
    probe = _ring(cfg, episodes[:1])
    per_slot = probe._per_step_bytes * probe.t_max
    ring = DeviceReplay(cfg, 8, int(2.5 * per_slot), device="cpu",
                        max_steps_hint=probe.t_max)
    ring.offer(episodes)
    ring.ingest()
    assert ring.capacity == 2 and ring.size == 2
    assert ring.buffers["obs"].dtype == torch.uint8
    assert ring.buffers["obs"].shape[1] == 2 * 72 * 96 * 16
    jring = JaxReplay(cfg, capacity=2, max_bytes=1 << 30)
    jring.offer(episodes)
    jring.ingest(max_episodes=len(episodes))
    # the two newest episodes, in the slots five appends left them in
    newest = episodes[-2:]
    picks = [(len(episodes) - 2 + i, t, p) for i, t, p in
             draws(newest, cfg, 8, len(players), seed=6)]
    picks = [(i % 2, t, p) for i, t, p in picks]
    _assert_gathers_equal(ring, jring, picks)


def test_fifo_eviction_keeps_the_newest_episodes():
    cfg = _cfg("turn")
    episodes, _ = make_episodes("TicTacToe", 7, seed=3)
    ring = _ring(cfg, episodes, capacity=4, batch=3)
    assert ring.size == 4 and ring.episodes_seen == 7
    newest = _ring(cfg, episodes[3:], capacity=4)
    slots = torch.arange(4)
    order = [(ring.oldest + i) % 4 for i in range(4)]
    a = ring.gather(torch.tensor(order), torch.zeros(4, dtype=torch.long),
                    torch.zeros(4, dtype=torch.long))
    b = newest.gather(slots, torch.zeros(4, dtype=torch.long),
                      torch.zeros(4, dtype=torch.long))
    for key in a:
        np.testing.assert_array_equal(_as_np(a[key]), _as_np(b[key]))


def test_growth_relays_the_ring_and_respects_the_byte_budget():
    cfg = _cfg("seat")
    episodes, _ = make_episodes("HungryGeese", 4, seed=5)
    episodes.sort(key=lambda e: e["steps"])
    short = episodes[0]
    short_only = _ring(cfg, [short], capacity=4)
    ring = DeviceReplay(cfg, 4, 1 << 30, device="cpu")
    ring.offer([short])
    ring.ingest()
    long_ep = dict(episodes[-1])
    long_ep["moment"] = long_ep["moment"] * 3  # a 3x longer episode
    long_ep["steps"] = 3 * long_ep["steps"]
    t_before = ring.t_max
    ring.offer([long_ep])
    ring.ingest()
    assert ring.growths == 1 and ring.t_max > t_before
    assert ring.t_max >= long_ep["steps"] and ring.size == 2
    # the episode stored before the growth still gathers the same
    idx = (torch.zeros(3, dtype=torch.long),
           torch.arange(3) * 2, torch.arange(3) % 4)
    a, b = ring.gather(*idx), short_only.gather(*idx)
    for key in a:
        np.testing.assert_array_equal(_as_np(a[key]), _as_np(b[key]))
    # a budget of ~2.5 slots caps the capacity at 2
    per_slot = ring._per_step_bytes * ring.t_max
    small = DeviceReplay(cfg, 16, int(2.5 * per_slot), device="cpu",
                         max_steps_hint=ring.t_max)
    small.offer(episodes)
    small.ingest()
    assert small.capacity == 2 and small.size == 2
    assert small.nbytes <= int(2.5 * per_slot) + small.capacity * 64 \
        + 256 * ring._per_step_bytes


def test_batched_ingest_equals_single_appends():
    cfg = _cfg("seat")
    episodes, _ = make_episodes("HungryGeese", 5, seed=6)
    batched = _ring(cfg, episodes, batch=8)
    single = _ring(cfg, episodes, batch=1)
    assert batched.t_max == single.t_max
    for a, b in zip(tree_leaves(batched.buffers), tree_leaves(single.buffers)):
        n = batched.capacity * batched.t_max  # the scratch stripe aside
        assert torch.equal(a[:n] if a.shape[0] > n else a[:-1],
                           b[:n] if b.shape[0] > n else b[:-1])


def test_device_draw_distribution():
    """Chi-squared at p = 0.001, three tests: slot recency P(idx) =
    (idx+1)/S over a wrapped ring, window starts uniform over each
    episode's candidates (jointly over the slots), seats uniform."""
    cfg = _cfg("seat")
    episodes, _ = make_episodes("HungryGeese", 9, seed=7)
    ring = _ring(cfg, episodes, capacity=6, batch=4)  # wraps: 9 into 6
    gen = torch.Generator().manual_seed(0)
    n_draws = 60000
    slots, tstarts, seats = ring.draw(ring.device_state(), gen, n_draws)
    slots, tstarts, seats = slots.numpy(), tstarts.numpy(), seats.numpy()
    age = (slots - ring.oldest) % ring.capacity   # 0 = oldest
    n = ring.size
    expected = (np.arange(n) + 1) / (n * (n + 1) / 2) * n_draws
    observed = np.bincount(age, minlength=n)
    chi2 = ((observed - expected) ** 2 / expected).sum()
    assert chi2 < stats.chi2.ppf(0.999, n - 1), (observed, expected)
    # window starts: one joint test over every (slot, start) cell, each
    # slot's draws spread uniformly over its candidates
    chi2 = dof = 0
    for s in range(ring.capacity):
        cands = 1 + max(0, ring.ep_len[s] - cfg["forward_steps"])
        got = np.bincount(tstarts[slots == s], minlength=cands)
        assert len(got) == cands
        chi2 += stats.chisquare(got).statistic
        dof += cands - 1
    assert chi2 < stats.chi2.ppf(0.999, dof)
    got = np.bincount(seats, minlength=4)
    assert stats.chisquare(got).statistic < stats.chi2.ppf(0.999, 3)


def test_fused_replay_step_trains_from_the_ring():
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer
    from torchfix import loss_cfg

    cfg = _cfg("turn")
    episodes, _ = make_episodes("TicTacToe", 6, seed=8)
    ring = _ring(cfg, episodes)
    net = TorchModel(TicTacToeNet(), device="cpu")
    net.init_params(seed=0)
    before = [p.detach().clone() for p in net.module.parameters()]
    update = UpdateStep(net.module, LossConfig.from_config(loss_cfg()),
                        make_optimizer(net.module.parameters(), 1e-3),
                        "bfloat16")
    step = make_replay_update_step(ring, update, batch_size=8, seed=0)
    state = ring.device_state()
    metrics = [step(state) for _ in range(3)]
    assert all(float(m["nonfinite"]) == 0 for m in metrics)
    assert all(float(m["dcnt"]) > 0 for m in metrics)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, net.module.parameters()))
