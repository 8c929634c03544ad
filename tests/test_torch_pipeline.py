"""The port's inference service and pipeline client.

  * batching-window units under an INJECTED clock, ported from
    tests/test_pipeline.py: wait-or-timeout, full-batch short circuit,
    hot swap between batches;
  * the service's answers against the JAX service's for the same
    requests on the same weights (``atol=1e-5``, the forward tolerance
    of test_torch_models.py);
  * a real service thread: served inference equals the local forward
    (same module, same device; ``atol=1e-6`` covers the batch-size
    dependence of CPU convolution kernels), a hot swap copies the new
    params onto the device once, episodes ride the trajectory ring;
  * the jax-order tree helpers that fix the request schema.
"""

import random
import time

import jax
import numpy as np
import pytest

from handyrl_tpu.models import TPUModel
from handyrl_tpu.models.geese_net import GeeseNet as FlaxGeeseNet
from handyrl_tpu.pipeline.config import PipelineConfig as JaxPipelineConfig
from handyrl_tpu.pipeline.service import InferenceService as JaxService
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.models import TorchModel
from handyrl_tpu_torch.models.geese_net import GeeseNet
from handyrl_tpu_torch.pipeline import (
    InferenceService,
    PipelineClient,
    PipelineConfig,
    ShmRing,
    build_obs_spec,
)
from handyrl_tpu_torch.pipeline import shm as shm_mod
from handyrl_tpu_torch.utils.tree import (
    tree_flatten,
    tree_map_leaves,
    tree_unflatten,
)
from torchfix import CHILD_ENV, one_torch_thread  # noqa: F401  (autouse)

# ---------------------------------------------------------------------
# batching-window units (injected clock)
# ---------------------------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.now = 0.0
        self.on_advance = None  # callable(now) hook (scripted arrivals)

    def __call__(self):
        return self.now

    def sleep(self, dt):
        self.now += dt
        if self.on_advance is not None:
            self.on_advance(self.now)


class _StubModel:
    """Counts forwards; policy = row index so replies are checkable."""

    def __init__(self):
        self.calls = []

    def inference_batch(self, obs, hidden=None):
        rows = obs.shape[0]
        self.calls.append(rows)
        return {"policy": np.tile(
            np.arange(rows, dtype=np.float32)[:, None], (1, 3))}


def _make_service(window=1.0, max_batch=64):
    cfg = PipelineConfig.from_config({
        "mode": "on", "batch_window": window, "max_batch": max_batch,
        "ring_slots": 8, "slot_bytes": 4096,
        "traj_slots": 4, "traj_slot_mb": 1})
    clock = _FakeClock()
    model = _StubModel()
    svc = InferenceService(model, cfg, epoch=1, device="cpu",
                           clock=clock, sleep=clock.sleep)
    return svc, clock, model


SPEC = {"leaves": [((2,), "float32")],
        "example": np.zeros(2, np.float32), "rows_max": 4}


def _push_request(desc, seq, rows):
    req = ShmRing.attach(**desc["req"])
    leaves = [np.full((rows, 2), float(seq), np.float32)]
    assert req.push(shm_mod.pack_request(seq, rows, leaves))
    req.close()


def _pop_reply(desc):
    rsp = ShmRing.attach(**desc["rsp"])
    out = rsp.pop(loads=shm_mod.loads_view)
    rsp.close()
    return out


def test_batching_window_waits_for_batch_mates():
    """A second worker's request arriving mid-window joins the SAME
    dispatch; the wait is accounted into infer_queue_wait_sec."""
    svc, clock, model = _make_service(window=1.0)
    try:
        d1 = svc.attach(SPEC)
        d2 = svc.attach(SPEC)
        _push_request(d1, seq=1, rows=2)

        def arrive(now):
            if now >= 0.4 and not arrive.done:
                arrive.done = True
                _push_request(d2, seq=1, rows=3)
        arrive.done = False
        clock.on_advance = arrive

        assert svc.step()
        assert model.calls == [8]          # 5 rows bucket-padded to 8
        r1 = _pop_reply(d1)
        r2 = _pop_reply(d2)
        assert r1[0] == 1 and r2[0] == 1   # both answered, matching seq
        assert r1[2]["policy"].shape == (2, 3)
        assert r2[2]["policy"].shape == (3, 3)
        # rows sliced in arrival order: d1 rows 0-1, d2 rows 2-4
        np.testing.assert_array_equal(r1[2]["policy"][:, 0], [0, 1])
        np.testing.assert_array_equal(r2[2]["policy"][:, 0], [2, 3, 4])
        stats = svc.epoch_stats()
        assert stats["infer_batches"] == 1
        assert stats["infer_requests"] == 2
        assert stats["infer_batch_size_mean"] == 5.0
        assert stats["infer_batch_size_p95"] == 5
        assert stats["infer_queue_wait_sec"] == pytest.approx(1.0,
                                                              abs=0.01)
        assert stats["infer_dispatch_ms_p50"] >= 0.0
        assert svc.epoch_stats()["infer_batches"] == 0  # reset
    finally:
        svc.close()


def test_full_batch_short_circuits_the_window():
    """max_batch staged rows dispatch immediately — the window is a
    ceiling on latency, not a floor."""
    svc, clock, model = _make_service(window=5.0, max_batch=4)
    try:
        d1 = svc.attach(SPEC)
        _push_request(d1, seq=1, rows=4)
        assert svc.step()
        assert clock.now < 5.0             # did not wait out the window
        assert model.calls == [4]          # no padding needed at cap
        assert svc.epoch_stats()["infer_batches"] == 1
    finally:
        svc.close()


def test_oversized_pending_splits_into_max_batch_chunks():
    svc, clock, model = _make_service(window=0.0, max_batch=8)
    try:
        d1 = svc.attach(SPEC)
        d2 = svc.attach(SPEC)
        _push_request(d1, seq=1, rows=4)
        _push_request(d2, seq=1, rows=4)
        _push_request(d1, seq=2, rows=3)
        assert svc.step()
        assert model.calls == [8, 8]       # 8 rows, then 3 padded to 8
        assert svc.stats()["rows_served"] == 11
    finally:
        svc.close()


def test_hot_swap_between_batches_answers_with_new_epoch():
    svc, clock, model = _make_service(window=0.0)
    try:
        d = svc.attach(SPEC)
        _push_request(d, seq=1, rows=1)
        assert svc.step()
        assert _pop_reply(d)[1] == 1       # epoch 1 answered

        model2 = _StubModel()
        svc.set_model(model2, 2)           # the learner's hot swap
        _push_request(d, seq=2, rows=1)
        assert svc.step()
        reply = _pop_reply(d)
        assert reply[1] == 2               # new snapshot, no drop
        assert model2.calls == [8]         # served BY the new model
    finally:
        svc.close()


# ---------------------------------------------------------------------
# the port's service vs the JAX service, same requests
# ---------------------------------------------------------------------

def _geese_models(seed):
    env = make_env({"env": "HungryGeese"})
    jax_model = TPUModel(FlaxGeeseNet(filters=8, blocks=2))
    jax_model.init_params(env.observation(0), seed=seed)
    params = jax.tree.map(np.asarray, jax_model.params)
    return env, jax_model, TorchModel.from_flax(
        GeeseNet(filters=8, blocks=2), params, device="cpu")


def _requests(env, sizes, seed=0):
    random.seed(seed)  # env resets draw start cells from ``random``
    rng = np.random.default_rng(seed)
    out = []
    for seq, rows in enumerate(sizes, 1):
        obs = []
        for _ in range(rows):
            env.reset()
            for _ in range(int(rng.integers(0, 5))):
                env.step({p: int(rng.integers(4)) for p in env.turns()})
                if env.terminal():
                    break
            obs.append(env.observation(int(rng.integers(4))))
        out.append((seq, rows, np.stack(obs)))
    return out


def test_service_answers_match_the_jax_service():
    env, jax_model, torch_model = _geese_models(seed=8)
    window = {"mode": "on", "batch_window": 0.0, "max_batch": 16}
    spec = build_obs_spec(env, rows_max=16)
    requests = _requests(env, sizes=[3, 5, 16, 1])
    replies = []
    for svc in (InferenceService(torch_model, PipelineConfig.from_config(
                    window), epoch=4, device="cpu"),
                JaxService(jax_model, JaxPipelineConfig.from_config(
                    window), epoch=4)):
        try:
            desc = svc.attach(spec)
            got = []
            for seq, rows, obs in requests:
                _push_obs(desc, seq, rows, obs)
                assert svc.step()
                got.append(_pop_reply(desc))
            replies.append(got)
        finally:
            svc.close()
    for ours, theirs in zip(*replies):
        assert ours[:2] == theirs[:2]      # seq, epoch
        for key in ("policy", "value"):
            assert ours[2][key].shape == theirs[2][key].shape
            np.testing.assert_allclose(ours[2][key], theirs[2][key],
                                       rtol=0, atol=1e-5)


def _push_obs(desc, seq, rows, obs):
    req = ShmRing.attach(**desc["req"])
    assert req.push(shm_mod.pack_request(seq, rows, [obs]))
    req.close()


# ---------------------------------------------------------------------
# real service thread + client
# ---------------------------------------------------------------------

def _real_service(model, **cfg_over):
    env = make_env({"env": "HungryGeese"})
    cfg = PipelineConfig.from_config({
        "mode": "on", "batch_window": 0.001, "fallback_after": 2.0,
        **cfg_over})
    svc = InferenceService(model, cfg, epoch=1, device="cpu")
    svc.start()
    client = PipelineClient(svc.attach(build_obs_spec(env, 8)), cfg)
    deadline = time.monotonic() + 20.0
    while not client.healthy() or svc.warm_pending:
        assert time.monotonic() < deadline, "service never warmed"
        time.sleep(0.01)
    return svc, client


def test_served_inference_matches_local():
    """The served forward equals the local one across the batch,
    rows-selected, and single-obs entry points."""
    env, _, model = _geese_models(seed=9)
    batch = _requests(env, sizes=[4], seed=3)[0][2]
    svc, client = _real_service(model)
    try:
        served = client.wrap(model, epoch=1)
        local = model.inference_batch(batch)
        out = served.inference_batch(batch, None)
        np.testing.assert_allclose(out["policy"], local["policy"],
                                   rtol=0, atol=1e-6)
        rows = np.array([0, 2])
        out = served.inference_batch(batch, None, rows=rows)
        np.testing.assert_allclose(out["policy"][rows],
                                   local["policy"][rows], rtol=0, atol=1e-6)
        assert (out["policy"][1] == 0).all()  # unasked rows untouched

        single = served.inference(batch[1], None)
        np.testing.assert_allclose(single["value"], local["value"][1],
                                   rtol=0, atol=1e-6)
        assert svc.stats()["requests"] >= 3
        assert client.fallbacks == 0 and client.local_rows == 0
        assert client.served_rows == 4 + 2 + 1
        assert svc.failure is None
    finally:
        svc.close()
        client.close()


def test_hot_swap_copies_new_params_once_and_serves_them():
    env, _, model = _geese_models(seed=10)
    _, _, model2 = _geese_models(seed=11)
    batch = _requests(env, sizes=[4], seed=4)[0][2]
    svc, client = _real_service(model)
    try:
        loads = svc.stats()["param_loads"]
        served = client.wrap(model, epoch=1)
        served.inference_batch(batch)
        svc.set_model(model2, 2)
        deadline = time.monotonic() + 10.0
        while client.serving_epoch() != 2:
            assert time.monotonic() < deadline, "swap never adopted"
            served.inference_batch(batch)  # adopted between batches
            time.sleep(0.01)
        served2 = client.wrap(model2, epoch=2)
        for _ in range(3):
            out = served2.inference_batch(batch)
        np.testing.assert_allclose(out["policy"],
                                   model2.inference_batch(batch)["policy"],
                                   rtol=0, atol=1e-6)
        assert svc.stats()["param_loads"] == loads + 1
        assert client.replies_by_epoch[2] >= 3
        # a wrapper pinned to the old epoch answers locally, counted
        before = client.local_rows
        served.inference_batch(batch)
        assert client.local_rows == before + 4
        assert client.fallbacks == 0
    finally:
        svc.close()
        client.close()


def test_trajectory_ring_carries_episodes_to_intake():
    env, _, model = _geese_models(seed=12)
    svc, client = _real_service(model, traj_slots=2)
    try:
        assert client.push_episode({"steps": 3, "moment": [b"x"]})
        assert client.push_episode({"steps": 4, "moment": [b"y"]})
        assert not client.push_episode({"steps": 5})  # ring full: spill
        assert client.episodes_spilled == 1
        got = svc.drain_trajectories()
        assert [ep["steps"] for ep in got] == [3, 4]
    finally:
        svc.close()
        client.close()


def test_service_thread_failure_is_recorded_and_stops_the_beat():
    class Broken:
        def inference_batch(self, obs, hidden=None):
            raise RuntimeError("forward exploded")

    cfg = PipelineConfig.from_config({"batch_window": 0.0,
                                      "fallback_after": 0.5})
    svc = InferenceService(Broken(), cfg, epoch=1, device="cpu")
    try:
        svc.start()
        svc.attach(SPEC)          # its warmup forward raises
        svc._thread.join(timeout=10)
        assert not svc.alive
        assert isinstance(svc.failure, RuntimeError)
    finally:
        svc.close()


def test_service_refuses_a_missing_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceService(_StubModel(), PipelineConfig(), epoch=0)


# ---------------------------------------------------------------------
# the request schema's leaf order
# ---------------------------------------------------------------------

TREES = [
    np.zeros(3),
    {"b": np.ones(2), "a": [np.zeros(1), None, (np.ones(3), 2.0)],
     "c": None},
    [{"z": 1, "y": {"q": np.arange(2), "p": None}}, ()],
    None,
]


@pytest.mark.parametrize("index", range(len(TREES)))
def test_tree_helpers_follow_jax_leaf_order(index):
    tree = TREES[index]
    leaves, treedef = tree_flatten(tree)
    ref_leaves, ref_def = jax.tree.flatten(tree)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert a is b
    if tree is None:
        assert leaves == [] and tree_unflatten(treedef, []) is None
    rebuilt = tree_unflatten(treedef, [np.asarray(x) for x in leaves])
    ref = jax.tree.unflatten(ref_def, [np.asarray(x) for x in ref_leaves])
    assert jax.tree.structure(rebuilt) == jax.tree.structure(ref)
    doubled = tree_map_leaves(lambda x: np.asarray(x) * 2, tree)
    ref_doubled = jax.tree.map(lambda x: np.asarray(x) * 2, tree)
    for a, b in zip(jax.tree.leaves(doubled), jax.tree.leaves(ref_doubled)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tree_unflatten(treedef, list(leaves) + [0])


# ---------------------------------------------------------------------
# the heartbeat board across processes
# ---------------------------------------------------------------------

BEAT_CHILD = """
import sys, time
from handyrl_tpu_torch.pipeline.shm import ShmBoard
board = ShmBoard.attach(sys.argv[1])
stop = time.monotonic() + float(sys.argv[2])
while time.monotonic() < stop:
    board.beat(epoch=7)
board.close()
"""


def test_board_beat_is_never_read_torn_across_processes():
    """A writer process beats in a tight loop; every read of the stamp
    in this process must see a recent beat.  ``struct.pack_into``
    zero-fills a field before writing it, which a reader in another
    process saw as a 0.0 stamp ("service dead") in about one read in a
    hundred; the board now publishes each field in one copy and reads
    it until two reads agree."""
    import subprocess
    import sys

    board = shm_mod.ShmBoard.create()
    repo = __file__.rsplit("/tests/", 1)[0]
    proc = subprocess.Popen(
        [sys.executable, "-c", BEAT_CHILD, board.name, "6.0"],
        env={**CHILD_ENV, "PYTHONPATH": repo})
    try:
        deadline = time.monotonic() + 30
        while board.epoch != 7:
            assert time.monotonic() < deadline, "writer never beat"
            time.sleep(0.001)
        reads, worst = 0, 0.0
        stop = time.monotonic() + 1.5
        while time.monotonic() < stop:
            worst = max(worst, board.age())
            reads += 1
            assert board.epoch == 7
        assert reads > 10000
        assert worst < 0.5, f"stale or torn beat read: age {worst}"
    finally:
        proc.wait(timeout=30)
        board.close()


@pytest.mark.parametrize("index", range(len(TREES)))
def test_none_as_leaf_helpers_match_the_jax_package(index):
    """``tree_map``/``tree_stack`` treat ``None`` as a leaf, as the JAX
    package's numpy helpers do (episode moments use it)."""
    from handyrl_tpu.utils import tree as jax_tree

    from handyrl_tpu_torch.utils.tree import tree_map, tree_stack

    tree = TREES[index]
    tag = tree_map(lambda x: "none" if x is None else "leaf", tree)
    assert tag == jax_tree.tree_map(
        lambda x: "none" if x is None else "leaf", tree)
    if tree is None or "c" in (tree if isinstance(tree, dict) else {}):
        return  # None leaves do not stack
    stacked = tree_stack([tree, tree])
    ref = jax_tree.tree_stack([tree, tree])
    for a, b in zip(jax.tree.leaves(stacked), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
