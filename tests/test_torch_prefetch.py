"""The host batcher path's device feed: the port's packed staging and
``DevicePrefetcher`` against the JAX package's.

  * ``stage_batch`` equals JAX's ``_stage_batch(batch, None, obs_float)``
    leaf for leaf, bit for bit (bfloat16 through its uint16 view), on
    the same ``make_batch`` output of both packages, for TicTacToe
    (turn-based) and a narrow GeeseNet (seat mode) at each wire format;
    and it equals the per-leaf upload it replaced;
  * the prefetcher's contract: at most ``depth`` batches staged, a
    pump's exception is the cause of ``get``'s error, ``stop()`` returns
    while pumps block on a full queue, ``_queue_depth`` counts staged
    batches;
  * training through the prefetcher (one thread, the trainer's epoch
    loop) leaves the parameters equal to direct steps on the same
    batches.
"""

import queue
import threading
import time
import types

import numpy as np
import pytest
import torch

from handyrl_tpu import batch as jbatch
from handyrl_tpu_torch import batch as tbatch
from handyrl_tpu_torch.learner import DevicePrefetcher, Trainer, stage_batch
from handyrl_tpu_torch.utils.tree import tree_map_leaves
from torchfix import draws, make_episodes, one_torch_thread, window  # noqa: F401

MODES = {
    # name: (env, turn_based_training)
    "turn": ("TicTacToe", True),
    "seat": ("HungryGeese", False),
}
# (transfer_dtype, compute_dtype): the wire formats, each with a compute
# dtype whose observations JAX's staging also yields (JAX keeps float32
# and bfloat16 observations as they ship; uint8 decodes to obs_float)
WIRES = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("uint8", "float32"), ("uint8", "bfloat16")]


def _cfg(mode, transfer):
    cfg = {"turn_based_training": MODES[mode][1], "observation": False,
           "forward_steps": 8, "burn_in_steps": 0, "compress_steps": 4}
    if transfer != "float32":
        cfg["transfer_dtype"] = transfer
    return cfg


def _episodes(mode, seed):
    net = None
    if mode == "seat":
        from handyrl_tpu_torch.models.geese_net import GeeseNet

        torch.manual_seed(seed)
        net = GeeseNet(filters=8, blocks=2)
    return make_episodes(MODES[mode][0], 3 if mode == "seat" else 6,
                         seed=seed, net=net)


def _batches(mode, cfg, monkeypatch, n=12, seed=0):
    """The same windows and seats through both packages' make_batch."""
    episodes, players = _episodes(mode, seed)
    picks = draws(episodes, cfg, n, len(players), seed)
    sels = [window(episodes[i], t, cfg) for i, t, _ in picks]
    seats = [players[s] for _, _, s in picks]
    out = []
    for module in (jbatch, tbatch):
        it = iter(seats)
        monkeypatch.setattr(module.random, "choice", lambda seq: next(it))
        out.append(module.make_batch(sels, cfg))
    return out


def _bits(a):
    """A staged leaf as numpy, bfloat16 as its uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _per_leaf_stage(batch, compute_dtype):
    """The upload the packed one replaced: every leaf on its own."""
    obs_dtype = getattr(torch, compute_dtype)

    def obs(a):
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(obs_dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(obs_dtype)

    staged = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items() if k != "observation"}
    staged["observation"] = tree_map_leaves(obs, batch["observation"])
    return staged


@pytest.mark.parametrize("transfer,compute", WIRES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stage_batch_equals_jax(mode, transfer, compute, monkeypatch):
    from handyrl_tpu.learner import _stage_batch

    cfg = _cfg(mode, transfer)
    jb, tb = _batches(mode, cfg, monkeypatch)
    staged = stage_batch(tb, "cpu", compute)
    jstaged = _stage_batch(jb, None, compute)
    plain = _per_leaf_stage(tb, compute)
    assert sorted(staged) == sorted(jstaged) == sorted(plain)
    for key in jstaged:
        got, want, old = (_bits(x[key]) for x in (staged, jstaged, plain))
        assert got.dtype == want.dtype == old.dtype, key
        assert got.shape == want.shape == old.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
        np.testing.assert_array_equal(got, old, err_msg=key)
    assert staged["observation"].dtype == getattr(torch, compute)
    assert all(t.is_contiguous() for t in staged.values())


def test_one_layout_per_batch_geometry(monkeypatch):
    """Two batches of one geometry give one layout (one key of a prefetch
    thread's pinned buffers), its columns in sorted key order."""
    from handyrl_tpu_torch.learner import _geometry

    cfg = _cfg("turn", "bfloat16")
    _, first = _batches("turn", cfg, monkeypatch, seed=0)
    _, second = _batches("turn", cfg, monkeypatch, seed=1)
    assert _geometry(first) == _geometry(second)
    assert len({_geometry(first), _geometry(second)}) == 1
    layout = _geometry(first).layout
    assert [key for key, *_ in layout] == sorted(
        k for k in first if k != "observation")
    assert _geometry(first).obs_bits == (True,)


def _forever(batch, pulled):
    def source(timeout=None):
        pulled.append(1)
        return batch
    return source


def _host_batch(monkeypatch):
    return _batches("turn", _cfg("turn", "float32"), monkeypatch, n=4)[1]


@pytest.mark.parametrize("depth,threads", [(2, 2), (3, 1), (0, 0)])
def test_at_most_depth_batches_are_staged(depth, threads, monkeypatch):
    pulled = []
    pf = DevicePrefetcher(_forever(_host_batch(monkeypatch), pulled),
                          depth=depth, device="cpu", threads=threads,
                          compute_dtype="float32")
    try:
        limit, pumps = max(1, depth), max(1, threads)
        assert len(pf.threads) == pumps
        deadline = time.monotonic() + 10
        while pf.staged.qsize() < limit and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)   # let the pumps push against the bound
        assert pf.staged.qsize() == limit
        # each pump holds at most one staged batch it cannot put
        assert len(pulled) <= limit + pumps
        staged = pf.get(timeout=1)
        assert staged["observation"].dtype == torch.float32
    finally:
        pf.stop()


def test_pump_failure_is_the_cause_of_gets_error():
    boom = ValueError("batcher died")

    def source(timeout=None):
        raise boom

    pf = DevicePrefetcher(source, depth=2, device="cpu", threads=2)
    try:
        with pytest.raises(RuntimeError, match="device prefetch failed") as e:
            pf.get(timeout=0.5)
        assert e.value.__cause__ is boom
        assert not any(t.is_alive() for t in pf.threads)
    finally:
        pf.stop()


def test_empty_source_keeps_get_waiting():
    def source(timeout=None):
        time.sleep(timeout)
        raise queue.Empty

    pf = DevicePrefetcher(source, depth=2, device="cpu", threads=1)
    try:
        with pytest.raises(queue.Empty):
            pf.get(timeout=0.2)
    finally:
        pf.stop()


def test_stop_returns_while_pumps_block_on_a_full_queue(monkeypatch):
    pf = DevicePrefetcher(_forever(_host_batch(monkeypatch), []), depth=1,
                          device="cpu", threads=3, compute_dtype="float32")
    deadline = time.monotonic() + 10
    while not pf.staged.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert pf.staged.full()
    t0 = time.monotonic()
    pf.stop()
    assert time.monotonic() - t0 < 5
    assert not any(t.is_alive() for t in pf.threads)


def test_queue_depth_counts_staged_batches(monkeypatch):
    pf = DevicePrefetcher(_forever(_host_batch(monkeypatch), []), depth=3,
                          device="cpu", threads=1, compute_dtype="float32")
    try:
        deadline = time.monotonic() + 10
        while not pf.staged.full() and time.monotonic() < deadline:
            time.sleep(0.01)
        waiting = queue.Queue()
        waiting.put({})
        trainer = types.SimpleNamespace(
            prefetcher=pf, device_replay=None,
            batcher=types.SimpleNamespace(executor=types.SimpleNamespace(
                output_queue=waiting)))
        assert Trainer._queue_depth(trainer) == 3 + 1
        pf.get(timeout=1)
        assert Trainer._queue_depth(trainer) in (3, 4)  # refilled or not
    finally:
        pf.stop()


TRAIN_ARGS = {
    "turn_based_training": True, "observation": False, "gamma": 0.8,
    "forward_steps": 4, "burn_in_steps": 0, "compress_steps": 4,
    "entropy_regularization": 0.1, "entropy_regularization_decay": 0.1,
    "update_episodes": 15, "batch_size": 4, "minimum_episodes": 4,
    "maximum_episodes": 200, "epochs": 1, "lambda": 0.7,
    "policy_target": "TD", "value_target": "TD", "seed": 1,
    "metrics_path": "", "device_replay": "off", "compute_dtype": "float32",
    # no batcher process: the batches come from a scripted source
    "num_batchers": 0, "prefetch_batches": 2, "transfer_threads": 1,
}


def _trainer(model, steps):
    trainer = Trainer(dict(TRAIN_ARGS, updates_per_epoch=steps), model,
                      device="cpu")
    assert trainer.batcher is not None and trainer.device_replay is None
    return trainer


def test_training_through_the_prefetcher_equals_direct_steps(
        tmp_path, monkeypatch):
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models import TorchModel

    monkeypatch.chdir(tmp_path)
    steps = 5
    cfg = _cfg("turn", "float32")
    batches = [_batches("turn", cfg, monkeypatch, n=4, seed=s)[1]
               for s in range(steps)]
    model = TorchModel(make_env({"env": "TicTacToe"}).net(), device="cpu")
    model.init_params(seed=0)

    direct = _trainer(model, steps)
    fed = _trainer(model, steps)
    try:
        for batch in batches:
            direct._host_batch_step(stage_batch(batch, "cpu", "float32"))

        script = iter(batches)

        def source(timeout=None):
            try:
                return next(script)
            except StopIteration:
                time.sleep(timeout)
                raise queue.Empty from None

        fed.prefetcher = DevicePrefetcher(
            source, depth=TRAIN_ARGS["prefetch_batches"], device="cpu",
            threads=TRAIN_ARGS["transfer_threads"],
            compute_dtype="float32")
        # the trainer's own epoch loop: the step budget, then the
        # learner's snapshot request
        epoch = threading.Thread(target=lambda: box.append(fed.train()))
        box = []
        epoch.start()
        deadline = time.monotonic() + 60
        while fed.steps < steps and time.monotonic() < deadline:
            time.sleep(0.01)
        fed.update_flag = True
        epoch.join(timeout=60)
        assert box and box[0] is not None
        assert fed.steps == direct.steps == steps
        assert fed.last_metrics["queue_depth"] == 0
        assert fed.last_metrics["replay"] == "host"
        for (name, p), q in zip(direct.module.named_parameters(),
                                fed.module.parameters()):
            assert torch.equal(p, q), name
    finally:
        direct.stop_feeds()
        fed.stop_feeds()
