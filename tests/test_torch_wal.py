"""The port's episode WAL and ring warm start, against the JAX package's.

  * WAL behaviour, scenario by scenario on both packages' ``EpisodeWAL``
    (round trip and idempotent double replay, torn tail, bit flip, a
    zero-length segment, retirement, flush cadence on an injected
    clock): the port's trace equals the JAX package's exactly;
  * cross-package replay: the JAX ``EpisodeWAL`` logs episodes made by
    the port's generator (its ``pack_episode`` wire format) and the
    port replays the same episodes under the same seqs; then the
    reverse; and both write the same segment bytes;
  * a record naming a JAX global is refused by the port's reader;
  * ``DeviceReplay.warm_start`` leaves the same ring as ``offer`` +
    ``ingest``, and gathers the same windows as the JAX twin's
    ``warm_start`` on injected indices (exact, on the CPU);
  * the learner's replay keeps only the newest ``wal_keep_episodes``.
"""

import os
import pickle
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.durability import EpisodeWAL as JaxWAL
from handyrl_tpu.staging import DeviceReplay as JaxReplay
from handyrl_tpu_torch.durability import _WAL_REC, EpisodeWAL
from handyrl_tpu_torch.learner import Learner
from handyrl_tpu_torch.staging import DeviceReplay
from handyrl_tpu_torch.utils.tree import tree_leaves
from torchfix import draws, make_episodes, one_torch_thread  # noqa: F401

WALS = {"port": EpisodeWAL, "jax": JaxWAL}


def _fill(cls, path, counts=(4, 3), **kw):
    wal = cls(path, flush_interval=0, **kw)
    i = 0
    for n in counts:
        for _ in range(n):
            wal.append({"i": i})
            i += 1
        wal.roll()
    return wal


def _ids(wal):
    return [ep["i"] for _, ep in wal.replay(set())]


# -- scenarios: each returns a trace; port == jax is the test ------------

def roundtrip_and_double_replay(cls, path):
    wal = _fill(cls, path)
    seen = set()
    first = [(seq, ep["i"]) for seq, ep in wal.replay(seen)]
    again = list(wal.replay(seen))
    reopened = cls(path, flush_interval=0)
    trace = [first, again, reopened.seq, reopened.episode_count(),
             _ids(reopened), reopened.stats()]
    assert [i for _, i in first] == list(range(7)) and again == []
    return trace


def torn_tail(cls, path):
    wal = _fill(cls, path, counts=(3, 3))
    seg = wal.segments()[0]
    data = open(seg, "rb").read()
    open(seg, "wb").write(data[:-5])
    trace = _ids(wal)
    assert trace == [0, 1, 3, 4, 5]
    return trace


def bitflip(cls, path):
    wal = _fill(cls, path, counts=(3, 2))
    seg = wal.segments()[0]
    data = bytearray(open(seg, "rb").read())
    data[len(data) // 2] ^= 0x01
    open(seg, "wb").write(bytes(data))
    trace = _ids(wal)
    assert trace[-2:] == [3, 4] and len(trace) < 5
    return trace


def zero_length_segment(cls, path):
    _fill(cls, path, counts=(2,))
    open(os.path.join(path, "seg-000099.wal"), "wb").close()
    reopened = cls(path, flush_interval=0)
    trace = [_ids(reopened), reopened.episode_count()]
    reopened.append({"i": 2})  # the next segment index follows 99
    trace.append([os.path.basename(p) for p in reopened.segments()])
    assert trace[:2] == [[0, 1], 2]
    return trace


def retirement(cls, path):
    wal = _fill(cls, path, counts=(4, 4, 4))
    trace = [wal.retire(9), [os.path.basename(p) for p in wal.retire(8)],
             wal.episode_count(), wal.retire(100)]
    wal.append({"i": 12})
    wal.checkpoint_landed(8)
    trace += [wal.episode_count(),
              [os.path.basename(p) for p in wal.segments()]]
    assert trace[:4] == [[], ["seg-000000.wal"], 8, []]
    return trace


def flush_cadence(cls, path):
    now = [0.0]
    wal = cls(path, flush_interval=5.0, clock=lambda: now[0])
    wal.append({"i": 0})
    trace = [wal.flushes]
    wal.append({"i": 1})
    trace.append(wal.flushes)
    now[0] += 6.0
    trace += [wal.maybe_flush(), wal.maybe_flush(), wal.flushes]
    wal.seal()
    trace.append(wal.flushes)
    wal.close()
    assert trace[1] == trace[0] and trace[2:4] == [True, False]
    return trace


@pytest.mark.parametrize("scenario", [
    roundtrip_and_double_replay, torn_tail, bitflip, zero_length_segment,
    retirement, flush_cadence], ids=lambda f: f.__name__)
def test_wal_matches_jax(scenario, tmp_path):
    port = scenario(EpisodeWAL, str(tmp_path / "port"))
    jax = scenario(JaxWAL, str(tmp_path / "jax"))
    assert port == jax


def _same_episode(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_either_package_replays_the_others_wal(writer, reader, tmp_path):
    episodes, _ = make_episodes("TicTacToe", 6, seed=3)
    path = str(tmp_path / "wal")
    wal = WALS[writer](path, flush_interval=0, segment_bytes=4096)
    seqs = [wal.append(ep) for ep in episodes[:4]]
    wal.checkpoint_landed(100)
    seqs += [wal.append(ep) for ep in episodes[4:]]
    wal.close()
    assert len(wal.segments()) >= 2  # the roll and the size cut
    replayed = list(WALS[reader](path, flush_interval=0).replay())
    assert [seq for seq, _ in replayed] == seqs
    for (_, got), sent in zip(replayed, episodes):
        _same_episode(got, sent)


def test_both_packages_write_the_same_bytes(tmp_path):
    episodes, _ = make_episodes("TicTacToe", 3, seed=4)
    blobs = {}
    for name, cls in WALS.items():
        wal = cls(str(tmp_path / name), flush_interval=0)
        for ep in episodes:
            wal.append(ep)
        wal.close()
        blobs[name] = [open(p, "rb").read() for p in wal.segments()]
    assert blobs["port"] == blobs["jax"]


def test_a_record_naming_a_jax_global_is_refused(tmp_path, capsys):
    path = str(tmp_path / "wal")
    wal = EpisodeWAL(path, flush_interval=0)
    wal.append({"i": 0})
    wal.close()
    payload = b"\x80\x02cjax.numpy\narray\nq\x00."
    with open(wal.segments()[0], "ab") as f:
        f.write(_WAL_REC.pack(len(payload), zlib.crc32(payload), 2)
                + payload)
    assert _ids(EpisodeWAL(path, flush_interval=0)) == [0]
    assert "unreadable record" in capsys.readouterr().out


# -- warm start -------------------------------------------------------------

CFG = {"turn_based_training": True, "observation": False,
       "forward_steps": 8, "burn_in_steps": 0, "compress_steps": 4,
       "transfer_dtype": "bfloat16", "compute_dtype": "bfloat16"}


def _same_ring(a, b):
    assert (a.size, a.write_ptr, a.episodes_seen, a.t_max) == \
        (b.size, b.write_ptr, b.episodes_seen, b.t_max)
    for x, y in zip(tree_leaves(a.buffers), tree_leaves(b.buffers)):
        n = a.capacity * a.t_max  # the scratch stripe aside
        assert torch.equal(x[:n] if x.shape[0] > n else x[:-1],
                           y[:n] if y.shape[0] > n else y[:-1])


def test_warm_start_equals_offer_and_ingest():
    episodes, _ = make_episodes("TicTacToe", 11, seed=5)
    warm = DeviceReplay(CFG, 16, 1 << 30, device="cpu")
    assert warm.warm_start([None] + episodes, chunk=4) == 11
    live = DeviceReplay(CFG, 16, 1 << 30, device="cpu")
    live.offer(episodes)
    live.ingest(max_episodes=len(episodes))
    _same_ring(warm, live)
    assert warm.dropped == 0 and not warm.pending


def test_warm_start_gathers_what_the_jax_warm_start_gathers():
    """70 episodes: two chunks of the JAX package's 64, a FIFO ring of
    48 that wraps; the same windows on injected indices, exact."""
    episodes, players = make_episodes("TicTacToe", 70, seed=6)
    ring = DeviceReplay(CFG, 48, 1 << 30, device="cpu")
    jring = JaxReplay(CFG, capacity=48, max_bytes=1 << 30)
    assert ring.warm_start(episodes) == jring.warm_start(episodes) == 70
    assert (ring.size, ring.write_ptr, ring.t_max, ring.episodes_seen) == \
        (jring.size, jring.write_ptr, jring.t_max, jring.episodes_seen)
    kept = episodes[-48:]
    picks = draws(kept, CFG, 32, len(players), seed=7)
    # draw i lands in ring slot (22 + i) % 48: the ring wrapped once
    slots = np.asarray([(70 + i) % 48 for i, _, _ in picks])
    tstarts, seats = (np.asarray(c) for c in list(zip(*picks))[1:])
    jb = jring._sample_fn(jring.buffers, jnp.asarray(slots, jnp.int32),
                          jnp.asarray(tstarts, jnp.int32),
                          jnp.asarray(seats, jnp.int32))
    tb = ring.gather(*(torch.from_numpy(c.astype(np.int64))
                       for c in (slots, tstarts, seats)))
    assert sorted(jb) == sorted(tb)
    for key in jb:
        t = tb[key]
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        j = np.asarray(jb[key])
        if j.dtype == jnp.bfloat16:
            j = j.astype(np.float32)
        np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=key)


def test_learner_replay_keeps_the_newest_episodes(tmp_path, capsys):
    episodes, _ = make_episodes("TicTacToe", 9, seed=8)
    wal = EpisodeWAL(str(tmp_path / "wal"), flush_interval=0)
    for ep in episodes:
        wal.append(ep)
    wal.close()
    ring = DeviceReplay(CFG, 16, 1 << 30, device="cpu")
    learner = Learner.__new__(Learner)
    learner.wal = EpisodeWAL(str(tmp_path / "wal"), flush_interval=0)
    learner.args = {"wal_keep_episodes": 4, "maximum_episodes": 100}
    learner.max_policy_lag = 0
    learner.device = torch.device("cpu")
    learner.trainer = types.SimpleNamespace(device_replay=ring)
    learner._replay_wal()
    assert learner.episodes_replayed == 4
    assert "wal: replayed 4 of 9 logged episode(s)" in capsys.readouterr().out
    newest = DeviceReplay(CFG, 16, 1 << 30, device="cpu")
    newest.warm_start(episodes[-4:])
    _same_ring(ring, newest)
    assert not hasattr(learner, "episodes_received")  # no epoch tick
    # every episode survived the pickle round trip through the log
    for (_, got), sent in zip(learner.wal.replay(), episodes):
        assert pickle.dumps(got) == pickle.dumps(sent)
