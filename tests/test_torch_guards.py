"""The port's runtime guards against the JAX package's.

CPU twins of tests/test_guards.py for the six guards the port has
(``RetraceGuard``, ``NumericsGuard``, ``HostTransferGuard``,
``StallWatchdog``, ``LockOrderGuard``, ``ResourceLedger``):

  * where both packages' guards take the same inputs (the watchdog and
    the lock guard under an injected clock, the ledger over fixture
    directories, the retrace and numerics counts over seeded numpy
    batches and Python scalars) each scenario runs through both and the
    counters must be equal, and equal to the JAX test's numbers;
  * the host-transfer cases run the port's torch guard with an injected
    device predicate, so CPU tensors count as a card's would: the
    entry points it patches, its deltas and budget, restoration, the
    keyword forms, its refusal to nest, and its cost on big host data.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from handyrl_tpu.analysis import guards as jguards
from handyrl_tpu_torch.analysis import guards as tguards
from torchfix import one_torch_thread  # noqa: F401  (autouse)

def both(scenario, *args):
    """Run one scenario through both packages' guards: equal results."""
    jax = scenario(jguards, *args)
    port = scenario(tguards, *args)
    assert port == jax
    return port


def _batch(seed, rows=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((rows, 3)).astype(dtype),
            "mask": (rng.random((rows, 1)) > 0.5).astype(np.float32),
            "turn": rng.integers(0, 2, (rows,)).astype(np.int32)}


def _identity(*args, **kwargs):
    return args


# -- RetraceGuard --------------------------------------------------------

def test_retrace_guard_stable_shapes_compile_once():
    def run(g):
        guard = g.RetraceGuard(name="step")
        step = guard.wrap(_identity)
        for i in range(5):
            step(_batch(i))
        return guard.compiles, guard.calls

    assert both(run) == (1, 5)


def test_retrace_guard_counts_shape_churn():
    def run(g):
        guard = g.RetraceGuard(name="step")
        step = guard.wrap(_identity)
        step(_batch(0, rows=4))
        step(_batch(1, rows=8))
        step(_batch(2, rows=4, dtype=np.float64))
        return guard.compiles

    assert both(run) == 3


def test_retrace_guard_budget_raises_at_the_offending_call():
    def run(g):
        guard = g.RetraceGuard(max_compiles=1, name="update_step")
        step = guard.wrap(_identity)
        step(_batch(0))
        with pytest.raises(g.RetraceError, match="update_step"):
            step(_batch(1, rows=5))
        return guard.calls

    assert both(run) == 2


def test_retrace_guard_counts_any_callable():
    def run(g):
        guard = g.RetraceGuard(name="plain")
        fn = guard.wrap(lambda x, flag=False: x)
        fn(np.ones(3))
        fn(np.ones(3), flag=True)    # same shapes, new kwarg treedef
        fn(np.ones((3, 1)))
        first = guard.compiles
        fn(np.ones(3))
        return first, guard.compiles

    assert both(run) == (3, 3)


def test_retrace_guard_allowance_exempts_designed_recompiles():
    def run(g):
        guard = g.RetraceGuard(max_compiles=1, name="step")
        step = guard.wrap(_identity)
        step(np.ones(4))
        guard.allowance = 1          # one ring growth happened
        step(np.ones(8))             # the post-growth signature
        with pytest.raises(g.RetraceError):
            step(np.ones(16))        # a third shape is real churn
        return guard.compiles

    assert both(run) == 3


def test_retrace_guard_sampling_still_catches_persistent_churn():
    def run(g):
        warm = getattr(g, "_GuardedCall", None) or g._GuardedJit
        guard = g.RetraceGuard(name="step")
        step = guard.wrap(_identity)
        for _ in range(warm.WARM_CALLS + 10):
            step(np.ones(4))
        before = guard.compiles
        for _ in range(warm.SAMPLE_EVERY):
            step(np.ones(8))         # churn begins past the warm window
        return before, guard.compiles

    assert both(run) == (1, 2)


def test_retrace_guard_sums_over_wrapped_fns_and_sees_tensors():
    def run(g):
        guard = g.RetraceGuard(name="pair")
        a, b = guard.wrap(_identity), guard.wrap(_identity)
        a(np.ones(2))
        b(np.ones(2))
        return guard.compiles

    assert both(run) == 2
    # torch tensors: shape and dtype are the signature
    guard = tguards.RetraceGuard(name="step")
    step = guard.wrap(_identity)
    for _ in range(3):
        step({"x": torch.ones(2, 3), "n": 5})
    step({"x": torch.ones(2, 3, dtype=torch.bfloat16), "n": 5})
    assert guard.compiles == 2


# -- NumericsGuard ---------------------------------------------------------

def test_numerics_guard_stable_dtypes_count_nothing():
    def run(g):
        guard = g.NumericsGuard(name="step")
        step = guard.wrap(_identity)
        for i in range(5):
            step(_batch(i))
        return guard.contract_breaks, guard.weak_upcasts

    assert both(run) == (0, 0)


def test_numerics_guard_counts_injected_fp64_leaf():
    def run(g):
        guard = g.NumericsGuard(name="step")
        step = guard.wrap(_identity)
        step({"w": np.ones(4, np.float32)})
        step({"w": np.ones(4, np.float64)})   # the split-brain leaf
        first = guard.contract_breaks
        step({"w": np.ones(4, np.float64)})   # no re-latch
        return first, guard.contract_breaks

    assert both(run) == (1, 2)
    guard = tguards.NumericsGuard(name="step")
    step = guard.wrap(_identity)
    step({"w": torch.ones(4)})
    step({"w": torch.ones(4, dtype=torch.float64)})
    assert guard.contract_breaks == 1


def test_numerics_guard_weak_flip_is_an_upcast_not_a_break():
    def run(g):
        guard = g.NumericsGuard(name="step")
        step = guard.wrap(_identity)
        step(np.ones(4, np.float32))   # a concrete dtype latches
        step(0.5)                      # a Python number: the weak side
        return guard.weak_upcasts, guard.contract_breaks

    assert both(run) == (1, 0)
    # torch has no weak types: a tensor <-> Python number flip is one
    guard = tguards.NumericsGuard(name="step")
    step = guard.wrap(_identity)
    step(torch.ones(4, dtype=torch.bfloat16))
    step(0.5)
    assert (guard.weak_upcasts, guard.contract_breaks) == (1, 0)


def test_numerics_guard_new_treedef_opens_fresh_contract():
    def run(g):
        guard = g.NumericsGuard(name="step")
        step = guard.wrap(_identity)
        step({"a": np.ones(4, np.float32)})
        step({"a": np.ones(4, np.float32), "b": np.ones(4, np.float16)})
        return guard.contract_breaks

    assert both(run) == 0


def test_numerics_guard_forced_nan_counts_exactly_once_per_step():
    """The update step's flag is fed once per step at the epoch's host
    copy; a device scalar flag works as well as a float."""
    def run(g):
        guard = g.NumericsGuard(name="step")
        bad = [guard.note_step(f) for f in (0.0, 1.0, 0.0)]
        return bad, guard.stats()["nonfinite_steps"]

    assert both(run) == ([False, True, False], 1)
    guard = tguards.NumericsGuard(name="step")
    flags = 1.0 - torch.isfinite(
        torch.tensor([1.0, float("nan"), 2.0])).float()
    assert [guard.note_step(f) for f in flags] == [False, True, False]


def test_numerics_guard_budget_raises_past_max_nonfinite():
    def run(g):
        guard = g.NumericsGuard(max_nonfinite=1, name="update_step")
        guard.note_step(1.0)                   # at budget: count only
        with pytest.raises(g.NumericsError, match="update_step"):
            guard.note_step(1.0)               # over budget
        lax = g.NumericsGuard(max_nonfinite=0, name="step")
        for _ in range(5):
            lax.note_step(1.0)
        return lax.stats()["nonfinite_steps"]

    assert both(run) == 5


def test_numerics_guard_snapshot_is_a_delta():
    def run(g):
        guard = g.NumericsGuard(name="step")
        step = guard.wrap(_identity)
        step(np.ones(4, np.float32))
        step(np.ones(4, np.float16))
        guard.note_step(1.0)
        return guard.snapshot(), guard.snapshot()

    first, second = both(run)
    assert first == {"nonfinite_steps": 1, "numerics_contract_breaks": 1,
                     "weak_upcasts": 0}
    assert second == {"nonfinite_steps": 0, "numerics_contract_breaks": 0,
                      "weak_upcasts": 0}


def test_numerics_guard_off_switch_is_a_true_noop():
    def run(g):
        fn = _identity
        guard = g.NumericsGuard(name="step", enabled=False)
        return guard.wrap(fn) is fn, guard.note_step(1.0), guard.stats()

    assert both(run) == (True, False, {
        "nonfinite_steps": 0, "numerics_contract_breaks": 0,
        "weak_upcasts": 0, "max_nonfinite_steps": 0})


# -- HostTransferGuard ------------------------------------------------------

def _everything_on_device(tensor):
    return True


def test_host_transfer_guard_counts_each_sync_entry_point():
    t = torch.arange(3.0)
    s = torch.tensor(2.0)
    with tguards.HostTransferGuard(is_device=_everything_on_device) as g:
        t.tolist()
        t.cpu()
        t.to("cpu")
        t.to(torch.device("cpu"), torch.float64)
        t.to(device="cpu")
        t.to(s)                  # a CPU tensor as the target
        s.item()
        float(s)
        int(s)
        bool(s)
        f"{s:.1f}"               # __format__ reads through item()
        t.to(torch.float64)      # a dtype-only cast: no transfer
        t.add(1)                 # not a sync entry point
    assert g.transfers == 11


def test_host_transfer_guard_default_predicate_skips_host_tensors():
    t = torch.ones(3)
    with tguards.HostTransferGuard() as g:
        t.tolist()
        t.cpu()
        float(t.sum())
    assert g.transfers == 0


def test_host_transfer_guard_cheap_on_big_host_data():
    big = torch.zeros(2_000_000)
    with tguards.HostTransferGuard() as g:
        t0 = time.perf_counter()
        big.tolist()
        armed = time.perf_counter() - t0
    assert g.transfers == 0
    t0 = time.perf_counter()
    big.tolist()
    bare = time.perf_counter() - t0
    assert armed < bare * 3 + 0.05


def test_host_transfer_guard_snapshot_deltas():
    t = torch.ones(3)
    with tguards.HostTransferGuard(is_device=_everything_on_device) as g:
        t.cpu()
        assert g.snapshot() == 1
        t.cpu()
        t.tolist()
        assert g.snapshot() == 2
        assert g.snapshot() == 0


def test_host_transfer_guard_budget():
    t = torch.ones(3)
    with pytest.raises(tguards.HostTransferError):
        with tguards.HostTransferGuard(max_transfers=1,
                                       is_device=_everything_on_device):
            t.cpu()
            t.cpu()
    # the patch is unwound even when the budget raised
    assert torch.Tensor.cpu is torch._C.TensorBase.cpu


def test_host_transfer_guard_restores_entry_points():
    names = ("item", "tolist", "cpu", "__float__", "__int__", "__bool__",
             "to")
    before = {n: torch.Tensor.__dict__.get(n) for n in names}
    with tguards.HostTransferGuard():
        assert torch.Tensor.item is not torch._C.TensorBase.item
    assert {n: torch.Tensor.__dict__.get(n) for n in names} == before
    assert torch.Tensor.item is torch._C.TensorBase.item


def test_host_transfer_guard_keeps_keyword_signatures_and_results():
    t = torch.arange(4.0)
    with tguards.HostTransferGuard(is_device=_everything_on_device) as g:
        assert t.to(device="cpu", dtype=torch.float64).dtype == \
            torch.float64
        assert t.to(dtype=torch.int32).tolist() == [0, 1, 2, 3]
        assert t.cpu(memory_format=torch.preserve_format).shape == (4,)
        assert torch.tensor(3.5).item() == 3.5
    assert g.transfers == 4   # the int32 copy's tolist() counts too


def test_host_transfer_guard_not_reentrant():
    with tguards.HostTransferGuard() as g:
        with pytest.raises(RuntimeError, match="reentrant"):
            g.__enter__()


def test_host_transfer_guard_counts_every_thread_and_torch_save(tmp_path):
    """The patch is process-wide: another thread's syncs count, and
    ``torch.save`` of a tensor works under it."""
    t = torch.ones(3)
    with tguards.HostTransferGuard(is_device=_everything_on_device) as g:
        worker = threading.Thread(target=lambda: t.tolist())
        worker.start()
        worker.join()
        torch.save({"t": t}, tmp_path / "t.pt")
    assert g.transfers >= 1
    assert torch.equal(torch.load(tmp_path / "t.pt")["t"], t)


# -- StallWatchdog ----------------------------------------------------------

def test_stall_watchdog_counts_and_recovers():
    def run(g):
        t = [0.0]
        dog = g.StallWatchdog(max_stall_seconds=5.0, clock=lambda: t[0])
        dog.beat("server")
        out = []
        for now, beat in ((3.0, False), (6.0, False), (9.0, True),
                          (20.0, False)):
            t[0] = now
            out.append(dog.sample())
            if beat:
                dog.beat("server")
        return out, dog.stall_events

    assert both(run) == ([0, 1, 0, 1], 2)


def test_stall_watchdog_snapshot_is_a_delta():
    def run(g):
        t = [0.0]
        dog = g.StallWatchdog(max_stall_seconds=1.0, clock=lambda: t[0])
        dog.beat("send_loop")
        t[0] = 5.0
        dog.sample()
        return dog.snapshot(), dog.snapshot()

    assert both(run) == (1, 0)


def test_stall_watchdog_tracks_loops_independently():
    def run(g):
        t = [0.0]
        dog = g.StallWatchdog(max_stall_seconds=2.0, clock=lambda: t[0])
        dog.beat("server")
        dog.beat("recv_loop")
        t[0] = 1.5
        dog.beat("recv_loop")         # only the server goes silent
        t[0] = 3.0
        return dog.sample(), dog.stall_events

    assert both(run) == (1, 1)


def test_stall_watchdog_dumps_the_stalled_stack_and_calls_the_hook(capsys):
    calls = []
    t = [0.0]
    dog = tguards.StallWatchdog(max_stall_seconds=1.0, clock=lambda: t[0])
    dog.on_stall = lambda name, silent: calls.append((name, silent))
    dog.beat("server")
    t[0] = 10.0
    dog.sample()
    out = capsys.readouterr().out
    assert "control-plane loop 'server' silent" in out
    assert "File " in out             # a real stack dump
    assert calls == [("server", 10.0)]


def test_stall_watchdog_start_stop_idempotent():
    def run(g):
        dog = g.StallWatchdog(max_stall_seconds=60.0)
        dog.start()
        dog.start()
        dog.beat("server")
        dog.stop()
        dog.stop()
        return dog.stall_events

    assert both(run) == 0


# -- LockOrderGuard ---------------------------------------------------------

def test_lock_guard_counts_contention_with_injected_clock():
    def run(g):
        times = iter([0.0, 1.5, 2.0, 2.0, 3.0, 3.0])
        guard = g.LockOrderGuard(clock=lambda: next(times))
        lock = guard.wrap(threading.Lock(), "A")
        for _ in range(3):
            with lock:
                pass
        return guard.snapshot()

    snap = both(run)
    assert snap["lock_contention_sec"] == pytest.approx(1.5)
    assert snap["lock_order_inversions"] == 0


def test_lock_guard_detects_forced_order_inversion():
    def run(g):
        guard = g.LockOrderGuard(clock=lambda: 0.0)
        a = guard.wrap(threading.Lock(), "A")
        b = guard.wrap(threading.Lock(), "B")
        with a:
            with b:
                pass
        before = guard.inversions
        with b:
            with a:
                pass
        return (before, guard.snapshot()["lock_order_inversions"],
                guard.snapshot()["lock_order_inversions"])

    assert both(run) == (0, 1, 0)


def test_lock_guard_reentrant_reacquire_records_no_pair():
    def run(g):
        guard = g.LockOrderGuard(clock=lambda: 0.0)
        r = guard.wrap(threading.RLock(), "R")
        with r:
            with r:
                pass
        return guard.inversions, guard.stats()["locks_guarded"]

    assert both(run) == (0, 1)


def test_lock_guard_arm_replaces_in_place_and_tolerates_absence():
    def run(g):
        class Box:
            def __init__(self):
                self._lock = threading.Lock()

        guard = g.LockOrderGuard()
        box = Box()
        out = [guard.arm(box, "_lock"),
               isinstance(box._lock, g._GuardedLock),
               guard.arm(box, "_lock"),       # already wrapped
               guard.arm(box, "_missing"),    # absent attribute
               guard.arm(None, "_lock")]      # absent subsystem
        with box._lock:
            out.append(box._lock.locked())
        out.append(box._lock.locked())
        return out

    assert both(run) == [True, True, False, False, False, True, False]


def test_lock_guard_cross_thread_contention_real_clock():
    guard = tguards.LockOrderGuard()
    lock = guard.wrap(threading.Lock(), "hot")
    entered = threading.Event()

    def holder():
        with lock:
            entered.set()
            time.sleep(0.2)

    thread = threading.Thread(target=holder)
    thread.start()
    entered.wait(5)
    with lock:
        pass
    thread.join(5)
    assert guard.stats()["lock_contention_sec"] >= 0.1
    assert guard.stats()["lock_order_inversions"] == 0


# -- ResourceLedger ---------------------------------------------------------

def _fixture_tree(root, fds, shm, sockets=0):
    """A fake /proc/self/fd (symlinks) and /dev/shm for both ledgers."""
    fd_dir, shm_dir = root / "fd", root / "shm"
    for d in (fd_dir, shm_dir):
        d.mkdir(exist_ok=True)
    for p in list(fd_dir.iterdir()) + list(shm_dir.iterdir()):
        p.unlink()
    for i in range(fds):
        target = f"socket:[{i}]" if i < sockets else f"/tmp/file{i}"
        (fd_dir / str(i)).symlink_to(target)
    for i in range(shm):
        (shm_dir / f"psm_{i:04x}").write_bytes(b"")
    (shm_dir / "other").write_bytes(b"")  # not a psm_ segment
    return str(fd_dir), str(shm_dir)


def test_resource_ledger_fixture_sequence_matches_jax(tmp_path):
    """One scripted population sequence through both ledgers: warm-up,
    baseline, growth, peak and the stats, equal field for field."""
    def run(g, root):
        fd_dir, shm_dir = _fixture_tree(root, 10, 2)
        ledger = g.ResourceLedger(warmup_epochs=1, proc_fd_dir=fd_dir,
                                  shm_dir=shm_dir)
        out = []
        for fds, shm, sockets in ((10, 2, 1), (12, 2, 2), (16, 3, 5),
                                  (13, 2, 2)):
            _fixture_tree(root, fds, shm, sockets)
            rec = ledger.snapshot()
            rec.pop("thread_count")
            out.append(rec)
        stats = ledger.stats()
        stats.pop("thread_count")
        return out, stats

    records, stats = both(run, tmp_path)
    assert [r["resource_growth"] for r in records] == [0, 0, 4, 1]
    assert [r["shm_segments"] for r in records] == [2, 2, 3, 2]
    assert stats["baseline_fd"] == 12 and stats["peak_fd_growth"] == 4
    assert stats["socket_count"] == 2


def test_resource_ledger_snapshot_has_stable_keys():
    ledger = tguards.ResourceLedger(warmup_epochs=0)
    record = ledger.snapshot()
    assert set(record) == {"fd_count", "thread_count", "shm_segments",
                           "resource_growth"}
    assert record["fd_count"] > 0 and record["thread_count"] >= 1


def test_resource_ledger_leaked_socket_trips_the_delta():
    ledger = tguards.ResourceLedger(warmup_epochs=1)
    ledger.snapshot()
    ledger.snapshot()                    # sets the baseline
    leaked = [socket.socket() for _ in range(4)]
    try:
        record = ledger.snapshot()
        assert record["resource_growth"] >= 4
        assert ledger.stats()["peak_fd_growth"] >= 4
    finally:
        for s in leaked:
            s.close()
    assert ledger.snapshot()["resource_growth"] <= 1


def test_resource_ledger_leaked_ring_trips_shm_count():
    from handyrl_tpu_torch.pipeline.shm import ShmRing

    ledger = tguards.ResourceLedger(warmup_epochs=0)
    before = ledger.snapshot()["shm_segments"]
    ring = ShmRing.create(slots=2, slot_bytes=128)
    try:
        assert ledger.snapshot()["shm_segments"] == before + 1
    finally:
        ring.close()
    assert ledger.snapshot()["shm_segments"] == before


def test_resource_ledger_budget_raises_past_max_fd_growth(tmp_path):
    def run(g, root):
        fd_dir, shm_dir = _fixture_tree(root, 5, 0)
        ledger = g.ResourceLedger(max_fd_growth=2, warmup_epochs=0,
                                  proc_fd_dir=fd_dir, shm_dir=shm_dir)
        ledger.snapshot()                # baseline
        _fixture_tree(root, 7, 0)
        ledger.snapshot()                # at budget: counts
        _fixture_tree(root, 9, 0)
        with pytest.raises(g.ResourceError):
            ledger.snapshot()
        return ledger.stats()["peak_fd_growth"]

    assert both(run, tmp_path) == 4


def test_resource_ledger_default_budget_never_raises(tmp_path):
    def run(g, root):
        fd_dir, shm_dir = _fixture_tree(root, 3, 0)
        ledger = g.ResourceLedger(warmup_epochs=0, proc_fd_dir=fd_dir,
                                  shm_dir=shm_dir)
        ledger.snapshot()
        _fixture_tree(root, 11, 0)
        return ledger.snapshot()["resource_growth"]

    assert both(run, tmp_path) == 8


def test_resource_ledger_degrades_without_proc(tmp_path):
    def run(g):
        ledger = g.ResourceLedger(proc_fd_dir=str(tmp_path / "nope"),
                                  shm_dir=str(tmp_path / "nope"))
        record = ledger.snapshot()
        return record["fd_count"], record["shm_segments"]

    assert both(run) == (0, 0)


def test_resource_ledger_delta_line_reports_movement():
    ledger = tguards.ResourceLedger()
    base = ledger.sample()
    sock = socket.socket()
    try:
        line = ledger.delta_line(base)
    finally:
        sock.close()
    assert line.startswith("resources: fd ") and "(+1)" in line


# -- ShardingContractGuard -------------------------------------------------

def _placers():
    """Per package, ``place(array, k)``: the array committed to layout
    ``k`` — JAX's virtual CPU devices 0 and 1, the port's CPU and meta
    devices (the meta tensor never runs: the step is an identity)."""
    import jax

    return {
        jguards: lambda a, k: jax.device_put(a, jax.devices()[k]),
        tguards: lambda a, k: torch.as_tensor(a).to(("cpu", "meta")[k]),
    }


def both_placed(scenario):
    """One sharding scenario through both packages' guards, each with
    its own placement: equal results."""
    placers = _placers()
    jax_result = scenario(jguards, placers[jguards])
    port_result = scenario(tguards, placers[tguards])
    assert port_result == jax_result
    return port_result


def test_sharding_guard_counts_changed_layouts_not_host_values():
    def run(g, place):
        guard = g.ShardingContractGuard(name="step")
        step = guard.wrap(_identity)
        a, b = np.ones((4, 3), np.float32), np.zeros((4,), np.float32)
        step(place(a, 0), place(b, 0))      # latches both
        step(place(a, 0), place(b, 0))
        step(place(a, 1), place(b, 0))      # a moved: one copy
        step(place(a, 0), place(b, 1))      # b moved: one more
        step(a, 1.5)                        # host values: no layout
        step({"x": place(a, 1)})            # new treedef: own contract
        step({"x": place(a, 1)})
        first = guard.snapshot()
        return guard.copies, first, guard.snapshot()

    assert both_placed(run) == (2, 2, 0)


def test_sharding_guard_is_inert_on_one_device():
    def run(g, place):
        guard = g.ShardingContractGuard(name="step")
        step = guard.wrap(_identity)
        for i in range(100):
            step(place(_batch(i)["obs"], 0), float(i))
        return guard.copies

    assert both_placed(run) == 0


def test_sharding_guard_budget_raises_at_the_offending_call():
    def run(g, place):
        guard = g.ShardingContractGuard(max_copies=1, name="step")
        step = guard.wrap(_identity)
        a = np.ones((2, 2), np.float32)
        step(place(a, 0))
        step(place(a, 1))                   # 1 copy: within budget
        with pytest.raises(g.ShardingContractError):
            step(place(a, 1))               # 2 > 1
        return guard.copies

    assert both_placed(run) == 2


def test_sharding_guard_samples_after_warmup_and_sums_wrapped():
    def run(g, place):
        guard = g.ShardingContractGuard(name="step")
        one, two = guard.wrap(_identity), guard.wrap(_identity)
        a = np.ones((2,), np.float32)
        for _ in range(64):                 # the warm calls
            one(place(a, 0))
        for i in range(16):                 # sampled: every 8th call
            one(place(a, 1))
        two(place(a, 1))
        two(place(a, 0))
        return guard.copies

    assert both_placed(run) == 3


def test_sharding_guard_counts_a_changed_dtensor_placement():
    """A DTensor leaf whose placement changes mid-run is a resharding
    copy (one rank: the layouts differ in placements only), and an
    armed budget raises at it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from handyrl_tpu_torch.connection import find_free_port

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{find_free_port()}",
        world_size=1, rank=0)
    try:
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("dp",))
        local = torch.ones(4, 3)
        rows = DTensor.from_local(local, mesh, [Shard(0)])
        copy = DTensor.from_local(local, mesh, [Replicate()])
        guard = tguards.ShardingContractGuard(max_copies=1, name="step")
        step = guard.wrap(_identity)
        step(rows)
        step(rows)
        step(copy)                          # placement changed: 1 copy
        assert guard.copies == 1
        with pytest.raises(tguards.ShardingContractError):
            step(copy)                      # 2 > 1
    finally:
        dist.destroy_process_group()


def test_trainer_guard_counts_a_moved_parameter_and_moment(
        tmp_path, monkeypatch):
    """The trainer's sharding guard latches the layouts of the
    parameters and Adam moments the step keeps in place, not only of
    its arguments: a parameter and a moment moved between steps are
    two copies, raised past a budget of 1 at the offending step and
    carried by the next epoch's record once moved back."""
    from handyrl_tpu_torch import learner as tlearner
    from handyrl_tpu_torch.config import Config
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models import TorchModel

    monkeypatch.chdir(tmp_path)
    raw = {"env_args": {"env": "TicTacToe"}, "train_args": {
        "batch_size": 4, "forward_steps": 4, "updates_per_epoch": 2,
        "anakin": {"mode": "on", "num_envs": 8},
        "max_resharding_copies": 1}}
    args = Config.from_dict(raw).train_args.to_dict()
    args["env"] = {"env": "TicTacToe"}
    model = TorchModel(make_env(args["env"]).net(), device="cpu")
    model.init_params(seed=0)
    trainer = tlearner.Trainer(args, model, device="cpu")
    for _ in range(2):
        trainer.update_flag = True      # raised already: one epoch
        trainer.train()
        assert trainer.last_metrics["resharding_copies"] == 0

    module = trainer.update_step.module
    (name, param), (other, held) = list(module.named_parameters())[:2]
    owner, _, attr = name.rpartition(".")
    owner = module.get_submodule(owner)
    state = trainer.optimizer.state[held]
    moment = state["exp_avg"]
    assert f"{other}.exp_avg" in trainer._step_state()
    # one parameter and another's moment moved to another device (the
    # step never runs on them: the guard raises before the call)
    setattr(owner, attr, torch.nn.Parameter(param.detach().to("meta")))
    state["exp_avg"] = moment.to("meta")
    trainer.update_flag = True
    with pytest.raises(tguards.ShardingContractError):
        trainer.train()
    assert trainer.shard_guard.copies == 2

    setattr(owner, attr, param)         # back on the latched layouts
    state["exp_avg"] = moment
    trainer.update_flag = True
    trainer.train()
    assert trainer.last_metrics["resharding_copies"] == 2
    assert trainer.shard_guard.copies == 2
