"""Runtime guards: retrace, numerics, host-transfer, stall, lock-order
and resource accounting.

The runtime half of ``handyrl_tpu.analysis.guards``, with torch inside.
The static linters of the JAX package's ``analysis/`` are not part of
the port; the guards measure what only a running program knows:

  * :class:`RetraceGuard` wraps a step callable and counts its distinct
    abstract call signatures ((treedef, shape, dtype) per argument
    leaf).  The JAX guard counts the same host-side signatures, not XLA
    compiles, so it ports as is.  In eager PyTorch a new signature is
    still a cost: a fresh cuDNN algorithm search, new caching-allocator
    blocks, and a CUDA graph that cannot be replayed.  The learner's
    step must keep one signature per run, plus the replay ring's
    designed growths (``allowance``).
  * :class:`NumericsGuard` latches each argument leaf's dtype at the
    first call and counts later divergence (``numerics_contract_breaks``
    for a concrete dtype flip, ``weak_upcasts`` for a flip between a
    Python number and an array), and counts nonfinite update steps from
    the step's in-graph flag (``nonfinite_steps``).
  * :class:`HostTransferGuard` counts device->host syncs by interposing
    on the Python-visible sync entry points of ``torch.Tensor``.
  * :class:`StallWatchdog` samples the learner's control-plane loops
    for silent wedges (``stall_events``).
  * :class:`LockOrderGuard` wraps the control plane's locks in timing
    and ordering proxies (``lock_contention_sec``,
    ``lock_order_inversions``).
  * :class:`ResourceLedger` samples the process's fd, thread and
    shared-memory populations once per epoch (``fd_count``,
    ``thread_count``, ``shm_segments``, ``resource_growth``).

  * :class:`ShardingContractGuard` latches each argument leaf's layout
    at the first call — its device and, for a DTensor, its mesh and
    placements — and counts later divergence (``resharding_copies``):
    a tensor that changed layout mid-run costs a copy (a transfer or a
    redistribution) on every step.

All are near-zero cost (a dict lookup, an integer bump per event) and
run armed by default: the learner writes their per-epoch deltas into
``metrics.jsonl`` next to the loss curves.
"""

import os
import sys
import threading
import time
import traceback

from ..utils.tree import tree_flatten


class RetraceError(RuntimeError):
    """A guarded step saw more signatures than its budget allows."""


class HostTransferError(RuntimeError):
    """More device->host transfers than the armed budget allows."""


class ShardingContractError(RuntimeError):
    """More resharding copies than the armed budget allows."""


class NumericsError(RuntimeError):
    """More nonfinite update steps than the armed budget allows."""


class ResourceError(RuntimeError):
    """The fd population grew past the armed budget."""


def _shape(leaf):
    return tuple(getattr(leaf, "shape", ()))


class _GuardedCall:
    """Callable proxy that counts the distinct abstract signatures of
    one step callable: (treedef, shape, dtype) per leaf, read BEFORE the
    call (an in-place step may change its arguments)."""

    # every call is fingerprinted for the first WARM_CALLS, then one in
    # SAMPLE_EVERY: persistent shape churn is still caught within
    # SAMPLE_EVERY steps; a one-call transient between samples can slip
    # through (the JAX package's trade)
    WARM_CALLS = 64
    SAMPLE_EVERY = 8

    def __init__(self, guard, fn):
        self._guard = guard
        self._fn = fn
        self._signatures = set()
        self._calls = 0

    def _signature(self, args, kwargs):
        leaves, treedef = tree_flatten((args, kwargs))
        return treedef, tuple(
            (_shape(leaf), getattr(leaf, "dtype", type(leaf)))
            for leaf in leaves)

    def __call__(self, *args, **kwargs):
        self._calls += 1
        if (self._calls <= self.WARM_CALLS
                or self._calls % self.SAMPLE_EVERY == 0):
            self._signatures.add(self._signature(args, kwargs))
        out = self._fn(*args, **kwargs)
        self._guard._after_call()
        return out

    @property
    def compiles(self) -> int:
        return len(self._signatures)

    def __getattr__(self, name):
        return getattr(self._fn, name)


class RetraceGuard:
    """Signature accounting over one or more step callables.

    ::

        guard = RetraceGuard(max_compiles=1, name="update_step")
        step = guard.wrap(make_replay_update_step(...))
        ...
        guard.compiles        # distinct signatures so far
        guard.check()         # raises RetraceError over budget

    ``max_compiles=0`` counts without asserting.  The check also runs
    after every wrapped call, so a retrace surfaces at (or within a few
    steps of) the step that caused it.  ``allowance`` widens the budget
    for signatures the caller knows are legitimate (the replay ring's
    growth count).  The JAX guard's ``on_compile`` hook has no
    counterpart: the port's cost model harvests FLOPs in its own
    first-call wrapper (:meth:`..telemetry.costmodel.CostModel.call`).
    """

    def __init__(self, max_compiles: int = 0, name: str = "step"):
        self.max_compiles = int(max_compiles or 0)
        self.allowance = 0
        self.name = name
        self.calls = 0
        self._wrapped = []

    def wrap(self, fn):
        """Wrap a step callable; returns the counting proxy."""
        proxy = _GuardedCall(self, fn)
        self._wrapped.append(proxy)
        return proxy

    @property
    def compiles(self) -> int:
        return sum(proxy.compiles for proxy in self._wrapped)

    def _after_call(self):
        self.calls += 1
        self.check()

    def check(self):
        budget = self.max_compiles + self.allowance
        if self.max_compiles and self.compiles > budget:
            raise RetraceError(
                f"{self.name} saw {self.compiles} call signatures "
                f"(budget {budget}) over {self.calls} calls — input "
                f"shapes/dtypes are churning; pad batches to fixed shapes")


class _ShardedCall:
    """Callable proxy that checks one step's layout contract.

    Each argument treedef carries a per-leaf contract that LATCHES on
    the first layout seen at that leaf: its device and, for a DTensor,
    its mesh and placements.  A later leaf laid out differently is a
    resharding copy — the step moves it (a device transfer or a DTensor
    redistribution) before it can run.  Leaves without a layout of
    their own (Python numbers, numpy arrays) are skipped, as the JAX
    guard skips uncommitted values; on a single device nothing can
    change layout, so the guard is inert there.  A NEW treedef is a
    different program with its own contract.  Layouts are read BEFORE
    the call; sampled on the :class:`_GuardedCall` schedule.
    Limitation, as in JAX: a leaf on the wrong layout from its very
    first call latches that layout and stays quiet.

    ``state``, when given, returns ``{name: tensor}`` of what the step
    carries in place instead of taking as arguments (the parameters and
    the optimizer's moments, which JAX passes to its jitted step): each
    name latches its layout as an argument leaf does.
    """

    WARM_CALLS = _GuardedCall.WARM_CALLS
    SAMPLE_EVERY = _GuardedCall.SAMPLE_EVERY

    def __init__(self, guard, fn, state=None):
        self._guard = guard
        self._fn = fn
        self._state = state
        self._contracts = {}
        self._state_contract = {}
        self._calls = 0
        self.copies = 0

    @staticmethod
    def _layout(leaf, tensor_type):
        if not isinstance(leaf, tensor_type):
            return None
        return (str(leaf.device), getattr(leaf, "device_mesh", None),
                tuple(getattr(leaf, "placements", ())))

    def _check(self, args, kwargs):
        import torch

        leaves, treedef = tree_flatten((args, kwargs))
        contract = self._contracts.get(treedef)
        if contract is None or len(contract) != len(leaves):
            contract = self._contracts[treedef] = [None] * len(leaves)
        mismatched = 0
        for i, leaf in enumerate(leaves):
            layout = self._layout(leaf, torch.Tensor)
            if layout is None:
                continue
            if contract[i] is None:
                contract[i] = layout
            elif contract[i] != layout:
                mismatched += 1
        for name, leaf in (self._state() if self._state else {}).items():
            layout = self._layout(leaf, torch.Tensor)
            if layout is None:
                continue
            if self._state_contract.setdefault(name, layout) != layout:
                mismatched += 1
        if mismatched:
            self._guard._note(mismatched, self)

    def __call__(self, *args, **kwargs):
        self._calls += 1
        if (self._calls <= self.WARM_CALLS
                or self._calls % self.SAMPLE_EVERY == 0):
            self._check(args, kwargs)
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)


class ShardingContractGuard:
    """Resharding-copy accounting over one or more step callables.

    ::

        guard = ShardingContractGuard(name="update_step")
        step = guard.wrap(make_sharded_update_step(...))
        ...
        guard.copies          # resharding copies observed so far
        guard.snapshot()      # copies since the previous snapshot

    The learner arms one around the update step, with the step's
    parameters and Adam moments as its ``state``, and reports the
    per-epoch delta as ``resharding_copies``; steady state is 0 (the
    parameters and the optimizer keep their layouts in place, the feed
    stages rows on the rank's device).  ``max_copies > 0`` turns the
    count into a hard assertion (:class:`ShardingContractError`) raised
    at the offending call."""

    def __init__(self, max_copies: int = 0, name: str = "step"):
        self.max_copies = int(max_copies or 0)
        self.name = name
        self._last_snapshot = 0
        self._wrapped = []

    def wrap(self, fn, state=None):
        """Wrap a step callable; returns the checking proxy.  ``state``
        returns ``{name: tensor}`` of what the step keeps in place
        (see :class:`_ShardedCall`)."""
        proxy = _ShardedCall(self, fn, state)
        self._wrapped.append(proxy)
        return proxy

    @property
    def copies(self) -> int:
        return sum(proxy.copies for proxy in self._wrapped)

    def _note(self, mismatched: int, proxy: "_ShardedCall"):
        proxy.copies += mismatched
        if self.max_copies and self.copies > self.max_copies:
            raise ShardingContractError(
                f"{self.name}: {self.copies} resharding copies "
                f"(budget {self.max_copies}) — an argument's layout "
                f"changed mid-run, so the step copies it on every "
                f"call; re-stage the input on the layout of the first "
                f"call")

    def snapshot(self) -> int:
        """Copies since the previous snapshot (per-epoch delta)."""
        delta = self.copies - self._last_snapshot
        self._last_snapshot = self.copies
        return delta


class _DtypeCall:
    """Callable proxy that checks one step's dtype contract.

    Each argument treedef latches a per-leaf ``(dtype, weak)`` signature
    at its first call, with no re-latch: a later call whose leaf arrives
    at another concrete dtype is a contract break; a flip where one side
    is weak is a weak upcast.  Torch has no weak types: a Python number
    is the weak side (as a JAX weak-typed scalar is), so a leaf that
    flips between a Python number and a tensor counts as a weak upcast.
    A new treedef is a different program with a fresh contract; leaves
    that are neither arrays nor Python numbers are skipped.  Sampled on
    the :class:`_GuardedCall` schedule.
    """

    WARM_CALLS = _GuardedCall.WARM_CALLS
    SAMPLE_EVERY = _GuardedCall.SAMPLE_EVERY

    def __init__(self, fn):
        self._fn = fn
        self._contracts = {}
        self._calls = 0
        self.contract_breaks = 0
        self.weak_upcasts = 0

    @staticmethod
    def _leaf_sig(leaf):
        dtype = getattr(leaf, "dtype", None)
        if dtype is not None:
            return (str(dtype), bool(getattr(leaf, "weak_type", False)))
        if isinstance(leaf, (bool, int, float)):
            return (type(leaf).__name__, True)
        return None  # host-side leaf with no dtype story

    def _check(self, args, kwargs):
        leaves, treedef = tree_flatten((args, kwargs))
        contract = self._contracts.get(treedef)
        if contract is None or len(contract) != len(leaves):
            contract = self._contracts[treedef] = [None] * len(leaves)
        breaks = upcasts = 0
        for i, leaf in enumerate(leaves):
            sig = self._leaf_sig(leaf)
            if sig is None:
                continue
            if contract[i] is None:
                contract[i] = sig
                continue
            if sig == contract[i]:
                continue
            (dtype0, weak0), (dtype1, weak1) = contract[i], sig
            if weak0 or weak1:
                upcasts += 1
            elif dtype0 != dtype1:
                breaks += 1
        self.contract_breaks += breaks
        self.weak_upcasts += upcasts

    def __call__(self, *args, **kwargs):
        self._calls += 1
        if (self._calls <= self.WARM_CALLS
                or self._calls % self.SAMPLE_EVERY == 0):
            self._check(args, kwargs)
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)


class NumericsGuard:
    """Dtype-contract and nonfinite-step accounting for the update step.

    ::

        guard = NumericsGuard(max_nonfinite=0, name="update_step")
        step = guard.wrap(step)
        ...
        guard.note_step(flag)   # per step, from the epoch's one copy
        guard.snapshot()        # per-epoch metric deltas

    The update step computes a nonfinite flag on the device (loss or
    gradient norm not finite, ``ops/update.py``); the trainer feeds the
    per-step flags to :meth:`note_step` after the epoch's single
    device->host copy of the metrics, so counting adds no sync.
    ``max_nonfinite > 0`` raises :class:`NumericsError` past the budget;
    0 counts without asserting.  ``enabled=False`` makes the guard a
    true no-op.
    """

    def __init__(self, max_nonfinite: int = 0, name: str = "step",
                 enabled: bool = True):
        self.max_nonfinite = int(max_nonfinite or 0)
        self.name = name
        self.enabled = bool(enabled)
        self.nonfinite_steps = 0
        self._last_nonfinite = 0
        self._last_breaks = 0
        self._last_upcasts = 0
        self._wrapped = []

    def wrap(self, fn):
        """The checking proxy of ``fn`` (``fn`` itself when disabled)."""
        if not self.enabled:
            return fn
        proxy = _DtypeCall(fn)
        self._wrapped.append(proxy)
        return proxy

    @property
    def contract_breaks(self) -> int:
        return sum(p.contract_breaks for p in self._wrapped)

    @property
    def weak_upcasts(self) -> int:
        return sum(p.weak_upcasts for p in self._wrapped)

    def note_step(self, flag) -> bool:
        """Count one step's nonfinite flag (0.0 clean, 1.0 poisoned);
        returns whether the step was nonfinite."""
        if not self.enabled:
            return False
        try:
            bad = float(flag) >= 0.5
        except (TypeError, ValueError):
            return False
        if bad:
            self.nonfinite_steps += 1
            if self.max_nonfinite \
                    and self.nonfinite_steps > self.max_nonfinite:
                raise NumericsError(
                    f"{self.name}: {self.nonfinite_steps} nonfinite "
                    f"update steps (budget {self.max_nonfinite}) — the "
                    f"loss or gradient went NaN/Inf; check the lr and "
                    f"clip settings before the parameters are "
                    f"unrecoverable")
        return bad

    def snapshot(self) -> dict:
        """Per-epoch deltas, keyed as the metrics jsonl expects."""
        breaks, upcasts = self.contract_breaks, self.weak_upcasts
        out = {
            "nonfinite_steps": self.nonfinite_steps - self._last_nonfinite,
            "numerics_contract_breaks": breaks - self._last_breaks,
            "weak_upcasts": upcasts - self._last_upcasts,
        }
        self._last_nonfinite = self.nonfinite_steps
        self._last_breaks = breaks
        self._last_upcasts = upcasts
        return out

    def stats(self) -> dict:
        """Cumulative totals for the status endpoint."""
        return {"nonfinite_steps": self.nonfinite_steps,
                "numerics_contract_breaks": self.contract_breaks,
                "weak_upcasts": self.weak_upcasts,
                "max_nonfinite_steps": self.max_nonfinite}


class StallWatchdog:
    """Samples registered control-plane loops for silent wedges.

    Each watched loop calls :meth:`beat` once per pass.  A background
    sampler checks every ``max_stall_seconds / 4``: a loop whose last
    beat is older than the threshold is one counted ``stall_event``
    with a one-shot stack dump of its thread; a loop that beats again
    recovers and can stall again later.  ``on_stall(name, silent_sec)``
    runs once per newly stalled loop (the learner wires the flight
    recorder's dump there).  The clock is injectable; with an injected
    clock the sampler is usually left unstarted and :meth:`sample`
    driven by hand.
    """

    def __init__(self, max_stall_seconds: float = 60.0,
                 clock=time.monotonic):
        self.max_stall = float(max_stall_seconds or 60.0)
        self.clock = clock
        self.stall_events = 0
        self._last_snapshot = 0
        self._loops = {}  # name -> [last_beat, stalled, thread_ident]
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self.on_stall = None

    def beat(self, loop: str = "server"):
        """Prove one loop alive (call once per loop pass)."""
        now = self.clock()
        with self._lock:
            state = self._loops.get(loop)
            if state is None:
                self._loops[loop] = [now, False, threading.get_ident()]
            else:
                state[0] = now
                state[1] = False  # a beating loop has recovered
                state[2] = threading.get_ident()

    def sample(self, now=None) -> int:
        """One watchdog pass: how many loops NEWLY stalled."""
        if now is None:
            now = self.clock()
        newly = []
        with self._lock:
            for name, state in self._loops.items():
                if state[1] or now - state[0] <= self.max_stall:
                    continue
                state[1] = True
                self.stall_events += 1
                newly.append((name, now - state[0], state[2]))
        hook = self.on_stall
        for name, silent, ident in newly:
            self._dump(name, silent, ident)
            if hook is not None:
                try:
                    hook(name, silent)
                except Exception as exc:  # a dead hook must not kill
                    print(f"WARNING: on_stall hook failed ({exc!r})")
        return len(newly)

    def _dump(self, name, silent, ident):
        frame = sys._current_frames().get(ident)
        where = "".join(traceback.format_stack(frame)) if frame \
            else "  <thread gone>\n"
        print(f"WARNING: control-plane loop '{name}' silent for "
              f"{silent:.1f}s (> max_stall_seconds={self.max_stall}); "
              f"stack of the stalled thread:\n{where}", end="")

    def snapshot(self) -> int:
        """Stall events since the previous snapshot (per-epoch delta)."""
        with self._lock:
            delta = self.stall_events - self._last_snapshot
            self._last_snapshot = self.stall_events
            return delta

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()
        return self

    def _run(self):
        interval = max(0.5, self.max_stall / 4.0)
        while not self._stop.wait(interval):
            self.sample()

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)


def _on_device(tensor):
    """The default predicate: a tensor off the CPU syncs to read."""
    return tensor.device.type != "cpu"


def _to_host(args, kwargs):
    """Does a ``Tensor.to(...)`` call name the CPU as its target?"""
    import torch

    target = kwargs.get("device")
    if target is None:
        for arg in args:
            if isinstance(arg, (str, torch.device)):
                target = arg
                break
            if isinstance(arg, torch.Tensor):
                target = arg.device
                break
    if target is None or isinstance(target, int):
        return False  # a dtype-only cast, or a CUDA ordinal
    return torch.device(target).type == "cpu"


# the Python-visible sync entry points of a tensor
_SYNC_METHODS = ("item", "tolist", "cpu", "__float__", "__int__",
                 "__bool__", "to")
_ABSENT = object()


class HostTransferGuard:
    """Context manager counting device->host syncs while armed.

    ::

        with HostTransferGuard() as guard:
            run_epoch()
        print(guard.transfers)

    The JAX guard patches ``jax.device_get``, ``np.asarray`` and
    ``np.array``.  A torch tensor syncs through its own methods, so this
    one patches those on ``torch.Tensor``: ``item``, ``tolist``,
    ``cpu``, ``__float__``, ``__int__``, ``__bool__``, and ``to`` with
    a CPU target.  A call counts only when ``is_device(tensor)`` holds
    (default: the tensor is off the CPU; injectable, so CPU tests can
    exercise the counting).  A CPU tensor costs one predicate call, so
    big host data stays cheap.  Syncs inside ops (a data-dependent
    shape, ``torch.nonzero``, a ``.copy_`` into host memory) are not
    method calls and go uncounted: ``torch.cuda.set_sync_debug_mode``
    sees those.  The patch is process-wide: every thread's syncs count
    while it is armed, and the wrappers call the original methods with
    the caller's arguments, so ``torch.save`` and the profiler work
    unchanged.  Entry points are restored on exit.  Not reentrant; arm
    one per process.  :meth:`snapshot` gives per-epoch deltas.
    """

    def __init__(self, max_transfers: int = 0, is_device=None):
        self.max_transfers = int(max_transfers or 0)
        self.is_device = is_device if is_device is not None else _on_device
        self.transfers = 0
        self._last_snapshot = 0
        self._lock = threading.Lock()
        self._saved = None

    def _note(self):
        with self._lock:
            self.transfers += 1
            if self.max_transfers and self.transfers > self.max_transfers:
                raise HostTransferError(
                    f"host-transfer budget exceeded: {self.transfers} "
                    f"device->host transfers (budget "
                    f"{self.max_transfers})")

    def snapshot(self) -> int:
        """Transfers since the previous snapshot (per-epoch delta)."""
        with self._lock:
            delta = self.transfers - self._last_snapshot
            self._last_snapshot = self.transfers
            return delta

    def _wrapper(self, name, original):
        guard = self
        if name == "to":
            def method(tensor, *args, **kwargs):
                if guard.is_device(tensor) and _to_host(args, kwargs):
                    guard._note()
                return original(tensor, *args, **kwargs)
        else:
            def method(tensor, *args, **kwargs):
                if guard.is_device(tensor):
                    guard._note()
                return original(tensor, *args, **kwargs)
        method.__name__ = name
        return method

    def __enter__(self):
        import torch

        if self._saved is not None:
            raise RuntimeError("HostTransferGuard is not reentrant")
        cls = torch.Tensor
        self._saved = {name: cls.__dict__.get(name, _ABSENT)
                       for name in _SYNC_METHODS}
        for name in _SYNC_METHODS:
            setattr(cls, name, self._wrapper(name, getattr(cls, name)))
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch

        saved, self._saved = self._saved, None
        if saved is not None:
            for name, value in saved.items():
                if value is _ABSENT:
                    delattr(torch.Tensor, name)
                else:
                    setattr(torch.Tensor, name, value)
        return False


class _GuardedLock:
    """Proxy around one lock that reports waits and ordering to its
    :class:`LockOrderGuard`; a drop-in for ``threading.Lock`` /
    ``RLock``."""

    def __init__(self, guard: "LockOrderGuard", inner, name: str):
        self._guard = guard
        self._inner = inner
        self._name = name

    def acquire(self, blocking=True, timeout=-1):
        clock = self._guard.clock
        t0 = clock()
        got = self._inner.acquire(blocking, timeout)
        waited = max(0.0, clock() - t0)
        if got:
            self._guard._note_acquired(self._name, waited)
        elif waited:
            self._guard._note_wait(waited)
        return got

    def release(self):
        self._inner.release()
        self._guard._note_released(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


class LockOrderGuard:
    """Runtime lock-order and contention accounting for the control
    plane.

    :meth:`wrap` replaces a lock with a :class:`_GuardedLock` proxy and
    :meth:`arm` does so in place on an object attribute (tolerating an
    absent object or attribute).  Every acquire then adds the time the
    thread waited to ``lock_contention_sec`` and records, for each lock
    the thread already holds, the first-seen acquisition order of the
    pair; the reverse order seen later is a counted
    ``lock_order_inversion`` (a latent ABBA deadlock).  A reentrant
    re-acquire records no pair.  ``clock`` is injectable.
    """

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.contention_sec = 0.0
        self.inversions = 0
        self._last_contention = 0.0
        self._last_inversions = 0
        self._names = []                  # wrap() order, for stats()
        self._pairs = {}                  # frozenset({a,b}) -> (a, b)
        self._meta = threading.Lock()     # guards the counters above
        self._held = threading.local()    # per-thread stack of names

    def wrap(self, lock, name: str):
        """Wrap ``lock`` in a reporting proxy registered as ``name``."""
        if isinstance(lock, _GuardedLock):
            return lock
        with self._meta:
            if name not in self._names:
                self._names.append(name)
        return _GuardedLock(self, lock, name)

    def arm(self, obj, attr: str = "_lock", name=None) -> bool:
        """Replace ``obj.attr`` with its wrapped proxy in place; False
        (and nothing done) when the object is None, the attribute is
        missing, or it is already wrapped."""
        if obj is None or not hasattr(obj, attr):
            return False
        lock = getattr(obj, attr)
        if lock is None or isinstance(lock, _GuardedLock):
            return False
        if name is None:
            name = f"{type(obj).__name__}.{attr}"
        setattr(obj, attr, self.wrap(lock, name))
        return True

    def _stack(self):
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def _note_acquired(self, name: str, waited: float):
        stack = self._stack()
        reentrant = name in stack
        if not reentrant and stack:
            with self._meta:
                self.contention_sec += waited
                for held in stack:
                    pair = frozenset((held, name))
                    first = self._pairs.get(pair)
                    if first is None:
                        self._pairs[pair] = (held, name)
                    elif first != (held, name):
                        self.inversions += 1
        elif waited:
            self._note_wait(waited)
        stack.append(name)

    def _note_released(self, name: str):
        stack = self._stack()
        # pop the most recent occurrence: releases may be unnested
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                break

    def _note_wait(self, waited: float):
        with self._meta:
            self.contention_sec += waited

    def snapshot(self) -> dict:
        """Per-epoch deltas, keyed as the metrics jsonl expects."""
        with self._meta:
            contention = self.contention_sec - self._last_contention
            inversions = self.inversions - self._last_inversions
            self._last_contention = self.contention_sec
            self._last_inversions = self.inversions
        return {"lock_contention_sec": round(contention, 6),
                "lock_order_inversions": inversions}

    def stats(self) -> dict:
        """Cumulative totals for the status endpoint."""
        with self._meta:
            return {"locks_guarded": len(self._names),
                    "lock_contention_sec": round(self.contention_sec, 6),
                    "lock_order_inversions": self.inversions}


class ResourceLedger:
    """Per-epoch resource-population sampling (the leak soak meter).

    Each :meth:`snapshot` (once per epoch) samples ``fd_count``
    (entries in ``/proc/self/fd``), ``thread_count``
    (``threading.enumerate()``), ``shm_segments`` (``psm_*`` names in
    ``/dev/shm``, the default names of ``multiprocessing.shared_memory``)
    and ``resource_growth`` (fds above the baseline).  The first
    ``warmup_epochs`` snapshots are bring-up and set the baseline at
    the end of the window: on a card that absorbs the ``/dev/nvidia*``
    fds the CUDA context opens and the caching allocator's warm-up
    mappings.
    ``max_fd_growth > 0`` raises :class:`ResourceError` past the budget;
    0 counts without raising.  Without ``/proc`` the fd samples degrade
    to 0 and the keys stay present.  Both paths are injectable.
    """

    def __init__(self, max_fd_growth: int = 0, warmup_epochs: int = 2,
                 proc_fd_dir: str = "/proc/self/fd",
                 shm_dir: str = "/dev/shm"):
        self.max_fd_growth = max(0, int(max_fd_growth or 0))
        self.warmup_epochs = max(0, int(warmup_epochs))
        self.proc_fd_dir = proc_fd_dir
        self.shm_dir = shm_dir
        self.epochs = 0
        self.baseline = None          # (fd, threads) post-warmup
        self.peak_growth = 0
        self.last = None              # most recent sample dict
        self._lock = threading.Lock()

    def sample(self) -> dict:
        """One population sample (no epoch bookkeeping)."""
        try:
            fds = os.listdir(self.proc_fd_dir)
        except OSError:
            fds = []
        sockets = 0
        for fd in fds:
            try:
                target = os.readlink(os.path.join(self.proc_fd_dir, fd))
            except OSError:
                continue
            if target.startswith("socket:"):
                sockets += 1
        try:
            shm = sum(1 for name in os.listdir(self.shm_dir)
                      if name.startswith("psm_"))
        except OSError:
            shm = 0
        return {"fd_count": len(fds),
                "thread_count": len(threading.enumerate()),
                "shm_segments": shm,
                "socket_count": sockets}

    def snapshot(self) -> dict:
        """One epoch tick: sample, update the baseline and growth, and
        return the metrics-jsonl keys."""
        sampled = self.sample()
        with self._lock:
            self.epochs += 1
            self.last = sampled
            if self.baseline is None and self.epochs > self.warmup_epochs:
                self.baseline = (sampled["fd_count"],
                                 sampled["thread_count"])
            growth = 0
            if self.baseline is not None:
                growth = max(0, sampled["fd_count"] - self.baseline[0])
                self.peak_growth = max(self.peak_growth, growth)
            budget = self.max_fd_growth
        record = {"fd_count": sampled["fd_count"],
                  "thread_count": sampled["thread_count"],
                  "shm_segments": sampled["shm_segments"],
                  "resource_growth": growth}
        if budget and growth > budget:
            raise ResourceError(
                f"fd count grew by {growth} over the post-warmup "
                f"baseline (> max_fd_growth={budget}): "
                f"{sampled['fd_count']} fds ({sampled['socket_count']} "
                f"sockets), {sampled['shm_segments']} shm segments — a "
                f"resource leak; check the container-held handles")
        return record

    def stats(self) -> dict:
        """Cumulative totals for the status endpoint."""
        with self._lock:
            last = dict(self.last) if self.last else {}
            return {"fd_count": last.get("fd_count", 0),
                    "thread_count": last.get("thread_count", 0),
                    "shm_segments": last.get("shm_segments", 0),
                    "socket_count": last.get("socket_count", 0),
                    "baseline_fd": None if self.baseline is None
                    else self.baseline[0],
                    "peak_fd_growth": self.peak_growth,
                    "max_fd_growth": self.max_fd_growth,
                    "epochs_sampled": self.epochs}

    def delta_line(self, since: dict) -> str:
        """One-line human delta against an earlier :meth:`sample`."""
        now = self.sample()

        def arrow(key):
            a, b = since.get(key, 0), now.get(key, 0)
            sign = f"{b - a:+d}" if b != a else "±0"
            return f"{a}->{b} ({sign})"

        return (f"resources: fd {arrow('fd_count')}, "
                f"threads {arrow('thread_count')}, "
                f"shm {arrow('shm_segments')}")
