"""Batched inference service: the learner-side half of the pipeline.

The counterpart of ``handyrl_tpu.pipeline.service`` on the shm plane.
One server thread owns a device copy of the serving model and answers
obs->action requests from every attached rollout worker: requests
accumulate across workers inside a **wait-or-timeout batching window**
(``pipeline.batch_window`` seconds after the first pending request, or
until ``pipeline.max_batch`` rows are staged, whichever first), then
ONE batched forward covers all of them and replies scatter back over
each worker's reply ring.

The forward keeps its parameters resident on ``device`` in modules
the service owns, a small LRU of them keyed by snapshot: a **hot
swap** (``set_model``) is adopted between batches on the service
thread, which copies the new snapshot's params into a module once; no
request ever pays a parameter upload, and the learner's own tensors
are never read mid-dispatch.  ``param_loads`` counts those copies, one
per distinct snapshot while the LRU holds them all.

**Guards** (the JAX service's contract): the forward runs behind the
port's :class:`~..analysis.guards.RetraceGuard` and
:class:`~..analysis.guards.ShardingContractGuard` (``name=
"inference_batch"``), built with the service, so they survive
``respawn()``.  ``infer_compiles`` counts the forward's distinct call
signatures: one per batch-bucket geometry, never one per snapshot (each
snapshot's parameters are arguments of one guarded forward); ``infer_resharding_copies``
counts arguments whose layout moved (steady state 0; ``max_reshard >
0`` raises past it).  ``mesh_devices`` is the mesh's rank count, 1
without one.  Each dispatch
uploads the bucket-padded observation batch once and downloads the
outputs once (:func:`..models.wrapper.forward_numpy`).  Batch shapes
bucket to powers of two (floor 8, ceiling ``max_batch``), as in the
JAX service, so the device sees a handful of shapes.

Liveness is a heartbeat stamp on a shared ``ShmBoard``: workers watch
its age and fall back to local inference when the service goes silent.
The learner supervises the service thread: a dead one (a crash, or the
``chaos.infer_kill_epoch`` drill's ``inject_kill``) is ``respawn``ed
behind a backoff, with a new board generation.

Counters: ``stats()`` is cumulative; ``epoch_stats()`` reduces the
dispatches since its last call into ``infer_batch_size_{mean,p95}``,
``infer_queue_wait_sec`` and ``infer_dispatch_ms_{p50,p99}`` (host
clock around upload + forward + download of one dispatch).

**Two planes, one window** (docs/serving.md): besides the shm rings,
``submit`` queues NETWORK-plane requests (the serving frontend's
handler threads call it) into the same batching window, so a remote
client's rows and a colocated worker's rows ride one bucket-padded
forward.  A network request may carry an **epoch pin**: ``_routed``
resolves it through ``model_resolver`` (set by the learner), and the
pinned group dispatches with that snapshot's module from the LRU
(bounded by ``snapshot_cache`` + the live one, the learner sets it from
``serving.snapshot_cache``), so alternating pinned and live traffic
never re-copies a snapshot per dispatch.  Every dispatch records an
``infer.batch`` span (rows, window wait, epoch).

Shm chaos (``chaos.shm_*``): the service's board and its end of every
client's rings are wrapped in :class:`~..resilience.chaos.ChaosBoard` /
:class:`~..resilience.chaos.ChaosRing`, seeded as in the JAX service,
so reply pushes can tear, truncate or be refused, request and
trajectory pops can stall, and heartbeats can be withheld or
backdated; ``stats()`` then carries the injected counts (``chaos``).

**With a mesh** (``mesh=``, a rank ``DeviceMesh``): the pow2 bucket
floor rises to a pow2 ``dp`` (a ``dp`` the buckets cannot honour
disarms the mesh with the JAX warning, and the dispatch runs
unsharded; :func:`mesh_bucket_floor`).  Each snapshot's module is laid
out once by :func:`..parallel.mesh.inference_shardings` (tp kernels
compute their output slice, fsdp leaves hold their dp chunk and gather
it), cached on the model keyed by the layout.  ``_forward(model, obs)``
is then a collective: every rank of the mesh calls it in lockstep with
the SAME observation batch, each forwards its ``dp`` rows, and the
outputs are gathered back over ``dp``.  A one-rank mesh is
bit-identical to the mesh-less dispatch.

**Across one host's launched ranks** (``lockstep=``, the
:class:`ServiceGroups` every rank built alike): rank 0's service is the
one batching window of the whole host, and each other rank runs a
:class:`ServiceFollower` thread in its place.  Before each sharded
forward rank 0 broadcasts a word ``(FORWARD, snapshot id, rows)`` and
the observation batch on the groups' gloo group; the followers join
the forward on the groups' own mesh.  A snapshot rank 0 places and the
followers lack goes first as ``(LOAD, snapshot id, evicted id)`` with
its state, so the followers hold exactly the snapshots rank 0's mirror
says (the live one plus ``snapshot_cache`` routed ones) and never read
their own learner's model or ``models/``.  ``stop()`` sends ``STOP``
once the loop has ended; a chaos kill sends nothing (the followers wait
at the next word, and the respawned loop carries on the stream).  A
loop that dies between a word and the end of its forward leaves the
followers mid-collective: ``lockstep_broken`` says so, and the learner
ends the rank.  Hand-started ranks pass no ``lockstep``: each answers
its own workers (the JAX rule for replicas).
"""

import random
import threading
import time
import traceback
from collections import OrderedDict, deque

import numpy as np

import torch

from .. import telemetry
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.wrapper import build_module, forward_numpy
from ..utils.tree import (
    tree_leaves,
    tree_map_leaves,
    tree_structure,
    tree_unflatten,
)
from .shm import (
    ShmBoard,
    ShmRing,
    dumps,
    loads_view,
    unpack_request,
)


class _Client:
    """One attached worker: its three rings + request schema."""

    __slots__ = ("cid", "req", "rsp", "traj", "leaf_specs", "example",
                 "rows_max", "treedef", "req_stuck_since",
                 "traj_stuck_since", "last_seen", "drop_warned")

    def __init__(self, cid, req, rsp, traj, leaf_specs, example,
                 rows_max):
        self.cid = cid
        self.req = req
        self.rsp = rsp
        self.traj = traj
        self.leaf_specs = [(tuple(s), str(d)) for s, d in leaf_specs]
        self.example = example
        self.rows_max = rows_max
        self.treedef = tree_structure(example)
        self.req_stuck_since = None  # torn-write reclaim bookkeeping
        self.traj_stuck_since = None
        self.last_seen = 0.0         # last request/trajectory activity
        self.drop_warned = False     # reply-drop warning, once per client

    def deliver(self, seq, epoch, part) -> bool:
        """Hand one answered request back over the reply ring.  The
        network-plane seat (serving frontend) implements the same
        method by waking its handler thread: dispatch is polymorphic
        over the two planes."""
        return self.rsp.push(dumps((seq, epoch, part)))


def _bucket(n, cap, floor=8):
    """Pad target for an n-row batch: next power of two, floor
    ``floor``, ceiling ``cap``."""
    b = floor
    while b < n:
        b <<= 1
    return min(b, cap)


def _percentile(values, q):
    srt = sorted(values)
    return srt[min(len(srt) - 1, int(q * len(srt)))]


BUCKET_FLOOR = 8

# the lockstep words rank 0 sends its followers: (op, snapshot id, n),
# n the rows of a FORWARD and the snapshot id a LOAD evicts (0: none)
STOP, FORWARD, LOAD = 0, 1, 2


def _dp_floor(dp):
    """The pow2 bucket floor, raised to a pow2 ``dp`` above it."""
    return dp if dp > BUCKET_FLOOR and dp & (dp - 1) == 0 else BUCKET_FLOOR


def mesh_bucket_floor(dp, max_batch):
    """The JAX rule of the sharded dispatch: the pow2 bucket floor a
    ``dp``-way mesh dispatches at, or None when the buckets cannot
    split evenly over ``dp`` (the mesh disarms)."""
    floor = _dp_floor(dp)
    if floor % dp == 0 and int(max_batch) % dp == 0 \
            and floor <= int(max_batch):
        return floor
    return None


class LockstepBroken(ConnectionError):
    """The lockstep between rank 0's service and its followers broke."""


class ServiceGroups:
    """The inference service's own process groups, built on EVERY rank
    of the group, in the same order, before any thread issues a
    collective on them: a gloo group for the words and the observation
    batches (CPU objects, rank 0 the source), and a ``DeviceMesh`` of
    the training mesh's ranks and axes whose groups are its own
    (:func:`..parallel.mesh.own_mesh`), so the service thread's
    collectives never share a communicator with the trainer thread's
    (gloo ones too, whatever the trainer's backend)."""

    def __init__(self, mesh, device_type):
        import torch.distributed as dist

        from ..parallel.mesh import own_mesh
        from ..parallel.multihost import CONTROL_TIMEOUT

        # a follower waits at the next word as long as rank 0's window
        # is idle: the control group's timeout, not gloo's 30 minutes
        self.words = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
        self.mesh = own_mesh(mesh, device_type)

    def send(self, word, payload=None):
        """Rank 0: one word and its payload to every follower."""
        torch.distributed.broadcast_object_list(
            [tuple(word), payload], src=0, group=self.words)

    def recv(self):
        """A follower: rank 0's next ``(word, payload)``."""
        box = [None, None]
        torch.distributed.broadcast_object_list(box, src=0,
                                                group=self.words)
        return box


class _GuardedForward:
    """The guarded forward of a batched dispatch, with or without a
    mesh: what rank 0's service and a follower share."""

    def __init__(self, device, mesh, fsdp, max_reshard):
        from ..analysis.guards import RetraceGuard, ShardingContractGuard

        self.device = resolve_device(device)
        self._mesh = mesh
        self._fsdp = bool(fsdp)
        # the guard contract, the update step's: signatures counted per
        # geometry (one per batch bucket, NOT per snapshot), layout
        # moves at the call boundary budgeted at 0 in steady state
        self.retrace_guard = RetraceGuard(name="inference_batch")
        self.shard_guard = ShardingContractGuard(
            max_copies=int(max_reshard or 0), name="inference_batch")
        self._fwd = None             # the guarded forward of _fwd_spec
        self._infer_sh = None        # InferenceShardings when mesh-armed
        # service-owned modules on the device, LRU by snapshot:
        # id(model) -> (model, (module, {name: tensor})); the model
        # reference pins the id
        self._fwds = OrderedDict()
        self._fwd_spec = None        # (class, config) of the forward
        # routed snapshots the LRU keeps beside the live one (the
        # learner sets serving.snapshot_cache when it serves)
        self.snapshot_cache = 0
        self.param_loads = 0         # snapshots copied onto the device

    @property
    def mesh_devices(self):
        """Ranks of the armed inference mesh (1 without one)."""
        return int(self._mesh.size()) if self._mesh is not None else 1

    def _ensure_forward(self, model):
        """The service-owned guarded forward ``fwd(module, params,
        obs)``, built once per net spec and shared by every snapshot;
        ``params`` (the module's tensors) rides as an argument so the
        guards see each snapshot's layouts, as the JAX jit's arguments.
        With a mesh the inference shardings are planned here.  None for
        duck models without a ``spec`` (RandomModel, stubs), which keep
        their own ``inference_batch``."""
        spec = getattr(model, "spec", None)
        if spec is None:
            return None
        if self._fwd is not None and self._fwd_spec == spec:
            return self._fwd
        self._fwds.clear()
        self._fwd_spec = spec
        self._infer_sh = None
        if self._mesh is not None:
            from ..parallel.mesh import inference_shardings

            self._infer_sh = inference_shardings(
                self._mesh, build_module(spec, "meta"), fsdp=self._fsdp)

        def forward(module, params, obs):
            return module(obs, None)

        self._fwd = self.retrace_guard.wrap(self.shard_guard.wrap(forward))
        return self._fwd

    def _placed(self, model):
        """``(module, params)``: a service-owned device module holding
        ``model``'s parameters, and its tensors by name.

        Without a mesh: from the snapshot LRU, copied once per snapshot
        it does not hold (the live one plus ``snapshot_cache`` routed
        ones); a full LRU hands its least recently used module over to
        the new snapshot instead of building another.  With a mesh: laid
        out on the inference param shardings ONCE per snapshot and
        cached on the model, keyed by the shardings it was placed with
        (a model that crosses services re-places instead of dispatching
        another mesh's layout)."""
        if self._infer_sh is not None:
            cached = getattr(model, "_infer_placed", None)
            if cached is not None and cached[0] is self._infer_sh:
                return cached[1]
            from ..parallel.update import shard_module

            module = build_module(self._fwd_spec, self.device)
            module.load_state_dict(model.module.state_dict())
            shard_module(module, self._mesh, self._infer_sh.params)
            placed = (module, dict(module.named_parameters()))
            model._infer_placed = (self._infer_sh, placed)
            self.param_loads += 1
            return placed
        key = id(model)
        hit = self._fwds.get(key)
        if hit is not None and hit[0] is model:
            self._fwds.move_to_end(key)
            return hit[1]
        if len(self._fwds) > max(0, int(self.snapshot_cache)):
            _old, (module, _params) = self._fwds.popitem(last=False)[1]
        else:
            module = build_module(self._fwd_spec, self.device)
        module.load_state_dict(model.module.state_dict())
        self.param_loads += 1
        placed = (module, dict(module.named_parameters()))
        self._fwds[key] = (model, placed)
        return placed

    def _gather_rows(self, out):
        """Each dp rank's output rows, concatenated in dp order on every
        rank (a collective over the mesh's dp group)."""
        from ..parallel.mesh import AXES

        group = self._mesh.get_group(AXES.index("dp"))
        n = torch.distributed.get_world_size(group)

        def gather(t):
            if t is None or n == 1:
                return t
            parts = [torch.empty_like(t) for _ in range(n)]
            torch.distributed.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts, dim=0)

        return tree_map_leaves(gather, out)

    def _dp_rows(self, obs):
        """The observation rows and this rank's dp slice of them; a row
        count that does not split over ``dp`` raises before any
        collective."""
        from ..parallel.mesh import AXES, axis_size

        dp = axis_size(self._mesh, "dp")
        rows = len(tree_leaves(obs)[0])
        if rows % dp:
            # the bucket floor keeps every dispatch divisible; a direct
            # caller must too
            raise ValueError(f"{rows} observation rows do not split "
                             f"over dp={dp}")
        share = rows // dp
        lo = self._mesh.get_local_rank(AXES.index("dp")) * share
        return rows, tree_map_leaves(lambda a: a[lo:lo + share], obs)

    def _forward(self, model, obs):
        """One batched forward: numpy leaves in, numpy dict out, through
        the guarded forward.  With a mesh, a collective every rank calls
        with the same ``obs``: this rank forwards its dp rows."""
        fwd = self._ensure_forward(model)
        if fwd is None:
            return model.inference_batch(obs, None)
        module, params = self._placed(model)
        if self._mesh is None:
            return forward_numpy(lambda x, _h: fwd(module, params, x),
                                 self.device, obs)
        _rows, local = self._dp_rows(obs)
        return forward_numpy(
            lambda x, _h: self._gather_rows(fwd(module, params, x)),
            self.device, local)


class InferenceService(_GuardedForward):
    """The batched inference server (one per learner process).

    Thread contract: ``attach``/``set_model``/``stats`` may be called
    from the learner's thread; the batching loop runs on the service's
    own thread; ``drain_trajectories`` belongs to the learner thread
    (it is the trajectory rings' single consumer).  ``clock``/``sleep``
    are injectable so the batching window is unit-testable without wall
    time.  ``device`` is where the forward runs (``"cuda"`` unless the
    caller names another).
    """

    TORN_GRACE = 30.0  # seconds a mid-write slot may stall before reclaim
    # a client silent on BOTH rings this long is presumed dead and its
    # rings are reclaimed; a live worker reaped by mistake degrades
    # itself to local inference on the next reply timeout
    CLIENT_IDLE_REAP = 600.0
    GRAVE_GRACE = 10.0  # close only after in-flight snapshots expire

    def __init__(self, model, cfg, epoch=0, device=DEFAULT_DEVICE,
                 clock=time.monotonic, sleep=time.sleep, chaos=None,
                 mesh=None, fsdp=False, max_reshard=0, lockstep=None):
        from ..resilience.chaos import maybe_chaos_board

        self.cfg = cfg
        # the sharded dispatch (module docstring): the pow2 bucket
        # floor must divide by dp so every dispatch splits the rows
        # evenly; a dp the buckets cannot honour disarms the mesh
        # LOUDLY (unsharded dispatch, never a shape error)
        if lockstep is not None:
            mesh = lockstep.mesh
        armed, self._bucket_floor = None, BUCKET_FLOOR
        if mesh is not None:
            from ..parallel.mesh import axis_size

            dp = int(axis_size(mesh, "dp")) or 1
            floor = mesh_bucket_floor(dp, cfg.max_batch)
            if floor is not None:
                armed, self._bucket_floor = mesh, floor
            elif lockstep is not None:
                # the followers would wait for words never sent
                raise ValueError(f"a lockstep dispatch needs an armed "
                                 f"mesh; dp={dp} disarms it")
            else:
                print(f"WARNING: inference mesh disarmed: dp={dp} "
                      f"does not divide the pow2 batch buckets "
                      f"(floor {_dp_floor(dp)}, max_batch "
                      f"{cfg.max_batch}); "
                      f"inference dispatch runs unsharded")
        super().__init__(device, armed, fsdp, max_reshard)
        # the followers' end (module docstring): the snapshots they
        # hold, id(model) -> (model, snapshot id), least recent first
        self._link = lockstep
        self._sent = OrderedDict()
        self._next_sid = 1
        self._midstream = False      # a word sent, its forward not done
        self._released = False       # STOP sent: no word follows
        self.lockstep_forwards = 0   # FORWARD words sent
        self.snapshots_sent = 0      # LOAD words sent
        self.clock = clock
        self.sleep = sleep
        self._lock = threading.Lock()
        self._clients = {}
        self._next_cid = 0
        self._model = model
        self._epoch = int(epoch)
        self._pending_model = None
        # network plane (serving frontend): handler threads queue
        # requests here via submit(); _collect drains them into the
        # same batching window as the shm rings.  The queue belongs to
        # this OBJECT, not the loop thread, so requests queued across a
        # kill are served by the respawned incarnation
        self._net_pending = deque()
        # epoch pin -> model, set by the learner; None makes every
        # non-live pin unroutable (a typed error upstream)
        self.model_resolver = None
        self.net_requests = 0        # cumulative network-plane frames
        # shm chaos: this side produces replies and consumes requests
        # and trajectories, and its heartbeat can be withheld or
        # backdated; one RNG seeded as the JAX service seeds it
        self._chaos = chaos if (chaos is not None
                                and (chaos.shm_faults_enabled
                                     or chaos.shm_beat_faults_enabled)
                                ) else None
        self._chaos_rng = (random.Random((chaos.seed << 20) ^ 0xB0A2)
                           if self._chaos is not None else None)
        self.board = maybe_chaos_board(ShmBoard.create(), self._chaos,
                                       rng=self._chaos_rng)
        self._thread = None
        self._stop = False
        self._kill = False           # chaos: die WITHOUT a parting beat
        self.failure = None          # exception that ended the loop
        self.respawns = 0            # incarnations after the first
        # counters — epoch accumulators reset by epoch_stats()
        self._batch_rows = []
        self._dispatch_sec = []
        self._queue_wait = 0.0
        self._requests_epoch = 0
        self._warm = []              # client ids awaiting a warmup
        self.batches = 0             # cumulative dispatches
        self.requests = 0            # cumulative request frames served
        self.rows_served = 0         # cumulative obs rows answered
        self.reclaimed = 0           # torn slots skipped (dead writers)
        self.corrupt = 0             # undecodable slots skipped
        self.reply_drops = 0         # replies refused by a full/small ring
        self.reaped = 0              # idle clients reclaimed
        self._grave = []             # (deadline, client) pending close

    # -- control-plane face (learner thread) ---------------------------
    def attach(self, spec):
        """Allocate a client slot + rings for one worker's handshake;
        returns the attach descriptor the worker maps."""
        leaf_specs = spec["leaves"]
        rows_max = max(1, int(spec.get("rows_max", 1)))
        row_bytes = sum(
            int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            for shape, dtype in leaf_specs)
        need = 16 + 2 * rows_max * max(1, row_bytes)
        slot = max(int(self.cfg.slot_bytes), need)
        from ..resilience.chaos import maybe_chaos_ring

        def ring(slots, slot_bytes):
            return maybe_chaos_ring(ShmRing.create(slots, slot_bytes),
                                    self._chaos, rng=self._chaos_rng)

        with self._lock:
            cid = self._next_cid
            self._next_cid += 1
            client = _Client(
                cid,
                req=ring(self.cfg.ring_slots, slot),
                rsp=ring(self.cfg.ring_slots, slot),
                traj=ring(self.cfg.traj_slots,
                          int(self.cfg.traj_slot_mb) << 20),
                leaf_specs=leaf_specs,
                example=spec["example"],
                rows_max=rows_max,
            )
            client.last_seen = self.clock()
            self._clients[cid] = client
            # warm this schema's buckets from the SERVICE thread, so the
            # first real request does not pay the first-call setup of
            # the device forward
            self._warm.append(cid)
        return {
            "client": cid,
            "board": self.board.name,
            "req": client.req.descriptor(),
            "rsp": client.rsp.descriptor(),
            "traj": client.traj.descriptor(),
        }

    def set_model(self, model, epoch):
        """Hot-swap the serving snapshot; adopted between batches, so
        no in-flight request is ever dropped."""
        with self._lock:
            self._pending_model = (model, int(epoch))

    # -- network plane (serving frontend handler threads) --------------
    def submit(self, seat, seq, rows, leaves, epoch=None) -> bool:
        """Queue one network-plane request into the batching window.
        ``seat`` is the frontend's client duck type (``treedef`` /
        ``deliver``); ``epoch`` pins the request to a specific snapshot
        (None = the live model).  False = the service is shut down for
        good (the frontend sheds with a typed reply).  A merely-dead
        (killed, pre-respawn) service still accepts: the queue belongs
        to the object, so these requests are served by the respawned
        incarnation; the frontend's admission check
        (``service.alive``) is what sheds NEW arrivals during the gap."""
        if self._stop:
            return False
        with self._lock:
            self._net_pending.append(
                (seat, seq, int(rows), leaves,
                 None if epoch is None else int(epoch)))
        return True

    def inject_kill(self):
        """Chaos: the loop exits without a parting beat, as a killed
        server process would look to the workers (stale board) and to
        the learner (dead thread).  A forward in flight finishes first:
        its replies copy back to the host before the loop looks at the
        flag, so no device work outlives the incarnation."""
        self._kill = True

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        self._kill = False
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="infer-service")
        self._thread.start()

    def respawn(self):
        """Relaunch after a death: same rings, same clients (their state
        lives in shared memory), a fresh dispatch thread on the same
        device.  The board's generation moves, so workers that degraded
        to local inference attach to the new incarnation.  The caller
        ``set_model``s the current snapshot first."""
        if self.alive:
            raise RuntimeError("respawn of a live inference service")
        self.board.bump_generation()
        self.respawns += 1
        self.start()

    def stop(self):
        """End the loop; with followers, then STOP to them (the loop has
        ended, so no word of its own can follow; not when it died
        mid-forward, which leaves them in a collective)."""
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.alive:
            print("WARNING: the inference service's loop outlived its "
                  "stop; its followers are not released")
        elif not self.lockstep_broken:
            self._release()

    def close(self):
        self.stop()
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
            clients.extend(c for _due, c in self._grave)
            self._grave = []
        for c in clients:
            c.req.close()
            c.rsp.close()
            c.traj.close()
        self.board.close()

    # -- metrics -------------------------------------------------------
    def _ring_counts(self, field):
        with self._lock:
            clients = list(self._clients.values())
        return sum(getattr(c.req, field) + getattr(c.rsp, field)
                   + getattr(c.traj, field) for c in clients)

    def ring_full_count(self):
        """Cumulative push refusals across every ring of every client,
        read straight from the shm headers."""
        return self._ring_counts("full_count")

    def torn_slot_count(self):
        """Cumulative torn/corrupt slots skipped across every ring."""
        return self._ring_counts("torn_count")

    def epoch_stats(self):
        """Reduction of the dispatches since the last call; resets the
        epoch accumulators."""
        with self._lock:
            rows = self._batch_rows
            secs = self._dispatch_sec
            wait = self._queue_wait
            requests = self._requests_epoch
            self._batch_rows = []
            self._dispatch_sec = []
            self._queue_wait = 0.0
            self._requests_epoch = 0
        out = {
            "infer_batches": len(rows),
            "infer_requests": requests,
            # the forward's guard contract: copies is the epoch's delta
            # (steady state 0); compiles is cumulative and stops growing
            # once every bucket geometry has been seen
            "infer_resharding_copies": self.shard_guard.snapshot(),
            "infer_compiles": self.retrace_guard.compiles,
            "shm_ring_full_count": self.ring_full_count(),
            "shm_torn_slots": self.torn_slot_count(),
        }
        if rows:
            out["infer_batch_size_mean"] = sum(rows) / len(rows)
            out["infer_batch_size_p95"] = _percentile(rows, 0.95)
            out["infer_queue_wait_sec"] = wait / len(rows)
            out["infer_dispatch_ms_p50"] = 1e3 * _percentile(secs, 0.50)
            out["infer_dispatch_ms_p99"] = 1e3 * _percentile(secs, 0.99)
        return out

    def chaos_counts(self):
        """Faults the service's chaos wrappers injected (empty when shm
        chaos is off)."""
        if self._chaos is None:
            return {}
        with self._lock:
            rings = [r for c in self._clients.values()
                     for r in (c.req, c.rsp, c.traj)]
        counts = {key: sum(getattr(r, key, 0) for r in rings)
                  for key in ("torn_injected", "full_injected",
                              "truncated_injected", "stalls_injected")}
        counts["beats_dropped"] = getattr(self.board, "beats_dropped", 0)
        counts["beats_delayed"] = getattr(self.board, "beats_delayed", 0)
        return counts

    def stats(self):
        """Cumulative snapshot (status endpoint)."""
        with self._lock:
            n = len(self._clients)
        chaos = self.chaos_counts()
        return {**({"chaos": chaos} if chaos else {}),
            "clients": n,
            "epoch": self._epoch,
            "alive": self.alive,
            "device": str(self.device),
            "generation": self.board.generation,
            "respawns": self.respawns,
            "batches": self.batches,
            "requests": self.requests,
            "rows_served": self.rows_served,
            "param_loads": self.param_loads,
            "net_requests": self.net_requests,
            "device_modules": len(self._fwds),
            "shm_ring_full_count": self.ring_full_count(),
            "shm_torn_slots": self.torn_slot_count(),
            "torn_reclaimed": self.reclaimed,
            "corrupt_slots": self.corrupt,
            "reply_drops": self.reply_drops,
            "clients_reaped": self.reaped,
            "infer_resharding_copies": self.shard_guard.copies,
            "infer_compiles": self.retrace_guard.compiles,
            "mesh_devices": self.mesh_devices,
            **({"lockstep_forwards": self.lockstep_forwards,
                "snapshots_sent": self.snapshots_sent}
               if self._link is not None else {}),
        }

    # -- trajectory intake (learner thread) ----------------------------
    def drain_trajectories(self, max_episodes=512):
        """Pop finished episodes off every client's trajectory ring."""
        episodes = []
        now = self.clock()
        with self._lock:
            clients = list(self._clients.values())
        for c in clients:
            while len(episodes) < max_episodes:
                try:
                    ep = c.traj.pop(loads=loads_view)
                except Exception as exc:
                    self._skip_corrupt(c.traj, c.cid, "trajectory", exc)
                    continue
                if ep is None:
                    c.traj_stuck_since = self._maybe_reclaim(
                        c.traj, c.traj_stuck_since, now,
                        cid=c.cid, kind="trajectory")
                    break
                c.traj_stuck_since = None
                c.last_seen = now
                episodes.append(ep)
        return episodes

    def _skip_corrupt(self, ring, cid, kind, exc):
        """A complete slot whose payload would not decode: skip it
        LOUDLY so the ring flows again."""
        if ring.skip_one():
            with self._lock:
                self.corrupt += 1
            print(f"WARNING: corrupt {kind} slot from client {cid} "
                  f"skipped ({exc!r})")

    def _maybe_reclaim(self, ring, stuck_since, now, cid=-1,
                       kind="request"):
        """Mid-write slot watch: a slot odd-stamped for longer than
        TORN_GRACE means its writer died mid-frame — skip it LOUDLY.
        Returns the updated stuck-since stamp."""
        if not ring.pending() or ring.readable():
            return None
        if stuck_since is None:
            return now
        if now - stuck_since >= self.TORN_GRACE:
            if ring.skip_torn():
                with self._lock:
                    self.reclaimed += 1
                print(f"WARNING: torn {kind} slot from client {cid} "
                      f"reclaimed (stalled {now - stuck_since:.0f}s)")
            return None
        return stuck_since

    # -- the device forward --------------------------------------------
    def _adopt_model(self):
        with self._lock:
            pending = self._pending_model
            self._pending_model = None
        if pending is None:
            return
        self._model, self._epoch = pending
        # copy the new params onto the device now, between batches:
        # the first request after a swap does not wait for the copy
        self._adopt_params(self._model)

    def _adopt_params(self, model):
        """Place a newly adopted snapshot's params between batches."""
        if self._ensure_forward(model) is not None:
            self._placed(model)

    # -- the followers' end (module docstring) -------------------------
    def _tell(self, word, payload=None):
        """One word to the followers; a FORWARD stays ``_midstream``
        until the forward ends, a word that fails to go out too."""
        if self._released:
            raise LockstepBroken("the followers were released (STOP sent)")
        self._midstream = True
        self._link.send(word, payload)
        self._midstream = word[0] == FORWARD

    def _share(self, model):
        """The followers' id of ``model``, sent first (a LOAD word and
        its state) when they do not hold it; the least recently used
        snapshot past ``snapshot_cache`` + the live one leaves with it."""
        key = id(model)
        hit = self._sent.get(key)
        if hit is not None and hit[0] is model:
            self._sent.move_to_end(key)
            return hit[1]
        evict = 0
        if len(self._sent) > max(0, int(self.snapshot_cache)):
            evict = self._sent.popitem(last=False)[1][1]
        sid, self._next_sid = self._next_sid, self._next_sid + 1
        state = {k: v.detach().cpu()
                 for k, v in model.module.state_dict().items()}
        self._tell((LOAD, sid, evict), (self._fwd_spec, state))
        self._sent[key] = (model, sid)
        self.snapshots_sent += 1
        return sid

    def _placed(self, model):
        if self._link is not None and self._infer_sh is not None:
            self._share(model)
        return super()._placed(model)

    def _forward(self, model, obs):
        """With followers, each sharded forward is announced first: the
        word and the batch, then every rank forwards its dp rows."""
        if self._link is None or self._ensure_forward(model) is None:
            return super()._forward(model, obs)
        rows, _local = self._dp_rows(obs)      # raises before any word
        self._tell((FORWARD, self._share(model), rows), obs)
        out = super()._forward(model, obs)
        self._midstream = False
        self.lockstep_forwards += 1
        return out

    def _release(self):
        """STOP to the followers, once, from a thread that is not the
        loop's (the loop has ended)."""
        if self._link is not None and not self._released:
            self._tell((STOP, 0, 0))
            self._released = True

    @property
    def lockstep_broken(self):
        """The loop died while a word went out or between a FORWARD and
        the end of its forward: the followers sit in a collective it
        will never finish."""
        return self._midstream and not self.alive

    # -- the batching loop --------------------------------------------
    def _collect(self, pending, now):
        """One sweep over every request ring plus the network-plane
        queue; appends (client, seq, rows, leaves, epoch_pin) tuples.
        Returns rows collected this sweep."""
        got = 0
        with self._lock:
            clients = list(self._clients.values())
            net = list(self._net_pending)
            self._net_pending.clear()
        for item in net:
            pending.append(item)
            got += item[2]
            self.net_requests += 1
        for c in clients:
            while True:
                try:
                    item = c.req.pop(
                        loads=lambda v, c=c: unpack_request(
                            v, c.leaf_specs))
                except Exception as exc:
                    self._skip_corrupt(c.req, c.cid, "request", exc)
                    continue
                if item is None:
                    c.req_stuck_since = self._maybe_reclaim(
                        c.req, c.req_stuck_since, now,
                        cid=c.cid, kind="request")
                    break
                c.req_stuck_since = None
                c.last_seen = self.clock()
                seq, rows, leaves = item
                pending.append((c, seq, rows, leaves, None))
                got += rows
        return got

    def step(self):
        """One batching-window pass: collect, wait-or-timeout, forward,
        reply.  Returns True when a batch dispatched.  Synchronous and
        clock-injected: unit tests drive it directly, no thread."""
        pending = []
        total = self._collect(pending, self.clock())
        if not pending:
            return False
        t_first = self.clock()
        # wait-or-timeout: give batch-mates from other workers
        # batch_window seconds to arrive, unless the batch is full
        deadline = t_first + self.cfg.batch_window
        while total < self.cfg.max_batch:
            now = self.clock()
            if now >= deadline:
                break
            self.sleep(min(2e-4, deadline - now))
            total += self._collect(pending, self.clock())
        self._dispatch(pending, self.clock() - t_first)
        return True

    def _routed(self, pin):
        """(model, epoch) for one dispatch group.  None pins, and pins
        naming the live snapshot, serve the installed model; other pins
        resolve through ``model_resolver`` (league/opponent-pool
        snapshots as first-class serving targets).  (None, pin) =
        unroutable, answered as a typed unavailable upstream."""
        if pin is None or int(pin) == self._epoch:
            return self._model, self._epoch
        if self.model_resolver is None:
            return None, int(pin)
        try:
            model = self.model_resolver(int(pin))
        except Exception as exc:  # a bad pin costs that request only
            print(f"WARNING: snapshot resolver failed for epoch "
                  f"{pin} ({exc!r})")
            model = None
        return model, int(pin)

    def _dispatch(self, pending, waited):
        self._adopt_model()
        # group by epoch pin: the unpinned/live group (ALL shm traffic
        # plus unpinned network requests) rides one bucket-padded
        # forward; each pinned group dispatches with its routed
        # snapshot's module.  A pin naming the LIVE epoch normalizes
        # into the unpinned group: splitting identical-params traffic
        # into two forwards would re-pay the per-dispatch overhead the
        # shared window exists to amortize
        groups = {}
        for item in pending:
            pin = item[4]
            if pin is not None and int(pin) == self._epoch:
                pin = None
            groups.setdefault(pin, []).append(item)
        for pin, items in groups.items():
            model, epoch = self._routed(pin)
            if model is None:
                # unroutable pin (pruned/never-committed epoch, no
                # resolver): typed unavailable, not a silent timeout
                for seat, seq, _n, _leaves, _pin in items:
                    seat.deliver(seq, None, None)
                continue
            self._dispatch_group(model, epoch, items, waited)

    def _dispatch_group(self, model, epoch, items, waited):
        # one forward per max_batch chunk (normally exactly one)
        i = 0
        while i < len(items):
            chunk, rows = [], 0
            while i < len(items) and (
                    rows + items[i][2] <= self.cfg.max_batch
                    or not chunk):
                chunk.append(items[i])
                rows += items[i][2]
                i += 1
            t0 = telemetry.span_begin()
            cap = max(rows, self.cfg.max_batch)
            if self._mesh is not None and rows > self.cfg.max_batch:
                # an oversized chunk under a mesh pads to the FULL pow2
                # (JAX's rule), so the bucket keeps dividing dp
                cap = 1 << (rows - 1).bit_length()
            bucket = _bucket(rows, cap, self._bucket_floor)
            leaves = [np.concatenate(parts, axis=0) for parts in zip(
                *[leaves for _, _, _, leaves, _ in chunk])]
            if bucket > rows:
                leaves = [np.concatenate(
                    [leaf, np.zeros((bucket - rows,) + leaf.shape[1:],
                                    leaf.dtype)], axis=0)
                    for leaf in leaves]
            obs = tree_unflatten(chunk[0][0].treedef, leaves)
            t1 = time.perf_counter()
            outputs = self._forward(model, obs)
            dispatch_sec = time.perf_counter() - t1
            outputs.pop("hidden", None)
            lo = 0
            for client, seq, n, _leaves, _pin in chunk:
                part = {k: np.asarray(v[lo:lo + n])
                        for k, v in outputs.items()}
                lo += n
                if not client.deliver(seq, epoch, part):
                    # full or too small for the OUTPUT pickle: the
                    # worker will time out, count it, and degrade to
                    # local inference — say why, once per client
                    self.reply_drops += 1
                    if not client.drop_warned:
                        client.drop_warned = True
                        print(f"WARNING: inference reply to client "
                              f"{client.cid} dropped (reply ring full "
                              f"or slot smaller than the output frame)")
            self.batches += 1
            self.requests += len(chunk)
            self.rows_served += rows
            with self._lock:
                self._batch_rows.append(rows)
                self._dispatch_sec.append(dispatch_sec)
                self._queue_wait += waited
                self._requests_epoch += len(chunk)
            telemetry.span_end("infer.batch", t0, rows=rows,
                               wait=round(waited, 6), epoch=epoch)

    def _warm_next(self):
        """Run the forward once at one pending client's likely buckets
        (min bucket + its lockstep rows_max) with zero observations.
        Runs on the service thread between batches."""
        with self._lock:
            if not self._warm:
                return False
            # peek, don't pop: warm_pending stays truthful while the
            # warmup forward blocks this thread (and the beat)
            client = self._clients.get(self._warm[0])
        try:
            if client is not None:
                self._adopt_model()
                buckets = {_bucket(1, self.cfg.max_batch,
                                   self._bucket_floor),
                           _bucket(client.rows_max, self.cfg.max_batch,
                                   self._bucket_floor)}
                for rows in sorted(buckets):
                    leaves = [np.zeros((rows,) + shape, dtype)
                              for shape, dtype in client.leaf_specs]
                    self._forward(self._model,
                                  tree_unflatten(client.treedef, leaves))
        finally:
            with self._lock:
                if self._warm:
                    self._warm.pop(0)
        return client is not None

    def _reap_idle(self):
        """Reclaim clients silent on both rings past CLIENT_IDLE_REAP.
        Two-phase: removal from the live set now, ring close after
        GRAVE_GRACE."""
        now = self.clock()
        with self._lock:
            dead = [cid for cid, c in self._clients.items()
                    if now - c.last_seen > self.CLIENT_IDLE_REAP]
            for cid in dead:
                client = self._clients.pop(cid)
                self._grave.append((now + self.GRAVE_GRACE, client))
                self.reaped += 1
                print(f"pipeline: reaped idle client {cid} "
                      f"(silent {self.CLIENT_IDLE_REAP:.0f}s)")
            ready = [c for due, c in self._grave if now >= due]
            self._grave = [(due, c) for due, c in self._grave
                           if now < due]
        for client in ready:
            client.req.close()
            client.rsp.close()
            client.traj.close()
        return bool(dead or ready)

    @property
    def warm_pending(self):
        with self._lock:
            return len(self._warm)

    def _loop(self):
        try:
            self.board.beat(epoch=self._epoch)
            while not self._stop:
                if self._kill:
                    return  # chaos death: no parting beat
                self._adopt_model()
                worked = self.step()
                if not worked:
                    worked = self._warm_next()
                if not worked:
                    self._reap_idle()
                self.board.beat(epoch=self._epoch)
                if not worked:
                    self.sleep(5e-4)
        except Exception as exc:
            # the beat stops with the thread, so workers see a dead
            # service; the owner reads the cause here
            self.failure = exc
            traceback.print_exc()


class _Snapshot:
    """A snapshot as rank 0 sent it: its net spec and a host module
    holding its state (what ``_placed`` lays out on the mesh)."""

    def __init__(self, spec, state):
        self.spec = spec
        self.module = build_module(spec, "cpu")
        self.module.load_state_dict(state)


class ServiceFollower(_GuardedForward):
    """A follower rank's stand-in for the inference service (module
    docstring): a thread that takes rank 0's words on ``groups`` and
    joins each sharded forward in lockstep, on the follower's card, with
    the snapshots rank 0 sent it, until STOP.  ``failure`` is the
    :class:`LockstepBroken` that ended it otherwise (a word out of
    protocol, a snapshot it does not hold, a group that failed)."""

    def __init__(self, groups, device=DEFAULT_DEVICE, fsdp=False,
                 max_reshard=0):
        super().__init__(device, groups.mesh, fsdp, max_reshard)
        self._link = groups
        self._models = {}            # snapshot id -> _Snapshot
        self.forwards = 0            # forwards joined
        self.snapshots = 0           # snapshots received
        self.failure = None
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="infer-follower")
        self._thread.start()

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    def _step(self):
        """One word; False on STOP."""
        # torchlint: disable=unbounded-recv -- the lockstep protocol: rank 0 sends every word, and a follower waits at the next one while rank 0's window is idle; a dead rank 0 fails the broadcast (raises here), and a wedged one wedges the group, which the launch's supervision ends
        (op, sid, n), payload = self._link.recv()
        if op == STOP:
            return False
        if op == LOAD:
            self._models.pop(n, None)
            self._models[sid] = _Snapshot(*payload)
            self.snapshots += 1
        elif op == FORWARD:
            model = self._models.get(sid)
            if model is None:
                raise LockstepBroken(f"a forward with snapshot {sid}, "
                                     f"which rank 0 never sent")
            self._forward(model, payload)
            self.forwards += 1
        else:
            raise LockstepBroken(f"unknown lockstep word {op!r}")
        return True

    def _run(self):
        try:
            while self._step():
                pass
        except Exception as exc:
            broken = LockstepBroken(f"inference follower failed ({exc!r})")
            broken.__cause__ = exc
            self.failure = broken
            traceback.print_exc()

    def stats(self):
        return {"forwards": self.forwards, "snapshots": self.snapshots,
                "infer_compiles": self.retrace_guard.compiles,
                "infer_resharding_copies": self.shard_guard.copies,
                "mesh_devices": self.mesh_devices}
