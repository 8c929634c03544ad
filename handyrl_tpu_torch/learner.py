"""The learner: conductor server, training thread, batcher farm.

The counterpart of the local single-process path of
``handyrl_tpu.learner``:

  * the Trainer owns the net's parameters, the Adam state and (by
    default) the replay ring, all on the training device.  One step is
    draw -> gather -> forward -> backward -> clip -> Adam, updating
    parameters and optimizer state in place (:mod:`.ops.update`,
    :mod:`.staging`); a steady-state step uploads nothing and reads
    nothing back;
  * per-step metrics stay on the device and are stacked and copied to
    the host once per epoch;
  * at each epoch boundary the trainer thread takes a HOST COPY of the
    parameters (never an alias of the live tensors, which the next
    step updates in place); the learner serves that snapshot to the
    workers and to the batched inference service, and checkpoints it
    in the JAX package's format;
  * ``device_replay: off`` trains from host batches assembled by
    batcher processes instead, and says so loudly.

The resilience layer is the JAX package's:

  * the episode WAL (:class:`~.durability.EpisodeWAL`) logs every
    admitted episode at intake; a restart replays the newest
    ``wal_keep_episodes`` of them straight into the ring on the
    device (``DeviceReplay.warm_start``) before the trainer starts;
  * SIGTERM is a preemption notice: the handler seals the WAL and asks
    the trainer thread for an emergency checkpoint (params and Adam
    state taken between steps, the only consistent point), then tears
    the local fleet down and exits nonzero;
  * the gather fleet is supervised (``WorkerCluster``), every message
    timestamps its peer in a ``FleetRegistry`` and silent peers are
    evicted; a dead inference service is respawned behind
    ``respawn_backoff`` and a windowed circuit breaker;
  * ``supervise_learner`` runs the learner under a ``LearnerGuard``
    that relaunches it with ``restart_epoch: auto``; chaos drills
    (gather kills and surges, frame faults, the learner SIGKILL, the
    service kill) drive all of it;
  * ``--train-server`` serves remote worker machines
    (``WorkerServer``); it runs no inference service, because shared
    memory does not cross machines.

Anakin mode is the JAX package's: with ``anakin: {mode: on}`` and an
env that has a device twin (``environment.DEVICE_ENV_REGISTRY``), the
trainer builds no ring and no batcher; each step is one fused
on-device segment of self-play plus one update
(:class:`~.anakin.AnakinEngine`), the epoch clock is the trainer's step
count (``updates_per_epoch``), and the worker fleet only evaluates.

Every epoch record carries the JAX package's step accounting:
``batch_wait_sec`` (host seconds the step waited for its feed),
``device_step_sec`` (host seconds inside the step calls; the card's
queue may run ahead of them), ``queue_depth`` (the feed backlog at the
boundary), the cost model's ``mfu`` / ``achieved_tflops`` /
``arithmetic_intensity`` / ``roofline_verdict``
(:mod:`.telemetry.costmodel`), the staleness of admitted episodes
(``policy_lag_{mean,p95,max}``) and, under IMPACT, ``target_net_age``.

League-lite is the JAX package's: with ``generation_opponent:
{past_epochs: K, prob: p}`` a fraction ``p`` of generation jobs seats a
retained past self (a checkpoint of the last ``K`` epochs that still
exists) as one opponent.  ``_serve_model`` serves that epoch from its
file; the workers run such mixed-snapshot jobs on their sequential
path.  The past seat's outcomes go to ``league_stats``, keyed by its
epoch, never into ``generation_stats``.

The stdout log format (``updated model(N)``, ``epoch N``, ``win rate``,
``loss = ...``, ``generation stats``, ``league stats``) is the JAX
package's, so its plot scripts read either.

Telemetry and the serving tier are the JAX package's: the learner
configures telemetry first (span log next to ``metrics_path``, the
flight recorder dumping on SIGTERM after the emergency save, on a
trainer crash), the trainer's sections record ``trainer.<name>`` spans
(:class:`~.utils.profiling.SectionTimers`) and ``profile_dir`` arms a
``torch.profiler`` window (:class:`~.utils.profiling.TraceWindow`);
every epoch record carries ``untracked_residual_sec`` and the
attribution tree is folded per epoch.  ``serving: {mode: on}`` opens the
network frontend over the inference service (epoch-pinned requests
resolve through ``_resolve_serving_snapshot``), ``router: {mode: on}``
hosts the pool router with this learner's frontend announced into it,
and ``status_port`` serves the read-only status JSON; each tier is
supervised behind backoff and a windowed breaker.

The runtime guards are the JAX package's (:mod:`.analysis.guards`), on
by default: each update step runs through a ``RetraceGuard`` and a
``NumericsGuard`` (``max_update_compiles`` and ``max_nonfinite_steps``
budgets), a ``HostTransferGuard`` is armed around the trainer thread,
a ``StallWatchdog`` samples the server loop and the communicator's
reader and writer, a ``LockOrderGuard`` wraps the control plane's
locks and a ``ResourceLedger`` samples fds, threads and shm segments
(``max_fd_growth``).  Every epoch record carries ``retrace_count``,
``host_transfers``, ``numerics_contract_breaks``, ``weak_upcasts``,
``nonfinite_steps``, ``stall_events``, ``lock_contention_sec``,
``lock_order_inversions``, ``fd_count``, ``thread_count``,
``shm_segments`` and ``resource_growth``, and the
``ShardingContractGuard`` (``max_resharding_copies``) adds
``resharding_copies``.

Multi-process training is the JAX package's multi-host learner, one
process per card (:mod:`.parallel`): with ``distributed:`` every rank
runs a full learner (its own workers, ring and rows of each global
batch: ``batch_size / dp``), the update step sums gradients and
metrics over the ``mesh:`` (dp/sp/tp, ``fsdp``), and rank 0 alone
decides epochs (a control word per step), writes checkpoints, the
manifest, the WAL and the metrics, and serves the network tier,
router and status endpoint.  Replicas snapshot collectively at the
same point (sharded state is gathered), keep the unsharded inference
dispatch on their own card, and fall back from Anakin, as the JAX
replicas do.

Chaos reaches every layer the JAX package's does: besides the gather
and service kills, ``chaos.serve_kill_epoch`` silences this replica's
frontend and announcer once, and ``_serving_tick`` respawns both; the
workers' shm brownout stamps episodes with their backlog depth, which
intake reduces into ``upload_backlog`` per epoch.
"""

import functools
import json
import os
import pickle
import queue
import random
import signal
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None

from . import telemetry
from .analysis import (
    HostTransferGuard,
    LockOrderGuard,
    NumericsGuard,
    ResourceLedger,
    RetraceGuard,
    ShardingContractGuard,
    StallWatchdog,
)
from .anakin import AnakinConfig, AnakinEngine
from .batch import make_batch
from .connection import MultiProcessJobExecutor
from .device import DEFAULT_DEVICE, resolve_device
from .durability import (
    CheckpointManifest,
    CorruptCheckpointError,
    EpisodeWAL,
    read_verified,
    resolve_restart,
    write_checksummed,
)
from .environment import (
    device_env_available,
    make_device_env,
    make_env,
    prepare_env,
)
from .models import TorchModel
from .models.convert import from_flax, to_flax
from .models.wrapper import build_module
from .ops.losses import LossConfig
from .ops.update import (
    DEFAULT_LR,
    UpdateStep,
    make_optimizer,
    set_learning_rate,
)
from .parallel import multihost as mh
from .parallel.mesh import AXES, MeshSpec, axis_size, check_mesh_size, make_mesh
from .parallel.update import full_state_dict, make_sharded_update_step
from .resilience import ChaosConfig, FleetRegistry, LearnerKillSwitch
from .resilience.supervisor import FailureWindow
from .staging import DeviceReplay, make_replay_update_step
from .telemetry import CostModel, PerfConfig, summarize_lags
from .telemetry.costmodel import device_kind
from .utils.profiling import SectionTimers, TraceWindow
from .utils.tree import tree_map_leaves
from .worker import WorkerCluster, WorkerServer


def _models_dir():
    return "models"


def model_path(model_id):
    return os.path.join(_models_dir(), f"{model_id}.ckpt")


def latest_model_path():
    return os.path.join(_models_dir(), "latest.ckpt")


def train_state_path():
    return os.path.join(_models_dir(), "train_state.ckpt")


def resolve_transfer_dtype(args):
    """The observation wire format: 'auto' follows the compute dtype."""
    transfer = args.get("transfer_dtype", "auto") or "auto"
    if transfer == "auto":
        compute = args.get("compute_dtype", "bfloat16") or "bfloat16"
        transfer = "bfloat16" if compute == "bfloat16" else "float32"
    return "" if transfer == "float32" else transfer


def host_copy(state):
    """Numpy copies of a ``state_dict``'s tensors: never views of them,
    so a later in-place update cannot reach the copy."""
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in state.items()}


def stage_batch(batch, device, compute_dtype="bfloat16"):
    """A host batch of ``make_batch`` as tensors on ``device``.
    Observations arrive in their wire format (bfloat16 as uint16 bit
    patterns, viewed on the device; uint8 planes) and leave in the
    compute dtype; every other leaf keeps its dtype."""
    obs_dtype = getattr(torch, compute_dtype)

    def obs(a):
        if a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16)).to(device).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t.to(obs_dtype)

    staged = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
              for k, v in batch.items() if k != "observation"}
    staged["observation"] = tree_map_leaves(obs, batch["observation"])
    return staged


# ---------------------------------------------------------------------
# the host batcher path (device_replay: off)
# ---------------------------------------------------------------------

def _batch_worker(conn, bid, cfg):
    """Batcher child process: decompress + assemble numpy batches."""
    from .batch import set_columnar_cache_mb

    set_columnar_cache_mb(cfg.get("columnar_cache_mb"))
    telemetry.configure_from_args(cfg, role=f"batcher-{bid}",
                                  primary=False)
    print(f"started batcher {bid}")
    try:
        while True:
            episodes = conn.recv()
            with telemetry.trace_span("batch.make",
                                      episodes=len(episodes)):
                batch = make_batch(episodes, cfg)
            conn.send(batch)
    except (ConnectionResetError, BrokenPipeError, EOFError, OSError):
        pass  # the learner is gone: exit quietly


class Batcher:
    """Parallel batch construction over ``num_batchers`` processes.
    The parent samples episode windows (recency-biased) and ships them
    to children that assemble fixed-shape numpy batches."""

    def __init__(self, args, episodes, batch_size=None):
        self.args = args
        self.episodes = episodes
        self.batch_size = batch_size or args["batch_size"]
        # the batch-geometry keys, plus the telemetry keys so batch.make
        # spans land in the same run's span log
        cfg = {k: args[k] for k in (
            "turn_based_training", "observation", "forward_steps",
            "burn_in_steps", "compress_steps", "columnar_cache_mb",
            "telemetry", "trace_sample_rate", "flightrec_spans",
            "metrics_path",
        ) if k in args}
        transfer = resolve_transfer_dtype(args)
        if transfer:
            cfg["transfer_dtype"] = transfer
        self.executor = MultiProcessJobExecutor(
            _batch_worker, self._selector(), self.args["num_batchers"],
            args_func=lambda i: (i, cfg))

    def _selector(self):
        while True:
            yield [self.select_episode() for _ in range(self.batch_size)]

    def run(self):
        self.executor.start()

    def select_episode(self):
        """Recency-biased sampling: triangular acceptance over buffer
        index, then a random training window with burn-in backoff and
        block slicing."""
        while True:
            ep_count = min(len(self.episodes),
                           self.args["maximum_episodes"])
            ep_idx = random.randrange(ep_count)
            accept_rate = 1 - (ep_count - 1 - ep_idx) / ep_count
            if random.random() >= accept_rate:
                continue
            try:
                ep = self.episodes[ep_idx]
                break
            except IndexError:
                continue
        turn_candidates = 1 + max(
            0, ep["steps"] - self.args["forward_steps"])
        train_st = random.randrange(turn_candidates)
        st = max(0, train_st - self.args["burn_in_steps"])
        ed = min(train_st + self.args["forward_steps"], ep["steps"])
        cmp = self.args["compress_steps"]
        st_block, ed_block = st // cmp, (ed - 1) // cmp + 1
        return {
            "args": ep["args"], "outcome": ep["outcome"],
            "moment": ep["moment"][st_block:ed_block],
            "base": st_block * cmp,
            "start": st, "end": ed, "train_start": train_st,
            "total": ep["steps"],
        }

    def batch(self, timeout=None):
        return self.executor.recv(timeout=timeout)

    def shutdown(self):
        self.executor.shutdown()


class ReplayBuffer(deque):
    """The host path's episode buffer: a deque capped at
    ``maximum_episodes``, trimmed tighter when host RAM passes 95 %
    (the JAX package's ``ReplayBuffer._cap``; psutil is optional, and
    without it the cap is the configured one)."""

    def __init__(self, maximum_episodes):
        super().__init__((), maximum_episodes)
        self.maximum_episodes = maximum_episodes
        self.warned = False

    def extend(self, episodes):
        super().extend(episodes)
        self._trim()

    def _cap(self):
        mem_percent = psutil.virtual_memory().percent if psutil else 0.0
        if mem_percent <= 95:
            return self.maximum_episodes
        if not self.warned:
            import warnings

            warnings.warn(
                "memory usage %.1f%% with buffer size %d"
                % (mem_percent, len(self)))
            self.warned = True
        return int(len(self) * 95 / mem_percent)

    def _trim(self):
        cap = self._cap()
        while len(self) > cap:
            self.popleft()


def target_net_age(steps, interval, tau):
    """Steps since the IMPACT target last synced (hard interval), the
    Polyak average's horizon ``1 / tau``, or the run length for a
    frozen target (the JAX trainer's formula)."""
    if tau > 0.0:
        return round(1.0 / tau, 1)
    if interval > 0:
        return steps % interval
    return steps


# ---------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------

class Trainer:
    """Owns the training device's state: the net, Adam, the replay ring
    and the step.  Everything here runs on the trainer thread, except
    :meth:`update`, the learner's epoch handshake."""

    def __init__(self, args, model, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        # the host path's replay buffer, trimmed to maximum_episodes
        # (tighter under memory pressure)
        self.episodes = ReplayBuffer(args["maximum_episodes"])
        self.args = args
        self.loss_cfg = LossConfig.from_config(args)
        self.compute_dtype = args.get("compute_dtype") or "bfloat16"
        self.default_lr = DEFAULT_LR
        self.data_cnt_ema = args["batch_size"] * args["forward_steps"]
        self.epoch = args.get("restart_epoch", 0)
        self.steps = 0
        self.update_flag = False
        self.shutdown_flag = False
        self.failure = None
        self.checkpoint_checksum = bool(
            args.get("checkpoint_checksum", True))
        self.last_state_digest = ""
        self.last_metrics = {}
        self.update_queue = queue.Queue(maxsize=1)
        self.updates_cap = int(args.get("updates_per_epoch", 0) or 0)
        self.timers = SectionTimers()
        # one-shot torch.profiler window over steps 10-20 (profile_dir)
        self.trace = TraceWindow(args.get("profile_dir") or "",
                                 device=self.device)
        self.emergency = None      # threading.Event armed by SIGTERM
        self.manifest = None       # set by the Learner
        self.stall_beat = None     # StallWatchdog beat (set by Learner)
        self.started_at = None     # monotonic: training loop entered
        self.first_step_at = None  # monotonic: first step enqueued
        # the runtime guards of every update step: its call signatures
        # must stay one per run (max_update_compiles > 0 asserts it
        # after every step), its arguments keep their first dtypes and
        # its in-graph nonfinite flag stays 0; device->host syncs are
        # counted while the trainer thread runs
        self.retrace_guard = RetraceGuard(
            max_compiles=args.get("max_update_compiles", 0),
            name="update_step")
        self.num_guard = (
            NumericsGuard(max_nonfinite=args.get("max_nonfinite_steps", 0),
                          name="update_step")
            if args.get("numerics_guard", True) else None)
        self.transfer_guard = (HostTransferGuard()
                               if args.get("host_transfer_guard", True)
                               else None)
        # the layout contract: every argument of the step, and every
        # parameter and Adam moment it keeps, holds the layout of its
        # first call (resharding_copies per epoch)
        self.shard_guard = (
            ShardingContractGuard(
                max_copies=args.get("max_resharding_copies", 0),
                name="update_step")
            if args.get("sharding_contract_guard", True) else None)
        # multi-process: this rank is one learner of a process group,
        # rank 0 the primary; its feed builds batch_size / dp rows
        self.multihost = mh.process_count() > 1
        self.primary = mh.is_primary()
        self.local_batch_size = args["batch_size"]
        if self.multihost:
            self.local_batch_size = mh.local_batch_size(args["batch_size"])
        self.train_mesh = None
        self.rows_mesh = None      # the ranks that share this rank's rows

        self.spec = model.spec
        self.module = build_module(self.spec, self.device).train()
        self.module.load_state_dict(model.module.state_dict())
        self.impact = self.loss_cfg.update_algorithm == "impact"
        self.target_module = None
        if self.impact:
            # the IMPACT target network starts as a copy of the params
            self.target_module = build_module(self.spec, self.device)
            self.target_module.load_state_dict(self.module.state_dict())
        state = self._read_train_state()
        if self.multihost:
            state = self._sync_initial_state(state)
        self.update_step = self._build_update_step()
        self.optimizer = self.update_step.optimizer
        self._restore_train_state(state)
        self.update_step.count = self.steps
        print(f"compute dtype: {self.compute_dtype}; training on "
              f"{self.device}")
        # FLOPs of each step function, counted on its first call, and
        # the per-epoch mfu reduction against the device's peaks
        self.costmodel = CostModel(PerfConfig.from_config(args.get("perf")),
                                   kind=device_kind(self.device))
        self._step_label = "update_step"

        # Anakin: rollout + batch + update fused per step on the device;
        # no ring and no batcher then (the workers only evaluate)
        self.anakin = None
        self._anakin_step = None
        self.anakin_carry = None
        self.anakin_pool = []
        self._maybe_build_anakin()

        self.device_replay = (None if self.anakin is not None
                              else self._maybe_device_replay())
        self._replay_step = None
        self._host_step = None
        self.batcher = None
        self._replay_state = None
        if self.device_replay is not None:
            # seeded from the config seed, the resumed step count and
            # the rank, so a restart draws a fresh, reproducible stream
            # and no two ranks draw alike
            self._replay_step = self._guarded(make_replay_update_step(
                self.device_replay, self.update_step,
                batch_size=self.local_batch_size,
                seed=int(args.get("seed", 0)) * 1_000_003 + self.steps
                + 7919 * mh.process_index(),
                share=self._share_rows))
            self._step_label = "replay_step"
        elif self.anakin is None:
            print("WARNING: device_replay is off — training from the "
                  "host batcher path (batches assembled on the CPU and "
                  "copied to the device every step)")
            self.batcher = Batcher(self.args, self.episodes,
                                   batch_size=self.local_batch_size)
            self._host_step = self._guarded(self.update_step)

    def _share_rows(self, batch):
        """The rows of this rank's dp group: under sp or tp the group's
        first rank's rows on every rank of it (None: this rank's own)."""
        return mh.share_rows(batch, self.rows_mesh)

    def _default_mesh_cfg(self):
        """With no mesh axes configured and several ranks, default to
        pure data parallelism over as many ranks as divide the batch
        (the JAX package's rule over devices).  One process drives one
        card: a single-process learner on a host with several cards
        uses one and says how to use the rest."""
        n = mh.process_count()
        if n <= 1:
            cards = (torch.cuda.device_count()
                     if self.device.type == "cuda" else 1)
            if cards > 1:
                print(f"{cards} cards visible, training on {self.device}: "
                      f"set distributed.num_processes (one process per "
                      f"card) and mesh to train on all of them")
            return {}
        batch = self.args["batch_size"]
        dp = max(d for d in range(1, n + 1) if batch % d == 0)
        if dp <= 1:
            print(f"1 of {n} devices used: batch_size "
                  f"{batch} has no divisor <= {n}")
            return {}
        if dp < n:
            print(f"WARNING: dp={dp} leaves {n - dp} of {n} "
                  f"devices idle; make batch_size divisible by {n} "
                  f"or set an explicit mesh")
        print(f"defaulting to dp={dp} over {n} devices")
        return {"dp": dp}

    def _build_update_step(self):
        """The update step and its Adam: the unsharded step, or with an
        engaged mesh the sharded step over the ranks (which lays the
        net out first and builds Adam on the laid-out parameters)."""
        lr = self.default_lr * self.data_cnt_ema
        mesh_cfg = dict(self.args.get("mesh") or {})
        if not {k: v for k, v in mesh_cfg.items() if k != "fsdp"}:
            # auto-shard only when the mesh AXES are unset (a bare
            # {fsdp: true} still engages auto-dp); an explicit all-ones
            # mesh forces the unsharded step
            default = self._default_mesh_cfg()
            if default:
                mesh_cfg = {**default, "fsdp": mesh_cfg.get("fsdp", False)}
            elif mesh_cfg.get("fsdp"):
                print("WARNING: mesh {fsdp: true} ignored — no "
                      "multi-device dp axis available")
        engaged = any(int(v) > 1 for k, v in mesh_cfg.items()
                      if k != "fsdp")
        if self.multihost and not engaged:
            raise ValueError(
                "multi-host training requires a multi-device mesh: set "
                "`mesh:` explicitly or make batch_size divisible by the "
                "global device count")
        if not engaged:
            return UpdateStep(
                self.module, self.loss_cfg,
                make_optimizer(self.module.parameters(), lr),
                self.compute_dtype, target_module=self.target_module)
        spec = MeshSpec.from_config(mesh_cfg)
        n = mh.process_count()
        check_mesh_size(spec, n)
        if spec.size != n:
            raise ValueError(
                f"mesh {spec.shape()} must cover all {n} processes: "
                f"every process runs a learner, and one outside the mesh "
                f"would train alone")
        self.train_mesh = make_mesh(spec, device_type=self.device.type)
        self.rows_mesh = mh.local_replay_mesh(self.train_mesh)
        dp = axis_size(self.train_mesh, "dp")
        if self.args["batch_size"] % dp:
            raise ValueError(f"batch_size {self.args['batch_size']} must "
                             f"be divisible by the mesh dp axis ({dp})")
        # each dp group feeds its share of the global batch (its sp/tp
        # ranks take the group's first rank's rows)
        self.local_batch_size = self.args["batch_size"] // dp
        print("mesh " + " ".join(f"{a}={k}" for a, k in
                                 zip(AXES, spec.shape()))
              + (" fsdp" if spec.fsdp else "")
              + f" over {n} processes; rank {mh.process_index()} on "
              f"{self.device}, {self.local_batch_size} rows per step")
        return make_sharded_update_step(
            self.module, self.loss_cfg, self.train_mesh, lr,
            self.compute_dtype, target_module=self.target_module,
            shard_time=spec.sp > 1, fsdp=spec.fsdp)

    def _guarded(self, step):
        """``step`` behind the numerics guard, the sharding guard, then
        the retrace guard."""
        if self.num_guard is not None:
            step = self.num_guard.wrap(step)
        if self.shard_guard is not None:
            step = self.shard_guard.wrap(step, state=self._step_state)
        return self.retrace_guard.wrap(step)

    def _step_state(self):
        """The update step's parameters and Adam moments by name (the
        target net's too): what it keeps in place across calls, whose
        layouts the sharding guard latches beside its arguments'."""
        step = self.update_step
        out = {}
        for prefix, module in (("", step.module),
                               ("target.", step.target_module)):
            for name, p in (module.named_parameters()
                            if module is not None else ()):
                out[prefix + name] = p
                for key, value in step.optimizer.state.get(p, {}).items():
                    if torch.is_tensor(value):
                        out[f"{prefix}{name}.{key}"] = value
        return out

    def _maybe_build_anakin(self):
        """Arm the fused on-device rollout + update when ``anakin`` is
        configured and the env has a device twin.  ``mode: on`` makes
        an unusable setup an error; ``auto`` falls back loudly to the
        worker path (envs without a twin, and the engine's layout
        constraints: a recurrent net, observation mode, burn-in, a
        short unroll)."""
        acfg = AnakinConfig.from_config(self.args.get("anakin") or {})
        if not acfg.enabled:
            return
        env_args = self.args.get("env") or {}
        if self.multihost:
            msg = ("anakin mode is single-process (multi-host learners "
                   "keep the IMPALA path)")
        elif not device_env_available(env_args):
            msg = (f"env {env_args.get('env')!r} has no device twin in "
                   "DEVICE_ENV_REGISTRY")
        else:
            msg = None
        if msg:
            if acfg.mode == "on":
                raise ValueError("anakin.mode: on — " + msg)
            print(f"WARNING: {msg}; falling back to the worker path")
            return
        if self.train_mesh is not None:
            dp = axis_size(self.train_mesh, "dp")
            if acfg.num_envs % dp != 0:
                raise ValueError(
                    f"anakin.num_envs {acfg.num_envs} must be "
                    f"divisible by the mesh dp axis ({dp}): the env "
                    "axis is the fused step's batch dimension")
        try:
            self.anakin = AnakinEngine(
                make_device_env(env_args), self.update_step, acfg,
                compute_dtype=self.compute_dtype,
                seed=int(self.args.get("seed", 0)))
        except ValueError as exc:
            if acfg.mode == "on":
                raise
            print(f"WARNING: anakin unavailable ({exc}); falling back "
                  "to the worker path")
            return
        self._anakin_step = self._guarded(self.anakin.make_fused_step())
        self._step_label = "anakin_step"
        # the carry folds the resumed step count into its generator's
        # seed, so a restart continues on fresh data reproducibly
        self.anakin_carry = self.anakin.init_carry(self.steps)
        self.anakin_pool = self.anakin.init_pool(self.module)
        print(f"anakin mode: {self.anakin.num_envs} on-device games x "
              f"{self.anakin.unroll}-step segments"
              + (f", opponent pool {self.anakin.K}"
                 if self.anakin.K else " (pure self-play)"))

    def _maybe_device_replay(self):
        """The replay ring on the training device (``device_replay``
        auto or on), or None for the host batcher path (off)."""
        mode = self.args.get("device_replay", "auto") or "auto"
        if mode == "off":
            return None
        cfg = {
            "turn_based_training": self.args["turn_based_training"],
            "observation": self.args.get("observation", False),
            "forward_steps": self.args["forward_steps"],
            "burn_in_steps": self.args.get("burn_in_steps", 0),
            "transfer_dtype": resolve_transfer_dtype(self.args),
            "compute_dtype": self.compute_dtype,
        }
        capacity = (self.args.get("device_replay_episodes", 0)
                    or self.args["maximum_episodes"])
        max_bytes = (self.args.get("device_replay_mb", 4096) or 4096) << 20
        return DeviceReplay(cfg, capacity, max_bytes, self.device)

    # -- train state ----------------------------------------------------

    def _read_train_state(self):
        """The train state to resume from (Adam moments, step count, the
        lr EMA and the IMPACT target), from ``train_state.ckpt`` when it
        verifies against the manifest digest and belongs to the restart
        epoch; otherwise None and the optimizer cold-starts, loudly.
        The target's weights load here, before any layout."""
        restart_epoch = self.args.get("restart_epoch", 0)
        if not isinstance(restart_epoch, int) or restart_epoch <= 0:
            return None
        try:
            state = read_verified(
                train_state_path(),
                expect_digest=self.args.get("_resume_state_digest") or None)
        except OSError:
            return None  # missing: cold-start the optimizer
        except CorruptCheckpointError as exc:
            print(f"WARNING: train state failed verification ({exc}); "
                  "cold-starting the optimizer")
            return None
        if state.get("epoch") != restart_epoch:
            print("train state is for epoch %s, not %d: cold-starting"
                  % (state.get("epoch"), restart_epoch))
            return None
        try:
            if self.target_module is not None \
                    and state.get("target_params") is not None:
                self.target_module.load_state_dict(
                    {k: torch.from_numpy(v)
                     for k, v in state["target_params"].items()})
        except (ValueError, TypeError, KeyError, RuntimeError):
            print("train state does not match the current model: "
                  "cold-starting the optimizer")
            return None
        return state

    def _sync_initial_state(self, state):
        """Rank 0's weights (and target) into every rank's modules, and
        its train state (or its cold start) to every rank: replicas
        provably start identical even when only rank 0 could read a
        restart checkpoint.  One-time, off the hot path."""
        tensors = dict(self.module.state_dict())
        if self.target_module is not None:
            tensors.update({"target/" + k: v for k, v in
                            self.target_module.state_dict().items()})
        _, opt_state, steps, ema = mh.broadcast_train_state(
            tensors, None if state is None else state["opt_state"],
            0 if state is None else state["steps"],
            self.data_cnt_ema if state is None else state["data_cnt_ema"])
        if opt_state is None:
            return None
        return {"opt_state": opt_state, "steps": steps,
                "data_cnt_ema": ema}

    def _restore_train_state(self, state):
        """Load a read (and synced) train state into the built step."""
        if state is None:
            return
        try:
            self.update_step.load_optimizer_state(state["opt_state"])
        except (ValueError, TypeError, KeyError, RuntimeError):
            print("train state does not match the current model: "
                  "cold-starting the optimizer")
            return
        self.steps = state["steps"]
        self.data_cnt_ema = state["data_cnt_ema"]
        print(f"restored optimizer state at step {self.steps}")

    def save_train_state(self, epoch):
        """``train_state.ckpt``: the port's own format (the torch
        optimizer ``state_dict`` with numpy leaves, the unsharded
        step's layout), not optax's.  Sharded state is gathered first,
        a collective every rank runs; rank 0 alone writes."""
        sd = self.update_step.optimizer_state()
        target = (None if self.target_module is None
                  else full_state_dict(self.target_module))
        if not self.primary:
            return
        state = {
            "opt_state": {
                "state": {i: host_copy(s) for i, s in sd["state"].items()},
                "param_groups": sd["param_groups"]},
            "steps": self.steps,
            "data_cnt_ema": self.data_cnt_ema,
            "epoch": epoch,
        }
        if target is not None:
            state["target_params"] = host_copy(target)
        os.makedirs(_models_dir(), exist_ok=True)
        self.last_state_digest = write_checksummed(
            train_state_path(), state, checksum=self.checkpoint_checksum)

    def _maybe_emergency_save(self):
        """SIGTERM grace window: the handler (``Learner._preempt_save``)
        armed ``self.emergency`` and is waiting on it.  Land a
        CONSISTENT mid-epoch checkpoint: the current params as
        ``latest.ckpt`` plus the matching optimizer state, and re-point
        the manifest at it as an emergency resume point.  Runs on the
        trainer thread between steps, the only thread that touches the
        parameters and Adam state; the copies to the host wait for the
        last step's work on the stream.  Skipped (the event still set)
        before the first completed epoch: resume keys on epoch >= 1."""
        event = self.emergency
        if event is None or event.is_set():
            return
        try:
            # multi-process: a gather inside a grace window is unsafe;
            # the boundary checkpoint is the resume point
            if self.multihost or self.epoch < 1 or self.steps <= 0:
                return
            state = {"params": to_flax(self.module), "steps": self.steps,
                     "epoch": self.epoch}
            os.makedirs(_models_dir(), exist_ok=True)
            digest = write_checksummed(latest_model_path(), state,
                                       checksum=self.checkpoint_checksum)
            self.save_train_state(self.epoch)
            if self.manifest is not None:
                self.manifest.commit(
                    self.epoch, latest_model_path(), digest, self.steps,
                    train_state_digest=self.last_state_digest,
                    emergency=True)
            print(f"emergency checkpoint landed (epoch {self.epoch}, "
                  f"step {self.steps})", flush=True)
        finally:
            event.set()

    def snapshot(self):
        """A CPU model holding a host copy of the live parameters (a
        collective when they are sharded: every rank takes it)."""
        model = TorchModel(build_module(self.spec, "cpu"), device="cpu")
        model.load_params(host_copy(full_state_dict(self.module)))
        return model

    # -- epochs ---------------------------------------------------------

    def update(self):
        """Called by the learner: finish the epoch, get a snapshot.
        Returns ``(None, steps)`` if the training thread has died."""
        self.update_flag = True
        while True:
            if self.stall_beat is not None:
                # the caller IS the server loop: a long epoch stays
                # distinguishable from a wedged server
                self.stall_beat("server")
            try:
                return self.update_queue.get(timeout=1)
            except queue.Empty:
                if self.failure is not None or self.shutdown_flag:
                    return None, self.steps

    def _epoch_loop_local(self):
        """Host batcher path: one staged batch per step."""
        cap = self.updates_cap
        batch_cnt, metric_acc = 0, []
        while batch_cnt == 0 or not self.update_flag:
            if self.shutdown_flag:
                return None
            self._maybe_emergency_save()
            if cap and batch_cnt >= cap:
                time.sleep(0.01)
                continue
            try:
                with self.timers.section("batch_wait"):
                    batch = self.batcher.batch(timeout=0.3)
            except queue.Empty:
                continue
            metric_acc.append(self._host_batch_step(batch))
            batch_cnt += 1
        return batch_cnt, metric_acc

    def _host_batch_step(self, batch):
        """One step on a host batch: staged on the device, the rows of
        this rank's dp group, the guarded update."""
        with self.timers.section("update"):
            batch = self._share_rows(
                stage_batch(batch, self.device, self.compute_dtype))
            metrics = self.costmodel.call(self._step_label,
                                          self._host_step, batch)
        self._count_step()
        return metrics

    def _count_step(self):
        self.trace.tick()
        if self.first_step_at is None:
            self.first_step_at = time.monotonic()
        self.steps += 1

    def _replay_ingest(self):
        """Drain arrivals into the ring (even while idling at the step
        budget, so the pending queue cannot overflow and shed); a ring
        growth re-lays the buffers: designed, so it widens the retrace
        budget instead of tripping it."""
        with self.timers.section("ingest"):
            self.device_replay.ingest(max_episodes=8)
        self.retrace_guard.allowance = self.device_replay.growths

    def _ring_step(self):
        """One draw + gather + update from the ring."""
        replay = self.device_replay
        if self._replay_state is None or replay.state_dirty:
            self._replay_state = replay.device_state()
        with self.timers.section("update"):
            metrics = self.costmodel.call(
                self._step_label, self._replay_step, self._replay_state)
        self._count_step()
        return metrics

    def _epoch_loop_device(self):
        """Device-ring path: draw + gather + update on the device, the
        host only draining newly arrived episodes into the ring."""
        cap = self.updates_cap
        batch_cnt, metric_acc = 0, []
        while batch_cnt == 0 or not self.update_flag:
            if self.shutdown_flag:
                return None
            self._maybe_emergency_save()
            self._replay_ingest()
            if cap and batch_cnt >= cap:
                time.sleep(0.01)
                continue
            metric_acc.append(self._ring_step())
            batch_cnt += 1
        return batch_cnt, metric_acc

    def _epoch_loop_multihost(self):
        """Multi-process epoch: rank 0 decides, every rank runs the same
        step count.  Each iteration syncs one control word (STEP /
        EPOCH_END / STOP) on the CPU control group; the same collective
        is the step barrier, so every rank's sequence of collectives is
        identical by construction."""
        cap = self.updates_cap
        batch_cnt, metric_acc = 0, []
        while True:
            if self.primary and cap and batch_cnt >= cap:
                # the epoch budget is spent: hold the next control word
                # until the learner asks for the snapshot (the replicas
                # wait in the collective)
                while not (self.update_flag or self.shutdown_flag
                           or self.failure is not None):
                    if self.device_replay is not None:
                        self._replay_ingest()
                    time.sleep(0.01)
            code = mh.STEP
            if self.primary:
                if self.shutdown_flag or self.failure is not None:
                    code = mh.STOP
                elif batch_cnt > 0 and self.update_flag:
                    code = mh.EPOCH_END
            code = mh.sync_epoch_code(code)
            if code == mh.STOP:
                self.shutdown_flag = True
                return None
            if code == mh.EPOCH_END:
                return batch_cnt, metric_acc
            # committed to one more global step: this rank's rows now
            if self.device_replay is not None:
                self._replay_ingest()
                metric_acc.append(self._ring_step())
            else:
                while True:
                    try:
                        with self.timers.section("batch_wait"):
                            batch = self.batcher.batch(timeout=1)
                        break
                    except queue.Empty:
                        continue
                metric_acc.append(self._host_batch_step(batch))
            batch_cnt += 1

    def _epoch_loop_anakin(self):
        """Anakin epoch: each step is one on-device self-play segment
        plus one update; the host enqueues it and nothing else (no
        intake, no ring).  ``updates_per_epoch`` (required > 0) is the
        epoch budget, after which the loop idles until the learner asks
        for the snapshot."""
        cap = self.updates_cap
        batch_cnt, metric_acc = 0, []
        while batch_cnt == 0 or not self.update_flag:
            if self.shutdown_flag:
                return None
            self._maybe_emergency_save()
            if cap and batch_cnt >= cap:
                time.sleep(0.01)
                continue
            t0 = telemetry.span_begin()
            with self.timers.section("update"):
                metrics, self.anakin_carry = self.costmodel.call(
                    self._step_label, self._anakin_step,
                    self.anakin_carry, self.anakin_pool)
            # static attrs only: the committed frame count is a device
            # scalar, read at the epoch boundary
            telemetry.span_end("anakin.rollout", t0,
                               games=self.anakin.num_envs,
                               unroll=self.anakin.unroll)
            metric_acc.append(metrics)
            self._count_step()
            batch_cnt += 1
        return batch_cnt, metric_acc

    def _queue_depth(self):
        """The feed backlog at the epoch boundary: assembled host
        batches waiting (host path) or episodes queued for ring ingest
        (device ring); Anakin has no feed."""
        if self.batcher is not None:
            return self.batcher.executor.output_queue.qsize()
        if self.device_replay is not None:
            return len(self.device_replay.pending)
        return 0

    def train(self):
        if self.multihost:
            result = self._epoch_loop_multihost()
        elif self.anakin is not None:
            result = self._epoch_loop_anakin()
        elif self.device_replay is not None:
            result = self._epoch_loop_device()
        else:
            result = self._epoch_loop_local()
        if result is None:
            return None
        batch_cnt, metric_acc = result

        # ONE device->host copy for the epoch's per-step metrics
        keys = sorted(metric_acc[0])
        host = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in metric_acc]).cpu().numpy()
        metrics = {k: host[:, i] for i, k in enumerate(keys)}
        data_cnt = float(metrics["dcnt"].sum())
        loss_sum = {k: float(metrics[k].sum())
                    for k in ("p", "v", "r", "ent", "total") if k in metrics}
        print("loss = %s" % " ".join(
            k + ":" + "%.3f" % (v / data_cnt) for k, v in loss_sum.items()))

        self.data_cnt_ema = (self.data_cnt_ema * 0.8
                             + data_cnt / (1e-2 + batch_cnt) * 0.2)
        lr = self.default_lr * self.data_cnt_ema / (1 + self.steps * 1e-5)
        set_learning_rate(self.optimizer, lr)
        # the snapshot is a host copy taken on this thread: the next
        # step updates the live tensors in place
        snapshot = self.snapshot()

        prof = self.timers.snapshot()
        if prof:
            # batch_wait = feed starvation; update = the step calls
            print("profile = %s" % self.timers.format(prof))
        record = {k: v / data_cnt for k, v in loss_sum.items()}
        record.update({f"profile_{k}_sec": v["sec"]
                       for k, v in prof.items()})
        record.update(
            epoch_steps=batch_cnt, lr=lr,
            grad_norm_mean=float(metrics["grad_norm"].mean()),
            is_clip_frac=round(float(metrics["clip_frac"].mean()), 4))
        # the guards' counters: the signature count is cumulative and
        # must stay flat after the first epoch; host transfers are the
        # epoch's delta and must not grow with the step count
        record["retrace_count"] = self.retrace_guard.compiles
        if self.transfer_guard is not None:
            record["host_transfers"] = self.transfer_guard.snapshot()
        if self.shard_guard is not None:
            # steady state 0: the step's arguments, parameters and
            # moments keep their layouts
            record["resharding_copies"] = self.shard_guard.snapshot()
        if self.num_guard is not None:
            # the steps' flags rode the epoch's one host copy; note_step
            # raises NumericsError past an armed max_nonfinite_steps
            for flag in metrics["nonfinite"]:
                self.num_guard.note_step(flag)
            record.update(self.num_guard.snapshot())
        else:
            record["nonfinite_steps"] = int(metrics["nonfinite"].sum())
        replay = self.device_replay
        if replay is not None:
            record.update(replay="device", replay_device=str(replay.device),
                          replay_episodes=replay.episodes_seen,
                          replay_size=replay.size,
                          replay_dropped=replay.dropped,
                          replay_mib=round(replay.nbytes / 2 ** 20, 3))
        elif self.anakin is None:
            record["replay"] = "host"
        # the step accounting: feed starvation, seconds inside the step
        # calls, the feed backlog, and the cost model's perf keys
        record["batch_wait_sec"] = prof.get("batch_wait", {}).get("sec", 0.0)
        record["device_step_sec"] = prof.get("update", {}).get("sec", 0.0)
        record["queue_depth"] = self._queue_depth()
        record.update(self.costmodel.epoch_metrics(
            self._step_label, record["device_step_sec"], batch_cnt))
        if self.anakin is not None:
            # fused-rollout production this epoch (committed env
            # transitions, completed games); the learner divides by the
            # epoch wall into anakin_{frames,games}_per_sec
            record["anakin_frames"] = int(metrics["anakin_frames"].sum())
            record["anakin_games"] = int(metrics["anakin_games"].sum())
        if self.target_module is not None:
            record["target_net_age"] = target_net_age(
                self.steps,
                int(self.args.get("target_update_interval", 0) or 0),
                float(self.args.get("target_update_tau", 0.0) or 0.0))
        if self.anakin is not None and self.anakin.K > 0:
            # epoch boundary: the newest snapshot joins the opponent
            # axis, the oldest falls off
            self.anakin_pool = self.anakin.refresh_pool(self.anakin_pool,
                                                        self.module)
        self.last_metrics = record
        self.epoch += 1
        try:
            self.save_train_state(self.epoch)
        except OSError as exc:
            print(f"WARNING: train state not saved ({exc!r})")
        return snapshot

    def request_shutdown(self):
        self.shutdown_flag = True

    def stop_feeds(self):
        if self.batcher is not None:
            self.batcher.shutdown()

    def run(self):
        print("waiting training")
        if self.transfer_guard is not None:
            # armed for the trainer's whole life; train() reports the
            # per-epoch delta
            self.transfer_guard.__enter__()
        try:
            # Anakin warms nothing: the first fused step makes its data
            if self.device_replay is not None:
                # warm the ring itself: episodes stream in as they
                # arrive; a ring smaller than minimum_episodes starts
                # once it is full
                replay = self.device_replay
                while replay.size < self.args["minimum_episodes"]:
                    if self.shutdown_flag:
                        return
                    self._maybe_emergency_save()
                    replay.ingest()
                    if replay.size and replay.size >= replay.capacity:
                        print(f"device replay ring ({replay.capacity}) is"
                              f" smaller than minimum_episodes "
                              f"({self.args['minimum_episodes']}): "
                              f"starting with a full ring")
                        break
                    time.sleep(0.05)
            elif self.batcher is not None:
                while len(self.episodes) < self.args["minimum_episodes"]:
                    if self.shutdown_flag:
                        return
                    self._maybe_emergency_save()
                    time.sleep(0.2)
                self.batcher.run()
            print("started training", flush=True)
            self.started_at = time.monotonic()
            while not self.shutdown_flag:
                model = self.train()
                if model is None:
                    break
                self.update_flag = False
                while not self.shutdown_flag:
                    # a SIGTERM can land while the learner thread is
                    # busy and will not drain this queue
                    self._maybe_emergency_save()
                    try:
                        self.update_queue.put((model, self.steps),
                                              timeout=0.3)
                        break
                    except queue.Full:
                        continue
        except Exception as exc:
            # record before dying so Learner.update() cannot wait
            # forever on a snapshot this thread will never produce
            import traceback

            traceback.print_exc()
            self.failure = exc
            # the flight recorder's crash trigger, strictly AFTER the
            # failure is recorded: a dump that itself dies must not
            # leave Learner.update() waiting on this thread
            try:
                telemetry.crash_dump("trainer", exc)
            except Exception:
                pass
        finally:
            if self.transfer_guard is not None:
                self.transfer_guard.__exit__(None, None, None)
            self.trace.close()  # this thread owns the profiler window


class RunningScore:
    """Streaming count/mean/std accumulator for outcome streams."""

    __slots__ = ("n", "total", "total_sq")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.total_sq = 0.0

    def add(self, x):
        self.n += 1
        self.total += x
        self.total_sq += x * x

    @property
    def mean(self):
        return self.total / (self.n + 1e-6)

    @property
    def std(self):
        return max(0.0, self.total_sq / (self.n + 1e-6)
                   - self.mean ** 2) ** 0.5

    @property
    def win_rate(self):
        """Outcome in [-1, 1] mapped to a win probability."""
        return (self.mean + 1) / 2


# ---------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------

class Learner:
    """Central conductor: serves worker requests, feeds the trainer,
    reports stats, and checkpoints every epoch."""

    # the serving tier's off states (a real __init__ overrides them):
    # the network frontend over the inference service, the pool router
    # this learner may host, and this replica's announcer into a router
    infer_service = None
    serve_frontend = None
    router_frontend = None
    serve_announcer = None
    status = None
    _serve_respawns = 0
    _serve_respawn_at = 0.0
    _serve_disabled = False
    _router_respawns = 0
    _router_respawn_at = 0.0
    _router_disabled = False
    _serve_kill_epoch = 0
    _serve_killed = False
    # the runtime guards (built in __init__; off = None)
    stall_watchdog = None
    lock_guard = None
    resource_ledger = None
    # the workers' shm brownout: deepest hold backlog stamped on an
    # episode at intake, this epoch (metrics) and this run (status)
    _upload_backlog_epoch = 0
    _upload_backlog_peak = 0

    def __init__(self, args, net=None, device=DEFAULT_DEVICE, remote=False):
        from .config import Config

        self.device = resolve_device(device)
        cfg = Config.from_dict(args)
        train_args = cfg.train_args.to_dict()
        env_args = dict(cfg.env_args)
        train_args["env"] = env_args
        self.args = train_args
        random.seed(self.args["seed"])

        # telemetry first: spans recorded by anything constructed below
        # (trainer set-up, worker bring-up) land in this run's log
        telemetry.configure_from_args(self.args, role="learner",
                                      primary=mh.is_primary())
        # per-epoch self-time attribution over the span ring; the last
        # snapshot rides every flight-recorder dump
        self.attributor = telemetry.Attributor()
        telemetry.register_dump_extra(
            "attribution", lambda: self.attributor.last)
        self._last_record = None       # latest metrics record (status)
        self._run_t0 = time.monotonic()
        self._epoch_t = self._run_t0
        # host seconds of the start-up stages, reported once in the
        # first metrics record (a relaunch's time-to-train, split)
        self._startup = SectionTimers(span_prefix="startup.")
        self.max_policy_lag = int(self.args.get("max_policy_lag", 0) or 0)
        self.episodes_rejected_stale = 0
        self._rejected_epoch = 0
        self._policy_lags = []         # admitted episodes' lags this epoch
        self.env = make_env(env_args)
        self.eval_rate = cfg.train_args.effective_eval_rate
        self.shutdown_flag = False
        # multi-process: every rank runs a full learner (own workers,
        # own ring, own rows of each global batch); rank 0 also owns
        # the checkpoints, the metrics and the epoch decisions
        self.multihost = mh.process_count() > 1
        self.primary = mh.is_primary()

        self.manifest = CheckpointManifest(_models_dir())
        self.checkpoint_checksum = bool(
            self.args.get("checkpoint_checksum", True))
        with self._startup.section("resume"):
            self._resume = resolve_restart(
                _models_dir(), self.args.get("restart_epoch", 0))
            self.args["restart_epoch"] = self._resume.epoch
            # the manifest-recorded digest of the train state that pairs
            # with the resumed params (a runtime key, not config)
            self.args["_resume_state_digest"] = \
                self._resume.train_state_digest
            self.model_epoch = self.args["restart_epoch"]
            self.model = self._initial_model(net)

        self.generation_stats = {}
        self.league_stats = {}         # past epoch -> its outcomes as
        #                                a scheduled league opponent
        self._league_epoch = 0         # league episodes this epoch
        self.eval_stats = {}
        self.eval_stats_by_opponent = {}
        self.eval_stats_by_seat = {}
        self.jobs_generated = 0
        self.jobs_evaluated = 0
        self.episodes_received = 0
        self.episodes_shm = 0
        self.episodes_spilled = 0
        self._shm_epoch = 0
        self._spilled_epoch = 0

        self.worker = WorkerServer(self.args) if remote \
            else WorkerCluster(self.args)
        # fleet health: every control-plane message timestamps its
        # peer; silence past heartbeat_timeout is a counted miss and an
        # eviction
        self.fleet = FleetRegistry(heartbeat_timeout=float(
            self.args.get("heartbeat_timeout", 30.0) or 30.0))
        self._last_sweep = 0.0
        with self._startup.section("device"):
            # the CUDA context and a first kernel: an empty tensor alone
            # would leave both to the trainer's build
            torch.zeros(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with self._startup.section("trainer"):
            self.trainer = Trainer(self.args, self.model, device=self.device)
        self.trainer.manifest = self.manifest if self.primary else None
        # Anakin's epoch clock: nothing ticks episode intake, so epochs
        # ride the trainer's step count (updates_per_epoch > 0, checked
        # by the config whenever anakin is configured)
        self._anakin_epoch_at = (
            self.trainer.steps
            + int(self.args.get("updates_per_epoch", 0) or 0))
        self.metrics_path = self.args.get("metrics_path") or ""

        # the episode WAL: admitted episodes are logged at intake, and a
        # resumed learner replays its backlog into the ring now, on
        # this thread, before the trainer thread starts
        self.wal = None
        self.episodes_replayed = 0
        # primary only: the WAL lives in the checkpoint dir rank 0 owns
        if self.args.get("wal_enabled", True) and self.primary:
            self.wal = EpisodeWAL(
                os.path.join(_models_dir(), "wal"),
                segment_bytes=int(
                    self.args.get("wal_segment_mb", 8) or 8) << 20,
                flush_interval=float(
                    self.args.get("wal_flush_interval", 1.0)))
            if self._resume.epoch > 0:
                with self._startup.section("wal_replay"):
                    self._replay_wal()
        chaos = ChaosConfig.from_config(self.args.get("chaos") or {})
        self._kill_switch = None
        if chaos.learner_kill_enabled:
            self._kill_switch = LearnerKillSwitch(
                chaos, os.path.join(_models_dir(), "chaos_learner_killed"))

        # the batched inference service answers every local worker's
        # forward on the training device and receives their finished
        # trajectories over shared memory (never across machines: a
        # remote learner runs none).  A dead service is respawned
        # behind respawn_backoff and a windowed breaker
        from .pipeline import InferenceService, PipelineConfig

        self.infer_service = None
        self._infer_kill_epoch = chaos.infer_kill_epoch
        self._serve_kill_epoch = chaos.serve_kill_epoch
        self._infer_killed = False
        self._infer_respawns = 0
        self._infer_respawn_at = 0.0
        self._infer_disabled = False
        self._infer_window = FailureWindow(
            int(self.args.get("max_respawns", 5)), 60.0)
        pipeline_cfg = PipelineConfig.from_config(
            self.args.get("pipeline") or {})
        if pipeline_cfg.enabled and not remote:
            if self.multihost and pipeline_cfg.infer_mesh == "auto":
                # the JAX rule for multi-host replicas: each rank's
                # service answers its own workers, unsharded, on its
                # card (a dispatch over the mesh would need every rank
                # in each forward)
                print("inference dispatch: unsharded on this rank's "
                      "card (multi-process learners keep per-rank "
                      "services)")
            with self._startup.section("service"):
                self.infer_service = InferenceService(
                    self.model, pipeline_cfg, epoch=self.model_epoch,
                    device=self.device, chaos=chaos)
                self.infer_service.start()
        self._build_serving()
        self._build_guards()

        # SIGTERM = preemption notice: durable state first (the
        # emergency checkpoint and the WAL seal inside the grace
        # window), THEN the flight-recorder dump and exit.  Main thread
        # only: a learner built off the main thread has no preemption
        # hook; the previous handler comes back when the learner stops
        self._sigterm_prev = None
        prev = signal.getsignal(signal.SIGTERM)
        if telemetry.install_signal_dump(pre_dump=self._preempt_save):
            self._sigterm_prev = prev

    def _build_serving(self):
        """The network serving tier and the status endpoint, as the
        JAX learner arms them: the frontend needs the inference service
        (a remote learner runs none), the router needs the frontend,
        the announcer heartbeats this frontend into a router (a remote
        ``serving.router_address`` or the local one)."""
        from .serving import RouterConfig, ServingConfig

        max_frame = int(self.args.get("max_frame_bytes", 0) or 0)
        self._serving_cfg = ServingConfig.from_config(
            self.args.get("serving") or {})
        if self._serving_cfg.enabled:
            if self.infer_service is None or not self.primary:
                print("WARNING: serving.mode is on but the batched "
                      "inference service is not running here (pipeline "
                      "off, remote learner, or non-primary replica); "
                      "network serving disabled for this process")
            else:
                from .serving import ServingFrontend

                self._serve_window = FailureWindow(
                    int(self.args.get("max_respawns", 5)), 60.0)
                self._serving_snapshots = OrderedDict()
                # multi-model routing: epoch-pinned network requests
                # resolve to the exact committed snapshot they asked for
                self.infer_service.model_resolver = \
                    self._resolve_serving_snapshot
                self.infer_service.snapshot_cache = \
                    self._serving_cfg.snapshot_cache
                self.serve_frontend = ServingFrontend(
                    self.infer_service, self.env, self._serving_cfg,
                    max_frame_bytes=max_frame)
                self.serve_frontend.start()
        self._router_cfg = RouterConfig.from_config(
            self.args.get("router") or {})
        if (self._router_cfg.enabled and self.primary
                and self.serve_frontend is not None):
            from .serving import RouterFrontend

            self._router_window = FailureWindow(
                int(self.args.get("max_respawns", 5)), 60.0)
            self.router_frontend = RouterFrontend(
                self._router_cfg, max_frame_bytes=max_frame)
            self.router_frontend.start()
        if self.serve_frontend is not None:
            target = None
            if self._serving_cfg.router_address:
                host, _, port = \
                    self._serving_cfg.router_address.rpartition(":")
                target = (host, int(port))
            elif self.router_frontend is not None:
                target = ("127.0.0.1", self.router_frontend.port)
            if target is not None:
                from .serving import ReplicaAnnouncer

                self.serve_announcer = ReplicaAnnouncer(
                    target[0], target[1], f"learner-0-{os.getpid()}",
                    self._serving_advert,
                    interval=self._router_cfg.heartbeat_interval,
                    max_frame_bytes=max_frame)
                self.serve_announcer.start()
        # read-only live status endpoint; 0 = off.  A router-hosting
        # learner answers /healthz from the registry snapshot
        status_port = int(self.args.get("status_port", 0) or 0)
        if status_port and self.primary:
            from .telemetry.status import StatusServer

            healthz_fn = None
            if self.router_frontend is not None:
                healthz_fn = self.router_frontend.healthz
            self.status = StatusServer(status_port, self._status_snapshot,
                                       healthz_fn=healthz_fn)

    def _build_guards(self):
        """The control plane's runtime guards, as the JAX learner arms
        them: the stall watchdog over the server loop (beating from
        ``trainer.update`` too) and the communicator's reader and
        writer, with the flight recorder's dump on a stall; the lock
        guard (armed in :meth:`run`, once the fleet's supervisor
        exists); the resource ledger."""
        if self.args.get("stall_watchdog", True):
            self.stall_watchdog = StallWatchdog(
                max_stall_seconds=float(
                    self.args.get("max_stall_seconds", 60.0) or 60.0))
            self.worker.liveness_hook = self.stall_watchdog.beat
            self.trainer.stall_beat = self.stall_watchdog.beat
            self.stall_watchdog.on_stall = telemetry.stall_hook
            self.stall_watchdog.start()
        if self.args.get("lock_order_guard", True):
            self.lock_guard = LockOrderGuard()
        if self.args.get("resource_ledger", True):
            self.resource_ledger = ResourceLedger(
                max_fd_growth=int(self.args.get("max_fd_growth", 0) or 0))

    def _arm_lock_guard(self):
        """Wrap every control-plane lock this configuration has in the
        lock guard's timing proxy (absent subsystems are skipped)."""
        if self.lock_guard is None:
            return
        for obj, attr in (
                (self.worker, "_lock"),
                (self.worker, "_admit_lock"),
                (getattr(self.worker, "supervisor", None), "_lock"),
                (self.fleet, "_lock"),
                (self.infer_service, "_lock"),
                (self.serve_frontend, "_lock"),
                (self.router_frontend, "_lock"),
                (self.stall_watchdog, "_lock"),
        ):
            self.lock_guard.arm(obj, attr)

    def _status_snapshot(self):
        """Live JSON for the status endpoint: fleet + telemetry + the
        latest per-epoch metrics record.  Read-only by construction."""
        snap = {
            "epoch": self.model_epoch,
            "episodes_received": self.episodes_received,
            "episodes_rejected_stale": self.episodes_rejected_stale,
            "episodes_replayed": self.episodes_replayed,
            "connections": self.worker.connection_count(),
            "time_sec": round(time.monotonic() - self._run_t0, 3),
            "fleet": self.fleet.snapshot(),
            "telemetry": telemetry.stats(),
            "last_record": self._last_record,
        }
        if self.lock_guard is not None:
            snap["locks"] = self.lock_guard.stats()
        if self.resource_ledger is not None:
            snap["resources"] = self.resource_ledger.stats()
        if self.wal is not None:
            snap["wal"] = self.wal.stats()
        trainer = self.trainer
        if trainer.num_guard is not None:
            snap["numerics"] = trainer.num_guard.stats()
        perf = trainer.costmodel.stats()
        perf["attribution"] = self.attributor.last
        snap["perf"] = perf
        if trainer.anakin is not None:
            snap["anakin"] = {
                "num_envs": trainer.anakin.num_envs,
                "unroll_length": trainer.anakin.unroll,
                "opponent_pool": trainer.anakin.K,
            }
        if self.infer_service is not None:
            snap["pipeline"] = {
                **self.infer_service.stats(),
                "respawns": self._infer_respawns,
                "episodes_shm": self.episodes_shm,
                "episodes_spilled": self.episodes_spilled,
                # the run's peak: every key here is cumulative-monotone
                "upload_backlog_peak": self._upload_backlog_peak,
            }
        if self.serve_frontend is not None:
            snap["serving"] = {
                **self.serve_frontend.stats(),
                "respawns": self._serve_respawns,
            }
            if self.serve_announcer is not None:
                snap["serving"]["announcer"] = {
                    "alive": self.serve_announcer.alive,
                    "generation": self.serve_announcer.generation,
                    "registrations": self.serve_announcer.registrations,
                }
        if self.router_frontend is not None:
            snap["router"] = {
                **self.router_frontend.stats(),
                "respawns": self._router_respawns,
            }
        return snap

    def _serving_advert(self):
        """This replica's registry advert (announcer callback, on the
        announcer thread): the frontend's capacity/load/p99 plus the
        committed epochs pinned requests can route here for, the
        manifest's entries (digests are verified at resolve time)."""
        epochs = {int(self.model_epoch)}
        try:
            epochs.update(int(e) for e in self.manifest.load()["entries"])
        except (ValueError, TypeError, OSError, KeyError):
            pass
        return self.serve_frontend.advert(epochs=epochs)

    def _resolve_serving_snapshot(self, epoch):
        """epoch -> model for the serving tier's multi-model routing.
        Runs on the inference service's thread at dispatch time: the
        live epoch answers the in-memory model; other epochs read their
        digest-verified checkpoint once (the JAX package's format,
        converted to the torch module) and LRU-cache it
        (``serving.snapshot_cache``); the service keeps one device
        module per cached snapshot.  None (a typed error at the
        frontend) when the epoch was never committed or its file is
        pruned/corrupt."""
        if epoch == self.model_epoch:
            return self.model
        cache = self._serving_snapshots
        model = cache.get(epoch)
        if model is not None:
            cache.move_to_end(epoch)
            return model
        try:
            params = read_verified(model_path(epoch))["params"]
        except (OSError, CorruptCheckpointError, pickle.UnpicklingError,
                EOFError, KeyError):
            return None  # pruned / never committed / corrupt
        model = TorchModel(build_module(self.model.spec, "cpu"),
                           device="cpu")
        model.load_params(from_flax(params, model.module))
        cache[epoch] = model
        while len(cache) > int(self._serving_cfg.snapshot_cache):
            cache.popitem(last=False)
        return model

    # -- durability ---------------------------------------------------
    def _wal_keep_episodes(self):
        return (int(self.args.get("wal_keep_episodes", 0) or 0)
                or self.args["maximum_episodes"])

    def _replay_wal(self):
        """Restore the backlog from the episode WAL (resume path, before
        any thread starts): the newest ``wal_keep_episodes`` admitted
        episodes go into the ring on the device, or the host deque.
        Replayed episodes do NOT tick ``episodes_received``: epoch
        cadence tracks fresh arrivals.  The staleness budget still
        applies."""
        t0 = time.perf_counter()
        restored = deque(maxlen=self._wal_keep_episodes())
        scanned = stale = 0
        for _seq, episode in self.wal.replay():
            scanned += 1
            if (self.max_policy_lag > 0
                    and self._episode_lag(episode) > self.max_policy_lag):
                stale += 1
                continue
            restored.append(episode)
        restored = list(restored)
        t1 = time.perf_counter()
        if self.trainer.device_replay is not None:
            self.episodes_replayed = \
                self.trainer.device_replay.warm_start(restored)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        else:
            self.trainer.episodes.extend(restored)
            self.episodes_replayed = len(restored)
        t2 = time.perf_counter()
        if scanned:
            print(f"wal: replayed {self.episodes_replayed} of {scanned} "
                  f"logged episode(s) into the backlog"
                  + (f" ({stale} past the staleness budget)"
                     if stale else "")
                  + f" in {t2 - t0:.3f} s (read {t1 - t0:.3f} s, "
                  f"ingest {t2 - t1:.3f} s)", flush=True)

    def _preempt_save(self):
        """SIGTERM: durable state inside the grace window, in rescue
        order.  Seal the WAL (this thread owns it), ask the trainer
        thread for an emergency checkpoint and wait for it with a
        deadline (``Event.wait`` releases the GIL to the trainer), then
        tear the local fleet down so no orphan competes with the
        relaunch.  Runs on the main (server) thread."""
        t0 = time.perf_counter()
        print("SIGTERM: preemption grace window — sealing WAL and "
              "requesting an emergency checkpoint", flush=True)
        if self.wal is not None:
            try:
                self.wal.seal()
            except Exception as exc:  # e.g. mid-roll: file just closed
                print(f"WARNING: WAL seal failed ({exc!r})")
        grace = float(self.args.get("preempt_grace_seconds", 5.0) or 0.0)
        if grace > 0:
            event = threading.Event()
            self.trainer.emergency = event
            if event.wait(grace):
                print(f"SIGTERM: emergency save done "
                      f"{1e3 * (time.perf_counter() - t0):.1f} ms after "
                      "the signal", flush=True)
            else:
                print("WARNING: emergency checkpoint did not land "
                      f"inside the {grace:.1f}s grace window; resume "
                      "falls back to the last epoch boundary")
        try:
            self.worker.terminate_fleet()
        except Exception as exc:  # teardown must not block the exit
            print(f"WARNING: fleet teardown failed ({exc!r})")

    def _initial_model(self, net):
        """The epoch-0 model (seeded init) or the resumed checkpoint's,
        as a CPU snapshot."""
        module = net if net is not None else self.env.net()
        model = TorchModel(module, device="cpu")
        if self.model_epoch > 0:
            src = self._resume.model_file or model_path(self.model_epoch)
            model.load_params(from_flax(read_verified(src)["params"],
                                        model.module))
        else:
            model.init_params(seed=self.args["seed"])
        return model

    # -- checkpointing ----------------------------------------------
    def _prune_checkpoints(self):
        """Keep the newest ``checkpoint_keep_last`` epoch files plus
        every ``checkpoint_keep_every``-th (0 = keep all)."""
        keep_last = int(self.args.get("checkpoint_keep_last", 0) or 0)
        if keep_last <= 0:
            return
        keep_every = int(self.args.get("checkpoint_keep_every", 0) or 0)
        boundary = self.model_epoch - keep_last + 1
        removed = []
        for epoch in range(getattr(self, "_pruned_below", 1), boundary):
            if keep_every > 0 and epoch % keep_every == 0:
                continue
            try:
                os.remove(model_path(epoch))
            except OSError:
                pass
            removed.append(epoch)
        self._pruned_below = max(getattr(self, "_pruned_below", 1),
                                 boundary)
        if removed:
            self.manifest.forget(removed)

    def update_model(self, model, steps):
        print("updated model(%d)" % steps)
        self.model_epoch += 1
        self.model = model
        self.worker.note_epoch(self.model_epoch)  # chaos surge clock
        if self.infer_service is not None:
            # hot-swap the serving snapshot BEFORE jobs labelled with
            # the new epoch go out
            self.infer_service.set_model(model, self.model_epoch)
            if (self._infer_kill_epoch > 0 and not self._infer_killed
                    and self.model_epoch >= self._infer_kill_epoch):
                # pipeline chaos: the service dies without a parting
                # beat; workers bridge on local inference until the
                # supervised respawn in _pipeline_tick
                self._infer_killed = True
                print(f"CHAOS: killing the inference service at epoch "
                      f"{self.model_epoch}")
                self.infer_service.inject_kill()
        if (self.serve_frontend is not None
                and self._serve_kill_epoch > 0 and not self._serve_killed
                and self.model_epoch >= self._serve_kill_epoch):
            # pool-routing chaos: this replica goes SILENT (frontend and
            # announcer die without a goodbye); the router must evict it
            # on missing beats, and _serving_tick respawns both
            self._serve_killed = True
            print(f"CHAOS: killing the serving replica at epoch "
                  f"{self.model_epoch}", flush=True)
            if self.serve_announcer is not None:
                self.serve_announcer.kill()
            self.serve_frontend.inject_kill()
        if not self.primary:
            # replicas serve the in-memory snapshot to their own
            # workers; only rank 0 writes the checkpoint dir
            return
        os.makedirs(_models_dir(), exist_ok=True)
        # the JAX package's checkpoint format: both packages read it
        state = {"params": to_flax(model.module), "steps": steps,
                 "epoch": self.model_epoch}
        digest = write_checksummed(model_path(self.model_epoch), state,
                                   checksum=self.checkpoint_checksum)
        write_checksummed(latest_model_path(), state,
                          checksum=self.checkpoint_checksum)
        # the manifest is the commit point of the epoch
        self.manifest.commit(
            self.model_epoch, model_path(self.model_epoch), digest, steps,
            train_state_digest=self.trainer.last_state_digest)
        self._prune_checkpoints()
        if self.wal is not None:
            # the active segment rolls, and segments the buffer no
            # longer covers retire
            self.wal.checkpoint_landed(self._wal_keep_episodes())

    # -- episode / result intake ------------------------------------
    def _episode_lag(self, episode):
        """Policy-version lag: learner epoch now minus the snapshot
        epoch that generated the episode."""
        gen = episode.get("gen_model_epoch")
        if gen is None:
            job = episode["args"]
            labels = [job["model_id"][p] for p in job["player"]]
            gen = max([label for label in labels if label >= 0],
                      default=self.model_epoch)
        return max(0, self.model_epoch - gen)

    def _note_intake(self, episode, lag):
        """Per-episode telemetry at intake: the lag joins this epoch's
        ``policy_lag_*`` reduction and, for a trace-stamped episode, an
        intake event under the episode's own context lets the exported
        trace cross the worker -> learner process boundary."""
        self._policy_lags.append(lag)
        ctx = episode.get("trace")
        if ctx is not None and telemetry.enabled():
            prev = telemetry.current_trace()
            telemetry.set_trace(ctx)
            telemetry.add_event("episode.intake", lag=int(lag))
            telemetry.set_trace(prev)  # the rpc span keeps ITS context

    def feed_episodes(self, episodes):
        arrived = [e for e in episodes if e is not None]
        for episode in arrived:
            # the shm plane's stamps, popped before the WAL or the ring
            # see the episode: a control-plane spill, and the worker's
            # hold-backlog depth at ship time
            if episode.pop("shm_spilled", False):
                self.episodes_spilled += 1
                self._spilled_epoch += 1
            backlog = int(episode.pop("upload_backlog", 0))
            self._upload_backlog_epoch = max(self._upload_backlog_epoch,
                                             backlog)
            self._upload_backlog_peak = max(self._upload_backlog_peak,
                                            backlog)
        # admission control: past-budget episodes are counted and
        # dropped; they still tick the intake clock below.  Each
        # admitted episode's lag feeds the epoch's policy_lag_* record
        kept = []
        for episode in arrived:
            lag = self._episode_lag(episode)
            if 0 < self.max_policy_lag < lag:
                self.episodes_rejected_stale += 1
                self._rejected_epoch += 1
            else:
                kept.append(episode)
                self._note_intake(episode, lag)
        if self.wal is not None:
            # write-ahead: an admitted episode reaches the log before
            # any stats or buffer touch it
            for episode in kept:
                self.wal.append(episode)
        for episode in kept:
            job = episode["args"]
            # trained seats credit the epoch that actually finished the
            # episode (the pool may swap snapshots mid-flight)
            final = episode.get("final_model_epoch")
            for p in job["player"]:
                label = job["model_id"][p]
                if final is not None and label >= 0:
                    label = final
                self.generation_stats.setdefault(
                    label, RunningScore()).add(episode["outcome"][p])
            # league seats (scheduled past-self opponents) track
            # SEPARATELY, keyed by the snapshot epoch they played:
            # folding them into generation_stats would collide with
            # the label that epoch earned when it was the one training
            league = [(p, label) for p, label in job["model_id"].items()
                      if label >= 0 and p not in job["player"]]
            for p, label in league:
                self.league_stats.setdefault(
                    label, RunningScore()).add(episode["outcome"][p])
            self._league_epoch += bool(league)
        before = self.episodes_received
        self.episodes_received += len(arrived)
        for mark in range(before // 100 + 1,
                          self.episodes_received // 100 + 1):
            print(mark * 100, end=" ", flush=True)
        if self.trainer.device_replay is not None:
            self.trainer.device_replay.offer(kept)
        else:
            self.trainer.episodes.extend(kept)
        if self._kill_switch is not None:
            # durability chaos: the scheduled learner SIGKILL ticks on
            # the intake clock (deterministically mid-window)
            self._kill_switch.note(self.model_epoch, self.episodes_received)

    def feed_results(self, results):
        players = self.env.players()
        for result in results:
            if result is None:
                continue
            job, opponent = result["args"], result["opponent"]
            for p in job["player"]:
                model_id = job["model_id"][p]
                score = result["result"][p]
                self.eval_stats.setdefault(model_id, RunningScore()
                                           ).add(score)
                self.eval_stats_by_opponent.setdefault(model_id, {}) \
                    .setdefault(opponent, RunningScore()).add(score)
                self.eval_stats_by_seat.setdefault(model_id, {}) \
                    .setdefault(players.index(p), RunningScore()).add(score)

    # -- epoch boundary ---------------------------------------------
    def _report_win_rates(self, record):
        overall = self.eval_stats.get(self.model_epoch)
        if overall is None:
            print("win rate = Nan (0)")
            return

        def line(tag, score):
            label = " (%s)" % tag if tag else ""
            print("win rate%s = %.3f (%.1f / %d)"
                  % (label, score.win_rate,
                     (score.total + score.n) / 2, score.n))
            record["win_rate" + ("_" + tag if tag else "")] = score.win_rate

        by_opp = self.eval_stats_by_opponent.get(self.model_epoch, {})
        if (len(self.args.get("eval", {}).get("opponent", [])) <= 1
                and len(by_opp) <= 1):
            line("", overall)
        else:
            line("total", overall)
            for name in sorted(by_opp):
                line(name, by_opp[name])
        record["eval_games"] = overall.n
        by_seat = self.eval_stats_by_seat.get(self.model_epoch, {})
        if len(by_seat) > 1:
            print("win rate by seat = " + " ".join(
                "%d:%.3f(%d)" % (s, by_seat[s].win_rate, by_seat[s].n)
                for s in sorted(by_seat)))
            for s, score in by_seat.items():
                record[f"win_rate_seat_{s}"] = score.win_rate

    def _report_generation(self, record):
        stats = self.generation_stats.get(self.model_epoch)
        if stats is None:
            print("generation stats = Nan (0)")
            return
        print("generation stats = %.3f +- %.3f" % (stats.mean, stats.std))
        record["generation_mean"] = stats.mean
        record["generation_std"] = stats.std
        if self.league_stats:
            # each past self's mean outcome while seated as a league
            # opponent (negative = the current model beats it)
            print("league stats = " + " ".join(
                "%d:%.3f(%d)" % (e, s.mean, s.n)
                for e, s in sorted(self.league_stats.items())))
            record["league_opponent_mean"] = {
                str(e): round(s.mean, 4)
                for e, s in self.league_stats.items()}

    def update(self):
        print()
        print("epoch %d" % self.model_epoch)
        # the epoch field is stamped at epoch START (before
        # update_model increments it)
        record = {"epoch": self.model_epoch}
        now = time.monotonic()
        record["time_sec"] = round(now - self._run_t0, 3)
        record["epoch_wall_sec"] = round(now - self._epoch_t, 3)
        record["episodes_received"] = self.episodes_received
        # off-policy staleness of the episodes admitted this epoch, and
        # how many arrivals the staleness budget rejected
        record.update(summarize_lags(self._policy_lags))
        self._policy_lags = []
        record["episodes_rejected_stale"] = self._rejected_epoch
        self._rejected_epoch = 0
        record["league_episodes"] = self._league_epoch
        self._league_epoch = 0
        self._epoch_t = now
        # WAL-restored backlog of this incarnation (constant after
        # start-up; > 0 proves a resume re-entered a warm ring)
        record["episodes_replayed"] = self.episodes_replayed
        if self.wal is not None:
            record.update(self.wal.stats())
        self._report_win_rates(record)
        self._report_generation(record)

        model, steps = self.trainer.update()
        if model is None:
            # keep serving the last snapshot, but say so LOUDLY
            if self.trainer.failure is not None:
                print("WARNING: trainer thread failed "
                      f"({self.trainer.failure!r}); serving the last "
                      "model unchanged")
            model = self.model
        self.update_model(model, steps)
        record["steps"] = steps
        record.update(self.trainer.last_metrics)
        if "anakin_frames" in record and record["epoch_wall_sec"] > 0:
            # fused-rollout throughput: committed env transitions and
            # completed self-play games per second of epoch wall
            wall = record["epoch_wall_sec"]
            record["anakin_frames_per_sec"] = round(
                record["anakin_frames"] / wall, 1)
            record["anakin_games_per_sec"] = round(
                record["anakin_games"] / wall, 1)
        if self.trainer.first_step_at is not None:
            # seconds from this learner's construction to its training
            # loop and to its first update step (a resume's
            # time-to-train; the gap is the first step's own set-up)
            record["training_started_sec"] = round(
                self.trainer.started_at - self._run_t0, 3)
            record["first_step_sec"] = round(
                self.trainer.first_step_at - self._run_t0, 3)
        if self._startup is not None:
            record.update({f"startup_{k}_sec": round(v["sec"], 3)
                           for k, v in self._startup.snapshot().items()})
            self._startup = None
        record.update(self._fleet_record())
        if self.infer_service is not None:
            record.update(self.infer_service.epoch_stats())
            record["infer_respawns"] = self._infer_respawns
            record["infer_param_loads"] = self.infer_service.param_loads
            # shm + spilled episodes reconcile against arrivals: a surge
            # hold shows as spills and backlog, never as loss
            record["episodes_shm"] = self._shm_epoch
            record["episodes_spilled"] = self._spilled_epoch
            record["upload_backlog"] = self._upload_backlog_epoch
            self._shm_epoch = self._spilled_epoch = 0
            self._upload_backlog_epoch = 0
        if self.serve_frontend is not None:
            # per-epoch request/ok/shed/error counts, QPS and the log2
            # histogram's latency reduction; sheds are typed replies
            record.update(self.serve_frontend.epoch_stats())
            record["serve_respawns"] = self._serve_respawns
        if self.router_frontend is not None:
            record.update(self.router_frontend.epoch_stats())
            record["router_respawns"] = self._router_respawns
        if self.stall_watchdog is not None:
            # control-plane loops silent past max_stall_seconds this
            # epoch; steady state 0
            record["stall_events"] = self.stall_watchdog.snapshot()
        if self.lock_guard is not None:
            # waits on control-plane locks and ABBA order inversions
            # this epoch; steady state (~0, 0)
            record.update(self.lock_guard.snapshot())
        if self.resource_ledger is not None:
            # fd/thread/shm populations and fd growth over the
            # post-warm-up baseline (ResourceError past max_fd_growth)
            record.update(self.resource_ledger.snapshot())
        # wall-time reconciliation: the residual is DEFINED over the
        # record's own rounded values, so epoch_wall_sec ==
        # sum(profile_*_sec) + untracked_residual_sec holds exactly
        record["untracked_residual_sec"] = \
            telemetry.untracked_residual(record)
        # fold this epoch's span ring into the self-time tree (status
        # perf section + flight-recorder dumps); no-op telemetry-off
        self.attributor.note_epoch(record)
        if self.metrics_path and self.primary:
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        self._last_record = record     # the status endpoint reads this
        telemetry.flush()              # epoch boundary: spans to disk

    # -- fleet health -----------------------------------------------
    def _fleet_record(self):
        """Per-epoch fleet metrics (fleet_size, respawns,
        heartbeat_misses, conn_drops, ...).  A shrunken fleet is loud
        but not fatal: it slows intake, it does not stop training."""
        self.fleet.record_drops(self.worker.drop_stats())
        snap = self.fleet.snapshot()
        stats = self.worker.fleet_stats()
        snap["respawns"] = stats.get("respawns", 0)
        # expected strength: the supervisor's slot count for a local
        # fleet, the registry's sustained peak for a remote one
        expected = stats.get("slots", self.fleet.peak_size)
        if snap["fleet_size"] < expected:
            print(f"WARNING: fleet degraded: {snap['fleet_size']} of "
                  f"{expected} gathers responsive "
                  f"({snap['respawns']} respawns, "
                  f"{stats.get('slots_dead', 0)} slots dead); "
                  "training continues on the surviving fleet")
        return snap

    def _sweep_fleet(self):
        """Time-gated heartbeat expiry: newly stale peers are reported
        to the communicator, which evicts them (a local gather is
        killed and respawned, a remote socket is severed).  Also the
        WAL's idle-tail fsync."""
        now = time.monotonic()
        if now - self._last_sweep < 1.0:
            return
        if self.wal is not None:
            self.wal.maybe_flush(now)
        # a much larger gap than the loop's ~0.3-1 s means THIS thread
        # stalled (an epoch boundary, checkpoint I/O) while peer
        # messages queued unread
        stalled = self._last_sweep > 0.0 and now - self._last_sweep > 5.0
        self._last_sweep = now
        self._check_fleet_dead()
        # peers whose connection the communicator already dropped are
        # gone, not merely silent
        live = set(self.worker.live_connections())
        for peer in self.fleet.peers():
            if peer not in live:
                self.fleet.forget(peer)
        if stalled:
            # the silence was ours: refresh everyone instead of
            # evicting a healthy fleet
            self.fleet.pardon(now)
            return
        for conn in self.fleet.sweep(now):
            self.worker.report_stale(conn)

    def _check_fleet_dead(self):
        """Every supervised gather slot circuit-broke: nothing can
        rejoin a LOCAL fleet, so shut down instead of idling forever."""
        stats = self.worker.fleet_stats()
        slots = stats.get("slots", 0)
        if (not slots or stats.get("fleet_alive", 1) > 0
                or stats.get("slots_dead", 0) < slots
                or self.shutdown_flag):
            return
        if self.trainer.anakin is not None:
            # the fleet only evaluates: training goes on, without the
            # win-rate stream, loudly
            now = time.monotonic()
            if now - getattr(self, "_fleet_dead_warned", 0.0) > 30.0:
                self._fleet_dead_warned = now
                print("WARNING: the entire eval worker fleet is dead; "
                      "anakin training continues WITHOUT win-rate "
                      "evaluation")
            return
        print("ERROR: the entire local gather fleet is dead (circuit "
              "breaker tripped on every slot); shutting down — raise "
              "max_respawns or fix the crash in the gather/worker logs")
        self.shutdown_flag = True
        self.worker.begin_drain()
        self.trainer.request_shutdown()

    # -- control plane ----------------------------------------------
    def _on_beat(self, beats):
        # liveness was noted in the server loop; a beat needs an ack
        return [None for _ in beats]

    def _on_args(self, requests):
        if self.shutdown_flag:
            return [None for _ in requests]
        return [self._assign_job() for _ in requests]

    def _on_episode(self, episodes):
        self.feed_episodes(episodes)
        return [None for _ in episodes]

    def _on_result(self, results):
        self.feed_results(results)
        return [None for _ in results]

    def _on_model(self, model_ids):
        return [self._serve_model(mid) for mid in model_ids]

    def _on_shm(self, specs):
        """The shm handshake: rings + a client slot per asking worker;
        None refuses (pipeline off, or shutting down) and the worker
        keeps local inference."""
        replies = []
        for spec in specs:
            if (self.infer_service is None or self._infer_disabled
                    or self.shutdown_flag or not isinstance(spec, dict)):
                replies.append(None)
                continue
            try:
                replies.append(self.infer_service.attach(spec))
            except (OSError, ValueError, KeyError) as exc:
                print(f"WARNING: shm attach failed ({exc!r}); "
                      "the peer keeps local inference")
                replies.append(None)
        return replies

    def _pipeline_tick(self):
        """Drain the shm trajectory rings into episode intake, and
        supervise the service thread: a dead service respawns behind
        ``respawn_backoff`` (workers bridge on local inference), and a
        windowed breaker trip disables pipelined inference for the rest
        of the run instead of respawn-storming.  The ring and the
        update step stay on the device either way."""
        svc = self.infer_service
        if svc is None:
            return
        episodes = svc.drain_trajectories(max_episodes=512)
        if episodes:
            self.episodes_shm += len(episodes)
            self._shm_epoch += len(episodes)
            with telemetry.trace_span("intake.shm",
                                      episodes=len(episodes)):
                self.feed_episodes(episodes)
        if svc.alive or self._infer_disabled or self.shutdown_flag:
            return
        now = time.monotonic()
        if self._infer_respawn_at == 0.0:
            if self._infer_window.record(now):
                self._infer_disabled = True
                print("ERROR: the inference service keeps dying "
                      "(circuit breaker tripped); pipelined inference "
                      "disabled for this run — workers continue on "
                      "local CPU inference")
                return
            delay = float(self.args.get("respawn_backoff", 0.5) or 0.5)
            self._infer_respawn_at = now + delay
            print(f"WARNING: inference service died"
                  + (f" ({svc.failure!r})" if svc.failure else "")
                  + f"; respawning in {delay:.1f}s (workers fall back "
                  "to local inference meanwhile)")
        elif now >= self._infer_respawn_at:
            self._infer_respawn_at = 0.0
            self._infer_respawns += 1
            svc.set_model(self.model, self.model_epoch)
            svc.respawn()
            print("inference service respawned "
                  f"(incarnation {svc.board.generation})", flush=True)

    def server(self):
        print("started server")
        handlers = {
            "args": self._on_args,
            "episode": self._on_episode,
            "result": self._on_result,
            "model": self._on_model,
            "beat": self._on_beat,
            "shm": self._on_shm,
        }
        next_epoch_at = (self.args["minimum_episodes"]
                         + self.args["update_episodes"])
        while self.worker.connection_count() > 0 or not self.shutdown_flag:
            if self.stall_watchdog is not None:
                self.stall_watchdog.beat("server")
            try:
                conn, (verb, payload) = self.worker.recv(timeout=0.3)
            except queue.Empty:
                conn = None  # epoch checks below still run on idle
            self._sweep_fleet()
            self._pipeline_tick()
            self._serving_tick()
            self._router_tick()
            if conn is not None:
                self.fleet.observe(conn, verb, payload)
                batched = isinstance(payload, list)
                handler = handlers.get(verb)
                if handler is None:
                    self.worker.note_unknown_verb(verb)
                    self.worker.send(conn, [] if batched else None)
                    continue
                # the request's trace context (adopted by the
                # communicator's recv codec) is current here, so this
                # span joins the sending gather's trace
                with telemetry.trace_span("rpc." + str(verb)):
                    replies = handler(payload if batched else [payload])
                self.worker.send(conn, replies if batched else replies[0])
            if self.multihost and not self.primary:
                # replicas do not decide epochs: they follow the trainer,
                # which follows rank 0 through the control word
                if (self.trainer.epoch > self.model_epoch
                        and not self.shutdown_flag):
                    self.update()
                if (self.trainer.shutdown_flag
                        or self.trainer.failure is not None) \
                        and not self.shutdown_flag:
                    self.shutdown_flag = True
                    self.worker.begin_drain()
            elif self.trainer.anakin is not None:
                self._anakin_tick()
            # episodes drained after shutdown still land in the buffer
            # but start no extra epoch
            elif (self.episodes_received >= next_epoch_at
                    and not self.shutdown_flag):
                next_epoch_at += self.args["update_episodes"]
                self.update()
                if 0 <= self.args["epochs"] <= self.model_epoch:
                    self.shutdown_flag = True
                    # workers drain from here: gather exits are
                    # completions, not crashes to respawn
                    self.worker.begin_drain()
        print("finished server")

    def _serving_tick(self):
        """Supervise the serving frontend once per server-loop pass:
        a dead acceptor respawns behind backoff and the windowed
        circuit breaker (a trip disables network serving for the rest
        of the run; training is never held hostage by it)."""
        fe = self.serve_frontend
        if (fe is None or fe.alive or self._serve_disabled
                or self.shutdown_flag):
            return
        now = time.monotonic()
        if self._serve_respawn_at == 0.0:
            if self._serve_window.record(now):
                self._serve_disabled = True
                print("ERROR: the serving frontend keeps dying "
                      "(circuit breaker tripped); network serving "
                      "disabled for this run — training continues")
                fe.close()
                return
            delay = float(self.args.get("respawn_backoff", 0.5) or 0.5)
            self._serve_respawn_at = now + delay
            print(f"WARNING: serving frontend died; respawning in "
                  f"{delay:.1f}s (clients see refused connections "
                  f"meanwhile)")
        elif now >= self._serve_respawn_at:
            self._serve_respawn_at = 0.0
            try:
                fe.respawn()
            except Exception as exc:
                # e.g. a fixed port still held elsewhere: the failure
                # costs the serving plane another ladder round, never
                # the server loop
                print(f"WARNING: serving frontend respawn failed "
                      f"({exc!r}); retrying through the backoff ladder")
                return
            self._serve_respawns += 1
            print("serving frontend respawned "
                  f"(incarnation {fe.generation})")
            if self.serve_announcer is not None:
                # the respawned frontend re-enters the pool: a fresh
                # register bumps this replica's registry generation
                self.serve_announcer.respawn()

    def _router_tick(self):
        """Supervise the pool router the way ``_serving_tick``
        supervises the frontend; a breaker trip disables pool routing
        for the run, never training."""
        rt = self.router_frontend
        if (rt is None or rt.alive or self._router_disabled
                or self.shutdown_flag):
            return
        now = time.monotonic()
        if self._router_respawn_at == 0.0:
            if self._router_window.record(now):
                self._router_disabled = True
                print("ERROR: the pool router keeps dying (circuit "
                      "breaker tripped); pool routing disabled for "
                      "this run — training continues")
                rt.close()
                return
            delay = float(self.args.get("respawn_backoff", 0.5) or 0.5)
            self._router_respawn_at = now + delay
            print(f"WARNING: pool router died; respawning in "
                  f"{delay:.1f}s (pool clients see refused "
                  f"connections meanwhile)")
        elif now >= self._router_respawn_at:
            self._router_respawn_at = 0.0
            try:
                rt.respawn()
            except Exception as exc:
                print(f"WARNING: pool router respawn failed "
                      f"({exc!r}); retrying through the backoff ladder")
                return
            self._router_respawns += 1
            print(f"pool router respawned (incarnation {rt.generation})")
            if (self.serve_announcer is not None
                    and not self._serving_cfg.router_address):
                # port 0 rebinds fresh: point the local announcer at
                # the new incarnation before its next retry
                self.serve_announcer.port = rt.port

    def _anakin_tick(self):
        """Anakin's epoch clock on the server loop: an epoch every
        ``updates_per_epoch`` trainer steps.  A dead fused loop can
        never advance it, so its failure shuts the learner down loudly
        instead of serving a frozen model forever."""
        if self.shutdown_flag:
            return
        if self.trainer.failure is not None:
            print("ERROR: anakin trainer thread failed "
                  f"({self.trainer.failure!r}); shutting down — nothing "
                  "advances epochs without the fused loop")
        elif self.trainer.steps >= self._anakin_epoch_at:
            self._anakin_epoch_at += self.args["updates_per_epoch"]
            self.update()
            if not 0 <= self.args["epochs"] <= self.model_epoch:
                return
        else:
            return
        self.shutdown_flag = True
        self.worker.begin_drain()

    def _league_opponent(self):
        """Sample a past checkpoint epoch for a league seat, or None.

        Candidates are the epochs from the last ``past_epochs`` whose
        snapshot file actually survives retention pruning: sampling a
        pruned epoch would silently serve the latest model under a
        stale label (``_serve_model``'s fallback)."""
        cfg = self.args.get("generation_opponent") or {}
        k = int(cfg.get("past_epochs", 0) or 0)
        if k <= 0 or self.model_epoch < 2:
            return None
        if random.random() >= float(cfg.get("prob", 0.25)):
            return None
        lo = max(1, self.model_epoch - k)
        cands = [e for e in range(lo, self.model_epoch)
                 if os.path.exists(model_path(e))]
        return random.choice(cands) if cands else None

    def _assign_job(self):
        """Split worker jobs between generation and evaluation so that
        evaluation keeps pace at ``eval_rate`` of the episode stream.
        With ``generation_opponent`` configured, a fraction of
        generation jobs seat a retained past self as one opponent
        (league-lite); those jobs carry mixed snapshots, so the
        workers route them down their sequential path."""
        players = self.env.players()
        league_seat = past = None
        # Anakin generates on the device, so every job is an evaluation
        if (getattr(self.trainer, "anakin", None) is not None
                or self.jobs_evaluated < self.eval_rate * self.jobs_generated):
            trained = [players[self.jobs_evaluated % len(players)]]
            self.jobs_evaluated += 1
            role = "e"
        else:
            trained = list(players)
            past = self._league_opponent()
            if past is not None:
                league_seat = random.choice(players)
                trained = [p for p in players if p != league_seat]
            self.jobs_generated += 1
            role = "g"
        model_id = {p: self.model_epoch if p in trained else -1
                    for p in players}
        if league_seat is not None:
            model_id[league_seat] = past
        return {"role": role, "player": trained, "model_id": model_id}

    def _serve_model(self, model_id):
        model = self.model
        if model_id != self.model_epoch and model_id > 0:
            try:
                params = read_verified(model_path(model_id))["params"]
                model = TorchModel(build_module(self.model.spec, "cpu"),
                                   device="cpu")
                model.load_params(from_flax(params, model.module))
            except (OSError, CorruptCheckpointError):
                pass  # missing/corrupt snapshot: serve the latest model
        return pickle.dumps(model)

    def run(self):
        trainer_thread = threading.Thread(target=self.trainer.run,
                                          daemon=True)
        trainer_thread.start()
        self.worker.run()
        self._arm_lock_guard()
        try:
            self.server()
        finally:
            # stop device work before interpreter teardown
            self.trainer.request_shutdown()
            trainer_thread.join(timeout=30)
            self.trainer.stop_feeds()
            self.worker.shutdown()
            if self.stall_watchdog is not None:
                # the loops stop beating by design now: a late sample
                # must not report teardown as a stall
                self.stall_watchdog.stop()
            if self.status is not None:
                self.status.close()
            if self.serve_announcer is not None:
                # graceful goodbye FIRST: the router drains this
                # replica before its listener goes away
                self.serve_announcer.close()
            if self.router_frontend is not None:
                self.router_frontend.close()
            if self.serve_frontend is not None:
                # the frontend rides the service: close it first so no
                # handler thread submits into a closing service
                self.serve_frontend.close()
            if self.infer_service is not None:
                print("inference service stats = "
                      + json.dumps(self.infer_service.stats(),
                                   sort_keys=True), flush=True)
                # workers are gone: unmap and unlink every ring
                self.infer_service.close()
            if self.wal is not None:
                self.wal.close()  # final fsync of the append tail
            telemetry.flush()  # ship the span-log tail before exit
            if self._sigterm_prev is not None:
                try:
                    signal.signal(signal.SIGTERM, self._sigterm_prev)
                except ValueError:
                    pass


def _maybe_init_distributed(args, device, backend=None):
    """Multi-process bring-up (``train_args.distributed``) before any
    use of the device; returns this rank's device."""
    dist_cfg = (args.get("train_args") or {}).get("distributed")
    if not dist_cfg:
        return device
    mh.init_distributed(dist_cfg, device=device, backend=backend)
    device = mh.rank_device(dist_cfg, device)
    print(f"distributed: process {mh.process_index()} of "
          f"{mh.process_count()}, {torch.distributed.get_backend()} on "
          f"{device}", flush=True)
    return device


def _train_local(args, device=DEFAULT_DEVICE, backend=None):
    """One learner incarnation with its local fleet (module-level: the
    supervised child's entry point, pickled by the spawn context).
    The process group, when there is one, comes down on every exit
    path, so no peer is left waiting in a collective on this rank."""
    try:
        device = _maybe_init_distributed(args, device, backend)
        prepare_env(args["env_args"])
        Learner(args=args, device=device).run()
    finally:
        mh.shutdown()


def _train_remote(args, device=DEFAULT_DEVICE, backend=None):
    """One learner incarnation serving remote worker machines."""
    try:
        device = _maybe_init_distributed(args, device, backend)
        prepare_env(args["env_args"])
        Learner(args=args, device=device, remote=True).run()
    finally:
        mh.shutdown()


def _maybe_supervised(args, target):
    """``supervise_learner: true`` runs the learner as a guarded child
    process: a crash or preemption relaunches it with ``restart_epoch:
    auto`` behind the fleet's backoff and circuit breaker.  The guard's
    process never initializes CUDA; the child makes its own context.
    Returns True when the guard ran (and has finished)."""
    if not (args.get("train_args") or {}).get("supervise_learner"):
        return False
    from .resilience.guardian import LearnerGuard

    code = LearnerGuard.from_args(target, args).run()
    print(f"learner guard: cuda initialized {torch.cuda.is_initialized()}",
          flush=True)
    if code:
        raise SystemExit(code)
    return True


def train_main(args, device=DEFAULT_DEVICE, backend=None):
    """``--train``: one local learner with its worker fleet; with
    ``distributed:`` this process is one rank of a multi-process
    learner (``backend`` overrides NCCL/gloo, e.g. gloo for two ranks
    sharing one card)."""
    resolve_device(device)  # fail before any work when the card is absent
    target = functools.partial(_train_local, device=device, backend=backend)
    if not _maybe_supervised(args, target):
        target(args)


def train_server_main(args, device=DEFAULT_DEVICE, backend=None):
    """``--train-server``: a learner serving remote worker machines on
    the entry and worker ports; the ring and the step on ``device``."""
    resolve_device(device)
    target = functools.partial(_train_remote, device=device,
                               backend=backend)
    if not _maybe_supervised(args, target):
        target(args)
