"""Actor-side runtime: workers, gather fan-in, local & remote clusters.

The counterpart of ``handyrl_tpu.worker``: CPU worker processes run
self-play or evaluation jobs; Gather processes fan in ~16 workers
each, so the learner serves O(gathers) connections instead of
O(workers).  The local :class:`WorkerCluster` keeps its gathers alive
under a :class:`~.resilience.Supervisor` (respawn with backoff behind
a circuit breaker); remote machines join a ``--train-server`` learner
through a one-shot entry handshake (:class:`WorkerServer`,
:class:`RemoteWorkerCluster`, ``--worker``).

The wire protocol is the learner's and stays as it is: request tuples
``(verb, payload)`` with verbs ``args`` / ``model`` / ``episode`` /
``result`` / ``shm`` (payload may be a list for batched requests) and
job-args dicts ``{role, player, model_id}``.

Every worker runs on the CPU because this module asks for it: models
arrive pickled (spec + numpy params) and are rebuilt on the CPU, and
no worker initializes CUDA — at exit each prints whether it did, with
its pipeline counters.  With the pipeline on, a worker's forwards go
to the learner's batched inference service and finished episodes ride
the shm trajectory ring (an episode the ring refuses is stamped
``shm_spilled`` and sent over the control plane, never dropped).
Remote workers keep local CPU inference: shared memory does not cross
machines, and a remote learner runs no inference service.

Gathers send an explicit ``("beat", stats)`` after
``heartbeat_interval`` seconds without a learner round trip, so the
learner's ``FleetRegistry`` tells idle from wedged.  The chaos section
drives gather kills, surges (burst kills, a respawn hold, a hold of
the gathers' uploads and of the workers' shm episode shipping, whose
backlog drains paced and spills its overflow, stamped) and frame
faults on the gather's learner connection; the shm faults wrap each
worker's ring endpoints (:class:`~.pipeline.client.PipelineClient`).  Telemetry is the JAX package's: each worker records an
``episode.rollout`` span per episode under a sampled trace context and
stamps the context into the finished payload; workers wrap their
gather pipe and gathers their learner connection in a
``TracedConnection``, so the context crosses worker -> gather ->
learner in the exported trace.

Ports (the JAX package's, so operational docs carry over):
  9999 — entry: one-shot handshake assigning worker-id blocks
  9998 — worker: persistent gather connections
"""

import copy
import functools
import pickle
import queue
import random
import signal
import sys
import threading
import time
from collections import OrderedDict, deque
from socket import gethostname

from . import telemetry
from .connection import (
    DEFAULT_MAX_FRAME_BYTES,
    QueueCommunicator,
    TracedConnection,
    _mp,
    accept_socket_connections,
    open_multiprocessing_connections,
    open_socket_connection,
    send_recv,
)
from .telemetry import payload_trace

ENTRY_PORT = 9999
WORKER_PORT = 9998

_PEER_GONE = (ConnectionResetError, BrokenPipeError, EOFError, OSError)


def _exit_on_sigterm(signum, frame):
    sys.exit(0)  # unwind: ``finally`` blocks run, children are reaped


class ModelCache:
    """Resolves model ids to CPU models, fetching snapshots from the
    learner on a miss.

    Id conventions (protocol): ``id < 0`` is an empty opponent slot,
    ``id == 0`` the uniform-random stand-in, positive ids are learner
    epochs.  A small LRU keeps the newest epoch plus recent old-epoch
    opponents warm."""

    CAPACITY = 3

    def __init__(self, conn, env):
        self._conn = conn
        self._env = env
        self._cache = OrderedDict()  # model_id -> model (LRU order)

    def _fetch(self, model_id):
        from .models import RandomModel

        model = pickle.loads(send_recv(self._conn, ("model", model_id)))
        if model_id == 0:
            self._env.reset()
            obs = self._env.observation(self._env.players()[0])
            model = RandomModel(model, obs)
        return model

    def resolve(self, model_ids):
        """Return {model_id: model} covering every id in the list."""
        resolved = {}
        for model_id in set(model_ids):
            if model_id < 0:
                resolved[model_id] = None
                continue
            if model_id in self._cache:
                self._cache.move_to_end(model_id)
                resolved[model_id] = self._cache[model_id]
                continue
            model = self._fetch(model_id)
            self._cache[model_id] = model
            while len(self._cache) > self.CAPACITY:
                self._cache.popitem(last=False)
            resolved[model_id] = model
        return resolved


class Worker:
    """One actor process: pull jobs, resolve their models, roll out
    episodes and evaluation matches, push the results back.

    With ``lockstep_episodes > 1`` (the default) jobs run through a
    RolloutPool: K episodes advance together and each step issues one
    batched forward across every seat.  Jobs the pool cannot take
    (mixed model snapshots) run on the sequential path."""

    def __init__(self, args, conn, wid):
        print(f"opened worker {wid}")
        self.worker_id = wid
        self.args = args
        self.conn = conn
        random.seed(args["seed"] + wid)

        from .environment import make_env
        from .evaluation import Evaluator
        from .generation import Generator, RolloutPool
        from .pipeline import attach_pipeline

        self.env = make_env({**args["env"], "id": wid})
        self.pipeline = attach_pipeline(conn, self.env, args)
        if self.pipeline is not None:
            print(f"worker {wid}: pipelined inference attached "
                  f"(client {self.pipeline.client_id})")
            if not self.pipeline.cfg.compress:
                # episodes ride shared memory: skip the bz2 CPU cost
                self.args = {**args, "episode_compress": False}
        self.models = ModelCache(conn, self.env)
        generator = Generator(self.env, self.args)
        evaluator = Evaluator(self.env, self.args)
        # role -> (runner, reply verb): the job protocol's two roles
        self.roles = {
            "g": (generator.execute, "episode"),
            "e": (evaluator.execute, "result"),
        }
        lockstep = int(self.args.get("lockstep_episodes", 1) or 1)
        self.pool = None
        if lockstep > 1:
            envs = [make_env({**args["env"], "id": wid})
                    for _ in range(lockstep)]
            self.pool = RolloutPool(envs, self.args)

    def _resolve(self, job):
        id_by_player = job.get("model_id", {})
        resolved = self.models.resolve(list(id_by_player.values()))
        if self.pipeline is not None:
            # epoch-pinned served wrappers: answered by the service
            # while it holds exactly that epoch, locally otherwise
            for mid, model in resolved.items():
                if (mid > 0 and model is not None
                        and hasattr(model, "module")
                        and not getattr(model, "is_recurrent", False)):
                    resolved[mid] = self.pipeline.wrap(model, mid)
        return {p: resolved[mid] for p, mid in id_by_player.items()}

    def _next_job(self):
        """One job from the learner; also the pipeline's surge trigger
        (the shm brownout arms off the model ids in the job stream, as
        the gather's control-plane hold does)."""
        job = send_recv(self.conn, ("args", None))
        if self.pipeline is not None:
            self.pipeline.note_jobs([job])
        return job

    def _ship(self, verb, payload):
        """Episodes ride the shm trajectory ring when the pipeline is
        attached (or wait in its surge backlog); results, and episodes
        the ring refuses or the backlog overflows (stamped
        ``shm_spilled``), take the control plane."""
        if (verb == "episode" and payload is not None
                and self.pipeline is not None):
            for episode in self.pipeline.ship_episode(payload):
                with payload_trace(episode):
                    send_recv(self.conn, ("episode", episode))
            return
        # the envelope carries the episode's own context upstream
        with payload_trace(payload):
            send_recv(self.conn, (verb, payload))

    def _run_job(self, job):
        runner, reply_verb = self.roles[job["role"]]
        payload = self._traced_run(runner, job, self._resolve(job))
        self._ship(reply_verb, payload)

    @staticmethod
    def _traced_run(runner, job, models):
        """One sequential job under a fresh (sampled) trace context:
        the rollout span is recorded here, and the finished payload is
        stamped with its context plus the snapshot epoch that generated
        it (the learner reduces those stamps into ``policy_lag_*`` and
        follows the context across processes in the exported trace)."""
        ctx = telemetry.maybe_trace()
        telemetry.set_trace(ctx)
        t0 = telemetry.span_begin()
        try:
            payload = runner(models, job)
            telemetry.span_end("episode.rollout", t0, mode=job["role"])
        finally:
            telemetry.clear_trace()
        if isinstance(payload, dict):
            if ctx is not None:
                payload.setdefault("trace", ctx)
            labels = [job["model_id"][p] for p in job["player"]]
            gen = max([label for label in labels if label >= 0],
                      default=-1)
            if gen >= 0:
                payload.setdefault("gen_model_epoch", gen)
        return payload

    def _run_lockstep(self):
        pool = self.pool
        while True:
            while pool.has_free_slot():
                job = self._next_job()
                if job is None:
                    # the learner is done assigning: finish what is in
                    # flight, then exit
                    self._drain_pool()
                    return
                if not pool.accepts(job):
                    self._run_job(job)
                    continue
                for verb, payload in pool.assign(job, self._resolve(job)):
                    self._ship(verb, payload)
            for verb, payload in pool.step():
                self._ship(verb, payload)

    def _drain_pool(self):
        pool = self.pool
        while any(slot is not None for slot in pool.slots):
            for verb, payload in pool.step():
                self._ship(verb, payload)

    def run(self):
        try:
            if self.pool is not None:
                self._run_lockstep()
                return
            while True:
                job = self._next_job()
                if job is None:
                    return
                self._run_job(job)
        except _PEER_GONE:
            pass  # learner/gather went away: exit quietly
        finally:
            if self.pipeline is not None:
                # episodes a surge hold staged must not die with the
                # worker: into the ring, the rest over the control
                # plane (best effort: a gone peer accepts nothing)
                try:
                    for episode in self.pipeline.flush_backlog():
                        send_recv(self.conn, ("episode", episode))
                except _PEER_GONE:
                    pass
            self._report()
            if self.pipeline is not None:
                self.pipeline.close()  # unmap; the learner owns unlink
            telemetry.flush()  # ship the span-log tail before exit

    def _report(self):
        import torch

        line = (f"closed worker {self.worker_id}: cuda initialized "
                f"{torch.cuda.is_initialized()}")
        if self.pipeline is not None:
            client = self.pipeline
            line += (f", pipeline fallbacks {client.fallbacks}, served "
                     f"rows {client.served_rows}, local rows "
                     f"{client.local_rows}, episodes shipped "
                     f"{client.episodes_shipped}, spilled "
                     f"{client.episodes_spilled}, held "
                     f"{client.episodes_held}")
            chaos = client.chaos_counts()
            if chaos:
                line += ", shm chaos " + " ".join(
                    f"{k}={v}" for k, v in chaos.items())
        # one write per report: workers share the parent's stdout
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def _spawn_worker(conn, args, wid):
    # a gather that exits terminates its daemonic workers: unwind, so
    # the exit report (CUDA state, pipeline counters) still prints
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    # one intra-op thread per worker: the fleet is one process per
    # core, and torch's default pool of a thread per core in every
    # worker oversubscribes the host once workers run their own
    # forwards (a recurrent net is never served)
    import torch

    torch.set_num_threads(1)
    telemetry.configure_from_args(args, role=f"worker-{wid}",
                                  primary=False)
    # the codec wraps post-spawn, in the owning process: sends carry
    # this worker's episode contexts, recvs adopt the gather's
    Worker(args, TracedConnection(conn), wid).run()


class Gather(QueueCommunicator):
    """Fan-in proxy between ~16 workers and the learner.

    Job requests are served from a prefetched block, model requests
    from an id-keyed cache, the shm handshake is forwarded as is, and
    episode/result uploads are acked at once and shipped upstream in
    batches (by count, or by age at low rates).  After
    ``heartbeat_interval`` seconds without a learner round trip the
    gather sends an explicit beat with its worker count and drop
    counters."""

    CACHE_CAPACITY = 4
    FLUSH_AGE = 0.5  # seconds an upload may wait for batch-mates

    def __init__(self, args, conn, gather_id):
        print(f"started gather {gather_id}")
        self.gather_id = gather_id
        self.learner_conn = conn
        self.job_queue = deque()
        self.model_cache = OrderedDict()
        self.pending_uploads = {}
        self.pending_count = 0
        self.first_pending_t = 0.0
        self.heartbeat_interval = float(
            args.get("heartbeat_interval", 2.0) or 0.0)
        self._last_learner_io = time.monotonic()
        self._init_surge(args)
        worker_conns = self._spawn_workers(args, gather_id)
        super().__init__(worker_conns)
        self.block_size = 1 + len(worker_conns) // 4

    @staticmethod
    def _spawn_workers(args, gather_id):
        wcfg = args["worker"]
        n_total, n_gathers = wcfg["num_parallel"], wcfg["num_gathers"]
        count = n_total // n_gathers + int(gather_id < n_total % n_gathers)
        base = wcfg.get("base_worker_id", 0)

        def worker_args(index):
            # interleave ids across gathers so id blocks stay balanced
            return args, base + index * n_gathers + gather_id

        return open_multiprocessing_connections(
            count, _spawn_worker, worker_args)

    def _init_surge(self, args):
        """Chaos surge hold (``chaos.surge_hold_uploads``): when the job
        stream first carries a model id at or past ``chaos.surge_epoch``,
        this gather sits on its upload backlog for the hold window:
        episodes are still acked and staged, nothing ships upstream
        until the window passes.  Job and model round trips keep
        flowing, so heartbeats are unaffected."""
        from .resilience import ChaosConfig

        chaos = ChaosConfig.from_config(args.get("chaos") or {})
        self._surge_epoch = chaos.surge_epoch
        self._surge_hold = chaos.surge_hold_uploads
        self._hold_until = 0.0
        self._surge_pending = chaos.surges_enabled and self._surge_hold > 0

    def _note_surge(self, jobs):
        if not self._surge_pending:
            return
        for job in jobs:
            ids = (job or {}).get("model_id") or {}
            if any(v >= self._surge_epoch for v in ids.values()):
                self._surge_pending = False
                self._hold_until = time.monotonic() + self._surge_hold
                print(f"gather {self.gather_id}: surge — holding "
                      f"uploads for {self._surge_hold:.1f}s")
                return

    def _holding_uploads(self):
        return time.monotonic() < self._hold_until

    def _ask_learner(self, request):
        reply = send_recv(self.learner_conn, request)
        self._last_learner_io = time.monotonic()
        return reply

    def _beat_if_due(self):
        """Explicit heartbeat after heartbeat_interval of silence."""
        if (self.heartbeat_interval > 0
                and time.monotonic() - self._last_learner_io
                >= self.heartbeat_interval):
            self._ask_learner(("beat", {
                "gather_id": self.gather_id,
                "workers": self.connection_count(),
                **self.drop_stats(),
            }))

    def _serve_job(self, conn):
        if not self.job_queue:
            jobs = self._ask_learner(("args", [None] * self.block_size))
            self.job_queue.extend(jobs)
            self._note_surge(jobs)
        self.send(conn, self.job_queue.popleft())

    def _serve_model(self, conn, model_id):
        cache = self.model_cache
        if model_id in cache:
            cache.move_to_end(model_id)
        else:
            cache[model_id] = self._ask_learner(("model", model_id))
            while len(cache) > self.CACHE_CAPACITY:
                cache.popitem(last=False)
        self.send(conn, cache[model_id])

    def _stage_upload(self, conn, verb, payload):
        self.send(conn, None)  # ack now, ship later
        if self.pending_count == 0:
            self.first_pending_t = time.monotonic()
        self.pending_uploads.setdefault(verb, []).append(payload)
        self.pending_count += 1
        if (self.pending_count >= self.block_size
                and not self._holding_uploads()):
            self.flush_uploads()

    def flush_uploads(self, drain=False):
        """Ship pending uploads upstream, at most two blocks per call:
        a post-surge backlog drains in block-sized frames interleaved
        with the job and model round trips instead of one giant frame.
        ``drain=True`` (exit) loops until empty: episodes are never
        dropped at exit."""
        while self.pending_count:
            budget = self.pending_count if drain else min(
                self.pending_count, 2 * self.block_size)
            for verb in list(self.pending_uploads):
                if budget <= 0:
                    break
                payloads = self.pending_uploads[verb]
                take, rest = payloads[:budget], payloads[budget:]
                budget -= len(take)
                self.pending_count -= len(take)
                if rest:
                    self.pending_uploads[verb] = rest
                else:
                    del self.pending_uploads[verb]
                self._ask_learner((verb, take))
            if not drain:
                break

    def _flush_if_stale(self):
        if (self.pending_count and not self._holding_uploads()
                and time.monotonic() - self.first_pending_t
                >= self.FLUSH_AGE):
            self.flush_uploads()

    def run(self):
        while self.connection_count() > 0:
            try:
                conn, (verb, payload) = self.recv(timeout=0.3)
            except queue.Empty:
                self._flush_if_stale()
                self._beat_if_due()
                continue
            if verb == "args":
                self._serve_job(conn)
            elif verb == "model":
                self._serve_model(conn, payload)
            elif verb == "shm":
                self.send(conn, self._ask_learner((verb, payload)))
            else:
                self._stage_upload(conn, verb, payload)
            self._flush_if_stale()
        if self.pending_count:
            self.flush_uploads(drain=True)  # never drop episodes at exit


def _maybe_chaos_wrap(conn, args, gather_id):
    """Frame-fault injection (``chaos.frame_*``) on this gather's
    learner connection, with a per-slot deterministic RNG.  A dropped
    request wedges the gather mid-round-trip by design: the learner's
    heartbeat eviction is what recovers it."""
    from .resilience import ChaosConfig, ChaosConnection

    chaos = ChaosConfig.from_config(args.get("chaos") or {})
    if not chaos.frames_enabled:
        return conn
    rng = random.Random((chaos.seed << 16) ^ gather_id)
    return ChaosConnection(conn, chaos, rng=rng)


def gather_loop(args, conn, gather_id):
    telemetry.configure_from_args(args, role=f"gather-{gather_id}",
                                  primary=False)
    # a chaos kill (or any preemption) is a SIGTERM: leave the flight
    # record behind on the way out
    telemetry.install_signal_dump()
    # trace codec OUTSIDE the chaos wrapper, so injected frame faults
    # hit enveloped frames exactly like real traffic
    gather = Gather(args,
                    TracedConnection(
                        _maybe_chaos_wrap(conn, args, gather_id)),
                    gather_id)
    try:
        gather.run()
    except _PEER_GONE:
        # the learner went away MID-session: exit nonzero so a
        # supervisor counts a failure; only the drain path (workers
        # done, run() returns) exits 0
        raise SystemExit(1)
    finally:
        gather.shutdown()
        telemetry.flush()  # ship the span-log tail before exit


def _default_num_gathers(num_parallel):
    return 1 + max(0, num_parallel - 1) // 16


class WorkerCluster(QueueCommunicator):
    """Local actor pool: gather processes on pipes, kept alive by a
    Supervisor.

    A gather that crashes (or is evicted for missed heartbeats, see
    ``report_stale``) is respawned after a jittered exponential
    backoff; a slot that keeps dying trips its circuit breaker and the
    fleet shrinks instead of restart-storming.  The ``chaos:`` section
    arms a ChaosMonkey against the same supervisor."""

    POLL_INTERVAL = 0.2  # supervision tick, seconds

    def __init__(self, args):
        super().__init__()
        self.args = args
        self.supervisor = None
        self._monkey = None
        self._slot_conns = {}
        self._procs = []

    def _spawn_gather(self, slot):
        """Supervisor spawn hook: a fresh pipe and gather process for a
        slot; the slot's previous (dead) connection is dropped."""
        ours, theirs = _mp.Pipe(duplex=True)
        # gathers spawn worker children, so they cannot be daemonic;
        # they exit on their own once every worker disconnects
        proc = _mp.Process(target=gather_loop,
                           args=(self.args, theirs, slot))
        proc.start()
        theirs.close()
        old = self._slot_conns.get(slot)
        if old is not None:
            self.disconnect(old)
        self._slot_conns[slot] = ours
        self.add_connection(ours)
        self._procs.append(proc)
        return proc

    def run(self):
        from .resilience import (
            BackoffPolicy,
            ChaosConfig,
            ChaosMonkey,
            Supervisor,
        )

        wcfg = self.args["worker"]
        wcfg.setdefault(
            "num_gathers", _default_num_gathers(wcfg["num_parallel"]))
        self.supervisor = Supervisor(
            self._spawn_gather, wcfg["num_gathers"],
            policy=BackoffPolicy(
                base=float(self.args.get("respawn_backoff", 0.5) or 0.5),
                rng=random.Random(self.args.get("seed", 0))),
            max_respawns=int(self.args.get("max_respawns", 5)))
        self.supervisor.start_all()
        chaos = ChaosConfig.from_config(self.args.get("chaos") or {})
        if chaos.kills_enabled or chaos.surges_enabled:
            self._monkey = ChaosMonkey(chaos)
        threading.Thread(target=self._supervise, daemon=True).start()

    def note_epoch(self, epoch):
        """Learner epoch tick: the chaos surge trigger's clock."""
        if self._monkey is not None:
            self._monkey.note_epoch(epoch)

    def _supervise(self):
        while not self.shutdown_flag:
            if self._monkey is not None:
                self._monkey.maybe_kill(self.supervisor)
                self._monkey.maybe_surge(self.supervisor)
            self.supervisor.poll()
            time.sleep(self.POLL_INTERVAL)

    def begin_drain(self):
        # workers are about to receive their None jobs and exit; from
        # here a gather exit is completion, not a crash
        if self.supervisor is not None:
            self.supervisor.stop()

    def report_stale(self, conn):
        """Heartbeat expiry: evict the wedged gather so the supervisor
        respawns it."""
        if self.supervisor is None:
            return
        for slot, slot_conn in self._slot_conns.items():
            if slot_conn is conn:
                self.supervisor.kill_slot(slot, reason="missed heartbeats")
                return

    def fleet_stats(self):
        stats = super().fleet_stats()
        if self.supervisor is not None:
            stats.update(self.supervisor.stats())
        return stats

    def terminate_fleet(self):
        """Preemption teardown (SIGTERM grace window): kill every gather
        now instead of draining, so no orphan fleet competes with the
        supervised relaunch; the WAL already holds the backlog."""
        if self.supervisor is not None:
            self.supervisor.terminate_all()

    def shutdown(self):
        self.begin_drain()
        super().shutdown()
        for proc in self._procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)


class WorkerServer(QueueCommunicator):
    """Learner-side acceptor for remote worker machines.

    Two listener threads: the entry port hands out worker-id blocks
    plus the merged config, and the worker port accepts persistent
    gather connections into the communicator, so machines may join at
    any time during training."""

    # entry-handshake deadline, seconds: a silent peer costs its own
    # deadline, never the machines queued behind it
    ENTRY_TIMEOUT = 10.0

    def __init__(self, args):
        super().__init__()
        self.args = args
        self.total_worker_count = 0
        self.entry_port = ENTRY_PORT
        self.worker_port = WORKER_PORT
        # handshakes run concurrently (one thread each): the id-block
        # reservation must be atomic
        self._admit_lock = threading.Lock()
        self._draining = False

    def begin_drain(self):
        """Training is over: refuse new machines and gathers, so a
        drained machine waits for the next learner instead of
        re-entering a session that hands out only None jobs."""
        self._draining = True

    def note_epoch(self, epoch):
        """No supervised fleet here: remote gathers run under their own
        machines' supervisors (the gather-side surge hold still works,
        triggered by the job stream)."""

    def terminate_fleet(self):
        """Remote gathers belong to their machines: a preempted learner
        just leaves, and the machine-side session resume brings them
        back against the relaunched learner."""

    def _admit(self, conn):
        """Entry handshake: reserve an id block, reply merged config."""
        remote_cfg = conn.recv()
        print(f"accepted connection from {remote_cfg['address']}")
        count = int(remote_cfg["num_parallel"])
        with self._admit_lock:
            remote_cfg["base_worker_id"] = self.total_worker_count
            self.total_worker_count += count
        merged = copy.deepcopy(self.args)
        merged["worker"] = remote_cfg
        conn.send(merged)
        conn.close()

    def _safe_admit(self, conn):
        """One guarded entry handshake: a peer preempted mid-handshake,
        a corrupt frame, or a stray client talking garbage costs that
        one connection, never the accept loop.  The broad catch is
        deliberate: garbage bytes surface as any of a zoo of errors."""
        try:
            # a peer that connects and says nothing raises
            # socket.timeout in _admit's recv after the deadline
            conn.sock.settimeout(self.ENTRY_TIMEOUT)
            self._admit(conn)
        except Exception as exc:  # noqa: BLE001 — see docstring
            print(f"entry handshake failed ({exc!r}); dropping peer")
            try:
                conn.close()
            except OSError:
                pass

    def _listen(self, port, on_conn):
        """Accept on ``port`` until shutdown; the listening socket
        closes with the loop."""
        conns = accept_socket_connections(
            port=port, timeout=0.5, max_frame_bytes=self._max_frame_bytes())
        try:
            for conn in conns:
                if self.shutdown_flag:
                    if conn is not None:
                        conn.close()
                    return
                if conn is not None and self._draining:
                    conn.close()
                elif conn is not None:
                    on_conn(conn)
        finally:
            conns.close()

    def _entry_server(self):
        print(f"started entry server {self.entry_port}")
        # one thread per handshake: a slow peer costs its own deadline,
        # never the machines queued behind it
        self._listen(self.entry_port, lambda conn: threading.Thread(
            target=self._safe_admit, args=(conn,), daemon=True,
            name="entry-admit").start())

    def _worker_server(self):
        print(f"started worker server {self.worker_port}")
        self._listen(self.worker_port, self.add_connection)

    def _max_frame_bytes(self):
        return int(self.args.get("max_frame_bytes", 0)
                   or DEFAULT_MAX_FRAME_BYTES)

    def report_stale(self, conn):
        """A remote gather missed its heartbeats: sever the socket so
        its blocked round trip fails, the gather exits nonzero, and its
        machine's supervisor respawns it."""
        print("dropping stale worker connection (missed heartbeats)")
        self.disconnect(conn)

    def run(self):
        threading.Thread(target=self._entry_server, daemon=True).start()
        threading.Thread(target=self._worker_server, daemon=True).start()


def entry(worker_args):
    """Remote machine -> learner handshake; returns the merged config."""
    conn = open_socket_connection(worker_args["server_address"],
                                  ENTRY_PORT)
    try:
        conn.send(worker_args)
        merged = conn.recv()
    finally:
        conn.close()  # a retry must not leak one fd per attempt
    return merged


class RemoteWorkerCluster:
    """Worker-machine runtime: handshake on the entry port, then local
    gathers each dialing the learner's worker port.

    Resilient by session: the entry handshake retries with backoff
    until the learner answers; each gather slot is supervised (a crash
    or a dial the learner refuses rides the backoff); and when every
    slot has circuit-broken dead (the learner was gone long enough to
    exhaust each slot's respawn budget) the cluster RESUMES the
    session: it re-runs the entry handshake and respawns the fleet,
    whose fresh workers fetch the current model on their first jobs.
    Every process here stays on the CPU."""

    SESSION_POLL = 0.5  # supervision tick, seconds

    def __init__(self, args):
        args["address"] = gethostname()
        args.setdefault(
            "num_gathers", _default_num_gathers(args["num_parallel"]))
        self.args = args
        self._rng = random.Random()

    def _join(self, policy):
        """Entry handshake, retried with backoff until the learner is
        reachable; returns the merged config."""
        attempt = 0
        while True:
            try:
                return entry(self.args)
            except OSError as exc:
                delay = policy.delay(attempt)
                attempt += 1
                print(f"learner unreachable ({exc!r}); "
                      f"retrying entry in {delay:.1f}s")
                time.sleep(delay)

    def _spawn_gather(self, merged, slot):
        conn = open_socket_connection(
            self.args["server_address"], WORKER_PORT,
            max_frame_bytes=int(merged.get("max_frame_bytes", 0)
                                or DEFAULT_MAX_FRAME_BYTES))
        try:
            proc = _mp.Process(target=gather_loop,
                               args=(merged, conn, slot))
            proc.start()
        finally:
            # the spawn context pickled conn at start(): the parent's
            # copy closes whether or not the start succeeded
            conn.close()
        return proc

    def _run_session(self, merged):
        """One supervised fleet against one learner session; returns
        once no slot is live: True for a clean drain (training ended),
        False when the fleet was lost (learner gone mid-session)."""
        from .resilience import BackoffPolicy, Supervisor

        supervisor = Supervisor(
            functools.partial(self._spawn_gather, merged),
            self.args["num_gathers"],
            policy=BackoffPolicy(
                base=float(merged.get("respawn_backoff", 0.5) or 0.5),
                rng=self._rng),
            max_respawns=int(merged.get("max_respawns", 5)),
            # a gather that exits 0 drained its workers after the
            # learner's None jobs: training ended, no respawn
            treat_clean_exit_as_drain=True)
        supervisor.start_all()
        try:
            while True:
                # poll BEFORE the exit check: a child that died during
                # the sleep is recorded (-> backoff respawn) first
                supervisor.poll()
                if (supervisor.alive_count() == 0
                        and supervisor.pending_count() == 0):
                    return (supervisor.dead_count() == 0
                            and supervisor.stopped_count() > 0)
                time.sleep(self.SESSION_POLL)
        finally:
            # gathers are non-daemonic and must not be orphaned
            supervisor.terminate_all()

    def run(self):
        from .environment import prepare_env
        from .resilience import BackoffPolicy

        entry_policy = BackoffPolicy(rng=self._rng)
        while True:
            merged = self._join(entry_policy)
            print(merged)
            prepare_env(merged["env"])
            drained = self._run_session(merged)
            print("training session complete; waiting for the next "
                  "learner" if drained
                  else "gather fleet lost; re-entering the session",
                  flush=True)


def worker_main(args, argv):
    """``--worker [num_parallel]``: this machine's gathers and workers
    join the learner at ``worker_args.server_address`` and serve it
    until the process is stopped (SIGTERM tears the fleet down).  Every
    child runs on the CPU; nothing here initializes CUDA."""
    worker_args = args["worker_args"]
    if len(argv) >= 1:
        worker_args["num_parallel"] = int(argv[0])
        worker_args.pop("num_gathers", None)
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    RemoteWorkerCluster(args=worker_args).run()
