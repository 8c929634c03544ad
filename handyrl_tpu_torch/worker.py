"""Actor-side runtime: workers, gather fan-in and the local cluster.

The counterpart of the local half of ``handyrl_tpu.worker``: CPU
worker processes run self-play or evaluation jobs; Gather processes
fan in ~16 workers each, so the learner serves O(gathers) connections
instead of O(workers).

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

Left for later items: remote workers over sockets (``WorkerServer``,
``RemoteWorkerCluster``), the supervised respawn of crashed gathers,
heartbeats, chaos and surge drills, and telemetry.
"""

import pickle
import queue
import random
import sys
import time
from collections import OrderedDict, deque

from .connection import (
    QueueCommunicator,
    _mp,
    open_multiprocessing_connections,
    send_recv,
)

_PEER_GONE = (ConnectionResetError, BrokenPipeError, EOFError, OSError)


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

    def _ship(self, verb, payload):
        """Episodes ride the shm trajectory ring when the pipeline is
        attached; results, and episodes the ring refuses, take the
        control plane."""
        if (verb == "episode" and payload is not None
                and self.pipeline is not None):
            if self.pipeline.push_episode(payload):
                return
            payload["shm_spilled"] = True
        send_recv(self.conn, (verb, payload))

    def _run_job(self, job):
        runner, reply_verb = self.roles[job["role"]]
        payload = runner(self._resolve(job), job)
        if isinstance(payload, dict):
            labels = [job["model_id"][p] for p in job["player"]]
            gen = max([label for label in labels if label >= 0],
                      default=-1)
            if gen >= 0:
                payload.setdefault("gen_model_epoch", gen)
        self._ship(reply_verb, payload)

    def _run_lockstep(self):
        pool = self.pool
        while True:
            while pool.has_free_slot():
                job = send_recv(self.conn, ("args", None))
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
                job = send_recv(self.conn, ("args", None))
                if job is None:
                    return
                self._run_job(job)
        except _PEER_GONE:
            pass  # learner/gather went away: exit quietly
        finally:
            self._report()
            if self.pipeline is not None:
                self.pipeline.close()  # unmap; the learner owns unlink

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
                     f"{client.episodes_spilled}")
        # one write per report: workers share the parent's stdout
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def _spawn_worker(conn, args, wid):
    Worker(args, conn, wid).run()


class Gather(QueueCommunicator):
    """Fan-in proxy between ~16 workers and the learner.

    Job requests are served from a prefetched block, model requests
    from an id-keyed cache, the shm handshake is forwarded as is, and
    episode/result uploads are acked at once and shipped upstream in
    batches (by count, or by age at low rates)."""

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

    def _ask_learner(self, request):
        return send_recv(self.learner_conn, request)

    def _serve_job(self, conn):
        if not self.job_queue:
            self.job_queue.extend(
                self._ask_learner(("args", [None] * self.block_size)))
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
        if self.pending_count >= self.block_size:
            self.flush_uploads()

    def flush_uploads(self):
        for verb, payloads in self.pending_uploads.items():
            self._ask_learner((verb, payloads))
        self.pending_uploads = {}
        self.pending_count = 0

    def _flush_if_stale(self):
        if (self.pending_count and time.monotonic() - self.first_pending_t
                >= self.FLUSH_AGE):
            self.flush_uploads()

    def run(self):
        while self.connection_count() > 0:
            try:
                conn, (verb, payload) = self.recv(timeout=0.3)
            except queue.Empty:
                self._flush_if_stale()
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
            self.flush_uploads()  # never drop episodes at exit


def gather_loop(args, conn, gather_id):
    gather = Gather(args, conn, gather_id)
    try:
        gather.run()
    except _PEER_GONE:
        raise SystemExit(1)  # the learner went away mid-session
    finally:
        gather.shutdown()


class WorkerCluster(QueueCommunicator):
    """Local actor pool: gather processes on pipes, each spawning its
    share of ``worker.num_parallel`` worker processes.  Gathers exit on
    their own once their workers have drained."""

    def __init__(self, args):
        super().__init__()
        self.args = args
        self.procs = []

    def run(self):
        wcfg = self.args["worker"]
        wcfg.setdefault("num_gathers",
                        1 + max(0, wcfg["num_parallel"] - 1) // 16)
        for slot in range(wcfg["num_gathers"]):
            ours, theirs = _mp.Pipe(duplex=True)
            # gathers spawn worker children, so they cannot be daemonic
            proc = _mp.Process(target=gather_loop,
                               args=(self.args, theirs, slot))
            proc.start()
            theirs.close()
            self.add_connection(ours)
            self.procs.append(proc)

    def shutdown(self):
        super().shutdown()
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
