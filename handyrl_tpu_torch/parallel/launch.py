"""One rank per local card: the counterpart of JAX's auto-dp.

The JAX learner is one process whose mesh defaults to ``dp`` over every
device of its host (``_default_mesh_cfg``), in ``--train`` and
``--train-server`` alike.  PyTorch drives one card per process, so
either mode with no ``distributed:`` section on a host with ``n > 1``
visible cards spawns the ranks itself:

  * with the ``mesh:`` axes (dp/sp/tp) unset, ``d`` ranks, ``d`` the
    largest divisor of ``batch_size`` that is at most ``n`` (JAX's rule
    and its messages), each with ``mesh: {dp: d}`` (``fsdp`` kept);
    ``d = 1`` is today's single process, with no spawn, and says so;
  * with the axes set, the user's mesh as it stands: one rank per
    device of it (JAX's size contract: larger than the host is an
    error), and an all-ones mesh such as ``{dp: 1}`` runs the
    unsharded step in one process, as JAX's explicit all-ones mesh does;
  * each rank gets ``distributed: {auto: true}`` through the torchrun
    variables :func:`.multihost.init_distributed` reads (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``)
    and its card from ``LOCAL_RANK``;
  * the ranks act as JAX's one process: rank 0 alone runs
    ``--train``'s local fleet (the whole ``train_args.worker``; the
    followers get none) or owns ``--train-server``'s entry and worker
    ports (``worker_args`` is what remote machines receive), and deals
    every admitted episode to one dp coordinate's rings (:mod:`.deal`;
    the ``sp``/``tp`` ranks of a coordinate hold copies, as its rows
    replicate over them); so ``minimum_episodes`` and
    ``maximum_episodes`` split in equal shares over the dp coordinates
    (each rank warms and trims its ring on what its coordinate is
    dealt, as each coordinate draws ``batch_size / dp`` rows) and
    ``update_episodes`` stays whole: rank 0 counts every episode, and
    the fleet's epochs fall at JAX's ``minimum_episodes + k *
    update_episodes``.  Under ``--train`` rank 0's inference service
    is the one batching window of every local worker and, with
    ``pipeline.infer_mesh: auto``, dispatches on the training mesh's
    layout with every follower joining each forward
    (:class:`..pipeline.service.ServiceFollower`);
  * ``batch_size`` is global (each dp rank draws ``batch_size / dp``
    rows);
  * a rank that dies brings the others down, and the launch returns its
    exit code; every rank exits 0 or the launch does not.

``supervise_learner`` guards the launch, not the ranks
(:func:`run_group` is the guard's target): a rank that dies ends the
group, and the guard relaunches the whole group with ``restart_epoch:
auto``, which :func:`rank_args` hands every rank.

A rank never falls back to the CPU: the device is the caller's, and a
missing card fails the rank as it fails a single process.  The card
count comes from ``torch.cuda.device_count()``, read in the process
that launches (under the guard, its child: the guard never touches the
card); only the ``cards`` argument of :func:`launch` overrides it
(tests run CPU ranks with it, and ranks sharing one card name it as
``cuda:0`` with the count given).
"""

import copy
import multiprocessing as mp
import os
import time

import torch

from .mesh import MeshSpec, check_mesh_size

TERM_GRACE = 10.0     # seconds a surviving rank gets to exit on SIGTERM

# each rank's ring counts split over the dp coordinates, the epoch
# clock (update_episodes) whole
SERVER_SPLIT_COUNTS = ("minimum_episodes", "maximum_episodes")
# the mark rank_args leaves on a rank it makes (a top-level key of the
# rank's args, which the config never reads): the rank is one of a
# launch, not a hand-started replica
LAUNCHED = "_launched_rank"


def default_dp(n, batch_size):
    """The JAX package's auto-dp rule over ``n`` devices, with its
    messages: the largest divisor of ``batch_size`` that is at most
    ``n`` (1 = no data parallelism)."""
    if n <= 1:
        return 1
    dp = max(d for d in range(1, n + 1) if batch_size % d == 0)
    if dp <= 1:
        print(f"1 of {n} devices used: batch_size "
              f"{batch_size} has no divisor <= {n}")
        return 1
    if dp < n:
        print(f"WARNING: dp={dp} leaves {n - dp} of {n} "
              f"devices idle; make batch_size divisible by {n} "
              f"or set an explicit mesh")
    print(f"defaulting to dp={dp} over {n} devices")
    return dp


def _default(key):
    """The train config's default for ``key``."""
    from ..config import TrainConfig

    return getattr(TrainConfig, key)


def share_split(total, parts):
    """``total`` in ``parts`` equal shares, the remainder to the first,
    at least 1 each."""
    share, rest = divmod(total, parts)
    return [max(1, share + rest)] + [max(1, share)] * (parts - 1)


def fleet_size(args):
    """The local fleet of ``--train``: ``train_args.worker.num_parallel``
    (the config's default when unset)."""
    from ..config import WorkerConfig

    worker = (args.get("train_args") or {}).get("worker") or {}
    return int(worker.get("num_parallel", WorkerConfig.num_parallel))


def launched(args):
    """Whether ``args`` are a launch's rank's (:data:`LAUNCHED`)."""
    return bool(args.get(LAUNCHED))


def rank_args(args, rank, mesh, server=False):
    """Rank ``rank``'s copy of the config, marked :data:`LAUNCHED`:
    ``distributed: {auto: true}``, the launch's ``mesh``, no guard of
    its own (the guard wraps the launch), and the ring's counts in
    equal shares over the mesh's dp coordinates (the rank's
    coordinate's share), ``update_episodes`` whole.  ``--train``: the
    whole fleet on rank 0 and none on the others; ``server``: the
    workers untouched (remote machines are the fleet)."""
    args = copy.deepcopy(args)
    args[LAUNCHED] = True
    train = args.setdefault("train_args", {})
    train["distributed"] = {"auto": True}
    train["mesh"] = dict(mesh)
    train.pop("supervise_learner", None)
    spec = MeshSpec.from_config(mesh)
    for key in SERVER_SPLIT_COUNTS:
        total = int(train.get(key, _default(key)))
        train[key] = share_split(total, spec.dp)[rank // (spec.sp * spec.tp)]
    if rank and not server:
        worker = dict(train.get("worker") or {})
        worker["num_parallel"] = 0
        worker.pop("num_gathers", None)
        train["worker"] = worker
    return args


def _rank_main(target, args, rank, world, port):
    """A spawned rank: the torchrun variables, then the learner."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    target(args)


def _planned_mesh(args, device, cards):
    """The launch's mesh config, ``{}`` for no spawn (run in this
    process)."""
    train = args.get("train_args") or {}
    if train.get("distributed"):
        return {}   # the user launches the ranks
    device = torch.device(device)
    if cards is None:
        if device.type != "cuda" or device.index is not None:
            return {}
        cards = torch.cuda.device_count()
    if cards <= 1:
        print(f"launch: {max(cards, 0)} card(s) visible, no spawn: one "
              f"process trains on {device}", flush=True)
        return {}
    mesh = dict(train.get("mesh") or {})
    fsdp = bool(mesh.get("fsdp"))
    if any(k != "fsdp" for k in mesh):
        # the user's axes stand (JAX auto-shards only when they are unset)
        spec = MeshSpec.from_config(mesh)
        check_mesh_size(spec, cards)
        if spec.size <= 1:
            print(f"launch: mesh {spec.shape()} is unsharded, no spawn: "
                  f"one process trains on {device}", flush=True)
            return {}
        return mesh
    dp = default_dp(cards, int(train.get("batch_size",
                                         _default("batch_size"))))
    return {"dp": dp, "fsdp": fsdp} if dp > 1 else {}


def launch(args, target, device="cuda", cards=None, server=False):
    """Run ``target(args)`` (a training mode's entry, picklable) on one
    rank per device of the launch's mesh; ``server`` for
    ``--train-server``'s ranks.  Returns None when no spawn is due (the
    caller runs ``target`` itself), else the launch's exit code."""
    mesh = _planned_mesh(args, device, cards)
    if not mesh:
        return None
    from ..connection import find_free_port

    world = MeshSpec.from_config(mesh).size
    if server:
        print(f"launch: {world} ranks, one per card; rank 0 serves the "
              f"worker machines and deals the episodes", flush=True)
    else:
        print(f"launch: {world} ranks, one per card; rank 0 runs the "
              f"whole fleet of {fleet_size(args)} workers and deals the "
              f"episodes", flush=True)
    port = find_free_port()
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(world):
        proc = ctx.Process(
            target=_rank_main, name=f"rank{rank}",
            args=(target, rank_args(args, rank, mesh, server),
                  rank, world, port))
        proc.start()
        procs.append(proc)
    return _supervise(procs)


def run_group(args, target, device="cuda", cards=None, server=False):
    """A training mode's whole run: ``target`` on the launch's ranks,
    or in this process when no spawn is due.  A launch that fails
    exits with its code (a rank killed by signal ``s``: ``128 + s``, as
    a shell reports it), so a guard around this sees the group die."""
    code = launch(args, target, device=device, cards=cards, server=server)
    if code is None:
        target(args)
    elif code:
        raise SystemExit(code if code > 0 else 128 - code)


def _supervise(procs):
    """Wait for every rank; the first that exits nonzero ends the rest
    (SIGTERM, then SIGKILL after ``TERM_GRACE``).  Returns 0 or that
    rank's exit code."""
    code = 0
    while any(p.is_alive() for p in procs):
        dead = [p for p in procs if not p.is_alive() and p.exitcode]
        if dead:
            code = dead[0].exitcode
            print(f"launch: {dead[0].name} exited {code}; stopping the "
                  f"other ranks", flush=True)
            break
        time.sleep(0.2)
    if code:
        for p in procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + TERM_GRACE
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
    for p in procs:
        p.join()
    if not code:
        code = next((p.exitcode for p in procs if p.exitcode), 0)
    return code
