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
  * ``--train``: together the ranks run the JAX single-host learner's
    fleet and counts: the local fleet (``train_args.worker.num_parallel``;
    ``worker_args`` sizes a remote ``--worker`` machine) is split over
    the ranks, the remainder to rank 0, each rank's workers numbered on
    from the previous rank's (so no two draw alike);
    ``update_episodes``, ``minimum_episodes`` and ``maximum_episodes``
    are split in the same shares, so each rank counts, warms and trims
    its own ring on its own workers' episodes and the fleet's epoch is
    JAX's ``update_episodes``; rank 0 decides the epoch's end;
  * ``--train-server`` (``server=True``): there is no local fleet to
    split, and ``worker_args`` is what remote machines receive, so
    both stay as they are; rank 0 alone owns the entry and worker
    ports and deals every admitted episode to one dp coordinate's
    rings (:mod:`.deal`; the ``sp``/``tp`` ranks of a coordinate hold
    copies, as its rows replicate over them), so ``minimum_episodes``
    and ``maximum_episodes`` split in equal shares over the dp
    coordinates (each rank warms and trims its ring on what its
    coordinate is dealt, as each coordinate draws ``batch_size / dp``
    rows) and ``update_episodes`` stays whole: rank 0 counts every
    episode its endpoint receives, and the fleet's epochs fall at JAX's
    ``minimum_episodes + k * update_episodes``;
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

# the episode counts split over the ranks in the fleet's shares
SPLIT_COUNTS = ("update_episodes", "minimum_episodes", "maximum_episodes")
# --train-server: each rank's ring counts split, the epoch clock whole
SERVER_SPLIT_COUNTS = ("minimum_episodes", "maximum_episodes")


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


def fleet_split(total, world):
    """Workers per rank: ``total`` split evenly, the remainder to rank
    0; every rank needs one worker to fill its ring, so a fleet smaller
    than the ranks grows to one each, loudly."""
    if total < world:
        print(f"WARNING: train_args.worker.num_parallel {total} < {world} "
              f"ranks: one worker per rank", flush=True)
        return [1] * world
    share, rest = divmod(total, world)
    return [share + rest] + [share] * (world - 1)


def _default(key):
    """The train config's default for ``key``."""
    from ..config import TrainConfig

    return getattr(TrainConfig, key)


def share_split(total, fleet):
    """``total`` split in the shares of ``fleet``, the remainder to
    rank 0, at least 1 each."""
    whole = sum(fleet)
    shares = [total * n // whole for n in fleet]
    shares[0] += total - sum(shares)
    return [max(1, n) for n in shares]


def fleet_size(args):
    """The local fleet of ``--train``: ``train_args.worker.num_parallel``
    (the config's default when unset)."""
    from ..config import WorkerConfig

    worker = (args.get("train_args") or {}).get("worker") or {}
    return int(worker.get("num_parallel", WorkerConfig.num_parallel))


def rank_args(args, rank, mesh, fleet, server=False):
    """Rank ``rank``'s copy of the config: ``distributed: {auto:
    true}``, the launch's ``mesh``, and no guard of its own (the guard
    wraps the launch).  ``--train``: its share ``fleet[rank]`` of the
    workers, numbered after the lower ranks', and the same share of the
    episode counts.  ``server``: the ring's counts in equal shares over
    the mesh's dp coordinates, the rank's coordinate's share (``fleet``
    unused), the workers and ``update_episodes`` untouched."""
    args = copy.deepcopy(args)
    train = args.setdefault("train_args", {})
    train["distributed"] = {"auto": True}
    train["mesh"] = dict(mesh)
    train.pop("supervise_learner", None)
    if server:
        spec = MeshSpec.from_config(mesh)
        for key in SERVER_SPLIT_COUNTS:
            total = int(train.get(key, _default(key)))
            train[key] = share_split(total, [1] * spec.dp)[
                rank // (spec.sp * spec.tp)]
        return args
    for key in SPLIT_COUNTS:
        total = int(train.get(key, _default(key)))
        train[key] = share_split(total, fleet)[rank]
    worker = dict(train.get("worker") or {})
    worker["base_worker_id"] = (int(worker.get("base_worker_id", 0))
                                + sum(fleet[:rank]))
    worker["num_parallel"] = fleet[rank]
    worker.pop("num_gathers", None)   # derived from the rank's share
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
        fleet = None
        print(f"launch: {world} ranks, one per card; rank 0 serves the "
              f"worker machines and deals the episodes", flush=True)
    else:
        fleet = fleet_split(fleet_size(args), world)
        print(f"launch: {world} ranks, one per card; workers per rank "
              f"{fleet}", flush=True)
    port = find_free_port()
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(world):
        proc = ctx.Process(
            target=_rank_main, name=f"rank{rank}",
            args=(target, rank_args(args, rank, mesh, fleet, server),
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
