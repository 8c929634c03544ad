"""Multi-process learner support over ``torch.distributed``.

The counterpart of ``handyrl_tpu.parallel.multihost``.  The JAX package
runs one controller process per HOST, each driving every local device
through one global mesh.  PyTorch's idiom is one process per CARD, so
here every rank is a full learner on one device (its own workers, its
own replay ring, its own rows of every global batch), the ranks meet in
collectives, and rank 0 owns the checkpoints, the metrics and the epoch
decisions:

  * :func:`init_distributed` — the ``distributed:`` config section as a
    process group, before any device use: ``coordinator_address``
    ("host:port") becomes a ``tcp://`` init method, ``num_processes``
    the world size, ``process_id`` the rank, ``local_device_ids`` the
    rank's card, and ``auto: true`` reads a launcher's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``
    (torchrun's).  The backend is NCCL for a card and gloo for the
    CPU; the Python API's ``backend=`` overrides it (two ranks sharing
    one card can only meet over gloo).
  * :func:`sync_epoch_code` — the one-word control collective that
    keeps epoch boundaries aligned: rank 0 decides, everyone obeys.  It
    runs on a CPU gloo group of its own, so it never touches a device
    stream and costs no device synchronisation.
  * :func:`broadcast_train_state` — rank 0's train state on every rank
    at start-up; the step count crosses as an int64.
  * :func:`one_host` — whether every rank of the group runs on this
    host, decided once at start-up from each rank's host name (the
    counterpart of JAX's single-process mesh over local devices: the
    paths JAX runs only there, Anakin's sharded env axis and
    ``--train-server``'s one endpoint with its episode deal, run only
    then); :func:`hosts` is every rank's host name;
  * :func:`broadcast_int` and :func:`sum_over_ranks` — one-time
    start-up agreements on host integers (the episode channel's port,
    the fleet's episode counts), on the control group.

The sharded update step reduces gradients explicitly
(:mod:`.update`), so each rank feeds it its OWN rows, as plain local
tensors: JAX's ``global_batch_from_local`` and
``global_from_local_shards`` have no counterpart here, because a
rank's local rows are already its shard of the global batch.

Operational requirements (as for the JAX package): every rank runs the
same config (global ``batch_size`` divisible by the process count; the
same mesh, the same seed); a ``restart_epoch`` resume reads the
checkpoint directory on every rank (a shared filesystem), and the
restored state is broadcast from rank 0 anyway; a rank that dies makes
its peers' next collective fail, and every rank then exits.
"""

import datetime
import os
import socket
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..utils.tree import tree_map_leaves

# epoch-control words for sync_epoch_code
STEP = 0        # keep training: every process must run one more step
EPOCH_END = 1   # finish the epoch: snapshot + report, then loop
STOP = 2        # end training entirely

ALLOWED_KEYS = {"coordinator_address", "num_processes", "process_id",
                "local_device_ids", "auto"}
# the control group waits on rank 0 across a whole epoch boundary (rank
# 0 may idle at its step budget until the epoch's episodes arrive), so
# it outlives gloo's 30-minute default; a dead peer still fails it at
# once (its sockets close)
CONTROL_TIMEOUT = datetime.timedelta(hours=24)

_control = None   # the CPU gloo group of the control word
_hosts = ()       # every rank's host name, in rank order


def check_config(cfg: Optional[Dict[str, Any]]) -> None:
    """The JAX package's key check of the ``distributed:`` section."""
    unknown = set(cfg or {}) - ALLOWED_KEYS
    if unknown:
        raise ValueError(f"unknown distributed config keys: "
                         f"{sorted(unknown)}")


def _set(value):
    return value is not None and value != ""


def _rank_of(cfg):
    if cfg.get("auto"):
        return int(os.environ.get("RANK", 0))
    return int(cfg.get("process_id") or 0)


def rank_device(cfg: Optional[Dict[str, Any]], device="cuda"):
    """The device this rank trains on: ``device`` as given when it
    names an index or the CPU, else the rank's card —
    ``local_device_ids[0]``, the launcher's ``LOCAL_RANK`` under
    ``auto``, or the rank modulo the visible cards."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not cfg:
        return device
    ids = cfg.get("local_device_ids")
    if _set(ids):
        index = int(ids[0] if isinstance(ids, (list, tuple)) else ids)
    elif cfg.get("auto") and "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        index = _rank_of(cfg) % max(1, torch.cuda.device_count())
    return torch.device("cuda", index)


def init_distributed(cfg: Optional[Dict[str, Any]], device="cuda",
                     backend: Optional[str] = None) -> bool:
    """Bring up the process group from the ``distributed:`` section.
    Empty/None = single process (no-op, returns False).  Must run
    before the first use of the rank's device."""
    global _control
    if not cfg:
        return False
    check_config(cfg)
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if cfg.get("auto"):
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        missing = [k for k in ("coordinator_address", "num_processes",
                               "process_id") if not _set(cfg.get(k))]
        if missing:
            raise ValueError(
                f"distributed: {missing} must be set (or auto: true "
                f"under a launcher that exports RANK/WORLD_SIZE)")
        init_method = "tcp://" + str(cfg["coordinator_address"])
        world, rank = int(cfg["num_processes"]), int(cfg["process_id"])
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        dev = rank_device(cfg, dev)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kwargs)
    _control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    _gather_hosts()
    return True


def _gather_hosts():
    global _hosts
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname(), group=_control)
    _hosts = tuple(names)


def one_host() -> bool:
    """True when every rank runs on this host (or there is one rank)."""
    return len(set(_hosts)) <= 1


def hosts():
    """Every rank's host name, in rank order (empty with no group)."""
    return _hosts


def broadcast_int(value: int) -> int:
    """Rank 0's integer on every rank, through the CPU control group."""
    word = torch.tensor([int(value)], dtype=torch.int64)
    dist.broadcast(word, src=0, group=_control)
    return int(word[0])


def sum_over_ranks(values):
    """Host integers summed over every rank, through the CPU control
    group."""
    total = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(total, group=_control)
    return total.tolist()


def shutdown() -> None:
    """Tear the process group down (every exit path of an entry point
    that initialized it): no rank is left holding sockets or NCCL
    communicators."""
    global _control, _hosts
    if dist.is_initialized():
        dist.destroy_process_group()
    _control, _hosts = None, ()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 owns checkpoints, metrics, and epoch decisions."""
    return process_index() == 0


def local_batch_size(global_batch_size: int) -> int:
    """Rows THIS process's feed must produce per step."""
    n = process_count()
    if global_batch_size % n != 0:
        raise ValueError(
            f"batch_size {global_batch_size} must be divisible by the "
            f"process count {n} (every process feeds an equal shard)")
    return global_batch_size // n


def sync_epoch_code(code: int) -> int:
    """All-process agreement on the epoch-control word.

    Every process calls this once per training-loop iteration; the
    value from rank 0 wins (STEP / EPOCH_END / STOP).  Doubles as the
    step barrier that keeps every rank's update-step count identical —
    which keeps the host-side lr anneal identical, since it is driven
    by the (all-reduced) metrics and the shared step count.  A CPU
    tensor over the gloo control group: no device sync."""
    word = torch.tensor([int(code)], dtype=torch.int32)
    dist.broadcast(word, src=0, group=_control)
    return int(word[0])


def sum_over_dp(values, mesh):
    """Host numbers summed over the ``dp`` axis of ``mesh`` on every
    rank, through the CPU control group (no device sync): the group
    sums every rank's values, and each dp coordinate's ``sp*tp`` ranks
    hold the same ones."""
    total = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(total, group=_control)
    return (total / replay_group_size(mesh)).tolist()


def _broadcast_tensor(tensor, group):
    """Rank 0's values into ``tensor`` in place, through a host copy:
    the control group is gloo on the CPU, whatever the device."""
    host = tensor.detach().to("cpu", copy=True).contiguous()
    dist.broadcast(host, src=0, group=group)
    with torch.no_grad():
        tensor.copy_(host)


def broadcast_train_state(params, opt_state, steps, data_cnt_ema,
                          group=None):
    """One-time broadcast of rank 0's train state at start-up.

    ``params`` is a ``{name: tensor}`` mapping (a ``state_dict``),
    overwritten in place with rank 0's values; ``opt_state`` any
    picklable tree or None (rank 0's is returned on every rank: the
    others may not have read one).  ``steps`` crosses as an int64, so
    it stays exact past 2^24 (JAX's float32 trip needs two 24-bit
    words); ``data_cnt_ema`` as a float64.  Returns ``(params,
    opt_state, steps, data_cnt_ema)``."""
    group = group if group is not None else _control
    for name in sorted(params):
        _broadcast_tensor(params[name], group)
    box = [opt_state]
    dist.broadcast_object_list(box, src=0, group=group)
    count = torch.tensor([int(steps)], dtype=torch.int64)
    dist.broadcast(count, src=0, group=group)
    ema = torch.tensor([float(data_cnt_ema)], dtype=torch.float64)
    dist.broadcast(ema, src=0, group=group)
    return params, box[0], int(count[0]), float(ema[0])


def replay_group_size(mesh) -> int:
    """Ranks per batch-replication group: batch rows shard over ``dp``
    and replicate across ``sp``/``tp``, so each dp coordinate owns
    ``sp*tp`` ranks."""
    from .mesh import axis_size

    return axis_size(mesh, "sp") * axis_size(mesh, "tp")


def local_replay_mesh(mesh):
    """The ranks that must draw the SAME rows as this one: its
    ``(sp, tp)`` sub-mesh, or None when that is this rank alone.  One
    process drives one card here, so a dp group spans ranks whenever
    ``sp*tp > 1``; the trainer then takes the group's first rank's rows
    (:func:`share_rows`) instead of JAX's process-local replication."""
    if replay_group_size(mesh) <= 1:
        return None
    return mesh["sp", "tp"]._flatten()


def share_rows(batch, rows_mesh):
    """The first rank of ``rows_mesh``'s rows on every rank of it, in
    place (a broadcast per batch leaf over that group)."""
    if rows_mesh is None:
        return batch
    group = rows_mesh.get_group()
    src = dist.get_global_rank(group, 0)

    def leaf(t):
        dist.broadcast(t, src=src, group=group)
        return t

    return tree_map_leaves(leaf, batch)
