"""Runtime guards of the port (``handyrl_tpu.analysis``'s runtime half).

:mod:`.guards` holds ``RetraceGuard``, ``NumericsGuard``,
``HostTransferGuard``, ``StallWatchdog``, ``LockOrderGuard``,
``ResourceLedger`` and ``ShardingContractGuard``; the learner arms
them by default and writes their per-epoch counters into
``metrics.jsonl``.  The JAX package's static
linters (commlint, racelint, leaklint and the rest) are not copied
here.
"""

from .guards import (
    HostTransferError,
    HostTransferGuard,
    LockOrderGuard,
    NumericsError,
    NumericsGuard,
    ResourceError,
    ResourceLedger,
    RetraceError,
    RetraceGuard,
    ShardingContractError,
    ShardingContractGuard,
    StallWatchdog,
)

__all__ = [
    "HostTransferError",
    "HostTransferGuard",
    "LockOrderGuard",
    "NumericsError",
    "NumericsGuard",
    "ResourceError",
    "ResourceLedger",
    "RetraceError",
    "RetraceGuard",
    "ShardingContractError",
    "ShardingContractGuard",
    "StallWatchdog",
]
