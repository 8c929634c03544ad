"""Static analysis + runtime guards of the port, for PyTorch/CUDA.

Two halves, one goal — keep the learner's hot path on the card and its
captured regions stable as the codebase grows:

  * :mod:`.torchlint` — an AST-based analyzer (stdlib ``ast`` only, no
    torch import) with six rule families.  The base rules
    (:mod:`.rules` over :mod:`.astutil`'s package model) flag host
    syncs in loops, Python branches on tensors in compiled or captured
    code, compiles and captures rebuilt per call, debugging leftovers,
    reseeded or global random streams, and weight aliases read after
    an in-place update.  ``--shard`` (:mod:`.shardlint` +
    ``shardrules``) checks the ``DeviceMesh`` axes, placement tuples,
    collective groups, layout contracts, rank-divergent collectives
    and divisibility; ``--comm`` (:mod:`.commlint` + ``commrules``)
    the ``(verb, payload)`` control plane; ``--race``
    (:mod:`.racelint` + ``racerules``) thread safety; ``--num``
    (:mod:`.numlint` + ``numrules``) the dtype lattice under torch's
    promotion rules; ``--leak`` (:mod:`.leaklint` + ``leakrules``)
    resource lifecycles.  CLI: ``python -m
    handyrl_tpu_torch.analysis.torchlint``; the port itself lints
    clean with all six families.
  * :mod:`.guards` — the runtime guards: ``RetraceGuard``,
    ``NumericsGuard``, ``HostTransferGuard``, ``StallWatchdog``,
    ``LockOrderGuard``, ``ResourceLedger`` and
    ``ShardingContractGuard``; the learner arms them by default and
    writes their per-epoch counters into ``metrics.jsonl``.

Guard classes are re-exported lazily (PEP 562), so importing the
analysis package — e.g. from the torchlint CLI — never pulls in torch.
"""

_GUARD_EXPORTS = (
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
)

__all__ = list(_GUARD_EXPORTS)


def __getattr__(name):
    if name in _GUARD_EXPORTS:
        from . import guards

        return getattr(guards, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
