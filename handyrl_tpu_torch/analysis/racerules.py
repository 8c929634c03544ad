"""racelint's rule registry: six thread-safety rules for the control plane.

Same shape as :mod:`.rules` / :mod:`.shardrules` / :mod:`.commrules` —
each rule is ``(Package, ModuleInfo) -> Iterable[Finding]`` under a
stable kebab-case id (what suppression comments name), registered in
``RACE_RULES`` and consuming the thread-spawn graph and lock
environment of :mod:`.racelint`.  None of them import torch (or spawn a
thread).

The rules, and the interleaving each one prevents:

  ``unguarded-shared-write``    an attribute every other site guards
                                with one lock is written bare on a
                                different thread -> readers under the
                                lock still see the torn/stale value;
                                the lock is a fiction.
  ``non-atomic-rmw``            ``self.x += 1`` (or get-then-set) on
                                cross-thread state outside any lock ->
                                two threads interleave LOAD/STORE and
                                an increment is lost — the
                                inflight-cap bug class.
  ``live-container-iteration``  iterating a dict/list another thread
                                mutates, with no common lock and no
                                snapshot -> ``RuntimeError: dictionary
                                changed size during iteration`` from
                                the status thread — the
                                ``episode_count`` bug class.
  ``lock-order-cycle``          two locks acquired in opposite orders
                                on different interprocedural paths ->
                                a once-a-week ABBA deadlock no test
                                reproduces.
  ``blocking-under-lock``       send/recv/join/sleep/subprocess while
                                holding a lock (directly or via a
                                callee) -> every thread needing that
                                lock stalls behind one slow peer; the
                                static twin of what StallWatchdog only
                                sees at runtime.
  ``leaked-lock``               a bare ``.acquire()`` with no
                                ``finally``-protected ``.release()``
                                -> the first exception leaves the lock
                                held forever and the process wedges.
                                ``with`` statements never trigger this.

A write of a plain constant (``self._stop = True``) is the GIL-atomic
flag idiom and stays quiet; single-writer monotone counters (all the
read-modify-writes happen on one thread) stay quiet too.  Deliberately
lock-free designs suppress per line with
``# torchlint: disable=<rule> -- reason``.
"""

from typing import Dict, FrozenSet, Iterable, Set

from .astutil import ModuleInfo, Package
from .racelint import Access, RaceAnalysis, _in_ctor, analyze_race
from .rules import Finding, Rule

RACE_RULES: Dict[str, Rule] = {}


def race_rule(rule_id: str, summary: str):
    def deco(fn):
        RACE_RULES[rule_id] = Rule(rule_id, summary, fn.__doc__ or "",
                                   fn)
        return fn
    return deco


def _loc(node):
    return node.lineno, getattr(node, "col_offset", 0)


def _ctx(an: RaceAnalysis, acc: Access) -> FrozenSet[str]:
    return an.context_of(acc.fn)


def _ctx_names(ctxs: Iterable[str]) -> str:
    short = sorted(c.rsplit(":", 1)[-1] for c in set(ctxs))
    return "/".join(short)


def _group_sites(an: RaceAnalysis, cls: str, attr: str):
    """Non-constructor accesses of one shared attribute."""
    return [a for a in an.accesses.get((cls, attr), [])
            if not _in_ctor(a.fn)]


@race_rule("unguarded-shared-write",
           "cross-thread attribute written outside the lock every "
           "other access holds")
def check_unguarded_shared_write(package: Package, mod: ModuleInfo):
    """An attribute whose every *other* access (read or write, any
    thread) holds one common lock is written or mutated bare at this
    site, and the bare site runs on a different thread context than
    some guarded site.  The guarded readers still race: holding a lock
    only helps if every writer holds it too.  Plain-constant stores
    (``self._stop = True``) are the GIL-atomic flag idiom and exempt;
    attributes with *no* lock discipline anywhere are a design choice
    this rule does not second-guess (``non-atomic-rmw`` and
    ``live-container-iteration`` still apply to them)."""
    an = analyze_race(package)
    for (cls, attr), _ in an.accesses.items():
        sites = _group_sites(an, cls, attr)
        if len(sites) < 2:
            continue
        group_ctx: Set[str] = set()
        for a in sites:
            group_ctx |= _ctx(an, a)
        if len(group_ctx) < 2:
            continue
        for site in sites:
            if site.fn.module is not mod:
                continue
            if site.kind not in ("write", "mutate") or site.const_value:
                continue
            others = [a for a in sites if a is not site]
            common = None
            for a in others:
                common = set(a.locks) if common is None \
                    else common & set(a.locks)
            if not common or (set(site.locks) & common):
                continue
            sctx = _ctx(an, site)
            other_ctx: Set[str] = set()
            for a in others:
                other_ctx |= _ctx(an, a)
            if len(sctx) < 2 and not (other_ctx - sctx):
                continue
            line, col = _loc(site.node)
            lock = sorted(common)[0]
            yield Finding(
                "unguarded-shared-write", mod.path, line, col,
                f"`self.{attr}` is written here without `{lock}`, but "
                f"every other access of `{cls}.{attr}` holds it; this "
                f"site runs on {_ctx_names(sctx)} while guarded sites "
                f"run on {_ctx_names(other_ctx)} — take the lock or "
                f"explain the tear")


@race_rule("non-atomic-rmw",
           "unlocked read-modify-write of cross-thread state")
def check_non_atomic_rmw(package: Package, mod: ModuleInfo):
    """``self.x += 1`` / ``self.x = self.x + ...`` / subscript
    read-modify-write outside any lock, on an attribute that is
    touched from at least two thread contexts, where either the
    mutating function itself runs on several contexts or the
    read-modify-writes span several contexts.  Two interleaved
    LOAD/ADD/STORE sequences lose one update — the inflight-cap bug
    class.  A counter only ever bumped from one thread (however many
    threads read it) is exempt: single-writer monotone counters are a
    supported idiom."""
    an = analyze_race(package)
    for (cls, attr), _ in an.accesses.items():
        sites = _group_sites(an, cls, attr)
        group_ctx: Set[str] = set()
        for a in sites:
            group_ctx |= _ctx(an, a)
        if len(group_ctx) < 2:
            continue
        rmw_sites = [a for a in sites if a.kind == "rmw"]
        rmw_ctx: Set[str] = set()
        for a in rmw_sites:
            rmw_ctx |= _ctx(an, a)
        for site in rmw_sites:
            if site.fn.module is not mod or site.locks:
                continue
            if len(_ctx(an, site)) < 2 and len(rmw_ctx) < 2:
                continue
            line, col = _loc(site.node)
            yield Finding(
                "non-atomic-rmw", mod.path, line, col,
                f"read-modify-write of `{cls}.{attr}` outside any "
                f"lock; the attribute is live on "
                f"{_ctx_names(group_ctx)} and concurrent updates can "
                f"interleave and lose one — guard it or make it "
                f"single-writer")


@race_rule("live-container-iteration",
           "iterating a container another thread mutates, without a "
           "snapshot")
def check_live_container_iteration(package: Package, mod: ModuleInfo):
    """A ``for``/comprehension/``sum(...)``-style iteration over
    ``self.X`` (or its ``.values()``/``.items()``/``.keys()`` view)
    while some other thread context mutates it in place, and no lock
    is common to both sites.  CPython raises ``RuntimeError:
    dictionary changed size during iteration`` — from the status HTTP
    thread this kills live metrics.  Iterate a snapshot
    (``list(...)`` under the lock) instead."""
    an = analyze_race(package)
    for (cls, attr), _ in an.accesses.items():
        sites = _group_sites(an, cls, attr)
        iter_sites = [a for a in sites if a.kind == "iterate"]
        mut_sites = [a for a in sites if a.kind in ("mutate", "rmw")]
        if not iter_sites or not mut_sites:
            continue
        for site in iter_sites:
            if site.fn.module is not mod:
                continue
            for m in mut_sites:
                if len(_ctx(an, site) | _ctx(an, m)) < 2:
                    continue
                if set(site.locks) & set(m.locks):
                    continue
                line, col = _loc(site.node)
                mline = m.node.lineno
                yield Finding(
                    "live-container-iteration", mod.path, line, col,
                    f"iterates `{cls}.{attr}` live while "
                    f"{m.fn.qname} (line {mline}, on "
                    f"{_ctx_names(_ctx(an, m))}) mutates it with no "
                    f"common lock — iterate a snapshot taken under "
                    f"the lock")
                break


@race_rule("lock-order-cycle",
           "two locks acquired in opposite orders on different paths")
def check_lock_order_cycle(package: Package, mod: ModuleInfo):
    """The lock-acquisition-order graph (nested ``with`` blocks plus
    calls made under a lock into functions that may acquire another)
    contains a cycle: some path takes A then B while another takes B
    then A.  Run long enough, two threads meet in the middle and
    deadlock.  A non-reentrant lock re-acquired while already held is
    the one-lock version of the same bug and is reported here too;
    RLocks are reentrant by design and self-edges on them stay
    quiet."""
    an = analyze_race(package)
    adj: Dict[str, Set[str]] = {}
    for e in an.order_edges:
        adj.setdefault(e.src, set()).add(e.dst)
    reach: Dict[str, Set[str]] = {}

    def reachable(src: str) -> Set[str]:
        if src in reach:
            return reach[src]
        seen: Set[str] = set()
        stack = [src]
        while stack:
            node = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        reach[src] = seen
        return seen

    reported: Set[tuple] = set()
    for e in an.order_edges:
        if e.fn.module is not mod:
            continue
        line, col = _loc(e.node)
        if e.src == e.dst:
            key = (e.src, e.dst, line)
            if key in reported:
                continue
            reported.add(key)
            yield Finding(
                "lock-order-cycle", mod.path, line, col,
                f"`{e.dst}` is acquired while already held and is not "
                f"reentrant — this thread deadlocks on itself"
                + (f" (via {e.via})" if e.via else ""))
            continue
        if e.src not in reachable(e.dst):
            continue
        key = (e.src, e.dst)
        if key in reported:
            continue
        reported.add(key)
        via = f" (via {e.via})" if e.via else ""
        yield Finding(
            "lock-order-cycle", mod.path, line, col,
            f"acquires `{e.dst}` while holding `{e.src}`{via}, but "
            f"another path acquires them in the opposite order — "
            f"ABBA deadlock; pick one global order")


@race_rule("blocking-under-lock",
           "blocking call while holding a lock")
def check_blocking_under_lock(package: Package, mod: ModuleInfo):
    """A call that can park the thread — ``time.sleep``, socket
    ``recv``/``accept``/``connect``/``send``, ``join``, ``wait``,
    ``select``, ``subprocess`` — executes while a lock is held, either
    directly or through a callee whose summary says it blocks.  Every
    other thread needing that lock now stalls behind one slow peer:
    the static form of the stall classes StallWatchdog only observes
    at runtime.  Move the slow call outside the critical section and
    keep the lock for the state update alone."""
    an = analyze_race(package)
    for bs in an.block_sites:
        if bs.fn.module is not mod or not bs.locks:
            continue
        line, col = _loc(bs.node)
        lock = sorted(bs.locks)[0]
        yield Finding(
            "blocking-under-lock", mod.path, line, col,
            f"blocking call `{bs.desc}` while holding `{lock}` — "
            f"every thread contending on the lock stalls with it")
    for cs in an.call_sites:
        if cs.caller.module is not mod or not cs.locks:
            continue
        sm = an.summaries.get(cs.callee)
        if sm is None or sm.blocking is None:
            continue
        line, col = _loc(cs.node)
        lock = sorted(cs.locks)[0]
        yield Finding(
            "blocking-under-lock", mod.path, line, col,
            f"calls `{cs.callee.qname}` while holding `{lock}`, and "
            f"it can block on `{sm.blocking[0]}` (line "
            f"{sm.blocking[1]}) — hoist the slow call out of the "
            f"critical section")


@race_rule("leaked-lock",
           "acquire() without a finally-protected release()")
def check_leaked_lock(package: Package, mod: ModuleInfo):
    """A bare ``.acquire()`` on a known lock whose function has no
    matching ``.release()`` inside a ``finally`` block.  The first
    exception between acquire and release leaves the lock held
    forever; every later acquirer wedges silently.  ``with lock:``
    (which this rule never flags) or try/finally is the idiom."""
    an = analyze_race(package)
    released_safely: Set[tuple] = set()
    for op in an.lock_ops:
        if op.op == "release" and op.in_finally:
            released_safely.add((op.fn, op.key))
    for op in an.lock_ops:
        if op.op != "acquire" or op.fn.module is not mod:
            continue
        if (op.fn, op.key) in released_safely:
            continue
        line, col = _loc(op.node)
        yield Finding(
            "leaked-lock", mod.path, line, col,
            f"`{op.key}.acquire()` with no `.release()` in a "
            f"`finally` block of this function — an exception here "
            f"leaks the lock; use `with` or try/finally")
