"""leaklint's rule registry: six resource-lifecycle rules.

Same shape as :mod:`.rules` / :mod:`.shardrules` / :mod:`.commrules` /
:mod:`.racerules` / :mod:`.numrules` — each rule is ``(Package,
ModuleInfo) -> Iterable[Finding]`` under a stable kebab-case id (what
suppression comments name), registered in ``LEAK_RULES`` and consuming
the acquisition facts, ownership lattice, and attribute-lifecycle
tables of :mod:`.leaklint`.  None of them import torch (or open a file).

The rules, and the slow death each one prevents:

  ``unreleased-resource``  a function-local socket/file/shm/process
                           reaches some exit (a return, or the end of
                           the function) still live -> one fd or shm
                           segment per call, forever; the accept-loop
                           server socket nobody closes.
  ``leak-on-error``        a release exists on the happy path, but a
                           risky call between acquire and release can
                           raise and skip it (no ``finally``, no
                           ``with``) -> the leak only fires under
                           error load, exactly when you can least
                           afford it.
  ``respawn-overwrite``    ``self.X = <fresh resource>`` while the
                           previous incarnation may still be live —
                           no ``is None`` guard, no prior release or
                           ``= None``, and no caller-side entry guard
                           -> the old socket/ring lives unreferenced
                           until process exit; the
                           ``frontend.respawn()`` bug class.
  ``unjoined-thread``      a non-daemon thread is spawned and no
                           shutdown path ever joins it -> interpreter
                           exit blocks forever on a worker the owner
                           forgot about.
  ``unlinked-shm``         a shared-memory CREATOR closes its mapping
                           but never unlinks the segment -> the ~66 MB
                           /dev/shm file outlives the process; the PR
                           9 dead-worker bug class.
  ``double-release``       two unconditional releases of one
                           obligation -> the second ``close()``
                           hits a recycled fd or raises mid-teardown
                           and masks the real shutdown error.

Ownership transfer keeps the rules quiet where the fleet is correct:
a resource that is returned, yielded, stored on ``self`` or in a
container, or passed to another call has a NEW owner who inherits the
close obligation — ``ShmRing.create()`` handing its raw segment to the
ring, ``_spawn_gather()`` returning the child process into a
Supervisor slot.  ``daemon=True`` threads/processes carry no join
obligation (the ``_stop``-flag shutdown idiom racelint audits), and
``with``/``contextlib.closing`` discharge everything in scope.
Intentional process-lifetime resources suppress per line with
``# torchlint: disable=<rule> -- reason``.
"""

from typing import Dict

from .astutil import ModuleInfo, Package
from .leaklint import (
    LeakAnalysis,
    _human_kind,
    _in_ctor,
    analyze_leaks,
)
from .rules import Finding, Rule

LEAK_RULES: Dict[str, Rule] = {}


def leak_rule(rule_id: str, summary: str):
    def deco(fn):
        LEAK_RULES[rule_id] = Rule(rule_id, summary, fn.__doc__ or "",
                                   fn)
        return fn
    return deco


def _loc(node):
    return node.lineno, getattr(node, "col_offset", 0)


def _local_obligated(an: LeakAnalysis, mod: ModuleInfo):
    """Named function-local acquisitions in this module that still own
    their close obligation (not escaped, not with-managed, not
    fire-and-forget daemons) — threads excluded, they belong to
    ``unjoined-thread``."""
    for acq in an.acqs:
        if acq.fn.module is not mod:
            continue
        if acq.kind == "thread" or acq.daemon:
            continue
        if acq.name is None or acq.via_with or acq.escaped:
            continue
        yield acq


@leak_rule("unreleased-resource",
           "function-local resource reaches an exit without a release")
def check_unreleased_resource(package: Package, mod: ModuleInfo):
    """A local socket / file / process / shm handle is acquired and
    some path out of the function — a ``return``, or falling off the
    end — leaves it live: either no release call exists at all, or an
    early return sidesteps the one that does.  Whoever calls this
    function cannot close what was never handed to them, so the fd is
    simply gone.  Escapes (returned, stored, passed on) transfer the
    obligation and stay quiet; ``with`` discharges it in-scope."""
    an = analyze_leaks(package)
    for acq in _local_obligated(an, mod):
        if not acq.leak_exits:
            continue
        line, col = _loc(acq.node)
        exits = ", ".join(str(l) for l in sorted(set(acq.leak_exits)))
        what = _human_kind(acq.kind)
        if acq.releases:
            detail = (f"the release at line "
                      f"{min(r.line for r in acq.releases)} is "
                      f"bypassed by the exit at line {exits}")
        else:
            detail = (f"no release call exists on any path "
                      f"(exits at line {exits})")
        yield Finding(
            "unreleased-resource", mod.path, line, col,
            f"local {what} `{acq.name}` is still live when the "
            f"function exits — {detail}; close it on every path "
            f"(`with`/`finally`) or transfer it to an owner")


@leak_rule("leak-on-error",
           "release exists but an exception between acquire and "
           "release skips it")
def check_leak_on_error(package: Package, mod: ModuleInfo):
    """Every normal exit releases the resource, but between the
    acquisition and the first release some other call runs — and if it
    raises, the exception propagates past the release and the handle
    leaks.  ``find_free_port()``-style helpers fail exactly under fd
    pressure, when ``bind()`` starts raising — the moment the leak
    compounds fastest.  A release inside ``finally`` (or an except
    handler), or a ``with`` block, is exception-safe and quiet."""
    an = analyze_leaks(package)
    for acq in _local_obligated(an, mod):
        if not acq.releases or acq.leak_exits:
            continue
        if any(r.in_finally or r.in_handler for r in acq.releases):
            continue
        if not acq.risky:
            continue
        first = min(r.line for r in acq.releases)
        line, col = _loc(acq.node)
        yield Finding(
            "leak-on-error", mod.path, line, col,
            f"local {_human_kind(acq.kind)} `{acq.name}` is released "
            f"at line {first}, but a call before that release can "
            f"raise and skip it — move the release into `finally` or "
            f"use `with`")


@leak_rule("respawn-overwrite",
           "attribute holding a live resource reassigned without "
           "closing the old one")
def check_respawn_overwrite(package: Package, mod: ModuleInfo):
    """``self.X = <fresh resource>`` outside ``__init__`` where the
    previous incarnation may still be live: no ``self.X is None``
    guard, no release / ``= None`` / teardown self-call earlier in the
    function, and no entry-guard discipline (every in-package caller
    checking first — the WAL ``append() -> _open_segment()`` shape).
    The old socket or ring keeps its fd until process exit with no
    reference left to close it — the exact bug the
    ``frontend.respawn()`` fix patched by hand.  Daemon threads are
    exempt (dropping the handle is their shutdown idiom)."""
    an = analyze_leaks(package)
    for (cls, attr), stores in sorted(an.attr_stores.items()):
        for st in stores:
            if st.fn.module is not mod:
                continue
            if st.guarded or st.daemon:
                continue
            line, col = _loc(st.node)
            yield Finding(
                "respawn-overwrite", mod.path, line, col,
                f"`self.{attr}` is reassigned a fresh "
                f"{_human_kind(st.kind)} in `{cls}` while the previous "
                f"incarnation may still be live — release or `None` "
                f"it first, or guard with `if self.{attr} is None`")


@leak_rule("unjoined-thread",
           "non-daemon thread spawned and never joined on any "
           "shutdown path")
def check_unjoined_thread(package: Package, mod: ModuleInfo):
    """A ``threading.Thread`` without ``daemon=True`` is started and
    no path ever joins it: a local handle that is dropped un-joined
    and un-escaped, or a ``self.X`` store whose class has no
    ``self.X.join()`` on any shutdown path.  Interpreter exit then
    blocks in threading's shutdown handler waiting on a worker nobody
    owns.  Either join it on the teardown path or make the
    fire-and-forget choice explicit with ``daemon=True``."""
    an = analyze_leaks(package)
    for acq in an.acqs:
        if acq.fn.module is not mod or acq.kind != "thread":
            continue
        if acq.daemon or acq.name is None or acq.via_with \
                or acq.escaped:
            continue
        if any(r.verb == "join" for r in acq.releases):
            continue
        line, col = _loc(acq.node)
        yield Finding(
            "unjoined-thread", mod.path, line, col,
            f"non-daemon thread `{acq.name}` is never joined — join "
            f"it before dropping the handle, or pass `daemon=True` if "
            f"fire-and-forget is intended")
    for (cls, attr), stores in sorted(an.attr_stores.items()):
        events = an.attr_events.get((cls, attr), ())
        if any(e.verb == "join" for e in events):
            continue
        for st in stores:
            if st.fn.module is not mod or st.kind != "thread" \
                    or st.daemon:
                continue
            line, col = _loc(st.node)
            yield Finding(
                "unjoined-thread", mod.path, line, col,
                f"non-daemon thread stored on `{cls}.{attr}` is never "
                f"joined by any method of the class — add a join to "
                f"the shutdown path or pass `daemon=True`")


@leak_rule("unlinked-shm",
           "shared-memory creator closes its mapping but never "
           "unlinks the segment")
def check_unlinked_shm(package: Package, mod: ModuleInfo):
    """``SharedMemory(create=True, ...)`` makes this code the
    segment's OWNER: ``close()`` only unmaps this process's view, the
    backing /dev/shm file needs ``unlink()`` or it survives every
    process that ever attached — the ~66 MB-per-dead-worker leak PR
    9's review caught by hand.  Fires on creators (local or stored on
    ``self``) that release without ever unlinking; attachers
    (``create=True`` absent) owe only ``close()`` and are exempt."""
    an = analyze_leaks(package)
    for acq in an.acqs:
        if acq.fn.module is not mod or not acq.shm_create:
            continue
        if acq.via_with or acq.escaped or not acq.releases:
            continue
        if any(r.verb == "unlink" for r in acq.releases):
            continue
        line, col = _loc(acq.node)
        yield Finding(
            "unlinked-shm", mod.path, line, col,
            f"shared-memory segment `{acq.name}` is created here and "
            f"closed, but never unlinked — the /dev/shm file outlives "
            f"the process; call `.unlink()` on the owner's teardown "
            f"path")
    for (cls, attr), stores in sorted(an.attr_stores.items()):
        events = an.attr_events.get((cls, attr), ())
        if any(e.verb == "unlink" for e in events):
            continue
        for st in stores:
            if st.fn.module is not mod or not st.shm_create:
                continue
            line, col = _loc(st.node)
            yield Finding(
                "unlinked-shm", mod.path, line, col,
                f"shared-memory segment stored on `{cls}.{attr}` is "
                f"created here but no method of the class ever "
                f"unlinks it — the /dev/shm file outlives the "
                f"process; add `.unlink()` to the teardown path")


@leak_rule("double-release",
           "two unconditional releases of one obligation")
def check_double_release(package: Package, mod: ModuleInfo):
    """The same obligation is discharged twice unconditionally — two
    depth-0 ``close()`` calls on one local, or two same-verb releases
    of one ``self.X`` in a single function with no ``= None`` / guard
    / re-store between them.  The second call hits an fd the OS may
    have recycled, or raises mid-teardown and masks the error that
    actually mattered.  Releases under a conditional, inside
    ``finally``/``except``, or separated by a ``self.X = None`` are
    legitimate idempotent-teardown idioms and stay quiet."""
    an = analyze_leaks(package)
    for acq in an.acqs:
        if acq.fn.module is not mod or acq.name is None:
            continue
        plain = [r for r in acq.releases
                 if r.depth == 0 and not r.in_finally
                 and not r.in_handler]
        seen = {}
        for r in sorted(plain, key=lambda r: r.line):
            if r.verb in seen and seen[r.verb] != r.line:
                yield Finding(
                    "double-release", mod.path, r.line, 0,
                    f"`{acq.name}.{r.verb}()` already ran "
                    f"unconditionally at line {seen[r.verb]} — the "
                    f"second release double-frees the "
                    f"{_human_kind(acq.kind)}")
                break
            seen.setdefault(r.verb, r.line)
    for fn, events in an.fn_attr_events.items():
        if fn.module is not mod:
            continue
        by_attr = {}
        for e in sorted(events, key=lambda e: e.line):
            by_attr.setdefault(e.attr, []).append(e)
        for attr, evs in sorted(by_attr.items()):
            # only attributes known to hold a resource participate
            if not any(key[1] == attr for key in an.attr_stores):
                continue
            seen = {}
            for e in evs:
                if e.verb in ("guard", "clear", "swap"):
                    seen.clear()
                    continue
                if e.depth != 0 or e.in_finally:
                    continue
                if e.verb in seen and seen[e.verb] != e.line:
                    yield Finding(
                        "double-release", mod.path, e.line, 0,
                        f"`self.{attr}.{e.verb}()` already ran "
                        f"unconditionally at line {seen[e.verb]} in "
                        f"this function — the second release "
                        f"double-frees the resource")
                    break
                seen.setdefault(e.verb, e.line)
