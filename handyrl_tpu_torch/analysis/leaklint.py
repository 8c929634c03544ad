"""leaklint — resource-lifecycle & ownership analysis for the fleet.

torchlint's base rules cover the compute layer, shardlint the mesh,
commlint the wire protocol, racelint the interleavings, numlint
the dtype lattice; this module covers the failure class that dominates
*weeks-long* serving runs: resources acquired and never released.  A
review once found exactly this live — three shm rings
leaked per dead worker — and only a human caught it; the router makes
replicas long-lived processes whose slow leaks now outrank crashes as
the unmodeled failure mode.  This module computes the package-level
facts the rules in :mod:`.leakrules` consume:

  * **resource-acquisition facts**: every construction of a socket /
    Thread / Process / SharedMemory / file / ThreadingHTTPServer plus
    the repo-local owners (``ShmRing``/``ShmBoard`` create+attach,
    ``FramedConnection``), grown through a *constructor-wrapper
    fixpoint* the way commlint grows send wrappers — a function that
    returns a fresh resource (``open_socket_connection`` returning a
    ``FramedConnection``) is itself a constructor at its call sites;
  * the **ownership / escape lattice**: a resource that is returned,
    stored on ``self``, yielded, passed to another call, or put in a
    container TRANSFERS its close obligation to the new owner; one
    that stays function-local must be released on every path out;
  * **per-path release coverage**: which exits (returns, fall-off-end)
    a local resource can take while still live, whether its releases
    sit inside ``finally``/``with`` (exception-safe) or on the happy
    path only, and whether two unconditional releases double-fire;
  * per-class **attribute-lifecycle tables**: every ``self.X = <fresh
    resource>`` store with its guard discipline (an ``is None`` check,
    a prior release/``None``-assign/swap in the same function, a call
    to a sibling method whose summary releases the attribute, or the
    *entry-guard* idiom where every in-package caller checks first —
    the WAL ``_open_segment`` shape), plus every ``self.X.close()``/
    ``.join()``/``.unlink()``/``= None`` release event.

Everything is stdlib ``ast`` only — like its five siblings the
analyzer never imports torch (or opens a socket).  The abstraction is
deliberately approximate in the quiet direction: only named locals and
``self.X`` state participate, any escape transfers the obligation, a
release in either branch of a conditional counts, and ``daemon=True``
threads/processes carry no join obligation (dropping their handle is a
supported fire-and-forget idiom — the ``_stop``-flag shutdown
discipline racelint already audits).  The per-line suppression syntax
is the escape hatch for intentional process-lifetime resources.
"""

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .astutil import (
    FunctionInfo,
    ModuleInfo,
    Package,
    _enclosing_class,
    dotted_parts,
)

# -- name tables ------------------------------------------------------

# full dotted constructor names -> resource kind
RESOURCE_CTORS = {
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "socket.create_server": "socket",
    "socket.socketpair": "socket",
    "threading.Thread": "thread",
    "threading.Timer": "thread",
    "multiprocessing.Process": "process",
    "open": "file",
    "io.open": "file",
    "tempfile.NamedTemporaryFile": "file",
    "tempfile.TemporaryFile": "file",
    "http.server.ThreadingHTTPServer": "server",
    "http.server.HTTPServer": "server",
    "socketserver.ThreadingTCPServer": "server",
    "socketserver.TCPServer": "server",
}

# trailing-name fallbacks for constructors reached through handles the
# resolver cannot chase: ``_mp = mp.get_context("spawn")`` then
# ``_mp.Process(...)``, re-exported repo classes (``FramedConnection``
# is a class, so resolve_callee reports it as an external name), and
# the ``ShmRing.create`` classmethod spelling
RESOURCE_CTOR_SUFFIXES = {
    ".Process": "process",
    ".SharedMemory": "shm",
    ".FramedConnection": "conn",
    ".ShmRing.create": "shm_ring",
    ".ShmRing.attach": "shm_ring",
    ".ShmBoard.create": "shm_ring",
    ".ShmBoard.attach": "shm_ring",
    ".ThreadingHTTPServer": "server",
}

# method names that discharge a close obligation on their receiver
RELEASE_VERBS = frozenset({
    "close", "shutdown", "terminate", "kill", "join", "unlink",
    "stop", "disconnect", "server_close", "cancel", "release",
})

# with-statement wrappers that adopt their argument's close obligation
CLOSING_WRAPPERS = frozenset({"contextlib.closing", "closing"})

# kinds whose dropped handle is never a leak when daemon=True was
# passed (fire-and-forget workers shut down by flag/atexit, the idiom
# racelint's shutdown rules already audit)
_DAEMONIZABLE = frozenset({"thread", "process"})


def _human_kind(kind: str) -> str:
    return {
        "socket": "socket", "thread": "thread", "process": "process",
        "shm": "shared-memory segment", "shm_ring": "shm ring",
        "conn": "framed connection", "file": "file handle",
        "server": "server socket",
    }.get(kind, kind)


# -- facts ------------------------------------------------------------

@dataclass
class Release:
    """One release call on a tracked resource."""

    line: int
    verb: str
    depth: int                   # conditional nesting at the call
    in_finally: bool
    in_handler: bool
    finally_of: Optional[int]    # id() of the Try whose finalbody holds it


@dataclass
class Acq:
    """One resource acquisition."""

    fn: FunctionInfo
    node: ast.AST                # the constructor call
    kind: str
    name: Optional[str]          # bound local name, None when unbound
    line: int
    daemon: bool = False
    shm_create: bool = False
    via_with: bool = False       # acquired by a with statement
    escaped: bool = False        # obligation transferred to a new owner
    releases: List[Release] = field(default_factory=list)
    risky: bool = False          # some call ran while live & unreleased
    leak_exits: List[int] = field(default_factory=list)


@dataclass
class AttrStore:
    """``self.X = <fresh resource>`` — ownership transferred to self."""

    cls: str
    attr: str
    fn: FunctionInfo
    node: ast.AST
    kind: str
    daemon: bool
    shm_create: bool
    line: int
    guarded: bool = False        # computed after all functions walk


@dataclass
class AttrEvent:
    """A lifecycle event on ``self.X``: a release verb, ``= None``
    ("clear"), a takeover read into a local ("swap"), or an ``is
    None``-style test ("guard")."""

    cls: str
    attr: str
    fn: FunctionInfo
    verb: str
    line: int
    depth: int
    in_finally: bool


def _fn_body(fn: FunctionInfo) -> List[ast.stmt]:
    if isinstance(fn.node, ast.Lambda):
        return [ast.copy_location(ast.Expr(fn.node.body),
                                  fn.node.body)]
    return fn.node.body


def _in_ctor(fn: FunctionInfo) -> bool:
    """Is this function ``__init__`` (or nested inside it)?  The first
    store of an attribute there has no previous incarnation to leak."""
    probe = fn
    while probe is not None:
        if probe.qname.rsplit(":", 1)[-1].split(".")[-1] == "__init__":
            return True
        probe = probe.parent
    return False


def _method_name(fn: FunctionInfo) -> str:
    return fn.qname.rsplit(":", 1)[-1].split(".")[-1]


def _own_stmts(fn: FunctionInfo):
    """The function's own statements, excluding nested def/class
    bodies (those analyze as their own functions)."""
    stack = list(_fn_body(fn))
    while stack:
        stmt = stack.pop()
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield stmt
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                stack.append(child)


def _self_attr2(expr) -> Optional[str]:
    """``self.X`` (exactly two parts) -> ``X``."""
    parts = dotted_parts(expr)
    if parts is not None and len(parts) == 2 and parts[0] == "self":
        return parts[1]
    return None


def _kw_true(call: ast.Call, name: str) -> bool:
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    return False


class LeakAnalysis:
    """All resource-lifecycle facts of one package, computed once."""

    MAX_PASSES = 4

    def __init__(self, package: Package):
        self.pkg = package
        self.acqs: List[Acq] = []
        self.attr_stores: Dict[Tuple[str, str], List[AttrStore]] = {}
        self.attr_events: Dict[Tuple[str, str], List[AttrEvent]] = {}
        self.fn_attr_events: Dict[FunctionInfo, List[AttrEvent]] = {}
        self.self_calls: Dict[FunctionInfo,
                              List[Tuple[str, int]]] = {}
        # constructor-wrapper summaries (the commlint fixpoint shape)
        self.returns_kind: Dict[FunctionInfo, str] = {}
        self.returns_daemon: Dict[FunctionInfo, bool] = {}
        # per-method released-attribute summaries (self-call closure)
        self.releases_attrs: Dict[FunctionInfo, Set[str]] = {}
        self._by_method: Dict[Tuple[str, str], List[FunctionInfo]] = {}

        for mod in self.pkg.modules.values():
            for fn in mod.functions:
                if fn.cls_name is not None:
                    self._by_method.setdefault(
                        (fn.cls_name, _method_name(fn)), []).append(fn)

        self._compute_wrapper_fixpoint()
        self._walk_functions()
        self._compute_release_summaries()
        self._mark_guarded_stores()

    # -- constructor kinds --------------------------------------------
    def ctor_kind(self, fn: Optional[FunctionInfo], mod: ModuleInfo,
                  call) -> Optional[Tuple[str, bool, bool]]:
        """A call that yields a FRESH resource -> (kind, daemon,
        shm_create), else None.  Wrapper summaries make in-package
        functions returning fresh resources constructors too."""
        if not isinstance(call, ast.Call):
            return None
        name = self.pkg.full_name(mod, fn, call.func)
        kind = None
        if name is not None:
            kind = RESOURCE_CTORS.get(name)
            if kind is None:
                for suffix, k in RESOURCE_CTOR_SUFFIXES.items():
                    if name == suffix[1:] or name.endswith(suffix):
                        kind = k
                        break
        if kind is None:
            res = self.pkg.resolve_callee(mod, fn, call.func)
            if res is not None and res[0] == "fn":
                wrapped = self.returns_kind.get(res[1])
                if wrapped is not None:
                    return (wrapped,
                            self.returns_daemon.get(res[1], False),
                            False)
            return None
        daemon = kind in _DAEMONIZABLE and _kw_true(call, "daemon")
        shm_create = kind == "shm" and _kw_true(call, "create")
        return kind, daemon, shm_create

    def _compute_wrapper_fixpoint(self):
        """Grow ``returns_kind``: a function returning a direct
        constructor result (or a local bound to one, or a call into an
        already-summarized wrapper) is a constructor itself."""
        for _ in range(self.MAX_PASSES):
            changed = False
            for fn in self.pkg.all_functions():
                if fn in self.returns_kind:
                    continue
                summary = self._returns_fresh(fn)
                if summary is not None:
                    self.returns_kind[fn] = summary[0]
                    self.returns_daemon[fn] = summary[1]
                    changed = True
            if not changed:
                break

    def _returns_fresh(self, fn: FunctionInfo):
        fresh: Dict[str, Tuple[str, bool]] = {}
        found = None
        for stmt in sorted(_own_stmts(fn),
                           key=lambda s: (s.lineno,
                                          getattr(s, "col_offset", 0))):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                summary = self.ctor_kind(fn, fn.module, stmt.value)
                if summary is not None:
                    fresh[stmt.targets[0].id] = (summary[0], summary[1])
                else:
                    fresh.pop(stmt.targets[0].id, None)
            elif isinstance(stmt, ast.Return) and stmt.value is not None:
                summary = self.ctor_kind(fn, fn.module, stmt.value)
                if summary is not None:
                    found = (summary[0], summary[1])
                elif isinstance(stmt.value, ast.Name) \
                        and stmt.value.id in fresh:
                    found = fresh[stmt.value.id]
        return found

    # -- per-function walk --------------------------------------------
    def _walk_functions(self):
        for mod in self.pkg.modules.values():
            for fn in mod.functions:
                _FnWalker(self, fn).run()

    def record_attr_event(self, fn, attr, verb, line, depth,
                          in_finally):
        cls = _enclosing_class(fn)
        if cls is None:
            return
        ev = AttrEvent(cls, attr, fn, verb, line, depth, in_finally)
        self.attr_events.setdefault((cls, attr), []).append(ev)
        self.fn_attr_events.setdefault(fn, []).append(ev)

    def record_attr_store(self, fn, attr, node, kind, daemon,
                          shm_create, line):
        cls = _enclosing_class(fn)
        if cls is None:
            return
        self.attr_stores.setdefault((cls, attr), []).append(AttrStore(
            cls, attr, fn, node, kind, daemon, shm_create, line))

    # -- summaries & guards -------------------------------------------
    def _compute_release_summaries(self):
        """Per-method released-attribute sets, closed over self-method
        calls (``respawn() -> _teardown_sockets()`` releases the
        listener too)."""
        for fn, events in self.fn_attr_events.items():
            attrs = {e.attr for e in events if e.verb != "guard"}
            if attrs:
                self.releases_attrs[fn] = set(attrs)
        for _ in range(self.MAX_PASSES):
            changed = False
            for fn, calls in self.self_calls.items():
                cls = _enclosing_class(fn)
                if cls is None:
                    continue
                mine = self.releases_attrs.get(fn)
                for mname, _line in calls:
                    for callee in self._by_method.get((cls, mname), ()):
                        theirs = self.releases_attrs.get(callee)
                        if not theirs:
                            continue
                        if mine is None:
                            mine = self.releases_attrs.setdefault(
                                fn, set())
                        add = theirs - mine
                        if add:
                            mine |= add
                            changed = True
            if not changed:
                break

    def _precedes(self, fn: FunctionInfo, attr: str, line: int) -> bool:
        """A guard / release / clear / swap of ``self.attr`` (direct,
        or via a self-method call whose summary releases it) lexically
        before ``line`` in this function."""
        for e in self.fn_attr_events.get(fn, ()):
            if e.attr == attr and e.line < line:
                return True
        cls = _enclosing_class(fn)
        if cls is not None:
            for mname, cline in self.self_calls.get(fn, ()):
                if cline >= line:
                    continue
                for callee in self._by_method.get((cls, mname), ()):
                    if attr in self.releases_attrs.get(callee, ()):
                        return True
        return False

    def _mark_guarded_stores(self):
        sites: Dict[Tuple[str, str],
                    List[Tuple[FunctionInfo, int]]] = {}
        for fn, calls in self.self_calls.items():
            cls = _enclosing_class(fn)
            if cls is None:
                continue
            for mname, line in calls:
                sites.setdefault((cls, mname), []).append((fn, line))
        for (cls, attr), stores in self.attr_stores.items():
            for st in stores:
                if _in_ctor(st.fn):
                    st.guarded = True
                    continue
                if self._precedes(st.fn, attr, st.line):
                    st.guarded = True
                    continue
                # entry-guard idiom: every in-package caller of this
                # method checks/releases the attribute first (the WAL
                # ``append() -> _open_segment()`` shape)
                csites = sites.get((cls, _method_name(st.fn)), ())
                if csites and all(self._precedes(cf, attr, cl)
                                  for cf, cl in csites):
                    st.guarded = True


class _FnWalker:
    """Lexical walk of one function body tracking live local resources
    and per-class attribute lifecycle events."""

    def __init__(self, an: LeakAnalysis, fn: FunctionInfo):
        self.an = an
        self.fn = fn
        self.mod = fn.module
        self.live: Dict[str, Acq] = {}
        # (acq, exit line, enclosing try-with-finally ids)
        self.pending: List[Tuple[Acq, int, Tuple[int, ...]]] = []
        self.try_stack: List[int] = []

    def run(self):
        for stmt in _fn_body(self.fn):
            self._stmt(stmt, 0, False, False, None)
        end = getattr(self.fn.node, "end_lineno", None) \
            or self.fn.node.lineno
        for acq in self.live.values():
            self.pending.append((acq, end, ()))
        for acq, line, tries in self.pending:
            if acq.escaped or acq.via_with:
                continue
            covered = any(
                r.line <= line
                or (r.in_finally and r.finally_of in tries)
                for r in acq.releases)
            if not covered:
                acq.leak_exits.append(line)

    # -- acquisition / release plumbing -------------------------------
    def _acquire(self, call, kind, daemon, shm_create, name):
        acq = Acq(self.fn, call, kind, name, call.lineno,
                  daemon=daemon, shm_create=shm_create)
        self.an.acqs.append(acq)
        if name is not None:
            self.live[name] = acq
        return acq

    def _release_live(self, name, verb, line, depth, in_finally,
                      in_handler, finally_of):
        acq = self.live.get(name)
        if acq is None:
            return False
        acq.releases.append(Release(line, verb, depth, in_finally,
                                    in_handler, finally_of))
        return True

    def _escape(self, name):
        acq = self.live.pop(name, None)
        if acq is not None:
            acq.escaped = True

    def _mark_risky(self, skip: Optional[str] = None):
        for name, acq in self.live.items():
            if name != skip and not acq.releases:
                acq.risky = True

    # -- statements ----------------------------------------------------
    def _stmt(self, stmt, depth, in_finally, in_handler, finally_of):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Assign):
            self._assign(stmt.targets, stmt.value, depth, in_finally,
                         in_handler, finally_of)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign([stmt.target], stmt.value, depth,
                             in_finally, in_handler, finally_of)
        elif isinstance(stmt, ast.AugAssign):
            self._value(stmt.value, depth, in_finally, in_handler,
                        finally_of)
        elif isinstance(stmt, ast.Expr):
            self._value(stmt.value, depth, in_finally, in_handler,
                        finally_of)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._value(stmt.value, depth, in_finally, in_handler,
                            finally_of, escaping=True)
            for acq in self.live.values():
                self.pending.append((acq, stmt.lineno,
                                     tuple(self.try_stack)))
        elif isinstance(stmt, ast.If):
            self._guard_test(stmt.test, depth, in_finally)
            self._value(stmt.test, depth, in_finally, in_handler,
                        finally_of)
            for s in stmt.body + stmt.orelse:
                self._stmt(s, depth + 1, in_finally, in_handler,
                           finally_of)
        elif isinstance(stmt, ast.While):
            self._guard_test(stmt.test, depth, in_finally)
            self._value(stmt.test, depth, in_finally, in_handler,
                        finally_of)
            for s in stmt.body + stmt.orelse:
                self._stmt(s, depth + 1, in_finally, in_handler,
                           finally_of)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._value(stmt.iter, depth, in_finally, in_handler,
                        finally_of)
            for s in stmt.body + stmt.orelse:
                self._stmt(s, depth + 1, in_finally, in_handler,
                           finally_of)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._with(stmt, depth, in_finally, in_handler, finally_of)
        elif isinstance(stmt, ast.Try):
            tid = id(stmt) if stmt.finalbody else None
            if tid is not None:
                self.try_stack.append(tid)
            for s in stmt.body:
                self._stmt(s, depth, in_finally, in_handler, finally_of)
            for handler in stmt.handlers:
                for s in handler.body:
                    self._stmt(s, depth + 1, in_finally, True,
                               finally_of)
            for s in stmt.orelse:
                self._stmt(s, depth, in_finally, in_handler, finally_of)
            if tid is not None:
                self.try_stack.pop()
            for s in stmt.finalbody:
                self._stmt(s, depth, True, in_handler, tid)
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                attr = _self_attr2(tgt)
                if attr is not None:
                    self.an.record_attr_event(
                        self.fn, attr, "clear", stmt.lineno, depth,
                        in_finally)
        elif isinstance(stmt, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._value(child, depth, in_finally, in_handler,
                                finally_of)
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._value(child, depth, in_finally, in_handler,
                                finally_of)
                elif isinstance(child, ast.stmt):
                    self._stmt(child, depth, in_finally, in_handler,
                               finally_of)

    def _guard_test(self, test, depth, in_finally):
        """``if self.X is None:`` / ``if not self.X:`` / ``if
        self.X:`` — a liveness check that precedes a re-store."""
        probes = [test]
        if isinstance(test, ast.UnaryOp) \
                and isinstance(test.op, ast.Not):
            probes.append(test.operand)
        if isinstance(test, ast.BoolOp):
            probes.extend(test.values)
        for probe in probes:
            attr = _self_attr2(probe)
            if attr is not None:
                self.an.record_attr_event(self.fn, attr, "guard",
                                          probe.lineno, depth,
                                          in_finally)

    def _with(self, stmt, depth, in_finally, in_handler, finally_of):
        for item in stmt.items:
            ce = item.context_expr
            summary = self.an.ctor_kind(self.fn, self.mod, ce)
            if summary is not None:
                # with socket.socket() as s: — released on exit
                self._acquire(ce, summary[0], summary[1], summary[2],
                              None).via_with = True
                continue
            if isinstance(ce, ast.Call):
                name = self.an.pkg.full_name(self.mod, self.fn, ce.func)
                if name in CLOSING_WRAPPERS and ce.args:
                    inner = ce.args[0]
                    inner_summary = self.an.ctor_kind(self.fn, self.mod,
                                                      inner)
                    if inner_summary is not None:
                        self._acquire(
                            inner, inner_summary[0], inner_summary[1],
                            inner_summary[2], None).via_with = True
                        continue
                    if isinstance(inner, ast.Name):
                        if self._release_live(
                                inner.id, "close", ce.lineno, depth,
                                True, False, None):
                            continue
            if isinstance(ce, ast.Name) and ce.id in self.live:
                # with sock: — the CM protocol closes it on exit
                self._release_live(ce.id, "close", ce.lineno, depth,
                                   True, False, None)
                continue
            self._value(ce, depth, in_finally, in_handler, finally_of)
        for s in stmt.body:
            self._stmt(s, depth, in_finally, in_handler, finally_of)

    def _assign(self, targets, value, depth, in_finally, in_handler,
                finally_of):
        # pairwise tuple assignment (the teardown swap idiom:
        # ``listener, self._listener = self._listener, None``)
        if len(targets) == 1 \
                and isinstance(targets[0], (ast.Tuple, ast.List)) \
                and isinstance(value, (ast.Tuple, ast.List)) \
                and len(targets[0].elts) == len(value.elts):
            for tgt, val in zip(targets[0].elts, value.elts):
                self._assign([tgt], val, depth, in_finally, in_handler,
                             finally_of)
            return
        summary = self.an.ctor_kind(self.fn, self.mod, value)
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                if summary is not None:
                    self._acquire(value, summary[0], summary[1],
                                  summary[2], tgt.id)
                    return
                if isinstance(value, ast.Name) \
                        and value.id in self.live:
                    self.live[tgt.id] = self.live.pop(value.id)
                    if self.live[tgt.id].name is not None:
                        self.live[tgt.id].name = tgt.id
                    return
                self.live.pop(tgt.id, None)
                attr = _self_attr2(value)
                if attr is not None:
                    # local takeover of an attribute-held resource
                    self.an.record_attr_event(
                        self.fn, attr, "swap", value.lineno, depth,
                        in_finally)
                self._value(value, depth, in_finally, in_handler,
                            finally_of)
                return
            attr = _self_attr2(tgt)
            if attr is not None:
                if summary is not None:
                    self.an.record_attr_store(
                        self.fn, attr, value, summary[0], summary[1],
                        summary[2], tgt.lineno)
                    return
                if isinstance(value, ast.Name) \
                        and value.id in self.live:
                    acq = self.live[value.id]
                    self.an.record_attr_store(
                        self.fn, attr, value, acq.kind, acq.daemon,
                        acq.shm_create, tgt.lineno)
                    self._escape(value.id)
                    return
                if isinstance(value, ast.Constant) \
                        and value.value is None:
                    self.an.record_attr_event(
                        self.fn, attr, "clear", tgt.lineno, depth,
                        in_finally)
                    return
                self._value(value, depth, in_finally, in_handler,
                            finally_of)
                return
            if isinstance(tgt, (ast.Subscript, ast.Attribute,
                                ast.Starred)):
                # container / foreign-object store transfers ownership
                if summary is None:
                    if isinstance(value, ast.Name) \
                            and value.id in self.live:
                        self._escape(value.id)
                    else:
                        self._value(value, depth, in_finally,
                                    in_handler, finally_of)
                if isinstance(tgt, ast.Subscript):
                    self._value(tgt.slice, depth, in_finally,
                                in_handler, finally_of)
                return
            self._value(value, depth, in_finally, in_handler,
                        finally_of)

    # -- expressions ---------------------------------------------------
    def _value(self, expr, depth, in_finally, in_handler, finally_of,
               escaping=False):
        if expr is None or isinstance(expr, (ast.Constant, ast.Lambda)):
            return
        release_calls = set()
        any_call = False
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                any_call = True
                func = node.func
                if isinstance(func, ast.Attribute):
                    parts = dotted_parts(func)
                    # conn.close() on a live local
                    if isinstance(func.value, ast.Name) \
                            and func.attr in RELEASE_VERBS \
                            and self._release_live(
                                func.value.id, func.attr, node.lineno,
                                depth, in_finally, in_handler,
                                finally_of):
                        release_calls.add(node)
                        continue
                    # self.X.close() — an attribute-lifecycle event
                    if parts is not None and len(parts) == 3 \
                            and parts[0] == "self" \
                            and parts[2] in RELEASE_VERBS:
                        self.an.record_attr_event(
                            self.fn, parts[1], parts[2], node.lineno,
                            depth, in_finally)
                        continue
                    # self.method() — recorded for release summaries
                    if parts is not None and len(parts) == 2 \
                            and parts[0] == "self":
                        self.an.self_calls.setdefault(
                            self.fn, []).append((parts[1], node.lineno))
            elif isinstance(node, ast.Compare) \
                    and all(isinstance(op, (ast.Is, ast.IsNot))
                            for op in node.ops):
                for side in [node.left] + list(node.comparators):
                    attr = _self_attr2(side)
                    if attr is not None:
                        self.an.record_attr_event(
                            self.fn, attr, "guard", node.lineno, depth,
                            in_finally)
        # escapes: live names passed as call arguments (directly or in
        # literal containers), yielded, or — for return values — used
        # anywhere in the returned expression
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and node not in release_calls:
                for arg in list(node.args) \
                        + [kw.value for kw in node.keywords]:
                    for name in self._literal_names(arg):
                        self._escape(name)
            elif isinstance(node, (ast.Yield, ast.YieldFrom)) \
                    and node.value is not None:
                for name in self._literal_names(node.value):
                    self._escape(name)
        if escaping:
            for name in self._literal_names(expr):
                self._escape(name)
        if any_call:
            self._mark_risky()

    def _literal_names(self, expr) -> List[str]:
        """Names (possibly inside tuple/list/dict/set literals) whose
        VALUE flows to a new owner — ``f(conn)``, ``return (a, conn)``,
        ``lst.append((t, conn))``.  ``conn.fileno()`` or an f-string
        mention does not move ownership."""
        out: List[str] = []
        stack = [expr]
        while stack:
            e = stack.pop()
            if isinstance(e, ast.Name):
                if e.id in self.live:
                    out.append(e.id)
            elif isinstance(e, (ast.Tuple, ast.List, ast.Set)):
                stack.extend(e.elts)
            elif isinstance(e, ast.Dict):
                stack.extend(v for v in e.values if v is not None)
            elif isinstance(e, ast.Starred):
                stack.append(e.value)
            elif isinstance(e, ast.IfExp):
                stack.extend([e.body, e.orelse])
        return out


def analyze_leaks(package: Package) -> LeakAnalysis:
    """Compute (or fetch the cached) resource-lifecycle analysis."""
    cached = getattr(package, "_leaklint_analysis", None)
    if cached is None:
        cached = LeakAnalysis(package)
        package._leaklint_analysis = cached
    return cached
