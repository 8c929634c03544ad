"""racelint — thread-spawn graph + lock environment for the control plane.

torchlint's base rules cover the compute layer, shardlint the mesh
layer, commlint the wire protocol; this module covers the layer
reviews find bugs in by hand: *thread interleavings*.
The learner is a dense multi-threaded system — server loop, inference-
service thread, serving-frontend handler threads, status HTTP threads,
StallWatchdog sampler, QueueCommunicator reader/writer, supervisor
sweeps — and its failure classes (a live-dict iteration from the
status thread, an unreserved ``inflight < max_inflight`` check)
are all instances of a few shapes the rules in :mod:`.racerules`
detect.  This module computes the package-level facts they consume:

  * the **thread-spawn graph**: which functions are thread roots
    (``Thread(target=...)`` / ``Timer``, resolved through spawn
    wrappers by fixpoint the way commlint resolves send wrappers, plus
    ``ThreadingHTTPServer``-style per-connection handler classes), and
    which *context set* every function runs on — the set of roots that
    reach it through resolvable calls, or ``{"main"}`` when nothing
    spawned reaches it;
  * the **lock environment**: which ``threading.Lock``-valued
    attributes exist (``self._lock = threading.Lock()`` in a method,
    class-level ``_admit_lock = threading.Lock()``, module-level
    locks), which of them every attribute access lexically holds via
    ``with``-statement scoping, and helper-method *entry summaries*
    ("every in-package call site of ``_live_count`` holds
    ``FleetRegistry._lock``, so its accesses are guarded too");
  * per-class **shared-attribute tables**: every ``self.X`` read /
    write / read-modify-write / container-mutation / iteration with
    its effective lock set and thread contexts;
  * the **lock-acquisition-order graph** (nested ``with`` blocks plus
    calls-under-lock into the transitive may-acquire summary) for
    cycle detection, and blocking-call / acquire-without-release facts.

Everything is stdlib ``ast`` only — like its three siblings the
analyzer never imports torch (or threading).  The abstraction is
deliberately approximate in the quiet direction: only ``self.X``
state, resolvable lock expressions, and resolvable calls participate;
a store of a plain constant (``self._stop = True``) is recognized as
the GIL-atomic flag idiom and stays quiet.  The per-line suppression
syntax is the escape hatch for intentionally lock-free designs (the
telemetry ring's atomic deque appends, say).
"""

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .astutil import (
    FunctionInfo,
    ModuleInfo,
    Package,
    _enclosing_class,
    dotted_parts,
)

# -- name tables ------------------------------------------------------

LOCK_CTORS = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
    "multiprocessing.Lock", "multiprocessing.RLock",
})
RLOCK_CTORS = frozenset({"threading.RLock", "multiprocessing.RLock"})
THREAD_CTORS = frozenset({"threading.Thread", "threading.Timer"})
# server classes that run each handler-class method on its own thread
THREADED_SERVERS = frozenset({
    "http.server.ThreadingHTTPServer",
    "socketserver.ThreadingTCPServer",
    "socketserver.ThreadingUDPServer",
    "socketserver.ThreadingMixIn",
})
# calls that park the holding thread: full dotted names...
BLOCKING_FNS = frozenset({
    "time.sleep", "select.select", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output", "os.system",
    "os.waitpid",
})
# ...and attribute-call names (socket/queue/thread/event verbs)
BLOCKING_ATTRS = frozenset({
    "recv", "accept", "join", "sleep", "wait", "select", "connect",
    "send", "sendall", "recv_exact", "send_recv", "serve_forever",
})
# full-name prefixes whose trailing attr coincides with a blocking verb
# but never parks a thread (``os.path.join`` is string glue)
_SAFE_BLOCK_PREFIXES = ("os.path.", "posixpath.", "ntpath.", "shlex.")

# container-method calls that mutate the receiver in place
MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "update",
    "pop", "popleft", "popitem", "remove", "discard", "clear",
    "setdefault",
})
# builtins that iterate their (single) argument to completion
ITER_WRAPPERS = frozenset({
    "sum", "list", "tuple", "set", "dict", "frozenset", "max", "min",
    "sorted", "any", "all",
})
_VIEW_METHODS = frozenset({"values", "items", "keys"})


# -- facts ------------------------------------------------------------

@dataclass
class LockInfo:
    """One lock object the package constructs."""

    key: str                     # "Class.attr" or "module:NAME"
    module: ModuleInfo
    line: int
    reentrant: bool


@dataclass
class ThreadRoot:
    """One function that runs on a spawned thread."""

    fn: FunctionInfo
    kind: str                    # "thread" | "timer" | "handler" | "wrapped"
    name: Optional[str]          # literal name= kwarg when present
    module: ModuleInfo
    line: int


@dataclass
class Access:
    """One ``self.X`` touch with its lexical lock set."""

    cls: str                     # canonical owning class name
    attr: str
    kind: str                    # read|write|rmw|mutate|iterate
    fn: FunctionInfo
    node: ast.AST
    locks: FrozenSet[str]        # effective (lexical + entry) lock keys
    const_value: bool = False    # write of a plain constant (flag idiom)


@dataclass
class CallSite:
    """One resolved in-package call with the caller's held locks."""

    caller: FunctionInfo
    callee: FunctionInfo
    node: ast.AST
    locks: FrozenSet[str]


@dataclass
class BlockSite:
    """One potentially-blocking call."""

    fn: FunctionInfo
    node: ast.AST
    desc: str
    locks: FrozenSet[str]


@dataclass
class LockOp:
    """One explicit ``.acquire()`` / ``.release()`` on a known lock."""

    fn: FunctionInfo
    node: ast.AST
    key: str
    op: str                      # "acquire" | "release"
    in_finally: bool


@dataclass
class OrderEdge:
    """Lock B acquired while lock A is held."""

    src: str
    dst: str
    fn: FunctionInfo
    node: ast.AST
    via: Optional[str] = None    # callee qname when the edge crosses a call


@dataclass
class FnRace:
    """Per-function concurrency summary."""

    may_acquire: Set[str] = field(default_factory=set)
    blocking: Optional[Tuple[str, int]] = None   # (desc, line), transitive
    entry_locks: FrozenSet[str] = frozenset()


def _walk_calls(mod: ModuleInfo):
    """Every Call node with its enclosing FunctionInfo (or None)."""
    out = []

    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            child_scope = mod.by_node.get(child, scope)
            if isinstance(child, ast.Call):
                out.append((scope, child))
            walk(child, child_scope)

    walk(mod.tree, None)
    return out


def _fn_body(fn: FunctionInfo) -> List[ast.stmt]:
    if isinstance(fn.node, ast.Lambda):
        return [ast.Expr(fn.node.body)]
    return fn.node.body


def _in_ctor(fn: FunctionInfo) -> bool:
    """Is this function ``__init__`` (or nested inside it)?  Writes
    there happen before any thread this object spawns exists."""
    probe = fn
    while probe is not None:
        if probe.qname.rsplit(":", 1)[-1].split(".")[-1] == "__init__":
            return True
        probe = probe.parent
    return False


def _const_write(value) -> bool:
    """A stored value whose write is a single atomic bytecode under the
    GIL *and* carries no derived state: the ``self._stop = True`` flag
    idiom."""
    if isinstance(value, ast.Constant):
        return True
    return (isinstance(value, ast.UnaryOp)
            and isinstance(value.operand, ast.Constant))


class RaceAnalysis:
    """All thread/lock facts of one package, computed once."""

    MAX_PASSES = 4

    def __init__(self, package: Package):
        self.pkg = package
        self.locks: Dict[str, LockInfo] = {}
        self._lock_attr_index: Dict[str, List[str]] = {}
        self._class_bases: Dict[str, List[str]] = {}
        self._class_methods: Dict[str, Set[str]] = {}
        self.thread_roots: Dict[str, ThreadRoot] = {}
        self.contexts: Dict[FunctionInfo, FrozenSet[str]] = {}
        self.accesses: Dict[Tuple[str, str], List[Access]] = {}
        self.call_sites: List[CallSite] = []
        self.block_sites: List[BlockSite] = []
        self.lock_ops: List[LockOp] = []
        self.order_edges: List[OrderEdge] = []
        self.summaries: Dict[FunctionInfo, FnRace] = {}
        self._with_acquires: Dict[FunctionInfo, Set[str]] = {}

        self._collect_classes()
        self._collect_locks()
        self._collect_thread_roots()
        self._walk_functions()
        self._compute_entry_locks()
        self._compute_contexts()
        self._compute_summaries()
        self._add_transitive_edges()

    # -- class / lock tables ------------------------------------------
    def _collect_classes(self):
        for mod in self.pkg.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                bases = []
                for b in node.bases:
                    parts = dotted_parts(b)
                    if parts:
                        bases.append(parts[-1])
                self._class_bases[node.name] = bases
            for cls, methods in mod.classes.items():
                self._class_methods.setdefault(cls, set()).update(methods)
            for fn in mod.functions:
                if fn.cls_name is not None:
                    self._class_methods.setdefault(
                        fn.cls_name, set()).add(
                            fn.qname.rsplit(":", 1)[-1].split(".")[-1])

    def _class_chain(self, cls: str) -> List[str]:
        """``cls`` plus its (transitive, by-name) base classes."""
        chain, seen = [cls], {cls}
        i = 0
        while i < len(chain):
            for base in self._class_bases.get(chain[i], ()):
                if base not in seen:
                    seen.add(base)
                    chain.append(base)
            i += 1
        return chain

    def _collect_locks(self):
        for mod in self.pkg.modules.values():
            # module-level: LOCK = threading.Lock()
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.Assign) \
                        and isinstance(stmt.value, ast.Call):
                    name = self.pkg.full_name(mod, None, stmt.value.func)
                    if name in LOCK_CTORS:
                        for tgt in stmt.targets:
                            if isinstance(tgt, ast.Name):
                                self._add_lock(
                                    f"{mod.name}:{tgt.id}", mod,
                                    stmt.lineno, name in RLOCK_CTORS,
                                    attr=None)
            # class-level: _admit_lock = threading.Lock() in a class body
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign) \
                            and isinstance(stmt.value, ast.Call):
                        name = self.pkg.full_name(mod, None,
                                                  stmt.value.func)
                        if name in LOCK_CTORS:
                            for tgt in stmt.targets:
                                if isinstance(tgt, ast.Name):
                                    self._add_lock(
                                        f"{node.name}.{tgt.id}", mod,
                                        stmt.lineno,
                                        name in RLOCK_CTORS,
                                        attr=tgt.id)
            # instance: self.X = threading.Lock() anywhere in a method
            for fn in mod.functions:
                cls = _enclosing_class(fn)
                if cls is None:
                    continue
                for node in ast.walk(fn.node):
                    if not isinstance(node, ast.Assign) \
                            or not isinstance(node.value, ast.Call):
                        continue
                    name = self.pkg.full_name(mod, fn, node.value.func)
                    if name not in LOCK_CTORS:
                        continue
                    for tgt in node.targets:
                        parts = dotted_parts(tgt)
                        if parts and len(parts) == 2 \
                                and parts[0] == "self":
                            self._add_lock(
                                f"{cls}.{parts[1]}", mod, node.lineno,
                                name in RLOCK_CTORS, attr=parts[1])

    def _add_lock(self, key, mod, line, reentrant, attr):
        if key not in self.locks:
            self.locks[key] = LockInfo(key, mod, line, reentrant)
        if attr is not None:
            keys = self._lock_attr_index.setdefault(attr, [])
            if key not in keys:
                keys.append(key)

    def _is_lock_attr(self, cls: Optional[str], attr: str) -> bool:
        if cls is not None:
            for c in self._class_chain(cls):
                if f"{c}.{attr}" in self.locks:
                    return True
        return False

    def resolve_lock(self, fn: Optional[FunctionInfo], mod: ModuleInfo,
                     expr) -> Optional[str]:
        """A lock-valued expression -> its lock key, or None.

        ``self.X`` resolves through the enclosing class (and its
        bases); a bare name through module-level locks (including
        ``from .x import LOCK``); ``obj.X`` resolves when exactly one
        class in the package owns a lock attribute named ``X`` (the
        ``state.lock`` idiom for module-singleton state objects).
        """
        parts = dotted_parts(expr)
        if parts is None:
            return None
        if len(parts) == 1:
            key = f"{mod.name}:{parts[0]}"
            if key in self.locks:
                return key
            imp = mod.from_imports.get(parts[0])
            if imp is not None:
                key = f"{imp[0]}:{imp[1]}"
                if key in self.locks:
                    return key
            return None
        attr = parts[-1]
        if parts[0] == "self" and len(parts) == 2 and fn is not None:
            cls = _enclosing_class(fn)
            if cls is not None:
                for c in self._class_chain(cls):
                    key = f"{c}.{attr}"
                    if key in self.locks:
                        return key
        candidates = self._lock_attr_index.get(attr, [])
        if len(candidates) == 1:
            return candidates[0]
        return None

    # -- thread roots --------------------------------------------------
    def _collect_thread_roots(self):
        spawn_params: Dict[FunctionInfo, Set[str]] = {}

        def add_root(fi, kind, name, mod, line):
            if fi.qname not in self.thread_roots:
                self.thread_roots[fi.qname] = ThreadRoot(
                    fi, kind, name, mod, line)

        def target_expr(call, ctor_name):
            kw_name = "function" if ctor_name.endswith("Timer") \
                else "target"
            for kw in call.keywords:
                if kw.arg == kw_name:
                    return kw.value
            if len(call.args) >= 2:
                return call.args[1]
            return None

        def literal_name(call):
            for kw in call.keywords:
                if kw.arg == "name" and isinstance(kw.value,
                                                   ast.Constant):
                    return str(kw.value.value)
            return None

        for mod in self.pkg.modules.values():
            for scope, call in _walk_calls(mod):
                name = self.pkg.full_name(mod, scope, call.func)
                if name in THREAD_CTORS:
                    tgt = target_expr(call, name)
                    if tgt is None:
                        continue
                    res = self.pkg.resolve_callee(mod, scope, tgt)
                    if res is not None and res[0] == "fn":
                        kind = "timer" if name.endswith("Timer") \
                            else "thread"
                        add_root(res[1], kind, literal_name(call), mod,
                                 call.lineno)
                    elif isinstance(tgt, ast.Name) and scope is not None \
                            and tgt.id in scope.all_params:
                        spawn_params.setdefault(scope, set()).add(tgt.id)
                elif name in THREADED_SERVERS and len(call.args) >= 2 \
                        and isinstance(call.args[1], ast.Name):
                    handler_cls = call.args[1].id
                    if handler_cls in mod.classes \
                            or handler_cls in self._class_methods:
                        for fi in mod.functions:
                            if fi.cls_name == handler_cls:
                                add_root(fi, "handler", handler_cls,
                                         mod, call.lineno)

        # fixpoint: calls into spawn wrappers make their function-valued
        # arguments thread roots too (and propagate wrapper-of-wrapper)
        for _ in range(self.MAX_PASSES):
            changed = False
            for mod in self.pkg.modules.values():
                for scope, call in _walk_calls(mod):
                    res = self.pkg.resolve_callee(mod, scope, call.func)
                    if res is None or res[0] != "fn" \
                            or res[1] not in spawn_params:
                        continue
                    wrapper = res[1]
                    names = wrapper.callable_params
                    exprs = []
                    for idx, arg in enumerate(call.args):
                        if idx < len(names) \
                                and names[idx] in spawn_params[wrapper]:
                            exprs.append(arg)
                    for kw in call.keywords:
                        if kw.arg in spawn_params[wrapper]:
                            exprs.append(kw.value)
                    for expr in exprs:
                        tres = self.pkg.resolve_callee(mod, scope, expr)
                        if tres is not None and tres[0] == "fn":
                            if tres[1].qname not in self.thread_roots:
                                add_root(tres[1], "wrapped", None, mod,
                                         call.lineno)
                                changed = True
                        elif isinstance(expr, ast.Name) \
                                and scope is not None \
                                and expr.id in scope.all_params:
                            before = spawn_params.setdefault(scope,
                                                             set())
                            if expr.id not in before:
                                before.add(expr.id)
                                changed = True
            if not changed:
                break

    # -- per-function walk ---------------------------------------------
    def _walk_functions(self):
        for mod in self.pkg.modules.values():
            for fn in mod.functions:
                _FnWalker(self, fn).run()

    def _record_access(self, fn, attr, kind, node, locks,
                       const_value=False):
        cls = _enclosing_class(fn)
        if cls is None:
            return
        if self._is_lock_attr(cls, attr):
            return
        if attr in self._class_methods.get(cls, ()):  # method refs
            return
        owner = cls
        for c in self._class_chain(cls)[1:]:
            if attr in self._class_methods.get(c, ()):
                return
        self.accesses.setdefault((owner, attr), []).append(Access(
            owner, attr, kind, fn, node, frozenset(locks), const_value))

    # -- entry-lock summaries ------------------------------------------
    def _compute_entry_locks(self):
        """Locks held at EVERY in-package call site of a function —
        the ``_live_count`` "called with the lock held" helper idiom.
        Two relaxation passes: direct site locks, then one level of
        caller-entry chaining (enough for helper-of-helper)."""
        sites: Dict[FunctionInfo, List[CallSite]] = {}
        for cs in self.call_sites:
            sites.setdefault(cs.callee, []).append(cs)
        entry: Dict[FunctionInfo, FrozenSet[str]] = {}
        for fn, fn_sites in sites.items():
            if fn.qname in self.thread_roots:
                continue  # the spawner's locks are NOT held on the thread
            common = None
            for cs in fn_sites:
                common = cs.locks if common is None \
                    else common & cs.locks
            if common:
                entry[fn] = common
        for fn, fn_sites in sites.items():
            if fn.qname in self.thread_roots or fn in entry:
                continue
            common = None
            for cs in fn_sites:
                eff = cs.locks | entry.get(cs.caller, frozenset())
                common = eff if common is None else common & eff
            if common:
                entry[fn] = common
        for fn, locks in entry.items():
            self.summaries.setdefault(fn, FnRace()).entry_locks = locks
        # fold entry locks into the recorded facts
        if entry:
            for sites_list in self.accesses.values():
                for acc in sites_list:
                    extra = entry.get(acc.fn)
                    if extra:
                        acc.locks = acc.locks | extra
            for bs in self.block_sites:
                extra = entry.get(bs.fn)
                if extra:
                    bs.locks = bs.locks | extra
            for cs in self.call_sites:
                extra = entry.get(cs.caller)
                if extra:
                    cs.locks = cs.locks | extra

    # -- thread contexts -----------------------------------------------
    def _compute_contexts(self):
        ctx: Dict[FunctionInfo, Set[str]] = {}
        callers: Dict[FunctionInfo, Set[FunctionInfo]] = {}
        for cs in self.call_sites:
            callers.setdefault(cs.callee, set()).add(cs.caller)
        for fn in self.pkg.all_functions():
            ctx[fn] = set()
            if fn.qname in self.thread_roots:
                ctx[fn].add(fn.qname)
        for fn in self.pkg.all_functions():
            if not ctx[fn] and not callers.get(fn):
                ctx[fn].add("main")
        for _ in range(16):
            changed = False
            for cs in self.call_sites:
                add = ctx.get(cs.caller, set()) - ctx[cs.callee]
                if add:
                    ctx[cs.callee] |= add
                    changed = True
            if not changed:
                break
        self.contexts = {fn: frozenset(c or {"main"})
                         for fn, c in ctx.items()}

    def context_of(self, fn: FunctionInfo) -> FrozenSet[str]:
        return self.contexts.get(fn, frozenset({"main"}))

    # -- may-acquire / blocking summaries ------------------------------
    def _compute_summaries(self):
        direct_block: Dict[FunctionInfo, Tuple[str, int]] = {}
        for bs in self.block_sites:
            direct_block.setdefault(bs.fn,
                                    (bs.desc, bs.node.lineno))
        for edge in self.order_edges:
            self.summaries.setdefault(edge.fn, FnRace()).may_acquire.add(
                edge.dst)
        acquired_in: Dict[FunctionInfo, Set[str]] = {}
        for mod in self.pkg.modules.values():
            for fn in mod.functions:
                acquired_in[fn] = set()
        for op in self.lock_ops:
            if op.op == "acquire":
                acquired_in.setdefault(op.fn, set()).add(op.key)
        for (fn, keys) in self._with_acquires.items():
            acquired_in.setdefault(fn, set()).update(keys)
        for fn, keys in acquired_in.items():
            if keys:
                self.summaries.setdefault(fn,
                                          FnRace()).may_acquire |= keys
        for fn, desc in direct_block.items():
            self.summaries.setdefault(fn, FnRace()).blocking = desc
        calls_of: Dict[FunctionInfo, List[CallSite]] = {}
        for cs in self.call_sites:
            calls_of.setdefault(cs.caller, []).append(cs)
        for _ in range(self.MAX_PASSES):
            changed = False
            for fn, sites in calls_of.items():
                sm = self.summaries.setdefault(fn, FnRace())
                for cs in sites:
                    callee_sm = self.summaries.get(cs.callee)
                    if callee_sm is None:
                        continue
                    add = callee_sm.may_acquire - sm.may_acquire
                    if add:
                        sm.may_acquire |= add
                        changed = True
                    if sm.blocking is None \
                            and callee_sm.blocking is not None:
                        sm.blocking = (
                            f"{callee_sm.blocking[0]} (via "
                            f"{cs.callee.qname})", cs.node.lineno)
                        changed = True
            if not changed:
                break

    def summary(self, fn: FunctionInfo) -> FnRace:
        return self.summaries.setdefault(fn, FnRace())

    # -- transitive lock-order edges -----------------------------------
    def _add_transitive_edges(self):
        seen = {(e.src, e.dst, e.fn.module.name)
                for e in self.order_edges}
        for cs in self.call_sites:
            if not cs.locks:
                continue
            callee_sm = self.summaries.get(cs.callee)
            if callee_sm is None or not callee_sm.may_acquire:
                continue
            for held in cs.locks:
                for acq in callee_sm.may_acquire:
                    if held == acq \
                            and self.locks.get(held) is not None \
                            and self.locks[held].reentrant:
                        continue
                    key = (held, acq, cs.caller.module.name)
                    if key in seen:
                        continue
                    seen.add(key)
                    self.order_edges.append(OrderEdge(
                        held, acq, cs.caller, cs.node,
                        via=cs.callee.qname))

    # -- gate helpers --------------------------------------------------
    def dominating_lock(self, cls: str, attr: str,
                        kinds: Optional[Tuple[str, ...]] = None,
                        ) -> Optional[str]:
        """The lock key held at every (non-ctor) access of
        ``cls.attr`` — the repo gate's "known guarded attrs resolve"
        proof.  None when any access is bare or the attr is unknown."""
        sites = [a for a in self.accesses.get((cls, attr), [])
                 if not _in_ctor(a.fn)
                 and (kinds is None or a.kind in kinds)]
        if not sites:
            return None
        common = None
        for a in sites:
            common = set(a.locks) if common is None \
                else common & set(a.locks)
        if not common:
            return None
        return sorted(common)[0]


class _FnWalker:
    """Lexical walk of one function body carrying the held-lock set."""

    def __init__(self, an: RaceAnalysis, fn: FunctionInfo):
        self.an = an
        self.fn = fn
        self.mod = fn.module
        self.cls = _enclosing_class(fn)
        self.with_acquires: Set[str] = set()

    def run(self):
        for stmt in _fn_body(self.fn):
            self._stmt(stmt, (), False)
        if self.with_acquires:
            self.an._with_acquires.setdefault(
                self.fn, set()).update(self.with_acquires)

    # -- helpers -------------------------------------------------------
    def _self_attr(self, expr) -> Optional[str]:
        parts = dotted_parts(expr)
        if parts is not None and len(parts) >= 2 and parts[0] == "self":
            return parts[1]
        return None

    def _container_attr(self, expr) -> Optional[Tuple[str, ast.AST]]:
        """``self.X`` or ``self.X.values()/items()/keys()`` -> X."""
        if isinstance(expr, ast.Attribute):
            attr = self._self_attr(expr)
            if attr is not None and dotted_parts(expr) is not None \
                    and len(dotted_parts(expr)) == 2:
                return attr, expr
        if isinstance(expr, ast.Call) and not expr.args \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in _VIEW_METHODS:
            inner = expr.func.value
            parts = dotted_parts(inner)
            if parts is not None and len(parts) == 2 \
                    and parts[0] == "self":
                return parts[1], expr
        return None

    def _reads_attr(self, expr, attr) -> bool:
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) \
                    and node.attr == attr \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                return True
        return False

    def _access(self, attr, kind, node, held, const_value=False):
        self.an._record_access(self.fn, attr, kind, node, held,
                               const_value)

    # -- statements ----------------------------------------------------
    def _stmt(self, stmt, held, in_finally):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs run later, not under these locks
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                self._assign_target(tgt, stmt.value, stmt, held)
            self._expr(stmt.value, held, in_finally)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign_target(stmt.target, stmt.value, stmt, held)
                self._expr(stmt.value, held, in_finally)
        elif isinstance(stmt, ast.AugAssign):
            attr = self._self_attr(stmt.target)
            if attr is not None and isinstance(stmt.target,
                                               ast.Attribute):
                self._access(attr, "rmw", stmt, held)
            elif isinstance(stmt.target, ast.Subscript):
                base = self._self_attr(stmt.target.value)
                if base is not None:
                    self._access(base, "rmw", stmt, held)
            self._expr(stmt.value, held, in_finally)
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Attribute):
                    attr = self._self_attr(tgt)
                    if attr is not None:
                        self._access(attr, "write", stmt, held)
                elif isinstance(tgt, ast.Subscript):
                    base = self._self_attr(tgt.value)
                    if base is not None:
                        self._access(base, "mutate", stmt, held)
                    self._expr(tgt.slice, held, in_finally)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in stmt.items:
                key = self.an.resolve_lock(self.fn, self.mod,
                                           item.context_expr)
                if key is None:
                    self._expr(item.context_expr, new_held, in_finally)
                    continue
                self.with_acquires.add(key)
                info = self.an.locks.get(key)
                for h in new_held:
                    if h == key and info is not None \
                            and info.reentrant:
                        continue
                    self.an.order_edges.append(OrderEdge(
                        h, key, self.fn, item.context_expr))
                if key not in new_held:
                    new_held = new_held + (key,)
            for s in stmt.body:
                self._stmt(s, new_held, in_finally)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = stmt.iter
            cont = self._container_attr(it)
            if cont is not None:
                self._access(cont[0], "iterate", it, held)
            else:
                self._expr(it, held, in_finally)
            for s in stmt.body + stmt.orelse:
                self._stmt(s, held, in_finally)
        elif isinstance(stmt, ast.While):
            self._expr(stmt.test, held, in_finally)
            for s in stmt.body + stmt.orelse:
                self._stmt(s, held, in_finally)
        elif isinstance(stmt, ast.If):
            self._expr(stmt.test, held, in_finally)
            for s in stmt.body + stmt.orelse:
                self._stmt(s, held, in_finally)
        elif isinstance(stmt, ast.Try):
            for s in stmt.body + stmt.orelse:
                self._stmt(s, held, in_finally)
            for handler in stmt.handlers:
                for s in handler.body:
                    self._stmt(s, held, in_finally)
            for s in stmt.finalbody:
                self._stmt(s, held, True)
        elif isinstance(stmt, (ast.Return, ast.Expr, ast.Raise,
                               ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, held, in_finally)
        else:
            # anything newer (Match, ...): scan expressions, recurse
            # into statement children with the same held set
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, held, in_finally)
                elif isinstance(child, ast.stmt):
                    self._stmt(child, held, in_finally)

    def _assign_target(self, tgt, value, stmt, held):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._assign_target(el, value, stmt, held)
            return
        if isinstance(tgt, ast.Starred):
            self._assign_target(tgt.value, value, stmt, held)
            return
        if isinstance(tgt, ast.Attribute):
            attr = self._self_attr(tgt)
            if attr is not None:
                if self._reads_attr(value, attr):
                    self._access(attr, "rmw", stmt, held)
                else:
                    self._access(attr, "write", stmt, held,
                                 const_value=_const_write(value))
            return
        if isinstance(tgt, ast.Subscript):
            base = self._self_attr(tgt.value)
            if base is not None:
                kind = "rmw" if self._reads_attr(value, base) \
                    else "mutate"
                self._access(base, kind, stmt, held)
            else:
                self._expr(tgt.value, held, False)
            self._expr(tgt.slice, held, False)

    # -- expressions ---------------------------------------------------
    def _expr(self, e, held, in_finally):
        if e is None or isinstance(e, (ast.Constant, ast.Lambda)):
            return
        if isinstance(e, ast.Call):
            self._call(e, held, in_finally)
            return
        if isinstance(e, ast.Attribute):
            attr = self._self_attr(e)
            parts = dotted_parts(e)
            if attr is not None and parts is not None:
                # self.a.b.c reads self.a; record the closest-to-self
                self._access(attr, "read", e, held)
                return
            self._expr(e.value, held, in_finally)
            return
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            for gen in e.generators:
                cont = self._container_attr(gen.iter)
                if cont is not None:
                    self._access(cont[0], "iterate", gen.iter, held)
                else:
                    self._expr(gen.iter, held, in_finally)
                for cond in gen.ifs:
                    self._expr(cond, held, in_finally)
            if isinstance(e, ast.DictComp):
                self._expr(e.key, held, in_finally)
                self._expr(e.value, held, in_finally)
            else:
                self._expr(e.elt, held, in_finally)
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self._expr(child, held, in_finally)

    def _blocking_desc(self, call, full_name) -> Optional[str]:
        if full_name in BLOCKING_FNS:
            return full_name
        if full_name is not None and full_name.startswith(
                _SAFE_BLOCK_PREFIXES):
            return None
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in BLOCKING_ATTRS:
            if isinstance(call.func.value, ast.Constant):
                return None  # "sep".join(...) string glue
            return f".{call.func.attr}()"
        return None

    def _call(self, call, held, in_finally):
        full_name = self.an.pkg.full_name(self.mod, self.fn, call.func)
        res = self.an.pkg.resolve_callee(self.mod, self.fn, call.func)
        if res is not None and res[0] == "fn":
            self.an.call_sites.append(CallSite(
                self.fn, res[1], call, frozenset(held)))
        else:
            desc = self._blocking_desc(call, full_name)
            if desc is not None:
                self.an.block_sites.append(BlockSite(
                    self.fn, call, desc, frozenset(held)))
        # explicit acquire / release on a known lock
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in ("acquire", "release"):
            key = self.an.resolve_lock(self.fn, self.mod,
                                       call.func.value)
            if key is not None:
                self.an.lock_ops.append(LockOp(
                    self.fn, call, key, call.func.attr, in_finally))
                if call.func.attr == "acquire":
                    info = self.an.locks.get(key)
                    for h in held:
                        if h == key and info is not None \
                                and info.reentrant:
                            continue
                        self.an.order_edges.append(OrderEdge(
                            h, key, self.fn, call))
        # iteration wrappers: sum(self.d.values()), list(self.conns)...
        if isinstance(call.func, ast.Name) \
                and call.func.id in ITER_WRAPPERS \
                and len(call.args) == 1 and not call.keywords:
            cont = self._container_attr(call.args[0])
            if cont is not None:
                self._access(cont[0], "iterate", call, held)
                return
        # method call on a self attribute: mutator or plain read
        if isinstance(call.func, ast.Attribute):
            base = call.func.value
            battr = self._self_attr(base)
            bparts = dotted_parts(base)
            if battr is not None and bparts is not None \
                    and len(bparts) == 2:
                kind = "mutate" if call.func.attr in MUTATORS \
                    else "read"
                self._access(battr, kind, call, held)
            else:
                self._expr(base, held, in_finally)
        elif not isinstance(call.func, ast.Name):
            self._expr(call.func, held, in_finally)
        for arg in call.args:
            self._expr(arg, held, in_finally)
        for kw in call.keywords:
            self._expr(kw.value, held, in_finally)


def analyze_race(package: Package) -> RaceAnalysis:
    """Compute (or fetch the cached) thread/lock analysis."""
    cached = getattr(package, "_racelint_analysis", None)
    if cached is None:
        cached = RaceAnalysis(package)
        package._racelint_analysis = cached
    return cached
