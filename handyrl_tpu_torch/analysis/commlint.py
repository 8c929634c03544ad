"""commlint — the protocol-graph analyzer behind the control-plane rules.

torchlint's base rules cover the compute layer and shardlint the mesh
layer; this module covers the layer both are blind to: the *distributed control plane* — the stringly-typed
``(verb, payload)`` RPC protocol that holds the learner, the gather
tree, the workers and the network-battle clients together, plus the
blocking recvs, writer threads, locks and process spawns around it.
The rules in :mod:`.commrules` need package-level answers that plain
pattern matching cannot give:

  * which verbs does this package ever SEND?  Collected from literal
    ``("verb", payload)`` tuples flowing into ``send``-like calls —
    directly (``conn.send(("quit", []))``), through send wrappers
    (``send_recv(conn, ("model", mid))``, ``self._ask_learner(("beat",
    stats))``, ``self._call("update", data)`` where the wrapper's own
    body does the send), through role/verb TABLES (``self.roles =
    {"g": (run, "episode")}`` unpacked into a send head), and through
    return-verb summaries (``RolloutPool.step`` returning ``("episode",
    ep)`` tuples that a caller loop forwards upstream);
  * which verbs does it HANDLE?  Dispatch-dict keys looked up with a
    recv-bound verb variable (``handlers.get(verb)``), and ``if verb ==
    "quit"`` / ``verb in ("a", "b")`` chains on such variables;
  * does every handler of a request/reply verb actually REPLY?  A verb
    sent via a wrapper that also recvs (``send_recv``) wedges its
    sender forever if any handler branch can ``continue``/``return``
    without sending;
  * which payload values are UNPICKLABLE or device-resident?  (locks,
    file handles, lambdas — and CUDA tensors via the base device-taint
    lattice: pickling one is also a hidden host transfer);
  * which process spawns are FORK-UNSAFE?  (a fork-context ``Process``
    after threads started / under a held lock / in a module that
    initializes CUDA — spawn contexts like ``connection._mp`` are recognized
    package-wide and stay quiet).

Everything is stdlib ``ast`` only — like its two siblings the analyzer
never imports torch, so it runs in a fresh interpreter in seconds.
The abstraction is deliberately approximate in the quiet direction:
verbs are only recorded when they resolve to literals, dynamic
dispatch stays silent, and the per-line suppression syntax is the
escape hatch for intentional wedges (a gather's blocked round trip
that the learner's heartbeat sweep recovers by design).
"""

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .astutil import (
    FunctionInfo,
    ModuleInfo,
    Package,
    dotted_parts,
)

# -- name tables ------------------------------------------------------

# synchronization primitives that cannot cross a pickle boundary
LOCK_PRODUCERS = frozenset({
    "threading.Lock", "threading.RLock", "threading.Semaphore",
    "threading.BoundedSemaphore", "threading.Condition",
    "threading.Event", "threading.Barrier", "_thread.allocate_lock",
    "multiprocessing.Lock", "multiprocessing.RLock",
})
# calls yielding OS-handle-backed objects (files, sockets)
HANDLE_PRODUCERS = frozenset({
    "open", "io.open", "gzip.open", "bz2.open", "lzma.open",
    "socket.socket",
})
# process constructors whose start method matters
PROCESS_NAMES = frozenset({
    "multiprocessing.Process", "multiprocessing.context.Process",
})
THREAD_NAMES = frozenset({"threading.Thread", "threading.Timer"})
FORK_CALLS = frozenset({"os.fork", "os.forkpty"})
# ``torch.cuda`` queries that do not create a CUDA context; every other
# ``torch.cuda.*`` call, ``.cuda()``, and a ``"cuda"`` device literal
# count as initializing CUDA, which a forked child cannot re-initialize
CUDA_QUIET = frozenset({
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.is_initialized",
})
GET_CONTEXT_NAMES = frozenset({
    "multiprocessing.get_context", "multiprocessing.context.get_context",
})
# telemetry's trace-context envelope codec (telemetry.spans): these
# functions are TRANSPARENT to the protocol — ``wrap_trace(msg)`` IS
# ``msg`` for verb collection and ``unwrap_trace(conn.recv())`` is a
# recv, while the envelope head they add/strip is a wire detail, never
# a verb.  Matched by trailing name so both the package definitions and
# re-imports resolve.
TRACE_CODECS = frozenset({"wrap_trace", "unwrap_trace"})


def module_initializes_cuda(pkg: Package, mod: ModuleInfo) -> bool:
    """Does this module create a CUDA context anywhere: a
    ``torch.cuda.*`` call other than the :data:`CUDA_QUIET` queries, a
    ``.cuda()`` call, or a ``"cuda"``/``"cuda:N"`` device literal?"""
    cached = getattr(mod, "_initializes_cuda", None)
    if cached is not None:
        return cached
    found = False
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.split(":")[0] == "cuda":
            found = True
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "cuda" and not node.args:
                found = True
            scope = None
            name = pkg.full_name(mod, scope, node.func) or ""
            if name.startswith("torch.cuda.") and name not in CUDA_QUIET:
                found = True
        if found:
            break
    mod._initializes_cuda = found
    return found


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# -- facts ------------------------------------------------------------

@dataclass
class SendSite:
    """One place a literal verb leaves the process."""

    verb: str
    module: ModuleInfo
    node: ast.AST                 # anchor for the finding location
    expects_reply: bool           # sent through a send+recv round trip


@dataclass
class HandlerSite:
    """One place a literal verb is dispatched on after a recv."""

    verb: str
    module: ModuleInfo
    node: ast.AST
    kind: str                     # "dict" | "branch"
    no_reply_path: bool           # handler can complete without a send


@dataclass
class FnComm:
    """Per-function communication summary (grown to a fixpoint)."""

    payload_params: Set[str] = field(default_factory=set)   # sent whole
    verb_params: Set[str] = field(default_factory=set)      # tuple head
    does_send: bool = False
    does_recv: bool = False
    return_verbs: Set[str] = field(default_factory=set)


def _is_send_attr_call(call: ast.Call) -> Optional[ast.expr]:
    """``X.send(payload)`` / ``hub.send(conn, payload)`` -> the payload
    expression, else None.  One positional arg is the framed-connection
    form; two is the communicator-hub form (conn first)."""
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "send"):
        return None
    if len(call.args) == 1:
        return call.args[0]
    if len(call.args) == 2:
        return call.args[1]
    return None


def _is_recv_attr_call(call: ast.Call) -> bool:
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "recv")


def _codec_name(pkg: Package, mod: ModuleInfo, scope,
                func) -> Optional[str]:
    """Trailing name of a call target when it resolves at all (package
    function or external dotted name); None for computed targets."""
    res = pkg.resolve_callee(mod, scope, func)
    if res is None:
        return None
    name = res[1].qname if res[0] == "fn" else (res[1] or "")
    # qnames read "module:Class.method"; externals read "pkg.mod.fn"
    return name.rpartition(".")[2].rpartition(":")[2]


def _strip_trace_codec(pkg: Package, mod: ModuleInfo, scope, expr):
    """Look through the trace-context envelope codec: without this, a
    send moved behind ``wrap_trace`` would silently vanish from the
    protocol graph — and a vanished verb disables unhandled-verb /
    dead-handler / reply-mismatch for that part of the plane."""
    while isinstance(expr, ast.Call) and len(expr.args) == 1 \
            and not expr.keywords \
            and _codec_name(pkg, mod, scope, expr.func) in TRACE_CODECS:
        expr = expr.args[0]
    return expr


def _fn_nodes(fn: FunctionInfo):
    """Every node of ``fn``'s own body (nested defs excluded); cached
    on ``fn``, since every comm rule walks every function."""
    cached = getattr(fn, "_comm_nodes", None)
    if cached is None:
        cached = fn._comm_nodes = list(_walk_fn_nodes(fn))
    return cached


def _walk_fn_nodes(fn: FunctionInfo):
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            yield child
            yield from walk(child)

    body = fn.node.body if not isinstance(fn.node, ast.Lambda) \
        else [ast.Expr(fn.node.body)]
    for stmt in body:
        yield stmt
        yield from walk(stmt)


def _own_statements(fn: FunctionInfo) -> List[ast.stmt]:
    if isinstance(fn.node, ast.Lambda):
        return [ast.Expr(fn.node.body)]
    return fn.node.body


class CommAnalysis:
    """All protocol/concurrency facts of one package, computed once."""

    def __init__(self, package: Package):
        self.pkg = package
        self.summaries: Dict[FunctionInfo, FnComm] = {}
        # (module_name, cls) -> attr -> tuple position -> verb strings
        self.verb_tables: Dict[Tuple[str, str],
                               Dict[str, Dict[int, Set[str]]]] = {}
        # (module_name, cls) -> attr -> constructed package class
        self.instance_attrs: Dict[Tuple[str, str],
                                  Dict[str, Tuple[ModuleInfo, str]]] = {}
        # (module_name, cls) -> attr -> dict-literal node (dispatch use)
        self.attr_dicts: Dict[Tuple[str, str], Dict[str, ast.Dict]] = {}
        # module name -> local names bound to mp contexts ("spawn"/"fork")
        self.mp_contexts: Dict[str, Dict[str, str]] = {}
        self.sends: List[SendSite] = []
        self.handlers: List[HandlerSite] = []

        self._collect_module_facts()
        self._compute_summaries()
        self._collect_protocol_graph()

        self.sent_verbs: Dict[str, List[SendSite]] = {}
        for site in self.sends:
            self.sent_verbs.setdefault(site.verb, []).append(site)
        self.handled_verbs: Dict[str, List[HandlerSite]] = {}
        for site in self.handlers:
            self.handled_verbs.setdefault(site.verb, []).append(site)

    # -- name resolution helpers -------------------------------------
    def resolve_class(self, mod: ModuleInfo, scope,
                      func) -> Optional[Tuple[ModuleInfo, str]]:
        """A constructor call target -> the package class it names."""
        name = self.pkg.full_name(mod, scope, func)
        if name is None:
            return None
        head, _, cls = name.rpartition(".")
        target = self.pkg.modules.get(head)
        if target is not None and cls in target.classes:
            return (target, cls)
        if not head and cls in mod.classes:
            return (mod, cls)
        return None

    def context_kind(self, mod: ModuleInfo, scope, expr) -> Optional[str]:
        """The multiprocessing start method behind ``expr`` when it
        names a tracked ``get_context(...)`` binding ("spawn"/"fork"/
        "forkserver"), locally or through a cross-module import."""
        parts = dotted_parts(expr)
        if parts is None:
            return None
        name = parts[-1]
        local = self.mp_contexts.get(mod.name, {})
        if len(parts) == 1 and name in local:
            return local[name]
        # imported context object: ``from .connection import _mp``
        if len(parts) == 1 and name in mod.from_imports:
            target, orig = mod.from_imports[name]
            return self.mp_contexts.get(target, {}).get(orig)
        return None

    # -- pass 0: module/class-level facts ----------------------------
    def _collect_module_facts(self):
        for mod in self.pkg.modules.values():
            ctxs: Dict[str, str] = {}
            for stmt in mod.tree.body:
                if not isinstance(stmt, ast.Assign) \
                        or not isinstance(stmt.value, ast.Call):
                    continue
                name = self.pkg.full_name(mod, None, stmt.value.func)
                if name in GET_CONTEXT_NAMES and stmt.value.args:
                    method = _const_str(stmt.value.args[0])
                    if method:
                        for tgt in stmt.targets:
                            if isinstance(tgt, ast.Name):
                                ctxs[tgt.id] = method
            if ctxs:
                self.mp_contexts[mod.name] = ctxs

            for fn in mod.functions:
                if fn.cls_name is None:
                    continue
                key = (mod.name, fn.cls_name)
                for node in _fn_nodes(fn):
                    if not isinstance(node, ast.Assign):
                        continue
                    for tgt in node.targets:
                        parts = dotted_parts(tgt)
                        if parts is None or len(parts) != 2 \
                                or parts[0] != "self":
                            continue
                        self._class_attr_fact(mod, fn, key, parts[1],
                                              node.value)

    def _class_attr_fact(self, mod, fn, key, attr, value):
        # verb table: every value a tuple carrying exactly one string
        if isinstance(value, ast.Dict) and value.values and all(
                isinstance(v, ast.Tuple) for v in value.values):
            table: Dict[int, Set[str]] = {}
            for v in value.values:
                strs = [(i, _const_str(el))
                        for i, el in enumerate(v.elts)
                        if _const_str(el) is not None]
                if len(strs) != 1:
                    return
                pos, verb = strs[0]
                table.setdefault(pos, set()).add(verb)
            self.verb_tables.setdefault(key, {})[attr] = table
            return
        # dispatch-dict attribute: string keys, name/attribute values
        if isinstance(value, ast.Dict) and value.keys and all(
                _const_str(k) is not None for k in value.keys) and all(
                isinstance(v, (ast.Name, ast.Attribute, ast.Lambda))
                for v in value.values):
            self.attr_dicts.setdefault(key, {})[attr] = value
        # instance attribute: ``self.pool = RolloutPool(...)``
        if isinstance(value, ast.Call):
            cls = self.resolve_class(mod, fn, value.func)
            if cls is not None:
                self.instance_attrs.setdefault(key, {})[attr] = cls

    # -- pass 1: per-function summaries (fixpoint) -------------------
    def summary(self, fn: FunctionInfo) -> FnComm:
        sm = self.summaries.get(fn)
        if sm is None:
            sm = self.summaries[fn] = FnComm()
        return sm

    def _compute_summaries(self):
        for _ in range(4):
            changed = False
            for fn in self.pkg.all_functions():
                if self._summarize_fn(fn):
                    changed = True
            if not changed:
                break

    def _callee_summary(self, mod, scope, func) -> Optional[FnComm]:
        res = self.pkg.resolve_callee(mod, scope, func)
        if res is not None and res[0] == "fn":
            return self.summary(res[1])
        return None

    def _summarize_fn(self, fn: FunctionInfo) -> bool:
        sm = self.summary(fn)
        before = (set(sm.payload_params), set(sm.verb_params),
                  sm.does_send, sm.does_recv, set(sm.return_verbs))
        params = set(fn.all_params)
        strings = self._string_env(fn)
        for node in _fn_nodes(fn):
            if isinstance(node, (ast.Return, ast.Yield)) \
                    and node.value is not None:
                sm.return_verbs |= self._tuple_head_verbs(
                    fn, node.value, strings, {})
            if not isinstance(node, ast.Call):
                continue
            payload = _is_send_attr_call(node)
            if payload is not None:
                payload = _strip_trace_codec(
                    self.pkg, fn.module, fn, payload)
                sm.does_send = True
                if isinstance(payload, ast.Name) \
                        and payload.id in params:
                    sm.payload_params.add(payload.id)
                if isinstance(payload, ast.Tuple) and payload.elts:
                    head = payload.elts[0]
                    if isinstance(head, ast.Name) and head.id in params:
                        sm.verb_params.add(head.id)
            elif _is_recv_attr_call(node):
                sm.does_recv = True
            callee = self._callee_summary(fn.module, fn, node.func)
            if callee is not None:
                sm.does_send = sm.does_send or callee.does_send
                sm.does_recv = sm.does_recv or callee.does_recv
                # wrapper-of-wrapper: a parameter forwarded into a
                # callee's payload/verb slot makes this fn a wrapper too
                payloads, verb_heads, _ = self._call_payloads(
                    fn.module, fn, node)
                for expr in payloads:
                    if isinstance(expr, ast.Name) and expr.id in params:
                        sm.payload_params.add(expr.id)
                    # ``send_recv(conn, (verb, payload))`` with verb a
                    # parameter: a tuple built at a send wrapper's
                    # payload slot makes ITS head a verb-head param —
                    # the Worker._ship shape (ship-or-spill helpers
                    # that route between the shm transport and the
                    # control plane)
                    if isinstance(expr, ast.Tuple) and expr.elts:
                        head = expr.elts[0]
                        if isinstance(head, ast.Name) \
                                and head.id in params:
                            sm.verb_params.add(head.id)
                for expr in verb_heads:
                    if isinstance(expr, ast.Name) and expr.id in params:
                        sm.verb_params.add(expr.id)
        return before != (sm.payload_params, sm.verb_params,
                          sm.does_send, sm.does_recv, sm.return_verbs)

    def _call_payloads(self, mod, scope, call: ast.Call):
        """Payload and verb-head argument expressions of ``call`` when
        it resolves to a send wrapper; ``(payloads, verb_heads,
        expects_reply)``."""
        res = self.pkg.resolve_callee(mod, scope, call.func)
        if res is None or res[0] != "fn":
            return [], [], False
        callee = res[1]
        sm = self.summary(callee)
        if not sm.payload_params and not sm.verb_params:
            return [], [], False
        names = callee.callable_params
        payloads, verb_heads = [], []
        for idx, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                continue
            if idx < len(names):
                if names[idx] in sm.payload_params:
                    payloads.append(arg)
                if names[idx] in sm.verb_params:
                    verb_heads.append(arg)
        for kw in call.keywords:
            if kw.arg in sm.payload_params:
                payloads.append(kw.value)
            if kw.arg in sm.verb_params:
                verb_heads.append(kw.value)
        return payloads, verb_heads, sm.does_recv

    # -- per-function environments -----------------------------------
    def _string_env(self, fn: FunctionInfo) -> Dict[str, Set[str]]:
        """Names bound to literal strings (incl. two-armed conditional
        expressions) inside ``fn`` — the ``verb = "episode" if g else
        "result"`` idiom."""
        env: Dict[str, Set[str]] = {}
        for node in _fn_nodes(fn):
            if not isinstance(node, ast.Assign):
                continue
            strs = self._expr_strings(node.value)
            if not strs:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    env.setdefault(tgt.id, set()).update(strs)
        return env

    @staticmethod
    def _expr_strings(expr) -> Set[str]:
        s = _const_str(expr)
        if s is not None:
            return {s}
        if isinstance(expr, ast.IfExp):
            body, orelse = _const_str(expr.body), _const_str(expr.orelse)
            if body is not None and orelse is not None:
                return {body, orelse}
        return set()

    def _table_env(self, fn: FunctionInfo) -> Dict[str, Set[str]]:
        """Names bound by unpacking a class verb-table entry:
        ``runner, reply_verb = self.roles[...]`` binds ``reply_verb``
        to the table's position-1 strings."""
        env: Dict[str, Set[str]] = {}
        if fn.cls_name is None:
            return env
        tables = self.verb_tables.get((fn.module.name, fn.cls_name), {})
        if not tables:
            return env
        for node in _fn_nodes(fn):
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Subscript):
                continue
            parts = dotted_parts(node.value.value)
            if parts is None or len(parts) != 2 or parts[0] != "self":
                continue
            table = tables.get(parts[1])
            if table is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Tuple):
                    for pos, el in enumerate(tgt.elts):
                        if isinstance(el, ast.Name) and pos in table:
                            env.setdefault(el.id, set()).update(
                                table[pos])
        return env

    def _return_verb_env(self, fn: FunctionInfo) -> Dict[str, Set[str]]:
        """Names bound as the HEAD of tuples unpacked from calls into
        functions with return-verb summaries: ``for verb, payload in
        pool.step():`` binds ``verb`` to step()'s literal verbs."""
        env: Dict[str, Set[str]] = {}
        instances = self._instance_env(fn)
        for node in _fn_nodes(fn):
            target = value = None
            if isinstance(node, (ast.For, ast.AsyncFor)):
                target, value = node.target, node.iter
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            if not isinstance(target, ast.Tuple) or not target.elts \
                    or not isinstance(value, ast.Call):
                continue
            verbs = self._call_return_verbs(fn, value, instances)
            head = target.elts[0]
            if verbs and isinstance(head, ast.Name):
                env.setdefault(head.id, set()).update(verbs)
        return env

    def _instance_env(self, fn: FunctionInfo) -> Dict[str,
                                                      Tuple[ModuleInfo,
                                                            str]]:
        """Local names known to hold instances of package classes:
        direct constructions and reads of tracked ``self.X``
        instance attributes."""
        env: Dict[str, Tuple[ModuleInfo, str]] = {}
        attrs = self.instance_attrs.get(
            (fn.module.name, fn.cls_name or ""), {})
        for node in _fn_nodes(fn):
            if not isinstance(node, ast.Assign):
                continue
            bound = None
            if isinstance(node.value, ast.Call):
                bound = self.resolve_class(fn.module, fn,
                                           node.value.func)
            else:
                parts = dotted_parts(node.value)
                if parts is not None and len(parts) == 2 \
                        and parts[0] == "self":
                    bound = attrs.get(parts[1])
            if bound is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    env[tgt.id] = bound
        return env

    def _call_return_verbs(self, fn, call: ast.Call, instances):
        """Return-verb summary of a call target, resolving instance
        methods (``pool.step()`` -> ``RolloutPool.step``)."""
        res = self.pkg.resolve_callee(fn.module, fn, call.func)
        if res is not None and res[0] == "fn":
            return self.summary(res[1]).return_verbs
        if isinstance(call.func, ast.Attribute) \
                and isinstance(call.func.value, ast.Name):
            inst = instances.get(call.func.value.id)
            if inst is not None:
                mod, cls = inst
                method = mod.classes.get(cls, {}).get(call.func.attr)
                if method is not None:
                    return self.summary(method).return_verbs
        return set()

    # -- pass 2: the protocol graph ----------------------------------
    def _collect_protocol_graph(self):
        for mod in self.pkg.modules.values():
            for fn in mod.functions:
                self._collect_sends(mod, fn)
                self._collect_handlers(mod, fn)

    def _head_verbs(self, head, strings, extra) -> Set[str]:
        s = _const_str(head)
        if s is not None:
            return {s}
        if isinstance(head, ast.Name):
            out = set()
            out |= strings.get(head.id, set())
            out |= extra.get(head.id, set())
            return out
        return set()

    def _tuple_head_verbs(self, fn, expr, strings, extra) -> Set[str]:
        """Verbs named by a ``(verb, payload)``-shaped expression (or a
        list of them)."""
        out: Set[str] = set()
        tuples = []
        if isinstance(expr, ast.Tuple) and len(expr.elts) >= 2:
            tuples = [expr]
        elif isinstance(expr, (ast.List, ast.Set)):
            tuples = [el for el in expr.elts
                      if isinstance(el, ast.Tuple) and len(el.elts) >= 2]
        for tup in tuples:
            out |= self._head_verbs(tup.elts[0], strings, extra)
        return out

    def _collect_sends(self, mod: ModuleInfo, fn: FunctionInfo):
        strings = self._string_env(fn)
        extra: Dict[str, Set[str]] = {}
        for env in (self._table_env(fn), self._return_verb_env(fn)):
            for k, v in env.items():
                extra.setdefault(k, set()).update(v)
        recv_bases = self._recv_bases(fn)
        for node in _fn_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            payloads: List[Tuple[ast.expr, bool]] = []
            direct = _is_send_attr_call(node)
            if direct is not None:
                direct = _strip_trace_codec(self.pkg, mod, fn, direct)
                base = dotted_parts(node.func.value)
                expects = bool(base) and tuple(base) in recv_bases
                payloads.append((direct, expects))
            wrap_payloads, verb_heads, wrap_reply = self._call_payloads(
                mod, fn, node)
            for expr in wrap_payloads:
                payloads.append((expr, wrap_reply))
            for head in verb_heads:
                for verb in self._head_verbs(head, strings, extra):
                    self.sends.append(SendSite(verb, mod, node,
                                               wrap_reply))
            for expr, expects in payloads:
                for verb in self._tuple_head_verbs(fn, expr, strings,
                                                   extra):
                    self.sends.append(SendSite(verb, mod, node, expects))

    @staticmethod
    def _recv_bases(fn: FunctionInfo) -> Set[Tuple[str, ...]]:
        """Dotted receiver chains ``X.recv()`` is called on inside this
        function — a send on the same chain is a round trip."""
        bases: Set[Tuple[str, ...]] = set()
        for node in _fn_nodes(fn):
            if isinstance(node, ast.Call) and _is_recv_attr_call(node):
                parts = dotted_parts(node.func.value)
                if parts:
                    bases.add(tuple(parts))
        return bases

    # -- handlers ----------------------------------------------------
    def _verb_vars(self, fn: FunctionInfo) -> Set[str]:
        """Names bound as the first element of a tuple unpacked from a
        recv-like call: ``verb, payload = conn.recv()`` and ``conn,
        (verb, payload) = self.recv(timeout=...)``."""
        out: Set[str] = set()

        def recv_like(value) -> bool:
            if not isinstance(value, ast.Call):
                return False
            # unwrap_trace(conn.recv()) is a recv for binding purposes
            value = _strip_trace_codec(self.pkg, fn.module, fn, value)
            if not isinstance(value, ast.Call):
                return False
            if isinstance(value.func, ast.Attribute) \
                    and value.func.attr in ("recv", "get"):
                return True
            sm = self._callee_summary(fn.module, fn, value.func)
            return sm is not None and sm.does_recv

        def bind(target):
            if not isinstance(target, ast.Tuple) or not target.elts:
                return
            nested = [el for el in target.elts
                      if isinstance(el, ast.Tuple)]
            if nested:
                # ``conn, (verb, payload) = hub.recv()``: the verb is
                # the nested tuple's head, not the outer conn
                for el in nested:
                    bind(el)
                return
            head = target.elts[0]
            if isinstance(head, ast.Name):
                out.add(head.id)

        for node in _fn_nodes(fn):
            if isinstance(node, ast.Assign) and recv_like(node.value):
                for tgt in node.targets:
                    bind(tgt)
            elif isinstance(node, (ast.For, ast.AsyncFor)) \
                    and recv_like(node.iter):
                bind(node.target)
        return out

    def _branch_replies(self, fn: FunctionInfo, body) -> Tuple[bool, bool]:
        """(contains_send, exits_without_fallthrough) of one handler
        branch: a send anywhere in the branch (transitively through
        called package functions) counts as a reply; ``continue`` /
        ``break`` / ``return`` mean the shared post-chain send is never
        reached."""
        sends = False
        exits = False

        def scan(node):
            nonlocal sends, exits
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, (ast.Continue, ast.Break, ast.Return)):
                exits = True
            if isinstance(node, ast.Call):
                if _is_send_attr_call(node) is not None:
                    sends = True
                else:
                    sm = self._callee_summary(fn.module, fn, node.func)
                    if sm is not None and sm.does_send:
                        sends = True
            for child in ast.iter_child_nodes(node):
                scan(child)

        for stmt in body:
            scan(stmt)
        return sends, exits

    def _collect_handlers(self, mod: ModuleInfo, fn: FunctionInfo):
        verb_vars = self._verb_vars(fn)
        if not verb_vars:
            return
        fn_sm = self.summary(fn)
        local_dicts = self._local_dispatch_dicts(fn)
        attr_dicts = self.attr_dicts.get(
            (mod.name, fn.cls_name or ""), {})
        for node in _fn_nodes(fn):
            # dict dispatch: handlers.get(verb) / handlers[verb]
            dict_node = None
            anchor = None
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" and node.args \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in verb_vars:
                dict_node = self._dispatch_dict(node.func.value,
                                                local_dicts, attr_dicts)
                anchor = node
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.slice, ast.Name) \
                    and node.slice.id in verb_vars:
                dict_node = self._dispatch_dict(node.value, local_dicts,
                                                attr_dicts)
                anchor = node
            if dict_node is not None:
                for key in dict_node.keys:
                    verb = _const_str(key)
                    if verb is not None:
                        self.handlers.append(HandlerSite(
                            verb, mod, key, "dict",
                            no_reply_path=not fn_sm.does_send))
                continue
            # branch dispatch: if verb == "x" / verb in ("x", "y")
            if isinstance(node, ast.If):
                for verb, test in self._branch_verbs(node.test,
                                                     verb_vars):
                    sends, exits = self._branch_replies(fn, node.body)
                    self.handlers.append(HandlerSite(
                        verb, mod, test, "branch",
                        no_reply_path=exits and not sends))

    @staticmethod
    def _local_dispatch_dicts(fn: FunctionInfo) -> Dict[str, ast.Dict]:
        out: Dict[str, ast.Dict] = {}
        for node in _fn_nodes(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Dict):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = node.value
        return out

    @staticmethod
    def _dispatch_dict(expr, local_dicts, attr_dicts) -> Optional[ast.Dict]:
        if isinstance(expr, ast.Name):
            return local_dicts.get(expr.id)
        parts = dotted_parts(expr)
        if parts is not None and len(parts) == 2 and parts[0] == "self":
            return attr_dicts.get(parts[1])
        return None

    @staticmethod
    def _branch_verbs(test, verb_vars) -> List[Tuple[str, ast.AST]]:
        """Literal verbs a branch test names: ``verb == "x"``,
        ``verb in ("x", "y")`` (also the reversed constant-first
        spelling)."""
        out: List[Tuple[str, ast.AST]] = []
        if not isinstance(test, ast.Compare) or len(test.ops) != 1:
            return out
        left, op, right = test.left, test.ops[0], test.comparators[0]
        if isinstance(op, ast.Eq):
            if isinstance(left, ast.Name) and left.id in verb_vars:
                s = _const_str(right)
                if s is not None:
                    out.append((s, test))
            elif isinstance(right, ast.Name) and right.id in verb_vars:
                s = _const_str(left)
                if s is not None:
                    out.append((s, test))
        elif isinstance(op, ast.In):
            if isinstance(left, ast.Name) and left.id in verb_vars \
                    and isinstance(right, (ast.Tuple, ast.List, ast.Set)):
                for el in right.elts:
                    s = _const_str(el)
                    if s is not None:
                        out.append((s, el))
        return out


def analyze_comm(package: Package) -> CommAnalysis:
    """Compute (or fetch the cached) protocol analysis of a package."""
    cached = getattr(package, "_commlint_analysis", None)
    if cached is None:
        cached = CommAnalysis(package)
        package._commlint_analysis = cached
    return cached
