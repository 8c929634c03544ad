"""commlint's rule registry: six control-plane protocol & concurrency rules.

Same shape as :mod:`.rules` and :mod:`.shardrules` — each rule is
``(Package, ModuleInfo) -> Iterable[Finding]`` under a stable
kebab-case id (what suppression comments name), registered in
``COMM_RULES`` and consuming the protocol graph of :mod:`.commlint`.
None of them import torch.

The rules, and the fleet-scale failure mode each one prevents:

  ``unhandled-verb``       a verb is sent but no receiver anywhere
                           handles it -> the request is silently
                           shrugged off (and a ``send_recv`` sender
                           wedges or gets a meaningless None).
  ``dead-handler``         a verb is handled but never sent -> dead
                           protocol surface that drifts unreviewed
                           until someone "revives" it wrongly.
  ``reply-mismatch``       a handler of a request/reply verb can
                           complete without replying -> the sender's
                           blocking recv never returns: a permanent
                           wedge only heartbeat eviction can break.
  ``unbounded-recv``       a blocking ``recv()``/``Queue.get()``/
                           ``accept()`` with no timeout and no sweep
                           protection -> one dead peer freezes the
                           thread forever, invisibly.
  ``unpicklable-payload``  a lock, file handle, lambda, or CUDA
                           tensor flows into a framed send -> pickle
                           raises at runtime (or, for CUDA tensors, a
                           hidden device->host transfer per send and
                           a peer that needs a card to unpickle).
  ``fork-unsafe``          a process is forked after threads started,
                           under a held lock, or in a module that
                           initializes CUDA -> child deadlocks on a
                           cloned lock or fails on its first CUDA
                           call; spawn contexts are the safe idiom and
                           stay quiet.
"""

import ast
from typing import Dict, List, Optional, Set, Tuple

from .astutil import ModuleInfo, Package, dotted_parts, launders_to_host
from .commlint import (
    FORK_CALLS,
    GET_CONTEXT_NAMES,
    HANDLE_PRODUCERS,
    LOCK_PRODUCERS,
    PROCESS_NAMES,
    module_initializes_cuda,
    THREAD_NAMES,
    CommAnalysis,
    _fn_nodes,
    _is_send_attr_call,
    analyze_comm,
)
from .rules import Finding, Rule

COMM_RULES: Dict[str, Rule] = {}


def comm_rule(rule_id: str, summary: str):
    def deco(fn):
        COMM_RULES[rule_id] = Rule(rule_id, summary, fn.__doc__ or "", fn)
        return fn
    return deco


# ---------------------------------------------------------------------
# unhandled-verb
# ---------------------------------------------------------------------

@comm_rule("unhandled-verb",
           "a verb is sent but no receiver in the package handles it")
def check_unhandled_verb(pkg: Package, mod: ModuleInfo):
    """Collects every literally-sent verb (direct ``(verb, payload)``
    tuples, send wrappers like ``send_recv``, role/verb tables, and
    return-verb summaries) and every handled verb (dispatch-dict keys,
    ``if verb == ...`` chains), package-wide.  A verb nobody handles is
    a request that dies in the receiver's else-branch at runtime — on
    a fleet, that surfaces as a wedged or silently idle worker, never
    as an error.  Dynamic dispatch the analyzer cannot resolve stays
    quiet (no literal, no finding).
    """
    an = analyze_comm(pkg)
    if not an.handlers:
        return  # no receivers in scope: nothing to check against
    for verb, sites in sorted(an.sent_verbs.items()):
        if verb in an.handled_verbs:
            continue
        for site in sites:
            if site.module is not mod:
                continue
            yield Finding(
                "unhandled-verb", mod.path, site.node.lineno,
                site.node.col_offset,
                f"verb '{verb}' is sent here but no receiver in the "
                f"package handles it — the request is silently "
                f"dropped at runtime")


# ---------------------------------------------------------------------
# dead-handler
# ---------------------------------------------------------------------

@comm_rule("dead-handler",
           "a verb is handled but nothing in the package ever sends it")
def check_dead_handler(pkg: Package, mod: ModuleInfo):
    """The inverse direction of the protocol graph: a dispatch entry or
    ``if verb == ...`` branch for a verb no send site (literal tuple,
    wrapper, verb table, or return-verb summary) ever produces.  Dead
    protocol surface rots: it is never exercised by tests, and a later
    "revival" from the sending side inherits stale semantics.  Packages
    with no send sites at all are skipped (a pure server linted alone).
    """
    an = analyze_comm(pkg)
    if not an.sends:
        return  # no senders in scope: nothing to check against
    for verb, sites in sorted(an.handled_verbs.items()):
        if verb in an.sent_verbs:
            continue
        for site in sites:
            if site.module is not mod:
                continue
            yield Finding(
                "dead-handler", mod.path, site.node.lineno,
                site.node.col_offset,
                f"verb '{verb}' is handled here but nothing in the "
                f"package ever sends it — dead protocol surface")


# ---------------------------------------------------------------------
# reply-mismatch
# ---------------------------------------------------------------------

@comm_rule("reply-mismatch",
           "a handler of a request/reply verb can complete without "
           "replying")
def check_reply_mismatch(pkg: Package, mod: ModuleInfo):
    """A verb sent through a send+recv round trip (``send_recv``, or
    any wrapper whose body both sends and recvs) blocks its sender
    until the reply lands.  A handler branch for such a verb that can
    ``continue``/``break``/``return`` without a send — or a dispatch
    loop that never sends after dispatching — leaves that sender
    blocked forever: a permanent wedge that only heartbeat eviction
    can break.  Handlers that fall through to a shared post-chain send
    are recognized and stay quiet, as are verbs only ever sent
    fire-and-forget.
    """
    an = analyze_comm(pkg)
    needs_reply = {verb for verb, sites in an.sent_verbs.items()
                   if any(s.expects_reply for s in sites)}
    for verb, sites in sorted(an.handled_verbs.items()):
        if verb not in needs_reply:
            continue
        for site in sites:
            if site.module is not mod or not site.no_reply_path:
                continue
            yield Finding(
                "reply-mismatch", mod.path, site.node.lineno,
                site.node.col_offset,
                f"verb '{verb}' is sent as a request/reply round trip "
                f"but this handler can complete without replying — "
                f"the sender's blocking recv wedges forever")


# ---------------------------------------------------------------------
# unbounded-recv
# ---------------------------------------------------------------------

def _bounded_wait(call: ast.Call, attr: str) -> bool:
    """Does this recv/get call carry an actual bound?  A ``timeout=``
    keyword always does.  Positional arguments are form-specific:
    ``get(block, timeout)`` is bounded, ``get(key)``/``get(key,
    default)`` is a dict read (not a wait), ``get(False)`` is
    non-blocking — but ``get(True)`` is the canonical forever-block,
    and a socket's ``recv(bufsize)`` positional is a BUFFER SIZE, not
    a timeout: neither may pass the gate."""
    if any(kw.arg == "timeout" for kw in call.keywords):
        return True
    if attr == "get":
        if len(call.args) >= 2:
            return True           # get(block, timeout) / get(k, dflt)
        if len(call.args) == 1:
            arg = call.args[0]
            return not (isinstance(arg, ast.Constant)
                        and arg.value is True)
    return False


def _class_is_swept(an: CommAnalysis, mod: ModuleInfo, fn) -> bool:
    """A class that participates in the heartbeat protocol (it defines
    a beat method) accepts blocked round trips by design: the learner's
    FleetRegistry sweep evicts it when the wedge outlives
    ``heartbeat_timeout``, so its blocking recv is bounded by the
    sweep, not by a local timeout."""
    cls = fn.cls_name
    probe = fn
    while cls is None and probe.parent is not None:
        probe = probe.parent
        cls = probe.cls_name
    if cls is None:
        return False
    methods = mod.classes.get(cls, {})
    return any("beat" in name for name in methods)


@comm_rule("unbounded-recv",
           "a blocking recv()/Queue.get()/accept() with no timeout and "
           "no sweep protection")
def check_unbounded_recv(pkg: Package, mod: ModuleInfo):
    """``conn.recv()``, ``queue.get()`` and ``sock.accept()`` with no
    timeout block the calling thread until the peer speaks — and a
    dead, wedged, or partitioned peer never does.  On a fleet that is
    an invisible freeze: no exception, no log line, one thread gone.
    Quiet when a timeout is passed, when the receiver (or its
    ``.sock`` — the framed-connection shape: ``conn.sock.settimeout``
    bounds ``conn.recv``) got a ``settimeout`` in the same function,
    and when the enclosing class
    participates in the heartbeat protocol (defines a beat method) —
    its wedges are bounded by the learner's FleetRegistry sweep, which
    evicts and respawns the peer.  Intentional blocking waits carry a
    suppression with the reason the wedge is bounded.
    """
    an = analyze_comm(pkg)
    for fn in mod.functions:
        swept = _class_is_swept(an, mod, fn)
        timeout_bases: Set[Tuple[str, ...]] = set()
        for node in _fn_nodes(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "settimeout":
                parts = dotted_parts(node.func.value)
                if parts:
                    timeout_bases.add(tuple(parts))
        for node in _fn_nodes(fn):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            if attr in ("recv", "get"):
                if _bounded_wait(node, attr) or swept:
                    continue
                if attr == "recv":
                    # a settimeout on the receiver — or on its .sock,
                    # the FramedConnection shape — in the same
                    # function bounds the recv: a silent peer raises
                    # socket.timeout instead of parking the thread
                    parts = tuple(dotted_parts(node.func.value) or ())
                    if parts and (parts in timeout_bases
                                  or parts + ("sock",) in timeout_bases):
                        continue
                what = ("blocking recv()" if attr == "recv"
                        else "blocking Queue.get()")
                yield Finding(
                    "unbounded-recv", mod.path, node.lineno,
                    node.col_offset,
                    f"{what} with no timeout — a dead or wedged peer "
                    f"freezes this thread forever; pass a timeout and "
                    f"loop, or bound the wedge by heartbeat sweep")
            elif attr == "accept" and not node.args:
                parts = dotted_parts(node.func.value)
                if parts and tuple(parts) in timeout_bases:
                    continue
                if swept:
                    continue
                yield Finding(
                    "unbounded-recv", mod.path, node.lineno,
                    node.col_offset,
                    "blocking accept() with no settimeout on the "
                    "listening socket — shutdown can never interrupt "
                    "this accept loop")


# ---------------------------------------------------------------------
# unpicklable-payload
# ---------------------------------------------------------------------

def _bad_value_env(pkg, mod, fn) -> Dict[str, str]:
    """Local names bound to values that must not cross a framed send:
    name -> human-readable kind."""
    env: Dict[str, str] = {}

    def producer_kind(value) -> Optional[str]:
        if isinstance(value, ast.Lambda):
            return "a lambda (unpicklable)"
        if not isinstance(value, ast.Call):
            return None
        name = pkg.full_name(mod, fn, value.func)
        if name in LOCK_PRODUCERS:
            return "a synchronization primitive (unpicklable)"
        if name in HANDLE_PRODUCERS:
            return "an OS-handle-backed object (unpicklable)"
        return None

    for node in _fn_nodes(fn):
        if isinstance(node, ast.Assign):
            kind = producer_kind(node.value)
            if kind is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    env[tgt.id] = kind
        elif isinstance(node, ast.With):
            for item in node.items:
                kind = producer_kind(item.context_expr)
                if kind is not None and isinstance(
                        item.optional_vars, ast.Name):
                    env[item.optional_vars.id] = kind
    return env


@comm_rule("unpicklable-payload",
           "a lock, file handle, lambda, or CUDA tensor flows "
           "into a framed send")
def check_unpicklable_payload(pkg: Package, mod: ModuleInfo):
    """The control plane frames payloads with pickle; a payload holding
    a lock, an open file/socket, or a lambda raises at send time — on
    the fleet, usually in a writer thread whose traceback nobody reads.
    A CUDA tensor pickles but does so through a hidden device->host
    transfer per send, and unpickling it in the peer needs a card
    there (a CPU worker raises) — ship host numpy instead, the
    ``.cpu().numpy()`` / ``tree_map(lambda t: t.cpu().numpy(), ...)``
    boundary every actor-facing path already uses.  Device facts come
    from the base rules' interprocedural device-taint lattice, so a
    tensor put on the card three calls away is still seen.
    """
    an = analyze_comm(pkg)
    for fn in mod.functions:
        env = _bad_value_env(pkg, mod, fn)
        device = set(fn.device_locals) | set(fn.device_params)
        for node in _fn_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            payloads = []
            direct = _is_send_attr_call(node)
            if direct is not None:
                payloads.append(direct)
            wrap_payloads, _heads, _reply = an._call_payloads(
                mod, fn, node)
            payloads.extend(wrap_payloads)
            for payload in payloads:
                yield from _scan_payload(pkg, mod, fn, payload, env,
                                         device)


def _scan_payload(pkg, mod, fn, payload, env, device):
    seen: Set[str] = set()
    findings: List[Finding] = []

    def scan(node):
        if isinstance(node, ast.Call) \
                and launders_to_host(pkg, mod, fn, node):
            # one shared definition of "what converts to host"
            # (astutil's lattice): everything below this call crosses
            # the wire as host data — conn.send(np.asarray(arr)) and
            # conn.send(tree_map(lambda t: t.cpu(), out)) both stay quiet
            return
        if isinstance(node, ast.Lambda):
            findings.append(Finding(
                "unpicklable-payload", mod.path, node.lineno,
                node.col_offset,
                "a lambda flows into a framed send — pickle cannot "
                "serialize it; ship data, not code"))
            return
        if isinstance(node, ast.Name) and node.id not in seen:
            seen.add(node.id)
            if node.id in env:
                findings.append(Finding(
                    "unpicklable-payload", mod.path, node.lineno,
                    node.col_offset,
                    f"'{node.id}' is {env[node.id]} and flows into a "
                    f"framed send — pickling it raises at runtime"))
            elif node.id in device:
                findings.append(Finding(
                    "unpicklable-payload", mod.path, node.lineno,
                    node.col_offset,
                    f"'{node.id}' is (or contains) a CUDA tensor "
                    f"and flows into a framed send — pickling it is a "
                    f"hidden device->host transfer per message; "
                    f"convert with .cpu().numpy() first"))
        for child in ast.iter_child_nodes(node):
            scan(child)

    scan(payload)
    return findings


# ---------------------------------------------------------------------
# fork-unsafe
# ---------------------------------------------------------------------

def _process_ctx_kind(an: CommAnalysis, mod, fn,
                      call: ast.Call) -> Optional[str]:
    """For a ``X.Process(...)``/``Process(...)`` call: the start-method
    kind — "spawn"/"fork"/"forkserver" for tracked contexts, "default"
    for a bare multiprocessing.Process (fork on Linux), None when the
    call is not a process constructor."""
    name = an.pkg.full_name(mod, fn, call.func)
    if name in PROCESS_NAMES:
        return "default"
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr == "Process":
        kind = an.context_kind(mod, fn, call.func.value)
        if kind is not None:
            return kind
        # an inline get_context("...").Process(...) chain
        base = call.func.value
        if isinstance(base, ast.Call):
            base_name = an.pkg.full_name(mod, fn, base.func)
            if base_name in GET_CONTEXT_NAMES and base.args:
                method = base.args[0]
                if isinstance(method, ast.Constant) \
                        and isinstance(method.value, str):
                    return method.value
    return None


@comm_rule("fork-unsafe",
           "a process is forked after threads started, under a held "
           "lock, or in a module that initializes CUDA")
def check_fork_unsafe(pkg: Package, mod: ModuleInfo):
    """``fork()`` clones exactly one thread and every held lock: a
    child forked after threads started (or inside a ``with lock:``)
    inherits locks whose owners no longer exist and deadlocks on first
    acquire.  And CUDA cannot be re-initialized in a forked child:
    once a module has created a CUDA context, a child forked from it
    fails on its first CUDA call.  Flags ``os.fork`` and fork-context (or
    bare, Linux-default-fork) ``multiprocessing.Process`` constructions
    in those three situations.  The safe idiom stays quiet: a
    ``get_context("spawn")`` context (tracked across modules, e.g.
    ``connection._mp``) starts children from a fresh interpreter.
    """
    an = analyze_comm(pkg)
    cuda_module = module_initializes_cuda(pkg, mod)
    for fn in mod.functions:
        thread_line = None
        lock_names: Set[str] = set()
        for node in _fn_nodes(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                name = pkg.full_name(mod, fn, node.value.func)
                if name in LOCK_PRODUCERS:
                    lock_names.update(
                        t.id for t in node.targets
                        if isinstance(t, ast.Name))
        held_lock_spans: List[Tuple[int, int]] = []
        for node in _fn_nodes(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Name) \
                            and expr.id in lock_names:
                        end = getattr(node, "end_lineno", node.lineno)
                        held_lock_spans.append((node.lineno, end))
        for node in _fn_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            name = pkg.full_name(mod, fn, node.func)
            if name in THREAD_NAMES:
                if thread_line is None:
                    thread_line = node.lineno
                continue
            is_fork_call = name in FORK_CALLS
            kind = _process_ctx_kind(an, mod, fn, node)
            if not is_fork_call and kind is None:
                continue
            if kind in ("spawn", "forkserver"):
                continue  # fresh interpreter: nothing is inherited
            what = "os.fork()" if is_fork_call else (
                "a fork-context Process" if kind == "fork"
                else "a default-context Process (fork on Linux)")
            if thread_line is not None and node.lineno > thread_line:
                yield Finding(
                    "fork-unsafe", mod.path, node.lineno,
                    node.col_offset,
                    f"{what} after threads started on line "
                    f"{thread_line} — the child inherits locks whose "
                    f"owner threads do not exist; use a spawn context")
                continue
            if any(lo <= node.lineno <= hi
                   for lo, hi in held_lock_spans):
                yield Finding(
                    "fork-unsafe", mod.path, node.lineno,
                    node.col_offset,
                    f"{what} while a lock is held — the child's clone "
                    f"of the lock is locked forever; spawn, or fork "
                    f"outside the critical section")
                continue
            if cuda_module:
                yield Finding(
                    "fork-unsafe", mod.path, node.lineno,
                    node.col_offset,
                    f"{what} in a module that initializes CUDA — a "
                    f"forked child cannot re-initialize it; use a "
                    f"spawn context (connection._mp)")
