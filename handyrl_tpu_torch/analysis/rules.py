"""torchlint's rule registry: the six base PyTorch/CUDA correctness rules.

Each rule is a function ``(Package, ModuleInfo) -> Iterable[Finding]``
registered under a stable kebab-case id (the id is what suppression
comments name).  Rules consume the package model + taint facts built
by :mod:`.astutil`; none of them import torch.

The rules, and the CUDA failure mode each one prevents:

  ``rng-reseed``      a generator reseeded from a loop-invariant value
                      inside a loop (every iteration draws the same
                      samples), or a sampling call with no
                      ``generator=`` (it draws from the global stream,
                      against the port's explicit-generator rule).
  ``tracer-branch``   Python ``if``/``while`` on a tensor value in code
                      that ``torch.compile`` traces or a CUDA graph
                      captures -> a graph break and a guard per branch
                      value, or a capture that bakes one branch in.
  ``host-sync``       ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                      ``float()`` / ``np.asarray()`` on device tensors,
                      or ``torch.cuda.synchronize()``, inside a loop ->
                      the host blocks on the card every iteration.
  ``inplace-alias``   a name bound to parameters, ``.data`` or
                      ``state_dict()`` without ``.clone()`` and read
                      after an in-place update of its source
                      (``optimizer.step()``, ``torch._foreach_*_``,
                      ``copy_``) -> a served or logged snapshot that
                      is torn by the update.
  ``retrace-risk``    ``torch.compile(f)(x)`` inline, or a compile or
                      graph capture built inside a loop -> a compile
                      or a capture on every call.
  ``debug-leftover``  ``breakpoint()`` / ``pdb.set_trace()`` /
                      anomaly detection left in production code.

:data:`JAX_TO_PORT` maps each rule id of the JAX package's linter to
its counterpart here: four base rules keep their id, two get a new one
because the bug class differs, and every rule of the other five
families keeps its id.
"""

import ast
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .astutil import (
    CAPTURE_BEGIN,
    GRAPH_BUILDERS,
    HOST_METHODS,
    JIT_WRAPPERS,
    SYNC_FNS,
    DeviceTaint,
    FunctionInfo,
    ModuleInfo,
    Package,
    TracerTaint,
    capture_nodes,
    dotted_parts,
    placement_of_call,
)

# JAX linter rule id -> port rule id, for every rule of the six
# families.  The ids of the other five families are unchanged.
JAX_TO_PORT: Dict[str, str] = {
    # base
    "host-sync": "host-sync",
    "tracer-branch": "tracer-branch",
    "retrace-risk": "retrace-risk",
    "debug-leftover": "debug-leftover",
    "prng-reuse": "rng-reseed",
    "donated-reuse": "inplace-alias",
    # shard
    "unknown-axis": "unknown-axis",
    "axis-reuse": "axis-reuse",
    "collective-mismatch": "collective-mismatch",
    "implicit-reshard": "implicit-reshard",
    "divergent-control": "divergent-control",
    "unsynced-divisibility": "unsynced-divisibility",
    # comm
    "unhandled-verb": "unhandled-verb",
    "dead-handler": "dead-handler",
    "reply-mismatch": "reply-mismatch",
    "unbounded-recv": "unbounded-recv",
    "unpicklable-payload": "unpicklable-payload",
    "fork-unsafe": "fork-unsafe",
    # race
    "unguarded-shared-write": "unguarded-shared-write",
    "non-atomic-rmw": "non-atomic-rmw",
    "live-container-iteration": "live-container-iteration",
    "lock-order-cycle": "lock-order-cycle",
    "blocking-under-lock": "blocking-under-lock",
    "leaked-lock": "leaked-lock",
    # num
    "implicit-upcast": "implicit-upcast",
    "weak-type-promotion": "weak-type-promotion",
    "lowp-accum": "lowp-accum",
    "unguarded-cast": "unguarded-cast",
    "dtype-split-brain": "dtype-split-brain",
    "nonfinite-risk": "nonfinite-risk",
    # leak
    "unreleased-resource": "unreleased-resource",
    "leak-on-error": "leak-on-error",
    "respawn-overwrite": "respawn-overwrite",
    "unjoined-thread": "unjoined-thread",
    "unlinked-shm": "unlinked-shm",
    "double-release": "double-release",
}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}"


@dataclass
class Rule:
    rule_id: str
    summary: str
    doc: str
    check: "object"


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, summary: str):
    def deco(fn):
        RULES[rule_id] = Rule(rule_id, summary, fn.__doc__ or "", fn)
        return fn
    return deco


# ---------------------------------------------------------------------
# shared walking helpers
# ---------------------------------------------------------------------

_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_COMP_NODES = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)
_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While)


def walk_with_context(mod: ModuleInfo) -> Iterator[Tuple[ast.AST,
                                                         Optional[FunctionInfo],
                                                         int]]:
    """Yield every node with its enclosing function and loop depth.

    Depths respect evaluation semantics: a ``for``'s iterable (and a
    comprehension's FIRST iterable) evaluates once, outside the loop it
    opens; a ``while`` test re-evaluates every iteration; comprehension
    element/filter expressions run once per item.  Nested function
    bodies restart the depth (they execute at their call site).
    The walk is cached on the module: every base rule reads it.
    """
    cached = getattr(mod, "_walk_with_context", None)
    if cached is not None:
        return iter(cached)
    out = []

    def child_of(node, scope, depth):
        child_scope = mod.by_node.get(node, scope)
        if isinstance(node, _FN_NODES):
            depth = 0
        out.append((node, child_scope, depth))
        descend(node, child_scope, depth)

    def descend(node, scope, depth):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            child_of(node.iter, scope, depth)        # evaluates once
            child_of(node.target, scope, depth + 1)
            for sub in node.body + node.orelse:
                child_of(sub, scope, depth + 1)
            return
        if isinstance(node, ast.While):
            child_of(node.test, scope, depth + 1)    # per iteration
            for sub in node.body + node.orelse:
                child_of(sub, scope, depth + 1)
            return
        if isinstance(node, _COMP_NODES):
            first = node.generators[0]
            child_of(first.iter, scope, depth)       # evaluates once
            child_of(first.target, scope, depth + 1)
            for cond in first.ifs:
                child_of(cond, scope, depth + 1)
            for gen in node.generators[1:]:
                for sub in ast.iter_child_nodes(gen):
                    child_of(sub, scope, depth + 1)
            for field in ("elt", "key", "value"):
                sub = getattr(node, field, None)
                if sub is not None:
                    child_of(sub, scope, depth + 1)
            return
        for sub in ast.iter_child_nodes(node):
            child_of(sub, scope, depth)

    descend(mod.tree, None, 0)
    mod._walk_with_context = out
    return iter(out)


def own_statements(fn: FunctionInfo) -> List[ast.stmt]:
    body = fn.node.body
    if isinstance(fn.node, ast.Lambda):
        return [ast.Expr(fn.node.body)]
    return body


def own_nodes(fn: FunctionInfo) -> Iterator[ast.AST]:
    """All nodes of ``fn``'s body, excluding nested function bodies
    (cached on ``fn``)."""
    cached = getattr(fn, "_own_nodes", None)
    if cached is None:
        cached = fn._own_nodes = list(_walk_own_nodes(fn))
    return iter(cached)


def _walk_own_nodes(fn: FunctionInfo) -> Iterator[ast.AST]:

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FN_NODES):
                continue
            yield child
            yield from walk(child)

    for stmt in own_statements(fn):
        yield stmt
        yield from walk(stmt)


def _tracer_eval(fn: FunctionInfo, pkg: Package) -> TracerTaint:
    ev = TracerTaint(fn, pkg)
    ev.tainted = set(fn.tracer_locals) | set(fn.tainted_params)
    return ev


def _device_eval(fn: FunctionInfo, pkg: Package) -> DeviceTaint:
    ev = DeviceTaint(fn, pkg)
    ev.tainted = set(fn.device_locals) | set(fn.device_params)
    ev.jit_names = dict(fn.jit_locals)
    return ev


def _capture_eval(fn: FunctionInfo, pkg: Package) -> DeviceTaint:
    """Device taint for a capture region's body: a CUDA graph records
    only work on the card, so the enclosing function's parameters
    count as device tensors there too."""
    ev = _device_eval(fn, pkg)
    ev.tainted |= set(fn.all_params) - {"self", "cls"}
    return ev


def _tainted_names(ev, expr) -> List[str]:
    names = []
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in ev.tainted \
                and node.id not in names:
            names.append(node.id)
    return names


def _stmt_exprs(stmt) -> List[ast.expr]:
    """The expressions evaluated by this statement itself (not by its
    nested sub-statements)."""
    out = []
    for field, value in ast.iter_fields(stmt):
        if isinstance(value, ast.expr):
            out.append(value)
        elif isinstance(value, list):
            out += [v for v in value if isinstance(v, ast.expr)]
    return out


def _as_dotted(expr) -> Optional[str]:
    """``name`` or ``self.attr`` (the state a function can rebind)."""
    if isinstance(expr, ast.Name):
        return expr.id
    parts = dotted_parts(expr)
    if parts is not None and len(parts) == 2 and parts[0] == "self":
        return f"self.{parts[1]}"
    return None


def _loads_in(node) -> Set[str]:
    names = set()
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)) \
                and isinstance(sub.ctx, ast.Load):
            d = _as_dotted(sub)
            if d is not None:
                names.add(d)
    return names


def _targets_in(stmt) -> Set[str]:
    nodes = []
    if isinstance(stmt, ast.Assign):
        nodes = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        nodes = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        nodes = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        nodes = [i.optional_vars for i in stmt.items
                 if i.optional_vars is not None]
    elif isinstance(stmt, _COMP_NODES):
        nodes = [g.target for g in stmt.generators]
    names = set()
    for tnode in nodes:
        for sub in ast.walk(tnode):
            d = _as_dotted(sub)
            if d is not None:
                names.add(d)
    for sub in ast.walk(stmt):
        if isinstance(sub, ast.NamedExpr):
            d = _as_dotted(sub.target)
            if d is not None:
                names.add(d)
    return names


# ---------------------------------------------------------------------
# rng-reseed
# ---------------------------------------------------------------------

_SEED_FNS = frozenset({
    "torch.manual_seed", "torch.random.manual_seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
})
_SAMPLING_FNS = frozenset({
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm",
    "torch.multinomial", "torch.bernoulli", "torch.normal",
    "torch.poisson",
})
_SAMPLING_METHODS = frozenset({
    "multinomial", "bernoulli", "normal_", "uniform_", "bernoulli_",
    "random_", "exponential_", "geometric_", "cauchy_", "log_normal_",
})
# calls that keep a seed expression a pure function of its inputs
_PURE_SEED_CALLS = frozenset({"int", "hash", "abs", "float", "str",
                              "len", "min", "max"})


@rule("rng-reseed",
      "a generator is reseeded from a loop-invariant value inside a "
      "loop, or a sampling call draws from the global stream")
def check_rng_reseed(pkg: Package, mod: ModuleInfo):
    """Two ways a torch random stream repeats or escapes its seed.  A
    ``torch.Generator``'s ``manual_seed`` (or ``torch.manual_seed``)
    called inside a loop with a value that does not change across its
    iterations restarts the stream every iteration, so every iteration
    draws the same samples — derive the seed from the loop variable,
    or seed once outside.  And a sampling call (``torch.rand*``,
    ``randint``, ``randperm``, ``multinomial``, ``bernoulli``,
    ``normal_``/``uniform_``) with no ``generator=`` draws from the
    process-global stream, which any other caller advances: the port
    passes an explicit generator to every draw so a seed reproduces a
    run.
    """
    for fn in mod.functions:
        yield from _check_rng_fn(pkg, mod, fn)


def _check_rng_fn(pkg: Package, mod: ModuleInfo, fn: FunctionInfo):
    findings = []
    generators: Set[str] = set()
    for node in own_nodes(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and pkg.full_name(mod, fn, node.value.func) \
                == "torch.Generator":
            for tgt in node.targets:
                d = _as_dotted(tgt)
                if d is not None:
                    generators.add(d)

    def is_reseed(call) -> bool:
        name = pkg.full_name(mod, fn, call.func)
        if name in _SEED_FNS:
            return True
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr == "manual_seed"):
            return False
        base = call.func.value
        if isinstance(base, ast.Call):  # torch.Generator().manual_seed(s)
            return pkg.full_name(mod, fn, base.func) == "torch.Generator"
        d = _as_dotted(base)
        return d in generators or "gen" in (d or "").lower()

    def invariant(expr, loop_assigned: Set[str]) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                name = pkg.full_name(mod, fn, sub.func)
                if name not in _PURE_SEED_CALLS:
                    return False
        return not (_loads_in(expr) & loop_assigned)

    def visit(node, loops: Tuple[ast.AST, ...]):
        if isinstance(node, _FN_NODES) and node is not fn.node:
            return
        if isinstance(node, ast.Call):
            if loops and is_reseed(node) and node.args:
                loop = loops[-1]
                assigned = set()
                for sub in ast.walk(loop):
                    if isinstance(sub, (ast.stmt,) + _COMP_NODES):
                        assigned |= _targets_in(sub)
                if invariant(node.args[0], assigned):
                    findings.append(Finding(
                        "rng-reseed", mod.path, node.lineno,
                        node.col_offset,
                        "generator reseeded inside a loop from a value "
                        "that does not change across iterations — every "
                        "iteration draws the same samples; seed once "
                        "outside the loop or fold the loop index in"))
            name = pkg.full_name(mod, fn, node.func)
            sampling = name in _SAMPLING_FNS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SAMPLING_METHODS
                and not (name or "").startswith(("numpy.", "random.")))
            if sampling and not any(kw.arg == "generator"
                                    for kw in node.keywords):
                label = name.rsplit(".", 1)[-1] if name \
                    else node.func.attr
                findings.append(Finding(
                    "rng-reseed", mod.path, node.lineno, node.col_offset,
                    f"{label}() with no generator= draws from the "
                    f"process-global stream — pass the run's "
                    f"torch.Generator so the seed reproduces the draw"))
        inner = loops
        if isinstance(node, _LOOP_NODES + _COMP_NODES):
            inner = loops + (node,)
        for child in ast.iter_child_nodes(node):
            if isinstance(node, (ast.For, ast.AsyncFor)) \
                    and child is node.iter:
                visit(child, loops)  # the iterable evaluates once
            else:
                visit(child, inner)

    for stmt in own_statements(fn):
        visit(stmt, ())
    return findings


# ---------------------------------------------------------------------
# tracer-branch
# ---------------------------------------------------------------------

@rule("tracer-branch",
      "Python if/while branches on a tensor value inside compiled or "
      "captured code")
def check_tracer_branch(pkg: Package, mod: ModuleInfo):
    """Inside functions reachable from a ``torch.compile`` entry point
    or a CUDA-graph capture region, a Python ``if``/``while``/
    conditional expression whose test involves a tensor value forces
    a graph break and a guard per branch value under ``torch.compile``,
    and under a CUDA-graph capture it either fails (the test syncs) or
    silently bakes one branch into the replayed graph.  Shape/dtype/
    None guards (``x.shape[0] > 1``, ``x is None``) are static and
    stay quiet; use ``torch.where`` for value-dependent selection.
    """
    for fn in mod.functions:
        if not fn.jit_reachable:
            continue
        ev = _tracer_eval(fn, pkg)
        yield from _branch_findings(mod, own_nodes(fn), ev,
                                    "compiled or captured code")
    captured = capture_nodes(pkg, mod)
    if captured:
        evals: Dict[FunctionInfo, DeviceTaint] = {}
        nodes = []
        for node, scope, _depth in walk_with_context(mod):
            if id(node) in captured and scope is not None \
                    and not scope.jit_reachable:
                nodes.append((node, scope))
        for node, scope in nodes:
            ev = evals.get(scope)
            if ev is None:
                ev = evals[scope] = _capture_eval(scope, pkg)
            yield from _branch_findings(mod, [node], ev,
                                        "a CUDA-graph capture region")


def _branch_findings(mod, nodes, ev, where):
    for node in nodes:
        test = None
        kind = None
        if isinstance(node, (ast.If, ast.While)):
            test, kind = node.test, (
                "if" if isinstance(node, ast.If) else "while")
        elif isinstance(node, ast.IfExp):
            test, kind = node.test, "conditional expression"
        elif isinstance(node, ast.comprehension):
            for cond in node.ifs:
                if ev.taint(cond):
                    yield Finding(
                        "tracer-branch", mod.path, cond.lineno,
                        cond.col_offset,
                        f"comprehension filter on a tensor value "
                        f"inside {where}")
            continue
        if test is None or not ev.taint(test):
            continue
        names = _tainted_names(ev, test)
        what = f" ({', '.join(names)})" if names else ""
        yield Finding(
            "tracer-branch", mod.path, test.lineno, test.col_offset,
            f"Python {kind} branches on a tensor value{what} inside "
            f"{where} — use torch.where, or branch on shapes only")


# ---------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------

_SYNC_CASTS = frozenset({"float", "int", "bool", "complex"})
_NP_SINKS = frozenset({"numpy.asarray", "numpy.array"})


def _host_copy_base(call: ast.Call) -> Optional[ast.expr]:
    """``t.item()`` / ``t.tolist()`` / ``t.cpu()`` / ``t.numpy()`` /
    blocking ``t.to("cpu")`` -> ``t``, else None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    if any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
           and kw.value.value for kw in call.keywords):
        return None
    attr = call.func.attr
    if attr in HOST_METHODS and not call.args:
        return call.func.value
    if attr == "to" and placement_of_call(call) == "host":
        return call.func.value
    return None


@rule("host-sync",
      "a device tensor is synced to the host inside a loop (or inside "
      "compiled or captured code)")
def check_host_sync(pkg: Package, mod: ModuleInfo):
    """``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``float()``/``int()``/``bool()`` and ``np.asarray()`` on a tensor
    on the card block the host until the card has drained its queue
    and copied the value back, and ``torch.cuda.synchronize()`` blocks
    outright.  Once per epoch that is fine; inside a loop (including
    comprehensions) it serializes the hot path — keep the values on
    the card and copy them once.  Inside compiled or captured code the
    same calls break the graph or fail the capture, and are flagged at
    any depth.
    """
    evals: Dict[FunctionInfo, DeviceTaint] = {}
    tracer_evals: Dict[FunctionInfo, TracerTaint] = {}
    captured = capture_nodes(pkg, mod)
    for node, scope, depth in walk_with_context(mod):
        if not isinstance(node, ast.Call) or scope is None:
            continue
        ev = evals.get(scope)
        if ev is None:
            ev = evals[scope] = _device_eval(scope, pkg)
        name = pkg.full_name(mod, scope, node.func)
        in_capture = id(node) in captured
        in_jit = scope.jit_reachable or in_capture
        tev = _capture_eval(scope, pkg) if in_capture else None
        if scope.jit_reachable:
            tev = tracer_evals.get(scope)
            if tev is None:
                tev = tracer_evals[scope] = _tracer_eval(scope, pkg)

        def hit(evaluator, expr) -> bool:
            return evaluator is not None and evaluator.taint(expr)

        if name in SYNC_FNS:
            if depth > 0:
                yield Finding(
                    "host-sync", mod.path, node.lineno, node.col_offset,
                    "torch.cuda.synchronize() inside a loop — the host "
                    "waits for the card every iteration")
            elif in_jit:
                yield Finding(
                    "host-sync", mod.path, node.lineno, node.col_offset,
                    "torch.cuda.synchronize() inside compiled or "
                    "captured code")
            continue
        if name in _SYNC_CASTS or name in _NP_SINKS:
            label = name.replace("numpy.", "np.")
            if depth > 0 and any(ev.taint(a) for a in node.args):
                yield Finding(
                    "host-sync", mod.path, node.lineno, node.col_offset,
                    f"{label}() on a device tensor inside a loop — each "
                    f"call blocks on a device->host copy; keep the "
                    f"values on the card and copy them once")
            elif in_jit and any(hit(tev, a) for a in node.args):
                yield Finding(
                    "host-sync", mod.path, node.lineno, node.col_offset,
                    f"{label}() on a tensor inside compiled or captured "
                    f"code — a graph break, or a failed capture")
            continue
        base = _host_copy_base(node)
        if base is None:
            continue
        what = f".{node.func.attr}()"
        if depth > 0 and ev.taint(base):
            yield Finding(
                "host-sync", mod.path, node.lineno, node.col_offset,
                f"{what} on a device tensor inside a loop — each call "
                f"is a blocking device->host sync")
        elif in_jit and hit(tev, base):
            yield Finding(
                "host-sync", mod.path, node.lineno, node.col_offset,
                f"{what} on a tensor inside compiled or captured code")


def host_sync_sites(pkg: Package, mod: ModuleInfo):
    """``(line, loop depth, function, call)`` for every device->host
    copy or sync of the module that the device lattice sees, in a loop
    or not: the static list a measured per-epoch sync count is read
    against (``host-sync`` flags the ones inside loops)."""
    evals: Dict[FunctionInfo, DeviceTaint] = {}
    for node, scope, depth in walk_with_context(mod):
        if not isinstance(node, ast.Call) or scope is None:
            continue
        ev = evals.get(scope)
        if ev is None:
            ev = evals[scope] = _device_eval(scope, pkg)
        name = pkg.full_name(mod, scope, node.func)
        if name in SYNC_FNS:
            hit = True
        elif name in _SYNC_CASTS or name in _NP_SINKS:
            hit = any(ev.taint(a) for a in node.args)
        else:
            base = _host_copy_base(node)
            hit = base is not None and ev.taint(base)
        if hit:
            yield (node.lineno, depth, scope.qname.rsplit(":", 1)[-1],
                   name or f".{node.func.attr}()")


# ---------------------------------------------------------------------
# inplace-alias
# ---------------------------------------------------------------------

_ALIAS_METHODS = frozenset({"state_dict", "parameters", "named_parameters",
                            "buffers", "named_buffers"})
_SNAPSHOT_METHODS = frozenset({"clone", "copy", "deepcopy"})
_SNAPSHOT_FNS = frozenset({"copy.deepcopy", "torch.clone", "numpy.array",
                           "numpy.copy", "torch.tensor"})
_ALL_SOURCES = "*"


def _root(expr) -> Optional[str]:
    """The dotted state a weight expression hangs off: ``model``,
    ``self.model`` or ``self.trainer.model`` (subscripts and ``.data``
    stripped)."""
    while isinstance(expr, ast.Subscript) or (
            isinstance(expr, ast.Attribute) and expr.attr == "data"):
        expr = expr.value
    parts = dotted_parts(expr)
    return ".".join(parts) if parts else None


@rule("inplace-alias",
      "a weight alias (no .clone()) is read after an in-place update "
      "of its source")
def check_inplace_alias(pkg: Package, mod: ModuleInfo):
    """``module.state_dict()``, ``module.parameters()`` and ``.data``
    return the live storage of the weights, not a copy.  The optimizer
    updates that storage in place (``optimizer.step()``,
    ``torch._foreach_*_``, ``copy_``, ``load_state_dict``), so a name
    bound before the update and read after it — logged, sent to a
    worker, served — sees the new weights, or a mix of old and new
    while the update runs on another stream.  Snapshot with
    ``.clone()`` (or ``copy.deepcopy``) where the name is bound, or
    bind it after the update.  In a loop that updates the source, a
    read of an alias bound before the loop sees the previous
    iteration's update.
    """
    for fn in mod.functions:
        if not isinstance(fn.node, ast.Lambda):
            yield from _check_inplace_fn(pkg, mod, fn)


def _check_inplace_fn(pkg: Package, mod: ModuleInfo, fn: FunctionInfo):
    findings = []
    aliases: Dict[str, str] = {}   # alias name -> source root
    stale: Dict[str, int] = {}     # alias name -> line of the update
    reported: Set[str] = set()
    optimizers: Set[str] = set()
    for node in own_nodes(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = pkg.full_name(mod, fn, node.value.func) or ""
            if name.startswith("torch.optim."):
                for tgt in node.targets:
                    d = _root(tgt)
                    if d is not None:
                        optimizers.add(d)

    def snapshots(expr) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                if isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in _SNAPSHOT_METHODS:
                    return True
                if pkg.full_name(mod, fn, sub.func) in _SNAPSHOT_FNS:
                    return True
        return False

    def alias_source(expr) -> Optional[str]:
        if expr is None or snapshots(expr):
            return None
        for sub in ast.walk(expr):
            if isinstance(sub, _FN_NODES):
                return None
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _ALIAS_METHODS:
                return _root(sub.func.value)
            if isinstance(sub, ast.Attribute) and sub.attr == "data" \
                    and isinstance(sub.ctx, ast.Load):
                return _root(sub.value)
        return None

    def updates_in(expr) -> List[Tuple[str, ast.Call]]:
        out = []
        for sub in ast.walk(expr):
            if isinstance(sub, _FN_NODES) or not isinstance(sub, ast.Call):
                continue
            name = pkg.full_name(mod, fn, sub.func) or ""
            if name.startswith("torch._foreach_") and name.endswith("_"):
                first = sub.args[0] if sub.args else None
                src = None
                if isinstance(first, ast.Name) and first.id in aliases:
                    src = aliases[first.id]
                elif first is not None:
                    src = _root(first)
                out.append((src or _ALL_SOURCES, sub))
                continue
            if not isinstance(sub.func, ast.Attribute):
                continue
            attr = sub.func.attr
            base = _root(sub.func.value)
            if attr == "step" and base is not None and (
                    base in optimizers
                    or "opt" in base.rsplit(".", 1)[-1].lower()):
                out.append((_ALL_SOURCES, sub))
            elif base is not None and (
                    attr == "load_state_dict"
                    or (attr.endswith("_") and not attr.startswith("_"))):
                out.append((base, sub))
        return out

    def matches(src: str, alias: str) -> bool:
        if src == _ALL_SOURCES:
            return True
        source = aliases.get(alias)
        return src == source or src == alias

    def process_block(stmts):
        """Returns (updates, assigned names, first load line per name)."""
        block_updates: List[Tuple[str, ast.Call]] = []
        block_assigns: Set[str] = set()
        block_loads: Dict[str, int] = {}
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            sub_stmts = [s for f in ("body", "orelse", "finalbody")
                         for s in (getattr(stmt, f, None) or [])
                         if isinstance(s, ast.stmt)]
            if isinstance(stmt, ast.Try):
                for handler in stmt.handlers:
                    sub_stmts += handler.body
            exprs = _stmt_exprs(stmt) if sub_stmts else [stmt]
            # 1. reads of aliases whose source was updated in place
            loads: Set[str] = set()
            for expr in exprs:
                loads |= _loads_in(expr)
            for name in sorted(loads):
                block_loads.setdefault(name, stmt.lineno)
                if name in stale and name not in reported:
                    reported.add(name)
                    findings.append(Finding(
                        "inplace-alias", mod.path, stmt.lineno,
                        stmt.col_offset,
                        f"'{name}' aliases the live weights of "
                        f"'{aliases.get(name, '?')}', which were updated "
                        f"in place on line {stale[name]} — it reads the "
                        f"updated (or half-updated) values; .clone() it "
                        f"where it is bound"))
            # 2. nested blocks (loops see their own updates twice; the
            # branches of an ``if`` each start from the state before it)
            if isinstance(stmt, ast.If):
                before = dict(stale)
                body_up, body_asn, body_loads = process_block(stmt.body)
                after_body = dict(stale)
                stale.clear()
                stale.update(before)
                else_up, else_asn, else_loads = process_block(stmt.orelse)
                for name, line in after_body.items():
                    stale.setdefault(name, line)
                block_updates += body_up + else_up
                block_assigns |= body_asn | else_asn
                for name, line in list(body_loads.items()) \
                        + list(else_loads.items()):
                    block_loads.setdefault(name, line)
                sub_stmts = []
            if sub_stmts:
                sub_up, sub_asn, sub_loads = process_block(sub_stmts)
                if isinstance(stmt, _LOOP_NODES):
                    for src, call in sub_up:
                        for alias in sorted(aliases):
                            if alias in sub_loads and alias not in sub_asn \
                                    and alias not in reported \
                                    and matches(src, alias):
                                reported.add(alias)
                                findings.append(Finding(
                                    "inplace-alias", mod.path,
                                    sub_loads[alias], 0,
                                    f"'{alias}' is read inside a loop "
                                    f"that updates the weights it "
                                    f"aliases in place (line "
                                    f"{call.lineno}) — from the second "
                                    f"iteration on it reads updated "
                                    f"values; .clone() it where it is "
                                    f"bound"))
                block_updates += sub_up
                block_assigns |= sub_asn
                for name, line in sub_loads.items():
                    block_loads.setdefault(name, line)
            # 3. this statement's own in-place updates
            own_updates = []
            for expr in exprs:
                own_updates += updates_in(expr)
            for src, call in own_updates:
                for alias in list(aliases):
                    if matches(src, alias) and alias not in stale:
                        stale[alias] = call.lineno
            block_updates += own_updates
            # 4. bindings
            assigned = _targets_in(stmt)
            block_assigns |= assigned
            value = getattr(stmt, "value", None) \
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)) else None
            for name in assigned:
                stale.pop(name, None)
                src = alias_source(value) if value is not None else None
                if src is not None and isinstance(stmt, ast.Assign) \
                        and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    aliases[name] = src
                else:
                    aliases.pop(name, None)
        return block_updates, block_assigns, block_loads

    process_block(own_statements(fn))
    return findings


# ---------------------------------------------------------------------
# retrace-risk
# ---------------------------------------------------------------------

@rule("retrace-risk",
      "a compile or graph-capture pattern that recompiles or recaptures "
      "on every call")
def check_retrace_risk(pkg: Package, mod: ModuleInfo):
    """Flags (a) ``torch.compile(f)(x)`` compiled inline — the compiled
    callable dies with the expression, so every execution pays the
    compile again; (b) ``torch.compile`` / ``torch.jit.script`` /
    ``make_graphed_callables`` created inside a loop — the same
    failure, one fresh wrapper and cache per iteration; (c) a CUDA
    graph built or captured inside a loop (``torch.cuda.CUDAGraph()``,
    ``with torch.cuda.graph(g)``, ``g.capture_begin()``) — a capture
    per iteration instead of one capture and many replays.  Build
    once, outside, and call or replay inside.
    """
    for node, scope, depth in walk_with_context(mod):
        if not isinstance(node, ast.Call):
            continue
        name = pkg.full_name(mod, scope, node.func)
        if depth > 0 and name in JIT_WRAPPERS:
            yield Finding(
                "retrace-risk", mod.path, node.lineno, node.col_offset,
                f"{name.rsplit('.', 1)[-1]} called inside a loop — each "
                f"iteration builds a fresh compiled callable and cache; "
                f"build it once outside")
        elif depth > 0 and (name in GRAPH_BUILDERS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == CAPTURE_BEGIN)):
            yield Finding(
                "retrace-risk", mod.path, node.lineno, node.col_offset,
                "CUDA graph built or captured inside a loop — capture "
                "once outside and replay() inside")
        if isinstance(node.func, ast.Call):
            inner = pkg.full_name(mod, scope, node.func.func)
            if inner in JIT_WRAPPERS:
                yield Finding(
                    "retrace-risk", mod.path, node.lineno,
                    node.col_offset,
                    f"{inner.rsplit('.', 1)[-1]}(...)(...) compiles "
                    f"inline and discards the compiled callable — every "
                    f"call compiles again; bind it once")


# ---------------------------------------------------------------------
# debug-leftover
# ---------------------------------------------------------------------

_DEBUG_CALLS = frozenset({
    "breakpoint", "pdb.set_trace", "ipdb.set_trace",
    "torch.autograd.detect_anomaly",
    "torch.autograd.anomaly_mode.detect_anomaly",
})
_ANOMALY_SWITCHES = frozenset({
    "torch.autograd.set_detect_anomaly",
    "torch.autograd.anomaly_mode.set_detect_anomaly",
})


@rule("debug-leftover",
      "a debugging call (breakpoint / anomaly detection) left in "
      "production code")
def check_debug_leftover(pkg: Package, mod: ModuleInfo):
    """``breakpoint()``/``pdb.set_trace()`` hang headless runs, and
    ``torch.autograd.detect_anomaly()`` /
    ``set_detect_anomaly(True)`` re-run every backward with stack
    capture and a NaN check per op, a several-fold slowdown.  Fine
    while debugging; never in merged code.
    """
    for node, scope, _depth in walk_with_context(mod):
        if not isinstance(node, ast.Call):
            continue
        name = pkg.full_name(mod, scope, node.func)
        if name in _ANOMALY_SWITCHES:
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and not arg.value:
                continue  # switching it off is not a leftover
        elif name not in _DEBUG_CALLS:
            continue
        yield Finding(
            "debug-leftover", mod.path, node.lineno, node.col_offset,
            f"leftover {name}() — remove before merging")
