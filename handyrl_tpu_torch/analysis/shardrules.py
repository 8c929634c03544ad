"""shardlint's rule registry: six mesh/collective-consistency rules.

Same shape as :mod:`.rules` — each rule is ``(Package, ModuleInfo) ->
Iterable[Finding]`` under a stable kebab-case id (what suppression
comments name), registered in ``SHARD_RULES`` and consuming the
package-level facts of :mod:`.shardlint`.  None of them import torch.

The rules, and the multi-rank failure mode each one prevents:

  ``unknown-axis``          an axis name in ``mesh["x"]``,
                            ``mesh.get_group(...)``, ``axis_size(mesh,
                            "x")`` or ``AXES.index("x")`` that no
                            constructed ``DeviceMesh`` declares -> a
                            KeyError/ValueError at the first multi-rank
                            launch, never on a one-rank test.
  ``axis-reuse``            a placements tuple that shards one tensor
                            dim on two mesh dims, or whose length
                            differs from the mesh's ndim -> a layout
                            the port's ``Layout.spec`` cannot express
                            (one axis silently dropped), or a DTensor
                            error at placement time.
  ``collective-mismatch``   a collective with no ``group=`` (WORLD)
                            under a mesh of more than one axis, or a
                            reduction over the group of an axis the
                            data is replicated on -> the sum counts
                            every replica: values multiplied by the
                            axis size.
  ``implicit-reshard``      a tensor placed (``distribute_tensor`` /
                            ``from_local`` / ``redistribute``) other
                            than the ``in_placements`` of the
                            ``local_map`` step it feeds -> a silent
                            redistribution copy per call: the static
                            twin of ``ShardingContractGuard``.
  ``divergent-control``     rank-dependent values (``dist.get_rank()``,
                            ``rank == 0``, ``self.primary``) deciding
                            whether (or in what order) a collective
                            runs -> a hang: one rank waits in a
                            collective its peers never enter.
  ``unsynced-divisibility`` a ``Shard(d)`` placement, or a split of a
                            dim by an axis size (the sp time split),
                            with no static ``%`` guard in sight ->
                            uneven shards that only appear at real axis
                            sizes.
"""

import ast
from typing import Dict, Set

from .astutil import ModuleInfo, Package, _walk_calls, dotted_parts
from .rules import Finding, Rule, own_nodes
from .shardlint import (
    COLLECTIVES,
    PLACING_CALLS,
    REDUCING_COLLECTIVES,
    UNKNOWN_AXES,
    ShardJit,
    analyze,
)

SHARD_RULES: Dict[str, Rule] = {}


def shard_rule(rule_id: str, summary: str):
    def deco(fn):
        SHARD_RULES[rule_id] = Rule(rule_id, summary, fn.__doc__ or "", fn)
        return fn
    return deco


def _module_calls(mod: ModuleInfo):
    """Every call in the module with its enclosing FunctionInfo."""
    return _walk_calls(mod)


def _is_mesh_expr(expr) -> bool:
    parts = dotted_parts(expr)
    return bool(parts) and "mesh" in parts[-1].lower()


def _axis_name_sites(pkg: Package, an, mod: ModuleInfo):
    """``(axis, node)`` for every literal axis name the module uses."""
    seen: Set[int] = set()

    def emit(axis, node):
        if id(node) not in seen:
            seen.add(id(node))
            yield axis, node

    for scope, call in _module_calls(mod):
        name = pkg.full_name(mod, scope, call.func) or ""
        arg = an.group_axis_exprs(call)
        if arg is not None and isinstance(arg, ast.Constant) \
                and isinstance(arg.value, str):
            yield from emit(arg.value, arg)
        if name.rsplit(".", 1)[-1] == "axis_size" \
                and len(call.args) >= 2 \
                and isinstance(call.args[1], ast.Constant) \
                and isinstance(call.args[1].value, str):
            yield from emit(call.args[1].value, call.args[1])
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "index" and call.args \
                and an.is_axis_tuple(mod, call.func.value) \
                and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            yield from emit(call.args[0].value, call.args[0])
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Subscript) and _is_mesh_expr(node.value):
            keys = node.slice.elts if isinstance(node.slice, ast.Tuple) \
                else [node.slice]
            for key in keys:
                if isinstance(key, ast.Constant) \
                        and isinstance(key.value, str):
                    yield from emit(key.value, key)


# ---------------------------------------------------------------------
# unknown-axis
# ---------------------------------------------------------------------

@shard_rule("unknown-axis",
            "an axis name that no constructed DeviceMesh declares")
def check_unknown_axis(pkg: Package, mod: ModuleInfo):
    """Collects the package's declared mesh axes from every
    ``DeviceMesh(..., mesh_dim_names=...)`` /
    ``init_device_mesh(..., mesh_dim_names=...)`` construction
    (chasing module-level axis-tuple constants like ``AXES``), then
    requires every literal axis name in ``mesh["x"]``,
    ``mesh.get_group("x")``, ``axis_size(mesh, "x")`` and
    ``AXES.index("x")`` to name one of them.  A stray axis name passes
    every one-rank test that never builds the sub-group and fails at
    the first multi-rank launch.  Packages that build no mesh are
    skipped — there is nothing to check against.
    """
    an = analyze(pkg)
    if an.mesh_axes is None:
        return
    for axis, node in _axis_name_sites(pkg, an, mod):
        if axis not in an.mesh_axes:
            yield Finding(
                "unknown-axis", mod.path, node.lineno, node.col_offset,
                f"axis '{axis}' is not an axis of the constructed mesh, "
                f"which only declares {sorted(an.mesh_axes)}")


# ---------------------------------------------------------------------
# axis-reuse
# ---------------------------------------------------------------------

@shard_rule("axis-reuse",
            "a placements tuple shards one tensor dim twice, or does not "
            "match the mesh's ndim")
def check_axis_reuse(pkg: Package, mod: ModuleInfo):
    """A placements tuple has one entry per mesh dim.  ``(Shard(0),
    Shard(0))`` splits tensor dim 0 over two mesh dims at once: DTensor
    accepts it as a nested split, but the port's layout contract
    (``Layout.spec``, one mesh axis per tensor dim, the JAX
    PartitionSpec) keeps only one of the two axes, so the declared and
    the real layouts part.  A tuple whose length differs from the
    mesh's number of axes is rejected by DTensor at placement time —
    at first multi-rank launch.
    """
    an = analyze(pkg)
    for node, scope in _placement_tuples(pkg, an, mod):
        fact = an.placements_literal(mod, scope, node)
        if fact is None or fact.sig is None:
            continue
        elts = node.elts if isinstance(node, (ast.Tuple, ast.List)) \
            else [node] * len(fact.sig)
        seen: Set[int] = set()
        for entry, el in zip(fact.sig, elts):
            if entry[0] != "S":
                continue
            if entry[1] in seen:
                yield Finding(
                    "axis-reuse", mod.path, el.lineno, el.col_offset,
                    f"tensor dim {entry[1]} is sharded on two mesh dims "
                    f"in one placements tuple — a mesh axis per tensor "
                    f"dim")
                break
            seen.add(entry[1])
        if an.mesh_order is not None \
                and len(fact.sig) != len(an.mesh_order):
            yield Finding(
                "axis-reuse", mod.path, node.lineno, node.col_offset,
                f"placements tuple has {len(fact.sig)} entries but the "
                f"mesh has {len(an.mesh_order)} axes "
                f"{list(an.mesh_order)}")


def _placement_tuples(pkg, an, mod):
    """Every tuple/list literal made only of placement calls, and every
    ``(...) * n`` repetition of one (its operand tuple is then judged
    as part of the repetition, not alone)."""
    out = []
    repeated: Set[int] = set()
    nodes = _nodes_with_scope(mod)
    for node, scope in nodes:
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult) \
                and an.placements_literal(mod, scope, node) is not None:
            repeated.add(id(node.left))
            out.append((node, scope))
    for node, scope in nodes:
        if isinstance(node, (ast.Tuple, ast.List)) and node.elts \
                and id(node) not in repeated \
                and an.placements_literal(mod, scope, node) is not None:
            out.append((node, scope))
    return out


def _nodes_with_scope(mod: ModuleInfo):
    out = []

    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            child_scope = mod.by_node.get(child, scope)
            out.append((child, child_scope))
            walk(child, child_scope)

    walk(mod.tree, None)
    return out


# ---------------------------------------------------------------------
# collective-mismatch
# ---------------------------------------------------------------------

def _group_expr(name: str, call: ast.Call):
    """The ``group`` argument of a collective call; ``False`` when the
    call passes none (WORLD)."""
    for kw in call.keywords:
        if kw.arg == "group":
            if isinstance(kw.value, ast.Constant) and kw.value.value is None:
                return False
            return kw.value
    pos = COLLECTIVES.get(name)
    if pos is not None and len(call.args) > pos:
        return call.args[pos]
    return False


@shard_rule("collective-mismatch",
            "a collective over WORLD under a multi-axis mesh, or a "
            "reduction over an axis the data is replicated on")
def check_collective_mismatch(pkg: Package, mod: ModuleInfo):
    """Two ways a collective and its data disagree.  A collective with
    no ``group=`` runs over WORLD — every rank of every mesh axis —
    which under a mesh of more than one axis is almost never the
    intended set: a dp gradient sum that also sums over tp multiplies
    by the tp size.  And a reduction (``all_reduce``/``reduce_scatter``)
    over the group of an axis the data is replicated on — the
    enclosing ``local_map``'s ``in_placements`` never shard it, or the
    tensor's own placements say ``Replicate()`` there — counts every
    replica: the "sum" multiplies by the axis size.  Functions are
    attributed to ``local_map`` entries interprocedurally.  Axes the
    mesh does not declare are ``unknown-axis``'s findings.
    """
    an = analyze(pkg)
    if an.mesh_axes is None:
        return
    for fn in mod.functions:
        bound = fn in an.bound
        sharded = an.sharded_axes.get(fn, UNKNOWN_AXES)
        for node in own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            name = pkg.full_name(mod, fn, node.func)
            if name not in COLLECTIVES:
                continue
            short = name.rsplit(".", 1)[-1]
            group = _group_expr(name, node)
            if group is False:
                if len(an.mesh_axes) > 1:
                    yield Finding(
                        "collective-mismatch", mod.path, node.lineno,
                        node.col_offset,
                        f"{short} with no group= runs over WORLD — every "
                        f"rank of every axis of the "
                        f"{sorted(an.mesh_axes)} mesh; pass the axis's "
                        f"group (mesh.get_group)")
                continue
            axis = an.group_axis(mod, fn, group)
            if axis is None or axis not in an.mesh_axes \
                    or name not in REDUCING_COLLECTIVES:
                continue
            if bound and sharded is not UNKNOWN_AXES \
                    and axis not in sharded:
                yield Finding(
                    "collective-mismatch", mod.path, node.lineno,
                    node.col_offset,
                    f"{short} over axis '{axis}' but the enclosing "
                    f"local_map's in_placements never shard '{axis}' — "
                    f"the reduction multiplies replicated values by the "
                    f"axis size")
                continue
            data = node.args[0] if node.args else None
            fact = an.resolve_spec(mod, fn, data) if data is not None \
                else None
            if fact is not None and fact.exact \
                    and an.mesh_order is not None \
                    and axis in an.mesh_order \
                    and len(fact.sig) == len(an.mesh_order) \
                    and fact.sig[an.mesh_order.index(axis)][0] == "R":
                yield Finding(
                    "collective-mismatch", mod.path, node.lineno,
                    node.col_offset,
                    f"{short} over axis '{axis}' of a tensor replicated "
                    f"on '{axis}' — the reduction multiplies it by the "
                    f"axis size")


# ---------------------------------------------------------------------
# implicit-reshard
# ---------------------------------------------------------------------

def _fmt(sig):
    return "(" + ", ".join(
        f"Shard({e[1]})" if e[0] == "S" else
        ("Replicate()" if e[0] == "R" else "Partial()")
        for e in sig) + ")"


@shard_rule("implicit-reshard",
            "a tensor's placements disagree with the in_placements of "
            "the local_map step it feeds")
def check_implicit_reshard(pkg: Package, mod: ModuleInfo):
    """A ``local_map`` step declares the placements of its inputs
    (``in_placements``), the layout contract the step was written for;
    a DTensor arriving laid out differently is redistributed on every
    call (with ``redistribute_inputs=True``, a silent all-gather or
    all-to-all copy; without it, an error at the first multi-rank
    call).  This is the static twin of ``ShardingContractGuard``.
    Fires only when BOTH sides resolve to literal placements (through
    ``distribute_tensor``/``DTensor.from_local``/``redistribute``
    bindings and builder return summaries); symbolic or unknown
    placements stay quiet.
    """
    an = analyze(pkg)
    for scope, call in _module_calls(mod):
        if scope is None:
            continue
        jit = an.lookup(scope, call.func.id) \
            if isinstance(call.func, ast.Name) else None
        if not isinstance(jit, ShardJit):
            continue
        for pos, arg in enumerate(call.args):
            expected = jit.expected(pos)
            if expected is None or not expected.exact:
                continue
            actual = an.resolve_spec(mod, scope, arg)
            if actual is None or not actual.exact:
                continue
            if actual.sig == expected.sig:
                continue
            yield Finding(
                "implicit-reshard", mod.path, call.lineno,
                call.col_offset,
                f"argument {pos} is placed as {_fmt(actual.sig)} but the "
                f"step's in_placements expect {_fmt(expected.sig)} — a "
                f"redistribution copy on every call")


# ---------------------------------------------------------------------
# divergent-control
# ---------------------------------------------------------------------

def _exits_block(body) -> bool:
    return any(isinstance(s, (ast.Return, ast.Raise, ast.Break,
                              ast.Continue)) for s in body)


@shard_rule("divergent-control",
            "rank-dependent values (dist.get_rank, rank == 0, "
            "self.primary) decide whether or in what order a collective "
            "runs")
def check_divergent_control(pkg: Package, mod: ModuleInfo):
    """Every rank of a process group must issue the same collectives
    in the same order; a collective guarded by a value derived from
    ``dist.get_rank()`` (directly, through a function that returns
    one, through a ``rank`` variable, or through a
    ``self.primary``-style attribute) hangs the job — rank 0 takes the
    branch, its peers never enter the collective and it waits forever.
    Flags a collective (or a call into a function that transitively
    runs one, ``DTensor.full_tensor()`` and ``redistribute`` included)
    inside an ``if``/``while`` body whose test is rank-divergent,
    inside a ``for`` over a rank-divergent iterable, and after a
    divergent guard that ends in ``return``/``raise``/``break``/
    ``continue``.  The safe idiom stays quiet: computing a divergent
    VALUE and broadcasting it (``sync_epoch_code``) runs the collective
    on every rank — and a collective's result is synchronized, so
    branching on it afterwards is fine.
    """
    an = analyze(pkg)
    for fn in mod.functions:
        ev = an.divergence_eval(fn)
        findings = []

        def scan(node, why):
            # manual stack so nested def/lambda bodies are PRUNED (a
            # collective there runs at its call site, not here)
            stack = [node]
            while stack:
                cur = stack.pop()
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.Lambda,
                                    ast.ClassDef)):
                    continue
                if isinstance(cur, ast.Call):
                    what = an.is_collective_call(mod, fn, cur)
                    if what is not None:
                        findings.append(Finding(
                            "divergent-control", mod.path, cur.lineno,
                            cur.col_offset,
                            f"collective {what} runs {why} a "
                            f"rank-dependent value — ranks that branch "
                            f"differently hang in the collective"))
                stack.extend(ast.iter_child_nodes(cur))

        def walk_block(stmts):
            guarded = False
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if guarded:
                    scan(stmt, "after an early exit guarded by")
                    continue
                if isinstance(stmt, (ast.If, ast.While)) \
                        and ev.taint(stmt.test):
                    for sub in stmt.body + stmt.orelse:
                        scan(sub, "under a branch on")
                    # exactly ONE branch exiting means the code after
                    # this statement runs on a process-dependent subset
                    # (`if not primary: return` and the equivalent
                    # `if primary: pass / else: return` both count)
                    if isinstance(stmt, ast.If) \
                            and (_exits_block(stmt.body)
                                 != _exits_block(stmt.orelse)):
                        guarded = True
                    continue
                if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                        and ev.taint(stmt.iter):
                    for sub in stmt.body + stmt.orelse:
                        scan(sub, "in an iteration order driven by")
                    continue
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub:
                        walk_block(sub)
                if isinstance(stmt, ast.Try):
                    for handler in stmt.handlers:
                        walk_block(handler.body)

        body = fn.node.body if not isinstance(fn.node, ast.Lambda) else []
        walk_block(body)
        yield from findings


# ---------------------------------------------------------------------
# unsynced-divisibility
# ---------------------------------------------------------------------

def _has_divisibility_guard(fn) -> bool:
    """A modulo expression used as a CHECK — inside a comparison, an
    assert, or directly as an ``if``/``while`` truthiness test
    (``if dim % n: raise``) — anywhere in the function: the static
    evidence that the split dimension was verified divisible before
    sharding."""
    for node in own_nodes(fn):
        probes = []
        if isinstance(node, ast.Compare):
            probes = [node.left] + list(node.comparators)
        elif isinstance(node, ast.Assert):
            probes = [node.test]
        elif isinstance(node, (ast.If, ast.While)):
            probes = [node.test]
        for probe in probes:
            for sub in ast.walk(probe):
                if isinstance(sub, ast.BinOp) \
                        and isinstance(sub.op, ast.Mod):
                    return True
    return False


def _axis_size_expr(pkg, an, mod, scope, expr) -> bool:
    """``sp`` / ``self.sp`` (an axis-named size), ``axis_size(...)``,
    ``dist.get_world_size(...)`` or ``mesh.size(...)``."""
    parts = dotted_parts(expr)
    if parts and parts[-1] in (an.mesh_axes or ()):
        return True
    if isinstance(expr, ast.Call):
        name = pkg.full_name(mod, scope, expr.func) or ""
        tail = name.rsplit(".", 1)[-1] if name else ""
        if tail == "axis_size" or name == "torch.distributed.get_world_size":
            return True
        if isinstance(expr.func, ast.Attribute) and expr.func.attr == "size" \
                and _is_mesh_expr(expr.func.value):
            return True
    return False


@shard_rule("unsynced-divisibility",
            "a Shard(d) placement or an axis-size split with no static "
            "divisibility guard in the function")
def check_unsynced_divisibility(pkg: Package, mod: ModuleInfo):
    """Placing a tensor with ``Shard(d)`` (``distribute_tensor``,
    ``DTensor.from_local``, ``redistribute``), or splitting a dim by an
    axis size by hand (``span = T // sp``, the sp time split), needs
    the dim to divide by the axis size — a property that holds on a
    one-rank test for EVERY size and breaks only at real axis sizes
    (DTensor then pads uneven shards; a hand split drops the
    remainder).  The repo's contract is that a function doing either
    carries a static divisibility check (a ``%`` comparison or assert,
    like ``T % self.sp == 0`` in ``parallel/update.py``) in itself or
    an enclosing function, so the guarantee is visible where the split
    happens.  Placements that cannot be resolved stay quiet.
    """
    an = analyze(pkg)
    if an.mesh_axes is None:
        return
    guard_cache: Dict[object, bool] = {}

    def guarded(fn) -> bool:
        # the guard may live in the enclosing builder (closure chain)
        probe = fn
        while probe is not None:
            if probe not in guard_cache:
                guard_cache[probe] = _has_divisibility_guard(probe)
            if guard_cache[probe]:
                return True
            probe = probe.parent
        return False

    for node, scope in _nodes_with_scope(mod):
        if scope is None:
            continue
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.FloorDiv) \
                and _axis_size_expr(pkg, an, mod, scope, node.right):
            if not guarded(scope):
                yield Finding(
                    "unsynced-divisibility", mod.path, node.lineno,
                    node.col_offset,
                    "a dim is split by an axis size with no static "
                    "divisibility guard in this function — add an "
                    "explicit `dim % axis_size == 0` check (or assert) "
                    "where the split is made")
            continue
        if not isinstance(node, ast.Call):
            continue
        name = pkg.full_name(mod, scope, node.func) or ""
        tail = name.rsplit(".", 1)[-1] if name else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        if tail not in PLACING_CALLS:
            continue
        arg = an.placement_arg(mod, scope, node)
        fact = an.resolve_spec(mod, scope, arg) if arg is not None else None
        if fact is None or fact.sig is None \
                or not any(e[0] == "S" for e in fact.sig):
            continue
        if guarded(scope):
            continue
        yield Finding(
            "unsynced-divisibility", mod.path, node.lineno,
            node.col_offset,
            f"{tail} places a tensor with {_fmt(fact.sig)} but this "
            f"function has no static divisibility guard — add an "
            f"explicit `dim % axis_size == 0` check (or assert) where "
            f"the placement is made")
