"""shardlint — the abstract interpreter behind the sharding rules.

torchlint's base rules prove generic PyTorch invariants; this module is
the layer they are blind to: the *mesh-parallel* contract of
``handyrl_tpu_torch/parallel``, one process per card over
``torch.distributed``.  The rules in :mod:`.shardrules` need
package-level answers to questions plain pattern matching cannot give:

  * which mesh axes does this package actually construct?  (collected
    from every ``DeviceMesh(..., mesh_dim_names=...)`` /
    ``init_device_mesh(..., mesh_dim_names=...)`` call, chasing
    module-level axis-tuple constants like ``AXES = ("dp", "sp",
    "tp")``, imported ones included);
  * what placements does this expression denote?  (an abstract
    environment per function: names bound from a tuple of
    ``Shard(d)``/``Replicate()``/``Partial()``, from a call that takes
    such a tuple — ``distribute_tensor``, ``DTensor.from_local``,
    ``.redistribute``, a ``Layout(mesh, placements)`` — and from the
    return summaries of internal builders like ``replicated`` /
    ``batch_sharding``; looked up through closures);
  * which functions run inside a ``local_map`` body, and over which
    axes does that entry actually shard its inputs?  (``local_map``'s
    ``in_placements`` are torch's ``shard_map`` in_specs; worklist over
    the call graph, including function-valued arguments);
  * which values are *rank-divergent* — derived from
    ``dist.get_rank()``, a ``rank`` variable or a ``self.primary``-style
    attribute — and which functions transitively run a collective?
    (two package fixpoints with function-return and ``self.*``
    attribute summaries, the same monotone style as :mod:`.astutil`'s
    device taint).

Everything is stdlib ``ast`` only — the analyzer never imports torch.
The abstraction is deliberately sound-where-it-matters: placements are
only compared when BOTH sides resolve to literal tuples, unknowns stay
silent, and the per-line suppression syntax is the escape hatch for
intentional violations.
"""

import ast
from collections import deque
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .astutil import (
    FunctionInfo,
    ModuleInfo,
    Package,
    _TaintWalk,
    _walk_calls,
    dotted_parts,
)

# -- name tables ------------------------------------------------------

MESH_NAMES = frozenset({
    "torch.distributed.device_mesh.DeviceMesh",
    "torch.distributed.DeviceMesh",
    "torch.distributed.device_mesh.init_device_mesh",
    "torch.distributed.init_device_mesh",
})
# placement constructors, by trailing name (the module moved between
# torch releases: ``torch.distributed.tensor`` / ``._tensor``)
PLACEMENT_TAILS = {"Shard": "S", "Replicate": "R", "Partial": "P"}
LOCAL_MAP_TAIL = "local_map"
# calls that take a placements tuple: (trailing name, positional index)
PLACING_CALLS = {"distribute_tensor": 2, "from_local": 2,
                 "redistribute": 1, "distribute_module": None}

# collective -> positional index of its ``group`` argument
COLLECTIVES: Dict[str, int] = {
    "torch.distributed.all_reduce": 2,
    "torch.distributed.broadcast": 2,
    "torch.distributed.all_gather": 2,
    "torch.distributed.all_gather_into_tensor": 2,
    "torch.distributed.reduce_scatter": 3,
    "torch.distributed.reduce_scatter_tensor": 3,
    "torch.distributed.all_to_all": 2,
    "torch.distributed.all_to_all_single": 4,
    "torch.distributed.reduce": 3,
    "torch.distributed.gather": 3,
    "torch.distributed.scatter": 3,
    "torch.distributed.barrier": 0,
    "torch.distributed.monitored_barrier": 0,
    "torch.distributed.broadcast_object_list": 2,
    "torch.distributed.all_gather_object": 2,
    "torch.distributed.gather_object": 3,
    "torch.distributed.scatter_object_list": 3,
}
# reductions (flagged by collective-mismatch over a replicated axis)
REDUCING_COLLECTIVES = frozenset({
    "torch.distributed.all_reduce", "torch.distributed.reduce",
    "torch.distributed.reduce_scatter",
    "torch.distributed.reduce_scatter_tensor",
})
# every rank must also enter these: creating a group, and the DTensor
# methods that run a collective under the hood
PROCESS_COLLECTIVES = frozenset({"torch.distributed.new_group"})
DTENSOR_COLLECTIVE_METHODS = frozenset({"full_tensor", "redistribute"})

# rank-divergent sources: a different value on every process
DIVERGENT_SOURCES = frozenset({
    "torch.distributed.get_rank", "torch.distributed.get_node_local_rank",
})
DIVERGENT_METHODS = frozenset({"get_local_rank", "get_coordinate"})
DIVERGENT_NAMES = frozenset({"rank", "global_rank", "local_rank",
                             "process_id", "process_index"})
DIVERGENT_ATTRS = frozenset({"primary", "is_primary", "rank",
                             "global_rank", "local_rank"})


def collective_name(pkg: Package, mod: ModuleInfo, scope,
                    call: ast.Call) -> Optional[str]:
    """The canonical collective a call runs directly, else None."""
    name = pkg.full_name(mod, scope, call.func)
    if name in COLLECTIVES or name in PROCESS_COLLECTIVES:
        return name
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in DTENSOR_COLLECTIVE_METHODS:
        return f"DTensor.{call.func.attr}"
    return None


# -- abstract facts ---------------------------------------------------

@dataclass(frozen=True)
class SpecFact:
    """What the analyzer knows about one placements tuple.

    ``sig`` is the entry tuple, one per mesh dim: ``("S", d)`` for
    ``Shard(d)``, ``("R",)`` for ``Replicate()``, ``("P",)`` for
    ``Partial()``, when every entry was a literal; else None.  ``axes``
    is the set of mesh axis names the tuple shards (resolved through
    the mesh's axis order), empty when that order is unknown.
    """

    sig: Optional[Tuple] = None
    axes: FrozenSet[str] = frozenset()

    @property
    def exact(self) -> bool:
        return self.sig is not None


@dataclass
class ShardJit:
    """A ``local_map`` callable with an input-placement contract,
    tracked so call sites can be checked against it (the
    implicit-reshard rule)."""

    # one entry per positional argument; None = unknown at that slot
    in_facts: Optional[List[Optional[SpecFact]]] = None

    def expected(self, pos: int) -> Optional[SpecFact]:
        if self.in_facts is not None and pos < len(self.in_facts):
            return self.in_facts[pos]
        return None


UNKNOWN_AXES = None  # sentinel: "this local_map's sharded axes are unknown"


def placement_entry(pkg: Package, mod: ModuleInfo, scope, node):
    """``Shard(0)`` -> ("S", 0), ``Replicate()`` -> ("R",),
    ``Partial()`` -> ("P",); None when not a literal placement."""
    if not isinstance(node, ast.Call):
        return None
    name = pkg.full_name(mod, scope, node.func) or ""
    kind = PLACEMENT_TAILS.get(name.rsplit(".", 1)[-1])
    if kind is None:
        return None
    if kind == "S":
        dim = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "dim":
                dim = kw.value
        if isinstance(dim, ast.Constant) and isinstance(dim.value, int):
            return ("S", dim.value)
        return ("S", None)
    return (kind,)


class ShardAnalysis:
    """All package-level sharding facts, computed once per Package."""

    MAX_PASSES = 5

    def __init__(self, package: Package):
        self.pkg = package
        # declared mesh axes in order; None when the package builds no
        # mesh (or none whose axis names resolve)
        self.mesh_order: Optional[Tuple[str, ...]] = None
        self.mesh_axes: Optional[FrozenSet[str]] = None
        # local_map context
        self.bound: Set[FunctionInfo] = set()
        self.sharded_axes: Dict[FunctionInfo, Optional[FrozenSet[str]]] = {}
        # abstract placement environments
        self.env: Dict[FunctionInfo, Dict[str, object]] = {}
        self.spec_returns: Dict[FunctionInfo, SpecFact] = {}
        self.jit_returns: Dict[FunctionInfo, ShardJit] = {}
        # ``self.X = mesh.get_group(<axis>)`` -> axis, per class
        self.group_attrs: Dict[Tuple[str, str], Dict[str, str]] = {}
        # rank-divergence facts
        self.divergent_locals: Dict[FunctionInfo, Set[str]] = {}
        self.divergent_params: Dict[FunctionInfo, Set[str]] = {}
        self.divergent_returns: Set[FunctionInfo] = set()
        self.divergent_attrs: Dict[Tuple[str, str], Set[str]] = {}
        # functions that transitively run a collective
        self.collective_fns: Set[FunctionInfo] = set()

        self._collect_mesh_axes()
        self._build_spec_envs()
        self._collect_group_attrs()
        self._propagate_shard_contexts()
        self._compute_divergence()
        self._compute_collective_summaries()

    # -- mesh axes ----------------------------------------------------

    def _module_axis_tuple(self, mod: ModuleInfo, name: str):
        """A module-level ``NAME = ("dp", "sp", "tp")`` constant."""
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            targets = [t.id for t in stmt.targets
                       if isinstance(t, ast.Name)]
            if name not in targets:
                continue
            if isinstance(stmt.value, (ast.Tuple, ast.List)) and all(
                    isinstance(el, ast.Constant)
                    and isinstance(el.value, str)
                    for el in stmt.value.elts):
                return tuple(el.value for el in stmt.value.elts)
        return None

    def axis_names_expr(self, mod: ModuleInfo, expr):
        """Axis names denoted by an axis-names expression: a literal
        tuple/list of strings, a single string, or a name resolving to
        a module-level tuple constant (possibly imported from another
        scanned module)."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return (expr.value,)
        if isinstance(expr, (ast.Tuple, ast.List)) and all(
                isinstance(el, ast.Constant)
                and isinstance(el.value, str) for el in expr.elts):
            return tuple(el.value for el in expr.elts)
        if isinstance(expr, ast.Name):
            local = self._module_axis_tuple(mod, expr.id)
            if local is not None:
                return local
            imp = mod.from_imports.get(expr.id)
            if imp is not None:
                target_mod = self.pkg.modules.get(imp[0])
                if target_mod is not None:
                    return self._module_axis_tuple(target_mod, imp[1])
        return None

    def _collect_mesh_axes(self):
        axes: Set[str] = set()
        order = None
        for mod in self.pkg.modules.values():
            for scope, call in _walk_calls(mod):
                name = self.pkg.full_name(mod, scope, call.func)
                if name not in MESH_NAMES:
                    continue
                for kw in call.keywords:
                    if kw.arg == "mesh_dim_names":
                        names = self.axis_names_expr(mod, kw.value)
                        if names:
                            axes.update(names)
                            order = order or names
        if axes:
            self.mesh_axes = frozenset(axes)
            self.mesh_order = order

    def is_axis_tuple(self, mod: ModuleInfo, expr) -> bool:
        """Is ``expr`` the mesh's axis-names tuple (``AXES`` or
        ``mesh.mesh_dim_names``)?"""
        if isinstance(expr, ast.Attribute) \
                and expr.attr == "mesh_dim_names":
            return True
        return isinstance(expr, ast.Name) \
            and self.axis_names_expr(mod, expr) is not None

    # -- placement environments ---------------------------------------

    def lookup(self, fn: Optional[FunctionInfo], name: str):
        """Closure-chain lookup of an abstract placement/jit fact."""
        while fn is not None:
            fact = self.env.get(fn, {}).get(name)
            if fact is not None:
                return fact
            fn = fn.parent
        return None

    def _fact_from_entries(self, entries) -> SpecFact:
        axes: Set[str] = set()
        exact = all(e is not None and (e[0] != "S" or e[1] is not None)
                    for e in entries)
        if self.mesh_order is not None:
            for axis, entry in zip(self.mesh_order, entries):
                if entry is not None and entry[0] == "S":
                    axes.add(axis)
        return SpecFact(tuple(entries) if exact else None,
                        frozenset(axes))

    def placements_literal(self, mod: ModuleInfo, scope, expr) \
            -> Optional[SpecFact]:
        """A tuple/list whose elements are all placement calls (or a
        ``(Replicate(),) * len(AXES)`` repetition)."""
        if isinstance(expr, ast.Call) and not expr.keywords \
                and len(expr.args) == 1 and self.pkg.full_name(
                    mod, scope, expr.func) in ("tuple", "list"):
            return self.placements_literal(mod, scope, expr.args[0])
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
            base = self.placements_literal(mod, scope, expr.left)
            count = expr.right
            n = None
            if isinstance(count, ast.Constant) \
                    and isinstance(count.value, int):
                n = count.value
            elif isinstance(count, ast.Call) and count.args \
                    and self.pkg.full_name(mod, scope, count.func) == "len":
                names = self.axis_names_expr(mod, count.args[0])
                n = len(names) if names else None
            if base is None or base.sig is None or n is None:
                return None
            return self._fact_from_entries(list(base.sig) * n)
        if not isinstance(expr, (ast.Tuple, ast.List)) or not expr.elts:
            return None
        for el in expr.elts:  # cheap syntactic filter first
            parts = dotted_parts(el.func) if isinstance(el, ast.Call) \
                else None
            if not parts or parts[-1] not in PLACEMENT_TAILS:
                return None
        entries = [placement_entry(self.pkg, mod, scope, el)
                   for el in expr.elts]
        if any(e is None for e in entries):
            return None
        return self._fact_from_entries(entries)

    def placement_arg(self, mod: ModuleInfo, scope, call: ast.Call):
        """The placements argument of a placing call, else None."""
        for kw in call.keywords:
            if kw.arg == "placements":
                return kw.value
        name = self.pkg.full_name(mod, scope, call.func) or ""
        tail = name.rsplit(".", 1)[-1] if name else (
            call.func.attr if isinstance(call.func, ast.Attribute) else "")
        pos = PLACING_CALLS.get(tail)
        if pos is not None and len(call.args) > pos:
            return call.args[pos]
        return None

    def resolve_spec(self, mod: ModuleInfo, scope, expr) \
            -> Optional[SpecFact]:
        """SpecFact denoted by an expression, or None when unknown."""
        if isinstance(expr, ast.Name):
            fact = self.lookup(scope, expr.id)
            return fact if isinstance(fact, SpecFact) else None
        if isinstance(expr, ast.Attribute):
            if expr.attr == "placements":
                return self.resolve_spec(mod, scope, expr.value)
            return None
        lit = self.placements_literal(mod, scope, expr)
        if lit is not None:
            return lit
        if not isinstance(expr, ast.Call):
            return None
        if isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in ("to_local", "contiguous"):
            return self.resolve_spec(mod, scope, expr.func.value)
        arg = self.placement_arg(mod, scope, expr)
        if arg is not None:
            return self.resolve_spec(mod, scope, arg)
        res = self.pkg.resolve_callee(mod, scope, expr.func)
        if res is not None and res[0] == "fn":
            return self.spec_returns.get(res[1])
        # a constructor taking a placements tuple: Layout(mesh, (...))
        for a in list(expr.args) + [kw.value for kw in expr.keywords]:
            lit = self.placements_literal(mod, scope, a)
            if lit is not None:
                return lit
        return None

    def _resolve_jit(self, mod: ModuleInfo, scope, expr) \
            -> Optional[ShardJit]:
        if isinstance(expr, ast.Name):
            fact = self.lookup(scope, expr.id)
            return fact if isinstance(fact, ShardJit) else None
        if not isinstance(expr, ast.Call):
            return None
        name = self.pkg.full_name(mod, scope, expr.func) or ""
        if name.rsplit(".", 1)[-1] == LOCAL_MAP_TAIL:
            return self._jit_from_call(mod, scope, expr)
        res = self.pkg.resolve_callee(mod, scope, expr.func)
        if res is not None and res[0] == "fn":
            return self.jit_returns.get(res[1])
        return None

    def in_placements(self, call: ast.Call):
        for kw in call.keywords:
            if kw.arg == "in_placements":
                return kw.value
        if len(call.args) >= 3:
            return call.args[2]
        return None

    def _jit_from_call(self, mod, scope, call: ast.Call) -> ShardJit:
        jit = ShardJit()
        value = self.in_placements(call)
        if isinstance(value, (ast.Tuple, ast.List)):
            jit.in_facts = [
                None if (isinstance(el, ast.Constant) and el.value is None)
                else self.resolve_spec(mod, scope, el)
                for el in value.elts
            ]
        return jit

    def _build_spec_envs(self):
        """Per-function abstract environments, run to a package
        fixpoint so builder-return summaries (``replicated`` ->
        ``(Replicate(),) * 3``) feed the environments that use them."""
        for _ in range(self.MAX_PASSES):
            changed = False
            for fn in self.pkg.all_functions():
                env: Dict[str, object] = {}
                returns_spec: List[Optional[SpecFact]] = []
                returns_jit: Optional[ShardJit] = None
                mod = fn.module

                def visit(node):
                    nonlocal returns_jit
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.Lambda, ast.ClassDef)):
                        return  # nested defs build their own env
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1 \
                            and isinstance(node.targets[0], ast.Name):
                        tgt = node.targets[0].id
                        fact = self.resolve_spec(mod, fn, node.value)
                        if fact is not None:
                            env[tgt] = fact
                        else:
                            jit = self._resolve_jit(mod, fn, node.value)
                            if jit is not None:
                                env[tgt] = jit
                    elif isinstance(node, ast.Return) \
                            and node.value is not None:
                        returns_spec.append(self.resolve_spec(
                            mod, fn, node.value))
                        if returns_jit is None:
                            returns_jit = self._resolve_jit(
                                mod, fn, node.value)
                    for child in ast.iter_child_nodes(node):
                        visit(child)

                body = fn.node.body
                if isinstance(fn.node, ast.Lambda):
                    body = [ast.Expr(fn.node.body)]
                for stmt in body:
                    visit(stmt)
                    if isinstance(fn.node, ast.Lambda) \
                            and isinstance(stmt, ast.Expr):
                        returns_spec.append(self.resolve_spec(
                            mod, fn, stmt.value))

                if env != self.env.get(fn, {}):
                    self.env[fn] = env
                    changed = True
                known = [r for r in returns_spec if r is not None]
                if known and len(known) == len(returns_spec):
                    joined = known[0] if all(
                        r == known[0] for r in known) else None
                    if joined is not None \
                            and self.spec_returns.get(fn) != joined:
                        self.spec_returns[fn] = joined
                        changed = True
                if returns_jit is not None \
                        and fn not in self.jit_returns:
                    self.jit_returns[fn] = returns_jit
                    changed = True
            if not changed:
                break

    # -- process groups -----------------------------------------------

    def group_axis_exprs(self, call: ast.Call):
        """The axis-denoting argument of ``mesh.get_group(...)`` /
        ``mesh.get_local_rank(...)``, else None."""
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr in ("get_group", "get_local_rank")):
            return None
        for kw in call.keywords:
            if kw.arg == "mesh_dim":
                return kw.value
        return call.args[0] if call.args else None

    def axis_of(self, mod: ModuleInfo, expr) -> Optional[str]:
        """A mesh axis named by ``"dp"``, ``AXES.index("dp")`` or
        ``mesh.mesh_dim_names.index("dp")``."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Constant) and isinstance(expr.value, int) \
                and self.mesh_order is not None \
                and 0 <= expr.value < len(self.mesh_order):
            return self.mesh_order[expr.value]
        if isinstance(expr, ast.Call) \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr == "index" and expr.args \
                and self.is_axis_tuple(mod, expr.func.value) \
                and isinstance(expr.args[0], ast.Constant) \
                and isinstance(expr.args[0].value, str):
            return expr.args[0].value
        return None

    def group_axis(self, mod: ModuleInfo, scope, expr) -> Optional[str]:
        """The mesh axis whose process group ``expr`` denotes."""
        if isinstance(expr, ast.Call):
            arg = self.group_axis_exprs(expr)
            return self.axis_of(mod, arg) if arg is not None else None
        parts = dotted_parts(expr)
        if parts and len(parts) == 2 and parts[0] == "self":
            cls = _class_of(scope)
            if cls is not None:
                return self.group_attrs.get(
                    (mod.name, cls), {}).get(parts[1])
        if isinstance(expr, ast.Name):
            fn = scope
            while fn is not None:
                for node in ast.walk(fn.node):
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1 \
                            and isinstance(node.targets[0], ast.Name) \
                            and node.targets[0].id == expr.id \
                            and isinstance(node.value, ast.Call):
                        axis = self.group_axis(mod, fn, node.value)
                        if axis is not None:
                            return axis
                fn = fn.parent
        return None

    def _collect_group_attrs(self):
        for mod in self.pkg.modules.values():
            for fn in mod.functions:
                cls = _class_of(fn)
                if cls is None:
                    continue
                for node in ast.walk(fn.node):
                    if not isinstance(node, ast.Assign) \
                            or not isinstance(node.value, ast.Call):
                        continue
                    axis = self.group_axis(mod, fn, node.value)
                    if axis is None:
                        continue
                    for tgt in node.targets:
                        parts = dotted_parts(tgt)
                        if parts and len(parts) == 2 and parts[0] == "self":
                            self.group_attrs.setdefault(
                                (mod.name, cls), {})[parts[1]] = axis

    # -- local_map contexts --------------------------------------------

    def _shard_entry_axes(self, mod, scope, call: ast.Call):
        """The axes a ``local_map`` actually shards over: the union of
        the sharded axes of its (resolvable) ``in_placements``.  None =
        unknown."""
        value = self.in_placements(call)
        if value is None or not isinstance(value, (ast.Tuple, ast.List)):
            return UNKNOWN_AXES
        if self.mesh_order is None:
            return UNKNOWN_AXES
        axes: Set[str] = set()
        for el in value.elts:
            if isinstance(el, ast.Constant) and el.value is None:
                continue
            fact = self.resolve_spec(mod, scope, el)
            if fact is None or not fact.exact:
                return UNKNOWN_AXES
            axes.update(fact.axes)
        return frozenset(axes)

    def _callee_fns(self, fn: FunctionInfo):
        """Directly-called internal functions + function-valued
        arguments (higher-order propagation), within ``fn``'s body
        (cached: the call graph does not change)."""
        cache = self.__dict__.setdefault("_callees", {})
        if fn not in cache:
            cache[fn] = self._scan_callees(fn)
        return cache[fn]

    def _scan_callees(self, fn: FunctionInfo):
        out = []

        def visit(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    continue
                if isinstance(child, ast.Call):
                    res = self.pkg.resolve_callee(
                        fn.module, fn, child.func)
                    if res is not None and res[0] == "fn":
                        out.append(res[1])
                    for arg in (list(child.args)
                                + [kw.value for kw in child.keywords]):
                        inner = (arg.value if isinstance(arg, ast.Starred)
                                 else arg)
                        if isinstance(inner, ast.Lambda):
                            target = fn.module.by_node.get(inner)
                            if target is not None:
                                out.append(target)
                        elif isinstance(inner, (ast.Name, ast.Attribute)):
                            r = self.pkg.resolve_callee(
                                fn.module, fn, inner)
                            if r is not None and r[0] == "fn":
                                out.append(r[1])
                visit(child)

        body = fn.node.body
        if isinstance(fn.node, ast.Lambda):
            body = [ast.Expr(fn.node.body)]
        for stmt in body:
            visit(stmt)
        return out

    def _propagate_shard_contexts(self):
        work = deque()

        def seed(fn, axes):
            prev = self.sharded_axes.get(fn, frozenset())
            if axes is UNKNOWN_AXES or prev is UNKNOWN_AXES:
                merged = UNKNOWN_AXES
            else:
                merged = prev | axes
            if fn not in self.bound or merged != prev:
                self.bound.add(fn)
                self.sharded_axes[fn] = merged
                work.append(fn)

        for mod in self.pkg.modules.values():
            for scope, call in _walk_calls(mod):
                name = self.pkg.full_name(mod, scope, call.func) or ""
                if name.rsplit(".", 1)[-1] != LOCAL_MAP_TAIL \
                        or not call.args:
                    continue
                target = call.args[0]
                fn = None
                if isinstance(target, ast.Lambda):
                    fn = mod.by_node.get(target)
                else:
                    res = self.pkg.resolve_callee(mod, scope, target)
                    if res is not None and res[0] == "fn":
                        fn = res[1]
                if fn is not None:
                    seed(fn, self._shard_entry_axes(mod, scope, call))

        guard = 0
        while work and guard < 10000:
            guard += 1
            fn = work.popleft()
            axes = self.sharded_axes.get(fn, UNKNOWN_AXES)
            for callee in self._callee_fns(fn):
                seed(callee, axes)

    # -- rank divergence ----------------------------------------------

    def _compute_divergence(self):
        analysis = self

        class DivergentTaint(_TaintWalk):
            def __init__(self, fn, pkg):
                super().__init__(fn, pkg)
                self.tainted = (
                    set(analysis.divergent_locals.get(fn, set()))
                    | set(analysis.divergent_params.get(fn, set()))
                    | (set(fn.all_params) & DIVERGENT_NAMES))

            def taint(self, e) -> bool:
                if isinstance(e, ast.Name) and e.id in DIVERGENT_NAMES:
                    return True
                return super().taint(e)

            def result_taint(self, name, resolution, call, arg_taints,
                             kw_taints):
                if name in DIVERGENT_SOURCES:
                    return True
                if isinstance(call.func, ast.Attribute) \
                        and call.func.attr in DIVERGENT_METHODS:
                    return True
                if collective_name(analysis.pkg, self.module, self.fn,
                                   call) is not None:
                    # a collective's RESULT is synchronized across
                    # ranks by construction — divergence laundering
                    # through broadcast is exactly the safe idiom
                    return False
                if resolution is not None and resolution[0] == "fn" \
                        and resolution[1] in analysis.divergent_returns:
                    return True
                if resolution is not None and resolution[0] == "fn":
                    return False  # summaries, not blanket propagation
                func_tainted = (isinstance(call.func, ast.Attribute)
                                and self.taint(call.func.value))
                return (any(arg_taints) or any(kw_taints.values())
                        or func_tainted)

            def assign_attr(self, target, value, tainted):
                parts = dotted_parts(target)
                if parts is None or len(parts) != 2 \
                        or parts[0] != "self" or self.fn.cls_name is None:
                    return
                if tainted:
                    analysis.divergent_attrs.setdefault(
                        (self.module.name, self.fn.cls_name),
                        set()).add(parts[1])

            def attr_taint(self, e):
                parts = dotted_parts(e)
                cls = _class_of(self.fn)
                if parts is not None and len(parts) == 2 \
                        and parts[0] == "self" \
                        and parts[1] in DIVERGENT_ATTRS:
                    return True
                if (parts is not None and len(parts) == 2
                        and parts[0] == "self" and cls is not None
                        and parts[1] in analysis.divergent_attrs.get(
                            (self.module.name, cls), ())):
                    return True
                return super().attr_taint(e)

        self._divergent_cls = DivergentTaint
        for _ in range(self.MAX_PASSES):
            changed = False
            for fn in self.pkg.all_functions():
                dt = DivergentTaint(fn, self.pkg).run()
                if dt.tainted != self.divergent_locals.get(fn, set()):
                    self.divergent_locals[fn] = set(dt.tainted)
                    changed = True
                if dt.return_tainted \
                        and fn not in self.divergent_returns:
                    self.divergent_returns.add(fn)
                    changed = True
                # argument flow into internal callees
                for resolution, call, arg_taints, kw_taints in dt.calls:
                    if resolution is None or resolution[0] != "fn":
                        continue
                    callee = resolution[1]
                    params = callee.callable_params
                    new: Set[str] = set()
                    for idx, t in enumerate(arg_taints):
                        if t and idx < len(params) \
                                and not isinstance(call.args[idx],
                                                   ast.Starred):
                            new.add(params[idx])
                    for kw, t in kw_taints.items():
                        if t and kw in callee.all_params:
                            new.add(kw)
                    have = self.divergent_params.setdefault(callee, set())
                    if new - have:
                        have |= new
                        changed = True
            if not changed:
                break

    def divergence_eval(self, fn: FunctionInfo):
        """A taint evaluator pre-seeded with ``fn``'s divergence
        fixpoint, for rules to test arbitrary expressions."""
        ev = self._divergent_cls(fn, self.pkg)
        ev.tainted = (set(self.divergent_locals.get(fn, set()))
                      | set(self.divergent_params.get(fn, set()))
                      | (set(fn.all_params) & DIVERGENT_NAMES))
        return ev

    # -- collective summaries ----------------------------------------

    def _performs_collective_directly(self, fn: FunctionInfo) -> bool:
        found = False

        def visit(node):
            nonlocal found
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    continue
                if isinstance(child, ast.Call) and collective_name(
                        self.pkg, fn.module, fn, child) is not None:
                    found = True
                visit(child)

        body = fn.node.body
        if isinstance(fn.node, ast.Lambda):
            body = [ast.Expr(fn.node.body)]
        for stmt in body:
            visit(stmt)
        return found

    def _compute_collective_summaries(self):
        for fn in self.pkg.all_functions():
            if self._performs_collective_directly(fn):
                self.collective_fns.add(fn)
        for _ in range(self.MAX_PASSES):
            changed = False
            for fn in self.pkg.all_functions():
                if fn in self.collective_fns:
                    continue
                for callee in self._callee_fns(fn):
                    if callee in self.collective_fns:
                        self.collective_fns.add(fn)
                        changed = True
                        break
            if not changed:
                break

    def is_collective_call(self, mod: ModuleInfo, scope,
                           call: ast.Call) -> Optional[str]:
        """The collective's display name when this call (transitively)
        runs one, else None."""
        name = collective_name(self.pkg, mod, scope, call)
        if name is not None:
            return name
        res = self.pkg.resolve_callee(mod, scope, call.func)
        if res is not None and res[0] == "fn" \
                and res[1] in self.collective_fns:
            return res[1].qname.rsplit(":", 1)[-1]
        return None


def _class_of(fn: Optional[FunctionInfo]) -> Optional[str]:
    while fn is not None:
        if fn.cls_name is not None:
            return fn.cls_name
        fn = fn.parent
    return None


def analyze(package: Package) -> ShardAnalysis:
    """Compute (or fetch the cached) sharding analysis of a package."""
    cached = getattr(package, "_shardlint_analysis", None)
    if cached is None:
        cached = ShardAnalysis(package)
        package._shardlint_analysis = cached
    return cached
