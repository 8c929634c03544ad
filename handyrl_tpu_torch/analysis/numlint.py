"""numlint: interprocedural dtype/precision-flow analysis for torchlint.

The mixed-precision regime (fp32 master weights + bf16 compute, see
``ops/update.py``) only pays on the tensor cores while the hot path
actually *stays* in bf16 — one stray dimensioned fp32 tensor mixed into
a bf16 expression promotes it back to fp32 without a single test
failing.  This module is the dataflow engine behind the ``numrules``
family: it tracks a small dtype lattice through the package so the
rules can ask "what dtype is this expression, really?" instead of
pattern-matching spellings.

The lattice fact is :class:`DtypeFact` — a canonical dtype name
(``bfloat16 / float16 / float32 / float64 / int / uint8 / int8 /
bool``) plus three qualifiers that carry torch's promotion rules:

  ``weak``       a Python (or numpy) scalar: it never promotes a tensor
                 of its own category (``h * 0.5`` stays bf16);
  ``zero``       a 0-dim tensor: it never promotes a *dimensioned*
                 tensor of its own category either
                 (``bf16 * torch.tensor(0.5)`` stays bf16, where JAX's
                 ``jnp.asarray(0.5)`` promotes);
  ``from_weak``  a tensor built from Python values with no ``dtype=``
                 (``torch.tensor([0.5])``, ``torch.full((n,), 0.5)``):
                 it took the default dtype, float32, and once it has a
                 dimension it DOES drag bf16 operands up.

:func:`promote` is ``torch.result_type`` over the lattice: the result
takes the highest category (bool < int < float) among the operands;
within it, dimensioned tensors decide, then 0-dim tensors, then
scalars (which give the default dtype, float32 or int64, only when
they alone carry the highest category).

Facts flow interprocedurally through four channels, built to a
package fixpoint (:class:`NumAnalysis`):

  * **config facts** — assignments to ``compute_dtype`` /
    ``obs_store`` anywhere in the package contribute their dtype
    tokens (string literals, ``torch.bfloat16``-style attributes), so
    ``getattr(torch, self.compute_dtype)`` resolves to the configured
    ``{bfloat16}``;
  * **dtype-value bindings** — ``dtype = getattr(torch, name)`` binds
    a *set* of possible dtype names to a local, chased through
    closures and call arguments into ``.to(dtype)``/``dtype=`` sites;
  * **tensor facts** — ``h = x.to(torch.bfloat16)`` (or
    ``.bfloat16()``, ``.float()``, ``.half()``) binds a concrete
    DtypeFact to a local; reductions and elementwise ``torch.*`` calls
    pass facts through; binary ops promote facts with torch's rules;
    ``torch.autocast(dtype=...)`` regions give matmuls, convolutions
    and ``F.linear`` the autocast dtype;
  * **function summaries** — definite, non-weak argument facts seed
    callee parameters (conflicting call sites collapse the parameter
    to unknown), and a function whose every return carries the same
    fact exports it as a return summary.

Everything is stdlib ``ast`` — numlint never imports torch or numpy.
Like the other analyzers the lattice is *approximate and monotone in
spirit*: unknown stays unknown (rules only fire on definite facts),
which keeps the false-positive rate near zero at the cost of missing
dynamically-chosen dtypes.  A tensor of unknown rank counts as
dimensioned.
"""

import ast
from collections import deque
from dataclasses import dataclass, replace
from typing import Dict, FrozenSet, List, Optional, Set

from .astutil import (FunctionInfo, ModuleInfo, Package, _walk_calls,
                      compute_tracer_taint, dotted_parts)

# Canonical spellings.  All integer widths >= 16 collapse to "int":
# the rules only care about float precision, the lossy 8-bit targets,
# and bool masks.
_DTYPE_TOKENS = {
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float16": "float16", "fp16": "float16", "half": "float16",
    "float32": "float32", "fp32": "float32", "single": "float32",
    "float": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "uint8": "uint8", "ubyte": "uint8",
    "int8": "int8",
    "int16": "int", "int32": "int", "int64": "int", "int": "int",
    "short": "int", "long": "int",
    "uint16": "int", "uint32": "int", "uint64": "int", "uint": "int",
    "bool": "bool", "bool_": "bool",
}

LOW_PRECISION = frozenset({"bfloat16", "float16"})
HIGH_PRECISION = frozenset({"float32", "float64"})
LOSSY_TARGETS = frozenset({"uint8", "int8"})

# Assignment targets (plain names or ``self.<key>`` attributes)
# harvested package-wide as configuration facts.
CONFIG_FACT_KEYS = ("compute_dtype", "obs_store")

_FLOAT_RANK = {"bfloat16": 1, "float16": 1, "float32": 2, "float64": 3}

# prefixes under which a trailing dtype token is a dtype *value*
# (``torch.float32``, ``np.float32``)
_DTYPE_NAMESPACES = ("numpy.", "torch.")

# tensor methods that cast to a fixed dtype
CAST_METHODS = {
    "bfloat16": "bfloat16", "half": "float16", "float": "float32",
    "double": "float64", "byte": "uint8", "char": "int8",
    "short": "int", "int": "int", "long": "int", "bool": "bool",
}

# torch factories that default to float32 when no dtype is passed
_F32_DEFAULT_PRODUCERS = frozenset({
    "torch.zeros", "torch.ones", "torch.empty", "torch.rand",
    "torch.randn", "torch.eye", "torch.linspace", "torch.logspace",
})
# factories whose dtype is inferred from Python data
_INFER_PRODUCERS = frozenset({"torch.tensor", "torch.as_tensor"})
_LIKE_PRODUCERS = frozenset({
    "torch.zeros_like", "torch.ones_like", "torch.empty_like",
    "torch.full_like", "torch.rand_like", "torch.randn_like",
})
_ASARRAY_FNS = frozenset({"numpy.asarray", "numpy.array"})

# torch calls whose result is a bool mask / index, never the input
# dtype — blocking the generic passthrough below.
_BOOL_RESULTS = frozenset({
    "isfinite", "isnan", "isinf", "isclose", "allclose", "equal", "eq",
    "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "logical_xor",
})
_NON_PASSTHROUGH = _BOOL_RESULTS | frozenset({
    "argmax", "argmin", "argsort", "nonzero", "where", "stack", "cat",
    "concat", "numel", "tensor", "as_tensor", "from_numpy", "full",
    "arange", "randint", "randperm", "multinomial", "bincount",
})

# dtype-passthrough method calls (``x.sum()`` has x's dtype); the
# reductions give a 0-dim result when called with no arguments
_PASSTHROUGH_METHODS = frozenset({
    "sum", "mean", "cumsum", "var", "std", "max", "min", "amax", "amin",
    "reshape", "view", "transpose", "permute", "contiguous", "clone",
    "detach", "squeeze", "unsqueeze", "flatten", "clamp", "clamp_min",
    "clamp_max", "abs", "exp", "log", "sqrt", "sigmoid", "tanh", "neg",
    "expand", "expand_as", "repeat", "flip", "roll", "narrow",
    "masked_fill", "softmax", "log_softmax", "relu", "square",
})
_REDUCING_METHODS = frozenset({"sum", "mean", "var", "std", "max",
                               "min", "amax", "amin"})

DTYPE_KWARGS = ("dtype",)

# autocast: ops that run at the autocast dtype inside the region
AUTOCAST_NAMES = frozenset({"torch.autocast", "torch.cuda.amp.autocast",
                            "torch.amp.autocast"})
_AUTOCAST_OPS = frozenset({
    "matmul", "mm", "bmm", "addmm", "linear", "conv1d", "conv2d",
    "conv3d", "einsum", "baddbmm",
})

# Transforms whose function argument runs inside compiled compute.
_COMPUTE_WRAPPERS = frozenset({
    "torch.func.grad", "torch.func.vmap", "torch.func.grad_and_value",
    "torch.vmap", "torch.utils.checkpoint.checkpoint",
})


def parse_dtype(token: Optional[str]) -> Optional[str]:
    """A dtype spelling (possibly dotted: ``torch.float32``) ->
    canonical lattice name, or None if it names no dtype."""
    if not token:
        return None
    return _DTYPE_TOKENS.get(token.split(".")[-1].lower())


@dataclass(frozen=True)
class DtypeFact:
    """One lattice point: a canonical dtype + torch's promotion
    qualifiers."""

    dtype: str
    weak: bool = False        # Python/numpy scalar
    from_weak: bool = False   # built from Python values w/o dtype=
    zero: bool = False        # a 0-dim tensor


def _category(dtype: str) -> int:
    if dtype == "bool":
        return 0
    if dtype in _FLOAT_RANK:
        return 2
    return 1


def _priority(f: DtypeFact) -> int:
    """dimensioned tensor 2 > 0-dim tensor 1 > Python scalar 0."""
    if f.weak:
        return 0
    return 1 if f.zero else 2


def _same_class(dtypes: List[str]) -> str:
    """Promotion among operands of one category and one priority."""
    out = dtypes[0]
    for d in dtypes[1:]:
        if d == out:
            continue
        if d in _FLOAT_RANK and out in _FLOAT_RANK:
            ra, rb = _FLOAT_RANK[out], _FLOAT_RANK[d]
            if ra == rb:
                out = "float32"  # bfloat16 x float16 -> float32
            elif rb > ra:
                out = d
        elif d == "bool":
            continue
        elif out == "bool":
            out = d
        else:
            out = "int"  # uint8 x int8 -> int16, anything x int64
    return out


def promote(a: Optional[DtypeFact],
            b: Optional[DtypeFact]) -> Optional[DtypeFact]:
    """torch's binary promotion (``torch.result_type``) over the
    lattice; None is absorbing (unknown in -> unknown out)."""
    if a is None or b is None:
        return None
    top = max(_category(a.dtype), _category(b.dtype))
    ops = [f for f in (a, b) if _category(f.dtype) == top]
    best = max(_priority(f) for f in ops)
    deciders = [f for f in ops if _priority(f) == best]
    rank = max(_priority(a), _priority(b))
    if best == 0:
        # only scalars carry the top category: the default dtype
        dtype = {2: "float32", 1: "int", 0: "bool"}[top]
        if rank == 0:
            return DtypeFact(_same_class([f.dtype for f in ops]),
                             weak=True)
        return DtypeFact(dtype, zero=(rank == 1))
    dtype = _same_class([f.dtype for f in deciders])
    from_weak = all(f.from_weak for f in deciders)
    return DtypeFact(dtype, from_weak=from_weak, zero=(rank == 1))


# sentinel: a callee parameter seeded with incompatible facts from
# different call sites — the summary collapses to "unknown"
_CONFLICT = object()


def _own_stmts(fn: FunctionInfo) -> List[ast.stmt]:
    node = fn.node
    if isinstance(node, ast.Lambda):
        return [ast.Expr(node.body)]
    return list(node.body)


def _own_nodes(fn: FunctionInfo):
    """Every node in fn's own body, excluding nested def/lambda
    bodies (those scan as their own FunctionInfos); cached on fn."""
    cached = getattr(fn, "_num_nodes", None)
    if cached is not None:
        return cached
    out = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            out.append(child)
            walk(child)

    for stmt in _own_stmts(fn):
        out.append(stmt)
        walk(stmt)
    fn._num_nodes = out
    return out


class NumAnalysis:
    """Package-wide dtype/precision facts (see module docstring)."""

    MAX_PASSES = 5

    def __init__(self, package: Package):
        self.package = package
        # config key -> dtype tokens harvested from every assignment
        self.config_facts: Dict[str, FrozenSet[str]] = {}
        # per-function array-fact environment (local name -> fact)
        self.env: Dict[FunctionInfo, Dict[str, DtypeFact]] = {}
        # per-function dtype-VALUE environment (name -> possible dtypes)
        self.dtype_env: Dict[FunctionInfo, Dict[str, FrozenSet[str]]] = {}
        # callee parameter facts seeded from call sites
        self.param_facts: Dict[FunctionInfo, Dict[str, object]] = {}
        self.param_dtypes: Dict[FunctionInfo, Dict[str, Set[str]]] = {}
        # return summaries (all returns known + equal)
        self.returns: Dict[FunctionInfo, DtypeFact] = {}
        # dtype names each function casts to (astype/asarray/dtype=)
        self.fn_casts: Dict[FunctionInfo, Set[str]] = {}
        # functions that run device compute: every function of a
        # torch-importing module, compiled/captured code (per astutil),
        # torch.func closures, and everything they call — the precision
        # rules' scope
        self.compute_fns: Set[FunctionInfo] = set()
        for fn in package.all_functions():
            self.env[fn] = {}
            self.dtype_env[fn] = {}
            self.param_facts[fn] = {}
            self.param_dtypes[fn] = {}
            self.fn_casts[fn] = set()
        # the compute-set seed reads fn.jit_reachable, which only the
        # base engine's taint pass computes — run it here (idempotent)
        # so analyze_num works on a bare Package too, not just after
        # lint_paths has primed the flags
        compute_tracer_taint(package)
        # id(call) -> autocast dtype, for calls inside an autocast body
        self.autocast_nodes: Dict[int, str] = {}
        self._collect_config_facts()
        self._collect_autocast()
        self._seed_param_defaults()
        self._build_envs()
        self._build_compute_set()

    # -- config facts -------------------------------------------------

    def _collect_config_facts(self):
        found: Dict[str, Set[str]] = {k: set() for k in CONFIG_FACT_KEYS}
        for mod in self.package.modules.values():
            for node in ast.walk(mod.tree):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                    value = node.value
                elif isinstance(node, ast.AnnAssign) and node.value:
                    targets = [node.target]
                    value = node.value
                else:
                    continue
                for tgt in targets:
                    key = None
                    if isinstance(tgt, ast.Name):
                        key = tgt.id
                    elif isinstance(tgt, ast.Attribute):
                        key = tgt.attr
                    if key in CONFIG_FACT_KEYS:
                        found[key] |= self._dtype_tokens_in(value)
        for key, toks in found.items():
            if toks:
                self.config_facts[key] = frozenset(toks)

    @staticmethod
    def _dtype_tokens_in(expr) -> Set[str]:
        """Every dtype token mentioned in a subtree (string literals
        plus ``np.float32``-style attributes)."""
        toks: Set[str] = set()
        for node in ast.walk(expr):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                d = parse_dtype(node.value)
                if d is not None:
                    toks.add(d)
            elif isinstance(node, ast.Attribute):
                parts = dotted_parts(node)
                if parts and parts[0] in ("np", "numpy", "torch"):
                    d = parse_dtype(parts[-1])
                    if d is not None:
                        toks.add(d)
        return toks

    def _collect_autocast(self):
        for mod in self.package.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                dtype = None
                for item in node.items:
                    ctx = item.context_expr
                    if not isinstance(ctx, ast.Call) \
                            or self.package.full_name(
                                mod, None, ctx.func) not in AUTOCAST_NAMES:
                        continue
                    for kw in ctx.keywords:
                        if kw.arg == "dtype":
                            parts = dotted_parts(kw.value)
                            dtype = parse_dtype(parts[-1]) if parts \
                                else None
                    if dtype is None:
                        dtype = "float16"  # torch's default on CUDA
                if dtype is None:
                    continue
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call):
                            self.autocast_nodes[id(sub)] = dtype

    # -- parameter defaults -------------------------------------------

    def _seed_param_defaults(self):
        for fn in self.package.all_functions():
            args = fn.node.args
            pos = args.posonlyargs + args.args
            for a, default in zip(pos[len(pos) - len(args.defaults):],
                                  args.defaults):
                toks = self._dtype_tokens_in(default)
                if toks:
                    self.param_dtypes[fn].setdefault(
                        a.arg, set()).update(toks)
            for a, default in zip(args.kwonlyargs, args.kw_defaults):
                if default is None:
                    continue
                toks = self._dtype_tokens_in(default)
                if toks:
                    self.param_dtypes[fn].setdefault(
                        a.arg, set()).update(toks)
            # a parameter literally named after a config fact inherits
            # the configured values (``def make_apply_fn(model,
            # compute_dtype=...)`` sees {bfloat16, ...})
            for key in CONFIG_FACT_KEYS:
                if key in fn.all_params and key in self.config_facts:
                    self.param_dtypes[fn].setdefault(
                        key, set()).update(self.config_facts[key])

    # -- environment fixpoint -----------------------------------------

    def _build_envs(self):
        for _ in range(self.MAX_PASSES):
            changed = False
            for fn in self.package.all_functions():
                if self._scan_function(fn):
                    changed = True
            if not changed:
                break

    def _scan_function(self, fn: FunctionInfo) -> bool:
        env: Dict[str, DtypeFact] = {}
        dtenv: Dict[str, FrozenSet[str]] = {}
        rets: List[Optional[DtypeFact]] = []
        for stmt in _own_stmts(fn):
            self._stmt(fn, stmt, env, dtenv, rets)
        casts: Set[str] = set()
        changed = False
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                self._record_cast(fn, node, env, dtenv, casts)
                if self._seed_callee(fn, node, env, dtenv):
                    changed = True
        ret = None
        if rets and all(r is not None for r in rets) \
                and len({r for r in rets}) == 1:
            ret = rets[0]
        if env != self.env[fn]:
            self.env[fn] = env
            changed = True
        if dtenv != self.dtype_env[fn]:
            self.dtype_env[fn] = dtenv
            changed = True
        if not (casts <= self.fn_casts[fn]):
            self.fn_casts[fn] |= casts
            changed = True
        if ret != self.returns.get(fn):
            if ret is None:
                self.returns.pop(fn, None)
            else:
                self.returns[fn] = ret
            changed = True
        return changed

    # -- statements ---------------------------------------------------

    def _stmt(self, fn, stmt, env, dtenv, rets):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Assign):
            if len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                self._bind(fn, stmt.targets[0].id, stmt.value, env,
                           dtenv)
            else:
                for tgt in stmt.targets:
                    self._clobber(tgt, env, dtenv)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            if isinstance(stmt.target, ast.Name):
                self._bind(fn, stmt.target.id, stmt.value, env, dtenv)
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name):
                name = stmt.target.id
                old = env.get(name)
                if old is not None and not old.weak:
                    return  # an in-place op keeps the tensor's dtype
                new = promote(old, self.fact(fn, stmt.value, env, dtenv))
                if new is not None:
                    env[name] = new
                else:
                    env.pop(name, None)
        elif isinstance(stmt, ast.For):
            self._clobber(stmt.target, env, dtenv)
            for s in stmt.body + stmt.orelse:
                self._stmt(fn, s, env, dtenv, rets)
        elif isinstance(stmt, (ast.While, ast.If)):
            for s in stmt.body + stmt.orelse:
                self._stmt(fn, s, env, dtenv, rets)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                if item.optional_vars is not None:
                    self._clobber(item.optional_vars, env, dtenv)
            for s in stmt.body:
                self._stmt(fn, s, env, dtenv, rets)
        elif isinstance(stmt, ast.Try):
            for s in (stmt.body + stmt.orelse + stmt.finalbody
                      + [h for hand in stmt.handlers
                         for h in hand.body]):
                self._stmt(fn, s, env, dtenv, rets)
        elif isinstance(stmt, ast.Return):
            rets.append(self.fact(fn, stmt.value, env, dtenv)
                        if stmt.value is not None else None)

    def _bind(self, fn, name, value, env, dtenv):
        dset = self.dtypes(fn, value, env, dtenv)
        if dset:
            dtenv[name] = dset
            env.pop(name, None)
            return
        fact = self.fact(fn, value, env, dtenv)
        if fact is not None:
            env[name] = fact
            dtenv.pop(name, None)
        else:
            env.pop(name, None)
            dtenv.pop(name, None)

    def _clobber(self, target, env, dtenv):
        for node in ast.walk(target):
            if isinstance(node, ast.Name):
                env.pop(node.id, None)
                dtenv.pop(node.id, None)

    # -- call-site fact extraction ------------------------------------

    def cast_target(self, fn, call: ast.Call, env=None,
                    dtenv=None) -> Optional[FrozenSet[str]]:
        """The dtypes a cast call converts to: ``.to(dtype)``,
        ``.to(device, dtype)``, ``.type(dtype)``, ``.bfloat16()``-style
        methods, numpy's ``.astype(dtype)``; None for anything else."""
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        if attr in CAST_METHODS and not call.args and not call.keywords:
            return frozenset({CAST_METHODS[attr]})
        if attr in ("astype", "type") and call.args:
            return self.dtypes(fn, call.args[0], env, dtenv)
        if attr == "to":
            for kw in call.keywords:
                if kw.arg == "dtype":
                    return self.dtypes(fn, kw.value, env, dtenv)
            for arg in call.args[:2]:
                dset = self.dtypes(fn, arg, env, dtenv)
                if dset:
                    return dset
        return None

    def _record_cast(self, fn, call: ast.Call, env, dtenv, casts):
        dset = self.cast_target(fn, call, env, dtenv)
        if dset:
            casts |= dset
        name = self.package.full_name(fn.module, fn, call.func)
        if name in _ASARRAY_FNS and len(call.args) >= 2:
            dset = self.dtypes(fn, call.args[1], env, dtenv)
            if dset:
                casts |= dset
        for kw in call.keywords:
            if kw.arg in DTYPE_KWARGS:
                dset = self.dtypes(fn, kw.value, env, dtenv)
                if dset:
                    casts |= dset

    def _seed_callee(self, fn, call: ast.Call, env, dtenv) -> bool:
        res = self.package.resolve_callee(fn.module, fn, call.func)
        if res is None or res[0] != "fn":
            return False
        callee: FunctionInfo = res[1]
        changed = False
        params = callee.callable_params
        pairs = []
        for idx, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if idx < len(params):
                pairs.append((params[idx], arg))
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in callee.all_params:
                pairs.append((kw.arg, kw.value))
        for pname, arg in pairs:
            dset = self.dtypes(fn, arg, env, dtenv)
            if dset:
                slot = self.param_dtypes[callee].setdefault(pname, set())
                if not (dset <= slot):
                    slot |= dset
                    changed = True
            fact = self.fact(fn, arg, env, dtenv)
            if fact is not None and not fact.weak:
                cur = self.param_facts[callee].get(pname)
                if cur is None:
                    self.param_facts[callee][pname] = fact
                    changed = True
                elif cur is not _CONFLICT and cur != fact:
                    self.param_facts[callee][pname] = _CONFLICT
                    changed = True
        return changed

    # -- dtype-VALUE resolution ---------------------------------------

    def dtypes(self, fn: FunctionInfo, e, env=None,
               dtenv=None) -> Optional[FrozenSet[str]]:
        """Expression as a dtype *value* -> the set of canonical dtype
        names it may denote (None: not a dtype value / unresolvable)."""
        if e is None:
            return None
        if dtenv is None:
            dtenv = self.dtype_env.get(fn, {})
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            d = parse_dtype(e.value)
            return frozenset({d}) if d else None
        if isinstance(e, ast.Attribute):
            parts = dotted_parts(e)
            if parts and len(parts) == 2 and parts[0] == "self" \
                    and parts[1] in self.config_facts:
                return self.config_facts[parts[1]]
            name = self.package.full_name(fn.module, fn, e)
            if name and name.startswith(_DTYPE_NAMESPACES):
                d = parse_dtype(name)
                return frozenset({d}) if d else None
            return None
        if isinstance(e, ast.Name):
            got = dtenv.get(e.id)
            if got:
                return got
            scope, first = fn, True
            while scope is not None:
                if not first:
                    got = self.dtype_env.get(scope, {}).get(e.id)
                    if got:
                        return got
                pd = self.param_dtypes.get(scope, {}).get(e.id)
                if pd:
                    return frozenset(pd)
                scope, first = scope.parent, False
            return None
        if isinstance(e, ast.Call):
            name = self.package.full_name(fn.module, fn, e.func)
            if name == "numpy.dtype" and e.args:
                return self.dtypes(fn, e.args[0], env, dtenv)
            if name == "getattr" and len(e.args) >= 2 \
                    and self.package.full_name(fn.module, fn,
                                               e.args[0]) == "torch":
                return self.dtypes(fn, e.args[1], env, dtenv)
            return None
        if isinstance(e, ast.BoolOp):
            # ``cfg.get("compute_dtype") or "bfloat16"``
            out: Set[str] = set()
            for v in e.values:
                sub = self.dtypes(fn, v, env, dtenv)
                if sub:
                    out |= sub
            return frozenset(out) if out else None
        if isinstance(e, ast.IfExp):
            a = self.dtypes(fn, e.body, env, dtenv)
            b = self.dtypes(fn, e.orelse, env, dtenv)
            if a and b:
                return a | b
            return a or b
        return None

    def single_dtype(self, fn, e, env=None, dtenv=None) -> Optional[str]:
        dset = self.dtypes(fn, e, env, dtenv)
        if dset and len(dset) == 1:
            return next(iter(dset))
        return None

    # -- array-fact evaluation ----------------------------------------

    def fact(self, fn: FunctionInfo, e, env=None,
             dtenv=None) -> Optional[DtypeFact]:
        """Best-effort dtype fact for a tensor-valued expression."""
        if e is None:
            return None
        if env is None:
            env = self.env.get(fn, {})
        if dtenv is None:
            dtenv = self.dtype_env.get(fn, {})
        if isinstance(e, ast.Constant):
            v = e.value
            if isinstance(v, bool):
                return DtypeFact("bool", weak=True)
            if isinstance(v, int):
                return DtypeFact("int", weak=True)
            if isinstance(v, float):
                return DtypeFact("float32", weak=True)
            return None
        if isinstance(e, ast.Name):
            got = env.get(e.id)
            if got is not None:
                return got
            scope, first = fn, True
            while scope is not None:
                if not first:
                    got = self.env.get(scope, {}).get(e.id)
                    if got is not None:
                        return got
                pf = self.param_facts.get(scope, {}).get(e.id)
                if isinstance(pf, DtypeFact):
                    return pf
                scope, first = scope.parent, False
            return None
        if isinstance(e, ast.Subscript):
            base = self.fact(fn, e.value, env, dtenv)
            if base is None or base.weak:
                return base
            slices = e.slice.elts if isinstance(e.slice, ast.Tuple) \
                else [e.slice]
            if all(isinstance(s, ast.Slice) for s in slices):
                return base
            # an index may drop every dimension: the rank is unknown,
            # and a 0-dim tensor never promotes a dimensioned peer
            return replace(base, zero=True)
        if isinstance(e, ast.UnaryOp):
            if isinstance(e.op, ast.Not):
                return DtypeFact("bool")
            return self.fact(fn, e.operand, env, dtenv)
        if isinstance(e, ast.BinOp):
            out = promote(self.fact(fn, e.left, env, dtenv),
                          self.fact(fn, e.right, env, dtenv))
            if out is not None and isinstance(e.op, ast.Div) \
                    and out.dtype in ("int", "bool", "uint8", "int8"):
                return DtypeFact("float32", weak=out.weak,
                                 zero=out.zero)
            return out
        if isinstance(e, ast.Compare):
            return DtypeFact("bool")
        if isinstance(e, ast.IfExp):
            a = self.fact(fn, e.body, env, dtenv)
            b = self.fact(fn, e.orelse, env, dtenv)
            return a if a == b else None
        if isinstance(e, ast.Call):
            return self._call_fact(fn, e, env, dtenv)
        return None

    @staticmethod
    def _empty_shape(call: ast.Call) -> bool:
        """Does a factory call build a 0-dim tensor (``size=()``)?"""
        shape = call.args[0] if call.args else None
        for kw in call.keywords:
            if kw.arg == "size":
                shape = kw.value
        return isinstance(shape, (ast.Tuple, ast.List)) \
            and not shape.elts

    def _data_fact(self, fn, data, env, dtenv) -> Optional[DtypeFact]:
        """``torch.tensor(data)`` with no dtype: the inferred fact."""
        if isinstance(data, ast.Constant):
            f = self.fact(fn, data, env, dtenv)
            if f is None:
                return None
            return DtypeFact(f.dtype, from_weak=True, zero=True)
        if isinstance(data, (ast.List, ast.Tuple)):
            facts = [self.fact(fn, el, env, dtenv) for el in data.elts]
            if not facts or any(f is None or not f.weak for f in facts):
                return None
            cats = {_category(f.dtype) for f in facts}
            dtype = {2: "float32", 1: "int", 0: "bool"}[max(cats)]
            return DtypeFact(dtype, from_weak=True)
        inner = self.fact(fn, data, env, dtenv)
        if inner is not None and not inner.weak:
            return inner
        return None

    def _call_fact(self, fn, call: ast.Call, env, dtenv):
        name = self.package.full_name(fn.module, fn, call.func) or ""
        tail = name.rsplit(".", 1)[-1] if name else (
            call.func.attr if isinstance(call.func, ast.Attribute)
            else "")
        reducing = (isinstance(call.func, ast.Attribute)
                    and call.func.attr in _REDUCING_METHODS
                    and not call.args
                    and not any(kw.arg == "dim" for kw in call.keywords))
        # explicit dtype= wins
        for kw in call.keywords:
            if kw.arg in DTYPE_KWARGS:
                d = self.single_dtype(fn, kw.value, env, dtenv)
                if d is None:
                    return None
                zero = reducing or (name in _INFER_PRODUCERS
                                    and call.args and isinstance(
                                        call.args[0], ast.Constant)) \
                    or (name in _F32_DEFAULT_PRODUCERS | {"torch.full"}
                        and self._empty_shape(call))
                return DtypeFact(d, zero=bool(zero))
        dset = self.cast_target(fn, call, env, dtenv)
        if dset is not None:
            if len(dset) != 1:
                return None
            base = self.fact(fn, call.func.value, env, dtenv)
            return DtypeFact(next(iter(dset)),
                             zero=bool(base is not None and base.zero))
        if isinstance(call.func, ast.Attribute):
            if call.func.attr == "to":  # a device move: dtype unchanged
                return self.fact(fn, call.func.value, env, dtenv)
            if call.func.attr in _PASSTHROUGH_METHODS \
                    and not name.startswith(("torch.", "numpy.")):
                base = self.fact(fn, call.func.value, env, dtenv)
                if base is not None and reducing and not base.weak:
                    return replace(base, zero=True)
                return base
        if name.startswith("numpy."):
            if name in _ASARRAY_FNS:
                if len(call.args) >= 2:
                    d = self.single_dtype(fn, call.args[1], env, dtenv)
                    return DtypeFact(d) if d else None
                return None
            d = parse_dtype(name)
            if d is not None:  # np.float32(0.5): a scalar to torch
                return DtypeFact(d, weak=True)
            return None
        if name in _F32_DEFAULT_PRODUCERS:
            return DtypeFact("float32", zero=self._empty_shape(call))
        if name == "torch.full" and len(call.args) >= 2:
            fill = self.fact(fn, call.args[1], env, dtenv)
            if fill is None or not fill.weak:
                return None
            return DtypeFact(fill.dtype, from_weak=True,
                             zero=self._empty_shape(call))
        if name in _INFER_PRODUCERS and call.args:
            return self._data_fact(fn, call.args[0], env, dtenv)
        if name in _LIKE_PRODUCERS and call.args:
            return self.fact(fn, call.args[0], env, dtenv)
        if name.startswith("torch."):
            if tail in _BOOL_RESULTS:
                return DtypeFact("bool")
            if tail in _NON_PASSTHROUGH:
                return None
            if id(call) in self.autocast_nodes and tail in _AUTOCAST_OPS:
                return DtypeFact(self.autocast_nodes[id(call)])
            # generic elementwise/reduction passthrough: only when
            # EVERY positional arg has a known fact
            if not call.args:
                return None
            out = None
            for i, arg in enumerate(call.args):
                f = self.fact(fn, arg, env, dtenv)
                if f is None:
                    return None
                out = f if i == 0 else promote(out, f)
            return out
        res = self.package.resolve_callee(fn.module, fn, call.func)
        if res is not None and res[0] == "fn":
            return self.returns.get(res[1])
        return None

    # -- compute reachability -----------------------------------------

    def _fn_value(self, mod: ModuleInfo, scope, expr) \
            -> Optional[FunctionInfo]:
        if isinstance(expr, ast.Lambda):
            return mod.by_node.get(expr)
        if isinstance(expr, (ast.Name, ast.Attribute)):
            res = self.package.resolve_callee(mod, scope, expr)
            if res is not None and res[0] == "fn":
                return res[1]
        return None

    def _build_compute_set(self):
        work = deque()

        def seed(fn):
            if fn is not None and fn not in self.compute_fns:
                self.compute_fns.add(fn)
                work.append(fn)

        # eager torch runs every op on the device as it is called: every
        # function of a module that imports torch is compute, and so is
        # everything compiled or captured
        for fn in self.package.all_functions():
            if fn.jit_reachable or _imports_torch(fn.module):
                seed(fn)
        for mod in self.package.modules.values():
            for scope, call in _walk_calls(mod):
                name = self.package.full_name(mod, scope, call.func)
                if name in _COMPUTE_WRAPPERS:
                    for arg in call.args:
                        seed(self._fn_value(mod, scope, arg))
        guard = 0
        while work and guard < 10000:
            guard += 1
            fn = work.popleft()
            mod = fn.module
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                res = self.package.resolve_callee(mod, fn, node.func)
                if res is not None and res[0] == "fn":
                    seed(res[1])
                for arg in list(node.args) \
                        + [kw.value for kw in node.keywords]:
                    seed(self._fn_value(mod, fn, arg))

    def call_dtype_kwarg(self, fn, call: ast.Call) \
            -> Optional[FrozenSet[str]]:
        """The dtype named by a ``dtype=``/``preferred_element_type=``
        kwarg on this call, if any resolves."""
        for kw in call.keywords:
            if kw.arg in DTYPE_KWARGS:
                return self.dtypes(fn, kw.value)
        return None


def _imports_torch(mod: ModuleInfo) -> bool:
    return any(t == "torch" or t.startswith("torch.")
               for t in mod.aliases.values()) or any(
        src == "torch" or src.startswith("torch.")
        for src, _sym in mod.from_imports.values())


def analyze_num(package: Package) -> NumAnalysis:
    """Build (once) and cache the dtype analysis for a package."""
    an = getattr(package, "_numlint_analysis", None)
    if an is None:
        an = NumAnalysis(package)
        package._numlint_analysis = an
    return an
