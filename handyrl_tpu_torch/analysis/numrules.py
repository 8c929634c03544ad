"""numlint's rule registry: six dtype/precision rules for the hot path.

Same shape as :mod:`.rules` / :mod:`.shardrules` / :mod:`.commrules` /
:mod:`.racerules` — each rule is ``(Package, ModuleInfo) ->
Iterable[Finding]`` under a stable kebab-case id (what suppression
comments name), registered in ``NUM_RULES`` and consuming the dtype
lattice of :mod:`.numlint`.  None of them import torch.  Each rule
fires on what torch does, not on what JAX would do.

The rules, and the numerics failure each one prevents:

  ``implicit-upcast``      a bf16 operand mixed with a dimensioned
                           fp32/fp64 tensor -> torch promotes the
                           result to fp32 and the tensor cores run at
                           the fp32 rate.  A Python scalar or a 0-dim
                           tensor never promotes a dimensioned bf16
                           tensor, so those stay quiet.
  ``weak-type-promotion``  a tensor built from Python values with no
                           ``dtype=`` (``torch.tensor([0.5])``,
                           ``torch.full((n,), 0.5)``) took float32 and,
                           having a dimension, drags bf16 peers up;
                           written as a bare ``0.5`` or a 0-dim
                           ``torch.tensor(0.5)`` it would have followed
                           the bf16 operand.
  ``lowp-accum``           a reduction asked to accumulate in bf16
                           (``sum``/``cumsum``/``mean`` with
                           ``dtype=torch.bfloat16``), or a bf16
                           accumulator updated across a Python loop ->
                           every step rounds to 8 mantissa bits and
                           the sum drifts.  ``matmul``/``conv``/``sum``
                           over bf16 accumulate in fp32 on the card
                           and stay quiet.
  ``unguarded-cast``       a lossy downcast (uint8/int8, or
                           fp32->bf16) escaping to a serialization /
                           shm / IPC boundary with no round-trip
                           check — ``staging.py``'s uint8 round-trip
                           assert is the guarded idiom.
  ``dtype-split-brain``    a function returning a dict/tuple that
                           mixes master-fp32 and compute-bf16 leaves
                           -> downstream consumers see a per-leaf
                           dtype lottery and the runtime NumericsGuard
                           counts contract breaks.
  ``nonfinite-risk``       ``torch.log``/``exp``/``sqrt`` on unclamped
                           inputs, or a division by a bare mask count
                           -> one empty mask or saturated ratio turns
                           the loss into NaN/Inf and poisons every
                           parameter in a single step.  ``+ eps``
                           denominators, ``clamp``/``maximum`` guards
                           and ``log_softmax`` results stay quiet.

Intentional fp32 islands suppress per line with
``# torchlint: disable=<rule> -- reason``.
"""

import ast
from typing import Dict, Optional, Set

from .astutil import ModuleInfo, Package
from .numlint import (
    DTYPE_KWARGS, DtypeFact, HIGH_PRECISION, LOSSY_TARGETS,
    LOW_PRECISION, _own_nodes, analyze_num, promote,
)
from .rules import Finding, Rule

NUM_RULES: Dict[str, Rule] = {}


def num_rule(rule_id: str, summary: str):
    def deco(fn):
        NUM_RULES[rule_id] = Rule(rule_id, summary, fn.__doc__ or "",
                                  fn)
        return fn
    return deco


def _loc(node):
    return node.lineno, getattr(node, "col_offset", 0)


def _is_low(f: Optional[DtypeFact]) -> bool:
    return f is not None and f.dtype in LOW_PRECISION and not f.weak


def _is_high_concrete(f: Optional[DtypeFact]) -> bool:
    return (f is not None and f.dtype in HIGH_PRECISION
            and not f.weak and not f.from_weak)


def _promotes(lo: DtypeFact, hi: DtypeFact) -> bool:
    """Does torch give ``lo op hi`` a dtype other than ``lo``'s?"""
    out = promote(lo, hi)
    return out is not None and out.dtype != lo.dtype


def _compute_functions(an, mod: ModuleInfo):
    """This module's functions that run device compute (every function
    of a module that imports torch, plus compiled and captured code
    and its callees — see :attr:`NumAnalysis.compute_fns`)."""
    for fn in mod.functions:
        if fn in an.compute_fns:
            yield fn


# ---------------------------------------------------------------------
# precision mixing
# ---------------------------------------------------------------------

@num_rule("implicit-upcast",
          "bf16 operand mixed with a dimensioned fp32 tensor")
def check_implicit_upcast(package: Package, mod: ModuleInfo):
    """A binary op mixes a low-precision (bf16/fp16) operand with a
    *concrete*, dimensioned fp32/fp64 tensor — an fp32 activation, a
    ``torch.zeros(n)`` default, a ``.float()`` result.  torch promotes
    the result to the high dtype (``torch.result_type``), so compute
    the mixed-precision regime put in bf16 silently runs at the fp32
    rate.  A Python scalar or a 0-dim tensor does not promote a
    dimensioned bf16 tensor and never fires here.  Cast the high
    operand down at the boundary.  Deliberate fp32 islands (Adam
    moments, V-Trace recursions) suppress with a reason."""
    an = analyze_num(package)
    for fn in _compute_functions(an, mod):
        for node in _own_nodes(fn):
            if not isinstance(node, ast.BinOp):
                continue
            left = an.fact(fn, node.left)
            right = an.fact(fn, node.right)
            for lo, hi in ((left, right), (right, left)):
                if _is_low(lo) and _is_high_concrete(hi) \
                        and _promotes(lo, hi):
                    line, col = _loc(node)
                    yield Finding(
                        "implicit-upcast", mod.path, line, col,
                        f"{lo.dtype} operand mixed with a dimensioned "
                        f"{hi.dtype} tensor — torch promotes the result "
                        f"to {hi.dtype}; cast the {hi.dtype} side down "
                        f"(or make it a Python scalar)")
                    break


@num_rule("weak-type-promotion",
          "a tensor built from Python values with no dtype= drags bf16 "
          "compute up to fp32")
def check_weak_type_promotion(package: Package, mod: ModuleInfo):
    """A tensor built from Python values with no ``dtype=``
    (``torch.tensor([0.5])``, ``torch.full((n,), 0.5)``,
    ``torch.as_tensor([..])``) takes the default dtype, float32, and
    because it has a dimension it promotes the bf16 operand it is
    mixed with.  A bare ``0.5`` — or a 0-dim ``torch.tensor(0.5)`` —
    would have followed the bf16 operand.  Pass the compute dtype at
    the constructor, or keep the value a scalar."""
    an = analyze_num(package)
    for fn in _compute_functions(an, mod):
        for node in _own_nodes(fn):
            if not isinstance(node, ast.BinOp):
                continue
            left = an.fact(fn, node.left)
            right = an.fact(fn, node.right)
            for lo, wk in ((left, right), (right, left)):
                if _is_low(lo) and wk is not None and wk.from_weak \
                        and wk.dtype in HIGH_PRECISION \
                        and _promotes(lo, wk):
                    line, col = _loc(node)
                    yield Finding(
                        "weak-type-promotion", mod.path, line, col,
                        f"a tensor built from Python values took "
                        f"{wk.dtype} (no dtype=) and promotes this "
                        f"{lo.dtype} operand — pass dtype= at the "
                        f"constructor or keep the value a scalar")
                    break


# ---------------------------------------------------------------------
# accumulation precision
# ---------------------------------------------------------------------

_ACCUM_FNS = frozenset({"torch.sum", "torch.mean", "torch.cumsum",
                        "torch.nansum", "torch.nanmean"})
_ACCUM_METHODS = frozenset({"sum", "mean", "cumsum", "nansum",
                            "nanmean"})


@num_rule("lowp-accum",
          "a reduction or a Python-loop accumulator runs in bf16")
def check_lowp_accum(package: Package, mod: ModuleInfo):
    """Two places torch really accumulates at low precision.
    ``sum``/``cumsum``/``mean`` given ``dtype=torch.bfloat16`` cast
    the input to bf16 before reducing and return a bf16 result, so the
    low bits are gone; and a bf16 tensor updated across a Python loop
    (``acc = acc + x`` / ``acc += x``, the recurrent scan's carry)
    rounds to bf16 at every step, and a long loop drifts.  A
    ``matmul``, a convolution or a plain ``sum`` over bf16 operands
    accumulates in fp32 inside the kernel on the card and stays quiet.
    Accumulate in fp32 and cast once at the end."""
    an = analyze_num(package)
    for fn in _compute_functions(an, mod):
        seen: Set[int] = set()
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                name = package.full_name(mod, fn, node.func)
                is_accum = name in _ACCUM_FNS or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _ACCUM_METHODS
                    and not (name or "").startswith("numpy."))
                if not is_accum:
                    continue
                dset = an.call_dtype_kwarg(fn, node)
                if dset and len(dset) == 1 \
                        and next(iter(dset)) in LOW_PRECISION:
                    op = (name or node.func.attr).rsplit(".", 1)[-1]
                    line, col = _loc(node)
                    yield Finding(
                        "lowp-accum", mod.path, line, col,
                        f"`{op}` with dtype={next(iter(dset))} rounds "
                        f"its input and result to low precision — "
                        f"reduce in float32 and cast the result")
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                yield from _loop_accumulators(an, mod, fn, node, seen)


def _loop_accumulators(an, mod, fn, loop, seen):
    """``acc = acc + x`` / ``acc += x`` in a loop body, with ``acc`` a
    definite low-precision tensor (each statement once, however many
    loops enclose it)."""
    for stmt in ast.walk(loop):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) or id(stmt) in seen:
            continue
        name = None
        if isinstance(stmt, ast.AugAssign) \
                and isinstance(stmt.op, (ast.Add, ast.Sub)) \
                and isinstance(stmt.target, ast.Name):
            name = stmt.target.id
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.BinOp) \
                and isinstance(stmt.value.op, (ast.Add, ast.Sub)) \
                and any(isinstance(side, ast.Name)
                        and side.id == stmt.targets[0].id
                        for side in (stmt.value.left, stmt.value.right)):
            name = stmt.targets[0].id
        if name is None:
            continue
        f = an.fact(fn, ast.Name(id=name, ctx=ast.Load()))
        if isinstance(stmt, ast.Assign):
            f = an.fact(fn, stmt.value) or f
        if _is_low(f):
            seen.add(id(stmt))
            line, col = _loc(stmt)
            yield Finding(
                "lowp-accum", mod.path, line, col,
                f"'{name}' accumulates across this loop in {f.dtype} — "
                f"every step rounds to {f.dtype}; carry the sum in "
                f"float32 and cast once after the loop")


# ---------------------------------------------------------------------
# lossy casts at boundaries
# ---------------------------------------------------------------------

_SINK_METHODS = frozenset({
    "send", "send_bytes", "put", "put_nowait", "write", "dump",
    "dumps", "save", "tobytes",
})
_SINK_FNS = frozenset({
    "pickle.dumps", "pickle.dump", "numpy.save", "numpy.savez",
    "numpy.savez_compressed",
})
_ROUNDTRIP_FNS = frozenset({
    "numpy.array_equal", "numpy.allclose",
    "numpy.testing.assert_allclose", "numpy.testing.assert_array_equal",
    "torch.equal", "torch.allclose", "torch.isclose",
    "torch.testing.assert_close",
})
_SINK_FNS = _SINK_FNS | frozenset({"torch.save"})


def _names_in(node) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


@num_rule("unguarded-cast",
          "lossy downcast escapes to a serialization boundary with "
          "no round-trip check")
def check_unguarded_cast(package: Package, mod: ModuleInfo):
    """A lossy cast (``.to(torch.uint8)``, ``.byte()``, numpy's
    ``astype(np.uint8)``, or a definite fp32->bf16 drop) whose result
    leaves the process — sent over a pipe/queue, written
    to shm, pickled, saved — with no round-trip assert or tolerance
    gate anywhere in the function.  Quantized wire formats are fine
    *when audited*: the ``staging.py`` uint8 path round-trips the
    first frame through an assert, and that guard is exactly what
    quiets this rule."""
    an = analyze_num(package)
    for fn in mod.functions:
        nodes = _own_nodes(fn)
        # lossy cast sites: (call node, bound name or None, src name)
        casts = []
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            target = src = None
            dset = an.cast_target(fn, node)
            if dset is not None:
                target = next(iter(dset)) if len(dset) == 1 else None
                src = node.func.value
            else:
                name = package.full_name(mod, fn, node.func)
                if name and name.rsplit(".", 1)[-1] in (
                        "asarray", "array", "tensor", "as_tensor") \
                        and node.args:
                    for kw in node.keywords:
                        if kw.arg == "dtype":
                            target = an.single_dtype(fn, kw.value)
                    src = node.args[0]
            if target is None:
                continue
            src_fact = an.fact(fn, src)
            lossy = (target in LOSSY_TARGETS
                     and (src_fact is None
                          or src_fact.dtype != target)) \
                or (target in LOW_PRECISION
                    and _is_high_concrete(src_fact))
            if lossy:
                casts.append((node, target, src))
        if not casts:
            continue
        # single-target bindings: name -> value node
        bound: Dict[ast.AST, str] = {}
        for node in nodes:
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                bound[node.value] = node.targets[0].id
        for call, target, src in casts:
            watch = {bound[call]} if call in bound else set()
            if isinstance(src, ast.Name):
                src_name = src.id
            else:
                src_name = None
            # does the cast escape?
            escapes = False
            for node in nodes:
                if isinstance(node, ast.Call):
                    is_sink = (isinstance(node.func, ast.Attribute)
                               and node.func.attr in _SINK_METHODS) \
                        or package.full_name(mod, fn,
                                             node.func) in _SINK_FNS
                    if is_sink and any(
                            a is call or (_names_in(a) & watch)
                            for a in node.args):
                        escapes = True
                elif isinstance(node, ast.Return) and watch \
                        and node.value is not None \
                        and (_names_in(node.value) & watch):
                    escapes = True
                elif isinstance(node, ast.Assign) and watch:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Subscript) \
                                and (_names_in(node.value) & watch):
                            escapes = True
            if not escapes:
                continue
            # round-trip guard anywhere in the function?
            guard_names = set(watch)
            if src_name:
                guard_names.add(src_name)
            guarded = False
            for node in nodes:
                if isinstance(node, ast.Assert) \
                        and (_names_in(node.test) & guard_names):
                    guarded = True
                elif isinstance(node, ast.Call) \
                        and package.full_name(
                            mod, fn, node.func) in _ROUNDTRIP_FNS \
                        and any(_names_in(a) & guard_names
                                for a in node.args):
                    guarded = True
            if guarded:
                continue
            line, col = _loc(call)
            yield Finding(
                "unguarded-cast", mod.path, line, col,
                f"cast to {target} escapes to a serialization "
                f"boundary with no round-trip check — assert the "
                f"decode matches (staging.py's uint8 idiom) or gate "
                f"it behind a tolerance")


# ---------------------------------------------------------------------
# return contracts
# ---------------------------------------------------------------------

@num_rule("dtype-split-brain",
          "returned pytree mixes bf16 and fp32 leaves against one "
          "contract")
def check_dtype_split_brain(package: Package, mod: ModuleInfo):
    """A function returns a dict/tuple/list literal whose leaves mix
    definite low-precision and definite high-precision dtypes.  Every
    consumer now inherits a per-leaf dtype lottery — the static twin
    of what the runtime NumericsGuard counts as a contract break.
    Cast the leaves to one declared dtype at the return, or split the
    master-fp32 and compute-bf16 trees into separate returns."""
    an = analyze_num(package)
    for fn in mod.functions:
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            val = node.value
            if isinstance(val, ast.Dict):
                leaves = [v for v in val.values]
            elif isinstance(val, (ast.Tuple, ast.List)):
                leaves = list(val.elts)
            else:
                continue
            lows, highs = [], []
            for leaf in leaves:
                f = an.fact(fn, leaf)
                if _is_low(f):
                    lows.append(f.dtype)
                elif _is_high_concrete(f):
                    highs.append(f.dtype)
            if lows and highs:
                line, col = _loc(node)
                yield Finding(
                    "dtype-split-brain", mod.path, line, col,
                    f"returned pytree mixes {sorted(set(lows))} and "
                    f"{sorted(set(highs))} leaves — cast to one "
                    f"declared dtype or split the trees")


# ---------------------------------------------------------------------
# nonfinite producers
# ---------------------------------------------------------------------

_LOG_LIKE = frozenset({"torch.log", "torch.log2", "torch.log10"})
_EXP_LIKE = frozenset({"torch.exp"})
_SQRT_LIKE = frozenset({"torch.sqrt", "torch.rsqrt"})
_METHOD_KINDS = {"log": "log", "log2": "log", "log10": "log",
                 "exp": "exp", "sqrt": "sqrt", "rsqrt": "sqrt"}
_CLAMP_ALL = ("clip", "clamp")
_CLAMP_LOW = ("maximum", "clamp_min", "abs", "square", "exp",
              "softmax", "sigmoid")  # guards log/sqrt/div lower bound
_CLAMP_HIGH = ("minimum", "clamp_max", "log_softmax", "logsigmoid",
               "tanh")               # guards exp upper bound
_REDUCTIONS = frozenset({"sum", "mean"})


def _positive_const(node) -> bool:
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool)
            and node.value > 0)


class _NonfiniteScan:
    """Per-function guard reasoning for log/exp/sqrt/div inputs."""

    def __init__(self, package: Package, mod: ModuleInfo, fn):
        self.pkg = package
        self.mod = mod
        self.fn = fn
        # single-assignment bindings, for chasing names into guards
        self.bindings: Dict[str, ast.AST] = {}
        seen: Set[str] = set()
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if name in seen:
                    self.bindings.pop(name, None)
                else:
                    seen.add(name)
                    self.bindings[name] = node.value

    def _callee_tail(self, call: ast.Call) -> Optional[str]:
        name = self.pkg.full_name(self.mod, self.fn, call.func)
        if name:
            return name.rsplit(".", 1)[-1]
        if isinstance(call.func, ast.Attribute):
            return call.func.attr
        return None

    def guarded(self, expr, kind: str, depth: int = 4) -> bool:
        """Is this input safe for ``kind`` in {log, exp, sqrt, div}?"""
        if depth <= 0:
            return False
        if isinstance(expr, ast.Constant):
            return True
        if isinstance(expr, ast.Name):
            chased = self.bindings.get(expr.id)
            if chased is not None:
                return self.guarded(chased, kind, depth - 1)
            return False
        if isinstance(expr, ast.Subscript):
            # shape[i]-style static denominators
            base = expr.value
            if isinstance(base, ast.Attribute) \
                    and base.attr in ("shape",):
                return True
            return self.guarded(base, kind, depth - 1)
        if isinstance(expr, ast.Attribute):
            return expr.attr in ("shape", "size", "ndim")
        if isinstance(expr, ast.Call):
            tail = self._callee_tail(expr)
            if tail in _CLAMP_ALL:
                return True
            if tail in ("stack", "cat") and expr.args \
                    and isinstance(expr.args[0], (ast.List, ast.Tuple,
                                                  ast.ListComp)):
                # a stack of guarded values is guarded
                elts = expr.args[0]
                elts = [elts.elt] if isinstance(elts, ast.ListComp) \
                    else elts.elts
                return bool(elts) and all(
                    self.guarded(el, kind, depth - 1) for el in elts)
            if kind in ("log", "sqrt", "div") and tail in _CLAMP_LOW:
                return True
            if kind == "exp" and tail in _CLAMP_HIGH:
                return True
            return False
        if isinstance(expr, ast.BinOp):
            if isinstance(expr.op, ast.Add) and kind != "exp" \
                    and (_positive_const(expr.left)
                         or _positive_const(expr.right)):
                return True  # the `+ eps` idiom
            if isinstance(expr.op, ast.Pow) and kind != "exp" \
                    and isinstance(expr.right, ast.Constant) \
                    and isinstance(expr.right.value, int) \
                    and expr.right.value % 2 == 0:
                return True  # an even power, like square()
            if isinstance(expr.op, (ast.Mult, ast.Div)):
                return self.guarded(expr.left, kind, depth - 1) \
                    and self.guarded(expr.right, kind, depth - 1)
            return False
        if isinstance(expr, ast.UnaryOp):
            return self.guarded(expr.operand, kind, depth - 1)
        return False

    def risky_reduction_denom(self, expr, depth: int = 3) -> bool:
        """Is this denominator an unguarded mask-count reduction
        (``tmasks.sum()`` with no ``+ eps``)?"""
        if depth <= 0:
            return False
        if isinstance(expr, ast.Name):
            chased = self.bindings.get(expr.id)
            return chased is not None \
                and self.risky_reduction_denom(chased, depth - 1)
        if isinstance(expr, ast.Call):
            if self.pkg.full_name(self.mod, self.fn, expr.func) == "sum":
                return False  # the builtin sums Python numbers
            tail = self._callee_tail(expr)
            return tail in _REDUCTIONS \
                and not any(kw.arg in DTYPE_KWARGS + ("where",)
                            for kw in expr.keywords)
        return False


@num_rule("nonfinite-risk",
          "log/exp/div/sqrt on unclamped inputs in device compute")
def check_nonfinite_risk(package: Package, mod: ModuleInfo):
    """A nonfinite producer in device compute: ``torch.log`` /
    ``torch.sqrt`` (or ``.log()``/``.sqrt()``) on an input with no
    clamp/eps lower bound, ``torch.exp`` on an unbounded exponent
    (importance ratios!), or a division whose denominator is a bare
    mask-count reduction (``x / tmasks.sum()`` — one empty mask and
    the loss is NaN).  Clamp at the producer:
    ``torch.log(p.clamp(1e-16, 1.0))``,
    ``torch.exp(logr.clamp(-20, 20))``, ``/ (count + 1e-8)``.  The
    analysis chases single-assignment names up to four hops, so
    naming the clamped value first costs nothing."""
    an = analyze_num(package)
    for fn in _compute_functions(an, mod):
        scan = _NonfiniteScan(package, mod, fn)
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                name = package.full_name(mod, fn, node.func)
                kind = None
                arg = node.args[0] if node.args else None
                if name in _LOG_LIKE:
                    kind = "log"
                elif name in _EXP_LIKE:
                    kind = "exp"
                elif name in _SQRT_LIKE:
                    kind = "sqrt"
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _METHOD_KINDS \
                        and not node.args \
                        and not (name or "").startswith(
                            ("math.", "numpy.", "torch.")):
                    kind = _METHOD_KINDS[node.func.attr]
                    arg = node.func.value
                if kind is None or arg is None:
                    continue
                if scan.guarded(arg, kind):
                    continue
                line, col = _loc(node)
                op = (name or kind).rsplit(".", 1)[-1]
                yield Finding(
                    "nonfinite-risk", mod.path, line, col,
                    f"`{op}` on an unclamped input — clamp at the "
                    f"producer (clamp / maximum / + eps) so one "
                    f"bad step cannot poison the parameters")
            elif isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.Div):
                if not scan.risky_reduction_denom(node.right):
                    continue
                if scan.guarded(node.right, "div"):
                    continue
                line, col = _loc(node)
                yield Finding(
                    "nonfinite-risk", mod.path, line, col,
                    "division by a bare mask-count reduction — an "
                    "empty mask divides by zero; add the `+ eps` "
                    "the other denominators here carry")
