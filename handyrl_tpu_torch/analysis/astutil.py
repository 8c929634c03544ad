"""AST machinery behind torchlint: package model + taint analyses.

torchlint's rules need to answer three questions that plain per-line
pattern matching cannot:

  * which functions execute *inside* a compile or capture region?
    (``torch.compile`` as a call or a decorator, ``torch.jit.script``
    / ``trace``, ``torch.cuda.make_graphed_callables``, and every call
    made in a ``with torch.cuda.graph(g):`` body or between
    ``g.capture_begin()`` and ``g.capture_end()`` — plus everything
    reachable from them through direct calls and function-valued
    arguments);
  * which values are *traced tensors* there?  (entry parameters,
    propagated through assignments — but NOT through ``.shape`` /
    ``.dtype`` / ``.size()`` / ``len()`` / ``is None``, which are
    static at trace time and therefore safe to branch on);
  * which host-side values are *device tensors*?  (results of torch
    factories given a ``device=``, of ``.to(device)`` / ``.cuda()``,
    of calling a module that was moved to the device, and of calling
    a compiled callable — propagated through containers, attributes
    and function-return summaries, so ``float(metrics["loss"])`` in an
    epoch loop is recognized as a device->host sync even though
    ``metrics`` crossed two functions).

What stays unknown: a CPU tensor and a CUDA tensor look alike in the
AST.  A tensor counts as on the device only when the code puts it
there (a ``device=`` that is not the literal ``"cpu"``, ``.to(x)``
with such an ``x``, ``.cuda()``), or when it is computed from such a
tensor.  ``self.device`` and other symbolic devices count as the card
(the port's entry points default to ``cuda``); a tensor built with no
device, or handed in by a caller outside the scanned files, is host
data to the lattice.  The rules therefore miss syncs on tensors whose
placement the scanned code does not show, and never flag pure-CPU
tensor code.

The names keep the JAX package's module's (``jit_reachable``,
``JitMeta``, ``find_jit_entries``): "jit" there means compiled or
captured.

Everything here is stdlib ``ast`` only — the linter never imports
torch, so it runs in a fresh interpreter in seconds for the whole
package, with no CUDA initialization.

The analyses are deliberately *monotone and approximate*: taint only
ever grows, locals are flow-insensitive within a function, and
unresolvable calls default to "tainted if any argument is tainted".
That bias keeps the engine small and the false-negative rate low; the
per-rule suppression syntax (see :mod:`.torchlint`) is the escape
hatch for the rare intentional violation.
"""

import ast
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

# Attribute reads (and metadata methods) that yield static, host-side
# facts about a tensor, never a tensor value: branching on these is
# always safe and never syncs.
SAFE_ATTRS = frozenset({
    "shape", "ndim", "dtype", "size", "dim", "numel", "device",
    "is_cuda", "requires_grad", "layout", "stride", "itemsize",
    "nbytes", "element_size", "is_floating_point", "is_contiguous",
    "is_leaf", "names",
})

# Wrappers whose first argument becomes a compiled (traced or
# captured) entry point.
JIT_WRAPPERS = frozenset({
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
})
# Context managers whose body is captured into a CUDA graph, and the
# method pair that brackets a manual capture.
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph"})
CAPTURE_BEGIN, CAPTURE_END = "capture_begin", "capture_end"
GRAPH_BUILDERS = frozenset({"torch.cuda.CUDAGraph", "torch.cuda.graph"})

# Calls whose result is definitely host data (break device taint).
HOST_RESULT_FNS = frozenset({
    "numpy.asarray", "numpy.array", "numpy.shape",
    "float", "int", "bool", "len", "isinstance", "type", "str", "repr",
    "hasattr", "callable",
})
# Tensor methods that copy to (or read out on) the host.
HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# Calls that block the host until the card drains its queue.
SYNC_FNS = frozenset({"torch.cuda.synchronize"})
# Tree maps: a map over a host converter returns host data.
TREE_MAP_TAILS = frozenset({"tree_map", "tree_map_leaves"})

_TORCH_DTYPES = frozenset({
    "float32", "float", "float64", "double", "float16", "half",
    "bfloat16", "uint8", "int8", "int16", "short", "int32", "int",
    "int64", "long", "bool", "complex64", "complex128",
})


def is_cpu_literal(node) -> bool:
    """``"cpu"`` / ``"cpu:0"`` / ``torch.device("cpu")`` — a device
    spelled as the host."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and node.args:
        parts = dotted_parts(node.func)
        if parts and parts[-1] == "device":
            return is_cpu_literal(node.args[0])
    return False


def is_dtype_expr(node) -> bool:
    """``torch.float32``-style attribute: a dtype, not a device."""
    parts = dotted_parts(node)
    return bool(parts) and len(parts) >= 2 \
        and parts[0] in ("torch",) and parts[-1] in _TORCH_DTYPES


def to_target(call: ast.Call):
    """For ``x.to(...)``: ``"host"``, ``"device"`` or ``"dtype"`` (a
    pure dtype cast leaves the placement as it was)."""
    device = None
    for kw in call.keywords:
        if kw.arg == "device":
            device = kw.value
    if device is None and call.args:
        first = call.args[0]
        if not is_dtype_expr(first) and not (
                isinstance(first, ast.Constant)
                and first.value is None):
            device = first
    if device is None:
        return "dtype"
    return "host" if is_cpu_literal(device) else "device"


def placement_of_call(call: ast.Call) -> Optional[str]:
    """Where a call puts its tensor result, read off the call alone:
    ``"host"`` for ``.cpu()``/``.numpy()``/``.item()``/``.tolist()``/
    ``.to("cpu")`` and a ``device="cpu"`` factory, ``"device"`` for
    ``.cuda()``/``.to(device)`` and a factory given any other
    ``device=``, else None."""
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in HOST_METHODS:
            return "host"
        if attr == "cuda":
            return "device"
        if attr == "to":
            target = to_target(call)
            return None if target == "dtype" else target
    for kw in call.keywords:
        if kw.arg == "device":
            return "host" if is_cpu_literal(kw.value) else "device"
    return None


def dotted_parts(node) -> Optional[List[str]]:
    """``a.b.c`` attribute chain -> ``["a", "b", "c"]`` (None if the
    chain bottoms out in anything but a plain Name)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    return parts


@dataclass
class JitMeta:
    """One compiled callable: the wrapper that built it
    (``torch.compile``, ``torch.jit.script``, ...).  torch has no
    static-argument or donation contract to record."""

    wrapper: str = ""


def jit_meta_from_call(call: ast.Call, wrapper: str = "") -> JitMeta:
    """The compiled-callable marker of a ``torch.compile(...)`` call."""
    return JitMeta(wrapper=wrapper)


class FunctionInfo:
    """One function/method/lambda in the scanned package."""

    def __init__(self, qname, node, module, parent, cls_name):
        self.qname = qname
        self.node = node
        self.module = module
        self.parent = parent          # enclosing FunctionInfo or None
        self.cls_name = cls_name      # enclosing class name or None
        args = node.args
        self.pos_params = [a.arg for a in args.posonlyargs + args.args]
        self.all_params = list(self.pos_params)
        if args.vararg:
            self.all_params.append(args.vararg.arg)
        self.all_params += [a.arg for a in args.kwonlyargs]
        if args.kwarg:
            self.all_params.append(args.kwarg.arg)
        self.local_defs: Dict[str, "FunctionInfo"] = {}

        # tracer-taint state (grown by the interprocedural worklist)
        self.jit_reachable = False
        self.tainted_params: Set[str] = set()
        self.tracer_locals: Set[str] = set()

        # device-taint state (grown by the package fixpoint)
        self.device_params: Set[str] = set()
        self.device_locals: Set[str] = set()
        self.returns_device = False
        self.returns_host = False     # host result whatever the args
        self.returns_jit: Optional[JitMeta] = None
        self.jit_locals: Dict[str, JitMeta] = {}

    @property
    def callable_params(self) -> List[str]:
        """Positional params as seen by callers (``self``/``cls``
        dropped for methods)."""
        if self.cls_name and self.pos_params[:1] in (["self"], ["cls"]):
            return self.pos_params[1:]
        return self.pos_params

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<fn {self.qname}>"


class ModuleInfo:
    """Parsed module + symbol tables."""

    def __init__(self, name: str, path: str, source: str):
        self.name = name
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.aliases: Dict[str, str] = {}         # name -> external dotted
        self.from_imports: Dict[str, Tuple[str, str]] = {}  # name -> (mod, sym)
        self.functions: List[FunctionInfo] = []
        self.by_node: Dict[ast.AST, FunctionInfo] = {}
        self.toplevel: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, Dict[str, FunctionInfo]] = {}
        # per-class attribute facts discovered by the device fixpoint
        self.class_jit_attrs: Dict[str, Dict[str, JitMeta]] = {}
        self.class_device_attrs: Dict[str, Set[str]] = {}
        _Collector(self).visit(self.tree)


class _Collector(ast.NodeVisitor):
    """Builds the function/import tables of one module."""

    def __init__(self, module: ModuleInfo):
        self.m = module
        self.fn_stack: List[FunctionInfo] = []
        self.cls_stack: List[str] = []

    # -- imports -----------------------------------------------------
    def visit_Import(self, node):
        for alias in node.names:
            name = alias.asname or alias.name.split(".")[0]
            target = alias.name if alias.asname else alias.name.split(".")[0]
            self.m.aliases[name] = target

    def visit_ImportFrom(self, node):
        if node.level > 0:
            base = self.m.name.split(".")
            base = base[: len(base) - node.level]
            target_mod = ".".join(base + ([node.module] if node.module
                                          else []))
        else:
            target_mod = node.module or ""
        for alias in node.names:
            name = alias.asname or alias.name
            self.m.from_imports[name] = (target_mod, alias.name)

    # -- scopes ------------------------------------------------------
    def visit_ClassDef(self, node):
        self.cls_stack.append(node.name)
        self.m.classes.setdefault(node.name, {})
        self.generic_visit(node)
        self.cls_stack.pop()

    def _enter_function(self, node, name):
        parent = self.fn_stack[-1] if self.fn_stack else None
        cls = self.cls_stack[-1] if self.cls_stack else None
        scope = ".".join(
            ([cls] if cls else [])
            + [f.qname.rsplit(":", 1)[1] for f in self.fn_stack[-1:]]
        )
        qname = f"{self.m.name}:{scope + '.' if scope else ''}{name}"
        info = FunctionInfo(qname, node, self.m, parent, cls)
        self.m.functions.append(info)
        self.m.by_node[node] = info
        if parent is not None:
            parent.local_defs[name] = info
        elif cls is not None:
            self.m.classes[cls][name] = info
        else:
            self.m.toplevel[name] = info
        self.fn_stack.append(info)
        self.generic_visit(node)
        self.fn_stack.pop()

    def visit_FunctionDef(self, node):
        self._enter_function(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._enter_function(node, node.name)

    def visit_Lambda(self, node):
        self._enter_function(node, f"<lambda:{node.lineno}>")


class Package:
    """All scanned modules + cross-module resolution."""

    def __init__(self, modules: List[ModuleInfo]):
        self.modules = {m.name: m for m in modules}

    # -- name resolution --------------------------------------------
    def lookup(self, module_name: str, symbol: str):
        mod = self.modules.get(module_name)
        if mod is None:
            return None
        fn = mod.toplevel.get(symbol)
        if fn is not None:
            return fn
        # chase one re-export hop (``from .x import y`` in __init__)
        imp = mod.from_imports.get(symbol)
        if imp is not None:
            target, orig = imp
            target_mod = self.modules.get(target)
            if target_mod is not None:
                return target_mod.toplevel.get(orig)
        return None

    def resolve_name(self, module: ModuleInfo, scope: Optional[FunctionInfo],
                     name: str):
        """A bare name -> ("fn", FunctionInfo) | ("ext", dotted) | None."""
        fn_scope = scope
        while fn_scope is not None:
            if name in fn_scope.local_defs:
                return ("fn", fn_scope.local_defs[name])
            fn_scope = fn_scope.parent
        if name in module.toplevel:
            return ("fn", module.toplevel[name])
        if name in module.from_imports:
            target_mod, orig = module.from_imports[name]
            fn = self.lookup(target_mod, orig)
            if fn is not None:
                return ("fn", fn)
            return ("ext", f"{target_mod}.{orig}" if target_mod else orig)
        if name in module.aliases:
            return ("ext", module.aliases[name])
        return ("ext", name)  # builtins / globals: keep the raw name

    def full_name(self, module: ModuleInfo, scope, node) -> Optional[str]:
        """Dotted call-target name with import aliases expanded, e.g.
        ``F.relu`` -> ``torch.nn.functional.relu``.  None for computed
        targets (``f()()``, subscripts)."""
        parts = dotted_parts(node)
        if parts is None:
            return None
        head, rest = parts[0], parts[1:]
        resolved = self.resolve_name(module, scope, head)
        if resolved is not None and resolved[0] == "ext":
            head = resolved[1]
        return ".".join([head] + rest)

    def resolve_callee(self, module: ModuleInfo, scope, func):
        """Call target -> ("fn", FunctionInfo) | ("ext", dotted) | None.

        Handles local defs (through enclosing scopes), module-level
        defs, package-relative imports (``from .ops.update import
        make_update_step``), module aliases (``from .parallel import
        multihost as mh`` -> ``mh.sync_epoch_code``), and
        ``self.method`` within a class.
        """
        if isinstance(func, ast.Name):
            return self.resolve_name(module, scope, func.id)
        parts = dotted_parts(func)
        if parts is None:
            return None
        if parts[0] == "self" and len(parts) == 2:
            cls = _enclosing_class(scope)
            if cls is not None:
                method = module.classes.get(cls, {}).get(parts[1])
                if method is not None:
                    return ("fn", method)
            return ("ext", f"self.{parts[1]}")
        # module alias: ``from .parallel import multihost as mh``
        if len(parts) == 2 and parts[0] in module.from_imports:
            target_mod, orig = module.from_imports[parts[0]]
            sub = f"{target_mod}.{orig}" if target_mod else orig
            fn = self.lookup(sub, parts[1])
            if fn is not None:
                return ("fn", fn)
        name = self.full_name(module, scope, func)
        return ("ext", name) if name else None

    def all_functions(self):
        for mod in self.modules.values():
            for fn in mod.functions:
                yield fn


def _enclosing_class(scope: Optional[FunctionInfo]) -> Optional[str]:
    while scope is not None:
        if scope.cls_name is not None:
            return scope.cls_name
        scope = scope.parent
    return None


def is_tree_map(name: Optional[str]) -> bool:
    return bool(name) and (name == "torch.utils._pytree.tree_map"
                           or name.rsplit(".", 1)[-1] in TREE_MAP_TAILS)


def _host_call(pkg: "Package", module: ModuleInfo, scope,
               call: ast.Call) -> bool:
    name = pkg.full_name(module, scope, call.func)
    if name in HOST_RESULT_FNS or (name or "").startswith("numpy."):
        return True
    return placement_of_call(call) == "host"


def is_host_converter(pkg: "Package", module: ModuleInfo, scope,
                      fn_expr) -> bool:
    """Is this function VALUE a host converter?  A tree map applied
    over such a function returns host data even when its tree argument
    is on the device — the ``tree_map(lambda t: t.cpu().numpy(), out)``
    idiom of every actor-facing boundary.  Shared by the device-taint
    lattice and commlint's payload scan so "what launders" has one
    definition."""
    if isinstance(fn_expr, ast.Lambda):
        body = fn_expr.body
        # unwrap trailing indexing: lambda a: a.cpu()[0]
        while isinstance(body, ast.Subscript):
            body = body.value
        if isinstance(body, ast.Call):
            return _host_call(pkg, module, scope, body)
        return False
    name = pkg.full_name(module, scope, fn_expr)
    return name in HOST_RESULT_FNS or (name or "").startswith("numpy.")


def launders_to_host(pkg: "Package", module: ModuleInfo, scope,
                     call: ast.Call) -> bool:
    """Does this CALL return host data regardless of its arguments'
    device placement?  True for the host-result builtins/numpy, the
    host-copy methods (``.cpu()``, ``.numpy()``, ``.item()``,
    ``.tolist()``, ``.to("cpu")``), and a tree map over a host
    converter."""
    if _host_call(pkg, module, scope, call):
        return True
    name = pkg.full_name(module, scope, call.func)
    return (is_tree_map(name) and bool(call.args)
            and is_host_converter(pkg, module, scope, call.args[0]))


# ---------------------------------------------------------------------
# taint evaluation
# ---------------------------------------------------------------------

_UNTAINT_CALLS = frozenset({
    "len", "isinstance", "type", "hasattr", "callable", "id", "repr",
    "print", "sorted" , "range", "enumerate", "zip", "min", "max",
})
# NOTE: float/int/bool are *not* here for tracer taint — calling them
# on a tracer is itself a violation (host-sync rule); their result
# taint is moot because the trace already failed.


class _TaintWalk(ast.NodeVisitor):
    """Shared statement walker: monotone name-taint over one function
    body, with the value logic supplied by a subclass.

    Runs the body to a fixpoint (loops make taint flow backward), then
    a final pass that records the facts rules consume (calls made,
    function-valued arguments, return taint).
    """

    MAX_PASSES = 4
    KEYS_TAINT = True  # does a tainted dict key taint the dict?

    def __init__(self, fn: FunctionInfo, package: Package):
        self.fn = fn
        self.pkg = package
        self.module = fn.module
        self.tainted: Set[str] = set()
        self.calls: List[Tuple] = []      # (resolution, node, arg_taints, kw_taints)
        self.fn_args: List[Tuple] = []    # (FunctionInfo, call node, any_other_arg_tainted)
        self.return_tainted = False
        self.collect = False

    def run(self):
        body = self.fn.node.body
        if isinstance(self.fn.node, ast.Lambda):
            body = [ast.Expr(self.fn.node.body)]
        for _ in range(self.MAX_PASSES):
            before = set(self.tainted)
            for stmt in body:
                self.handle_stmt(stmt)
            if self.tainted == before:
                break
        self.collect = True
        for stmt in body:
            self.handle_stmt(stmt)
        return self

    # -- statements --------------------------------------------------
    def handle_stmt(self, stmt):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs analyze as their own functions
        if isinstance(stmt, ast.Assign):
            t = self.taint(stmt.value)
            for tgt in stmt.targets:
                self.assign(tgt, stmt.value, t)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self.assign(stmt.target, stmt.value, self.taint(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            t = self.taint(stmt.value) or self.taint(stmt.target)
            self.assign(stmt.target, stmt.value, t)
        elif isinstance(stmt, ast.For):
            self.assign_iteration(stmt.target, stmt.iter)
            for s in stmt.body + stmt.orelse:
                self.handle_stmt(s)
        elif isinstance(stmt, ast.While):
            self.taint(stmt.test)
            for s in stmt.body + stmt.orelse:
                self.handle_stmt(s)
        elif isinstance(stmt, ast.If):
            self.taint(stmt.test)
            for s in stmt.body + stmt.orelse:
                self.handle_stmt(s)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                t = self.taint(item.context_expr)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, item.context_expr, t)
            for s in stmt.body:
                self.handle_stmt(s)
        elif isinstance(stmt, ast.Try):
            for s in (stmt.body + stmt.orelse + stmt.finalbody
                      + [h for hand in stmt.handlers for h in hand.body]):
                self.handle_stmt(s)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None and self.taint(stmt.value):
                self.return_tainted = True
            if stmt.value is not None:
                self.handle_return(stmt.value)
        elif isinstance(stmt, ast.Expr):
            self.taint(stmt.value)
            self.handle_expr_stmt(stmt.value)
        elif isinstance(stmt, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.taint(child)
        # Pass/Break/Continue/Import/Global/Delete: nothing to do

    def handle_return(self, value):
        """Hook for subclasses (device mode records compiled-callable
        returns)."""

    def handle_expr_stmt(self, value):
        """Hook for subclasses (device mode tracks ``lst.append(x)``)."""

    # -- assignment --------------------------------------------------
    def assign(self, target, value, tainted: bool):
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            self.assign_name(target.id, value, tainted)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, value, tainted)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self.assign(t, v, self.taint(v))
            else:
                for t in target.elts:
                    self.assign(t, value, tainted)
        elif isinstance(target, ast.Attribute):
            self.assign_attr(target, value, tainted)
        elif isinstance(target, ast.Subscript):
            # writing a tainted value into a container taints it
            if tainted and isinstance(target.value, ast.Name):
                self.tainted.add(target.value.id)

    def assign_name(self, name, value, tainted):
        """Hook for subclasses (device mode tracks compiled-callable
        names)."""

    def assign_attr(self, target, value, tainted):
        """Hook for subclasses (device mode tracks ``self.x`` facts)."""

    def assign_iteration(self, target, iter_expr):
        """``for target in iter_expr`` — dict ``.items()`` keys stay
        untainted (they are static strings in practice)."""
        t = self.taint(iter_expr)
        if (t and isinstance(iter_expr, ast.Call)
                and isinstance(iter_expr.func, ast.Attribute)
                and iter_expr.func.attr == "items"
                and isinstance(target, (ast.Tuple, ast.List))
                and len(target.elts) == 2):
            self.assign(target.elts[0], iter_expr, False)
            self.assign(target.elts[1], iter_expr, True)
            return
        if (isinstance(iter_expr, ast.Call)
                and isinstance(iter_expr.func, ast.Attribute)
                and iter_expr.func.attr == "keys"):
            t = False
        self.assign(target, iter_expr, t)

    # -- expressions -------------------------------------------------
    def taint(self, e) -> bool:
        if e is None or isinstance(e, (ast.Constant, ast.JoinedStr)):
            return False
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in SAFE_ATTRS:
                self.taint(e.value)
                return False
            return self.attr_taint(e)
        if isinstance(e, ast.Subscript):
            return self.subscript_taint(e)
        if isinstance(e, (ast.BinOp,)):
            left, right = self.taint(e.left), self.taint(e.right)
            return left or right
        if isinstance(e, ast.UnaryOp):
            return self.taint(e.operand)
        if isinstance(e, ast.BoolOp):
            return any([self.taint(v) for v in e.values])
        if isinstance(e, ast.Compare):
            subs = [self.taint(e.left)] + [self.taint(c)
                                           for c in e.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False  # ``x is None`` guards are static
            if any(isinstance(op, (ast.In, ast.NotIn)) for op in e.ops):
                return False  # dict/key membership idiom
            return any(subs)
        if isinstance(e, ast.Call):
            return self.call_taint(e)
        if isinstance(e, ast.IfExp):
            self.taint(e.test)
            body, orelse = self.taint(e.body), self.taint(e.orelse)
            return body or orelse
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any([self.taint(el) for el in e.elts])
        if isinstance(e, ast.Dict):
            keys = [self.taint(k) for k in e.keys if k is not None]
            vals = [self.taint(v) for v in e.values]
            return (self.KEYS_TAINT and any(keys)) or any(vals)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            self._comp_generators(e.generators)
            return self.taint(e.elt)
        if isinstance(e, ast.DictComp):
            self._comp_generators(e.generators)
            k, v = self.taint(e.key), self.taint(e.value)
            return (self.KEYS_TAINT and k) or v
        if isinstance(e, ast.Starred):
            return self.taint(e.value)
        if isinstance(e, (ast.Await, ast.YieldFrom)):
            return self.taint(e.value)
        if isinstance(e, ast.Yield):
            return self.taint(e.value) if e.value else False
        if isinstance(e, ast.NamedExpr):
            t = self.taint(e.value)
            self.assign(e.target, e.value, t)
            return t
        if isinstance(e, ast.Lambda):
            return False  # a function value, not a data value
        if isinstance(e, ast.Slice):
            for part in (e.lower, e.upper, e.step):
                self.taint(part)
            return False
        if isinstance(e, ast.FormattedValue):
            self.taint(e.value)
            return False
        return False

    def subscript_taint(self, e: ast.Subscript) -> bool:
        value, index = self.taint(e.value), self.taint(e.slice)
        return value or index

    def _comp_generators(self, generators):
        for gen in generators:
            self.assign_iteration(gen.target, gen.iter)
            for cond in gen.ifs:
                self.taint(cond)

    def attr_taint(self, e: ast.Attribute) -> bool:
        return self.taint(e.value)

    # -- calls -------------------------------------------------------
    def call_taint(self, call: ast.Call) -> bool:
        arg_taints = [self.taint(a) for a in call.args]
        kw_taints = {kw.arg: self.taint(kw.value) for kw in call.keywords}
        name = self.pkg.full_name(self.module, self.fn, call.func)
        resolution = self.pkg.resolve_callee(self.module, self.fn,
                                             call.func)
        if self.collect:
            self.calls.append((resolution, call, arg_taints, kw_taints))
            any_tainted = any(arg_taints) or any(kw_taints.values())
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                target = self._as_function_value(arg)
                if target is not None:
                    self.fn_args.append((target, call, any_tainted))
        return self.result_taint(name, resolution, call, arg_taints,
                                 kw_taints)

    def _as_function_value(self, expr) -> Optional[FunctionInfo]:
        """An argument that is itself a function (lambda or reference
        to a local/module def) — the higher-order propagation targets."""
        if isinstance(expr, ast.Lambda):
            return self.module.by_node.get(expr)
        if isinstance(expr, (ast.Name, ast.Attribute)):
            res = self.pkg.resolve_callee(self.module, self.fn, expr)
            if res is not None and res[0] == "fn":
                return res[1]
        return None

    def result_taint(self, name, resolution, call, arg_taints, kw_taints):
        raise NotImplementedError


class TracerTaint(_TaintWalk):
    """Taint = "is a traced tensor inside a compile/capture region"."""

    def __init__(self, fn, package):
        super().__init__(fn, package)
        self.tainted = set(fn.tainted_params)

    def result_taint(self, name, resolution, call, arg_taints, kw_taints):
        if name is not None:
            if name in _UNTAINT_CALLS:
                return False
            if (name == "getattr" and len(call.args) >= 2
                    and isinstance(call.args[1], ast.Constant)
                    and call.args[1].value in SAFE_ATTRS):
                return False
        func_tainted = (isinstance(call.func, ast.Attribute)
                        and self.taint(call.func.value)
                        and call.func.attr not in SAFE_ATTRS)
        return (any(arg_taints) or any(kw_taints.values())
                or func_tainted)


class DeviceTaint(_TaintWalk):
    """Taint = "is (or contains) a tensor on the card" on the host side.

    Runs on every function; cross-function facts (return summaries,
    ``self.X`` attribute facts, higher-order parameter injection) live
    on the FunctionInfo/ModuleInfo objects and are grown by the
    package-level fixpoint in :func:`compute_device_summaries`.  A
    name bound to a module moved to the card (``net =
    Net().to(device)``) is tainted too, so calling it yields device
    outputs.
    """

    def __init__(self, fn, package):
        super().__init__(fn, package)
        self.tainted = set(fn.device_params)
        self.jit_names: Dict[str, JitMeta] = dict(fn.jit_locals)
        self.return_jit: Optional[JitMeta] = None

    KEYS_TAINT = False  # dict keys are host values

    def subscript_taint(self, e: ast.Subscript) -> bool:
        # indexing host data with a device index yields host data
        self.taint(e.slice)
        return self.taint(e.value)

    def assign(self, target, value, tainted: bool):
        # ``leaves, treedef = tree_flatten(tree)``: the structure is
        # host data whatever the leaves are
        if (isinstance(target, (ast.Tuple, ast.List))
                and len(target.elts) == 2
                and isinstance(value, ast.Call)):
            name = self.pkg.full_name(self.module, self.fn, value.func)
            if (name or "").rsplit(".", 1)[-1] == "tree_flatten":
                super().assign(target.elts[0], value, tainted)
                super().assign(target.elts[1], value, False)
                return
        super().assign(target, value, tainted)

    # -- compiled-callable tracking ------------------------------------
    def jit_value(self, e) -> Optional[JitMeta]:
        """Is this expression a compiled callable?  Follows the
        wrapper idiom: any call with a compiled argument yields a
        compiled callable (``guard.wrap(compiled)``,
        ``functools.partial``)."""
        if isinstance(e, ast.Name):
            return self.jit_names.get(e.id)
        if isinstance(e, ast.Attribute):
            parts = dotted_parts(e)
            cls = _enclosing_class(self.fn)
            if (parts is not None and len(parts) == 2
                    and parts[0] == "self" and cls is not None):
                return self.module.class_jit_attrs.get(cls, {}).get(
                    parts[1])
            return None
        if isinstance(e, ast.Call):
            name = self.pkg.full_name(self.module, self.fn, e.func)
            if name in JIT_WRAPPERS:
                return jit_meta_from_call(e, name)
            res = self.pkg.resolve_callee(self.module, self.fn, e.func)
            if res is not None and res[0] == "fn" \
                    and res[1].returns_jit is not None:
                return res[1].returns_jit
            for arg in list(e.args) + [kw.value for kw in e.keywords]:
                meta = self.jit_value(arg)
                if meta is not None:
                    return meta
        return None

    def assign_name(self, name, value, tainted):
        # strong update: rebinding a name to a host value clears its
        # device taint, so the ``metrics = {k: v.item() ...}`` laundering
        # idiom works.  (Tracer taint stays monotone.)
        if not tainted:
            self.tainted.discard(name)
        meta = self.jit_value(value)
        if meta is not None:
            self.jit_names[name] = meta

    probe = False  # True: evaluate only, record no class facts

    def assign_attr(self, target, value, tainted):
        parts = dotted_parts(target)
        cls = _enclosing_class(self.fn)
        if parts is None or len(parts) != 2 or parts[0] != "self" \
                or cls is None or self.probe:
            return
        meta = self.jit_value(value)
        if meta is not None:
            self.module.class_jit_attrs.setdefault(cls, {})[parts[1]] = meta
        if tainted:
            self.module.class_device_attrs.setdefault(cls, set()).add(
                parts[1])

    def attr_taint(self, e: ast.Attribute) -> bool:
        parts = dotted_parts(e)
        cls = _enclosing_class(self.fn)
        if (parts is not None and len(parts) == 2 and parts[0] == "self"
                and cls is not None
                and parts[1] in self.module.class_device_attrs.get(
                    cls, ())):
            return True
        return super().attr_taint(e)

    def handle_return(self, value):
        meta = self.jit_value(value)
        if meta is not None:
            self.return_jit = meta

    def handle_expr_stmt(self, value):
        # ``lst.append(device_value)`` taints the container
        if (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr in ("append", "extend", "insert",
                                        "add", "appendleft")
                and isinstance(value.func.value, ast.Name)
                and any(self.taint(a) for a in value.args)):
            self.tainted.add(value.func.value.id)

    def result_taint(self, name, resolution, call, arg_taints, kw_taints):
        if launders_to_host(self.pkg, self.module, self.fn, call):
            return False
        if placement_of_call(call) == "device":
            return True
        if name is not None and name in SYNC_FNS:
            return False
        if self.jit_value(call.func) is not None:
            return True  # calling a compiled callable -> device result
        if resolution is not None and resolution[0] == "fn":
            if resolution[1].returns_device:
                return True
            if resolution[1].returns_host:
                return False
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr in SAFE_ATTRS) \
                and self.taint(call.func):
            return True  # a module on the card, called, or a method
        return any(arg_taints) or any(kw_taints.values())


# ---------------------------------------------------------------------
# package-level drivers
# ---------------------------------------------------------------------

def capture_bodies(package: Package, mod: ModuleInfo):
    """Yield ``(scope, statements)`` for every CUDA-graph capture
    region of the module: a ``with torch.cuda.graph(g):`` body, or the
    statements of one block between ``g.capture_begin()`` and
    ``g.capture_end()``."""
    for fn in [None] + mod.functions:
        body = mod.tree.body if fn is None else (
            [] if isinstance(fn.node, ast.Lambda) else fn.node.body)
        stack = [body]
        while stack:
            block = stack.pop()
            open_at = None
            for idx, stmt in enumerate(block):
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                marker = _capture_marker(stmt)
                if marker == CAPTURE_BEGIN:
                    open_at = idx + 1
                elif marker == CAPTURE_END and open_at is not None:
                    yield fn, block[open_at:idx]
                    open_at = None
                if isinstance(stmt, (ast.With, ast.AsyncWith)) and any(
                        isinstance(item.context_expr, ast.Call)
                        and package.full_name(
                            mod, fn, item.context_expr.func)
                        in CAPTURE_CONTEXTS
                        for item in stmt.items):
                    yield fn, stmt.body
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if isinstance(sub, list) and sub \
                            and isinstance(sub[0], ast.stmt):
                        stack.append(sub)
                if isinstance(stmt, ast.Try):
                    for handler in stmt.handlers:
                        stack.append(handler.body)


def _capture_marker(stmt) -> Optional[str]:
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) \
            and isinstance(stmt.value.func, ast.Attribute) \
            and stmt.value.func.attr in (CAPTURE_BEGIN, CAPTURE_END):
        return stmt.value.func.attr
    return None


def capture_nodes(package: Package, mod: ModuleInfo) -> Set[int]:
    """``id()`` of every AST node inside a capture region of ``mod``
    (nested function bodies excluded: they run at their call site)."""
    cached = getattr(mod, "_capture_nodes", None)
    if cached is not None:
        return cached
    out: Set[int] = set()
    for _scope, stmts in capture_bodies(package, mod):
        stack = list(stmts)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            out.add(id(node))
            stack.extend(ast.iter_child_nodes(node))
    mod._capture_nodes = out
    return out


def find_jit_entries(package: Package):
    """Yield ``(FunctionInfo, static_param_names, meta)`` for every
    function that is a direct compile/capture entry point: decorated
    with (or passed to) a compile wrapper, or called inside a capture
    region — package-wide.  torch has no static arguments, so the
    static set is always empty."""
    for mod in package.modules.values():
        # decorators
        for fn in mod.functions:
            if isinstance(fn.node, ast.Lambda):
                continue
            for dec in fn.node.decorator_list:
                meta = _decorator_jit_meta(package, mod, fn, dec)
                if meta is not None:
                    yield fn, set(), meta
        # call sites: torch.compile(f, ...)
        for scope, call in _walk_calls(mod):
            name = package.full_name(mod, scope, call.func)
            if name not in JIT_WRAPPERS or not call.args:
                continue
            meta = jit_meta_from_call(call, name)
            target = call.args[0]
            if isinstance(target, (ast.Tuple, ast.List)) and target.elts:
                target = target.elts[0]  # make_graphed_callables((f,), ...)
            if isinstance(target, ast.Lambda):
                fn = mod.by_node.get(target)
                if fn is not None:
                    yield fn, set(), meta
                continue
            res = package.resolve_callee(mod, scope, target)
            if res is not None and res[0] == "fn":
                yield res[1], set(), meta
        # calls made inside a capture region
        for scope, stmts in capture_bodies(package, mod):
            for stmt in stmts:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    res = package.resolve_callee(mod, scope, node.func)
                    if res is not None and res[0] == "fn":
                        yield res[1], set(), JitMeta("torch.cuda.graph")


def _decorator_jit_meta(package, mod, fn, dec):
    name = package.full_name(mod, fn.parent, dec)
    if name in JIT_WRAPPERS:
        return JitMeta(name)
    if isinstance(dec, ast.Call):
        dec_name = package.full_name(mod, fn.parent, dec.func)
        if dec_name in JIT_WRAPPERS:
            return jit_meta_from_call(dec, dec_name)
        if dec_name == "functools.partial" and dec.args:
            inner = package.full_name(mod, fn.parent, dec.args[0])
            if inner in JIT_WRAPPERS:
                return jit_meta_from_call(dec, inner)
    return None


def _walk_calls(mod: ModuleInfo):
    """Every Call node with its enclosing FunctionInfo (or None);
    cached on the module."""
    cached = getattr(mod, "_calls", None)
    if cached is not None:
        return cached
    out = []

    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            child_scope = mod.by_node.get(child, scope)
            if isinstance(child, ast.Call):
                out.append((scope, child))
            walk(child, child_scope)

    walk(mod.tree, None)
    mod._calls = out
    return out


def compute_tracer_taint(package: Package):
    """Interprocedural worklist: mark compile/capture-reachable
    functions and the tracer taint of their parameters/locals."""
    if getattr(package, "_tracer_done", False):
        return
    package._tracer_done = True
    work = deque()

    def seed(fn, tainted_params):
        new = tainted_params - fn.tainted_params
        if new or not fn.jit_reachable:
            fn.jit_reachable = True
            fn.tainted_params |= tainted_params
            work.append(fn)

    for fn, static, _meta in find_jit_entries(package):
        params = set(fn.all_params) - static - {"self", "cls"}
        seed(fn, params)

    seen_guard = 0
    while work and seen_guard < 10000:
        seen_guard += 1
        fn = work.popleft()
        tt = TracerTaint(fn, package).run()
        fn.tracer_locals = set(tt.tainted)
        for resolution, call, arg_taints, kw_taints in tt.calls:
            if resolution is None or resolution[0] != "fn":
                continue
            callee = resolution[1]
            params = callee.callable_params
            tainted = set()
            for idx, t in enumerate(arg_taints):
                if not t:
                    continue
                if isinstance(call.args[idx], ast.Starred):
                    # a tainted *splat can land anywhere from here on
                    tainted.update(params[idx:])
                elif idx < len(params):
                    tainted.add(params[idx])
            for kw, t in kw_taints.items():
                if t and kw in callee.all_params:
                    tainted.add(kw)
            if tainted:
                seed(callee, tainted)
        for target, _call, _any_tainted in tt.fn_args:
            # a function value passed around inside traced code will be
            # called with traced tensors
            seed(target,
                 set(target.all_params) - {"self", "cls"})


def compute_device_summaries(package: Package, max_passes: int = 6):
    """Package fixpoint for the host-side device-value facts."""
    if getattr(package, "_device_done", False):
        return
    package._device_done = True
    # host summaries first (they only depend on each other), then
    # the device facts
    for _ in range(max_passes):
        if not _host_summaries(package):
            break
    _device_fixpoint(package, max_passes)


def _host_summaries(package: Package) -> bool:
    """Mark the functions that return host data even when every
    parameter is a device tensor (``forward_numpy``-style boundaries
    that copy their results back): a call to one launders its
    arguments.  True when a summary changed."""
    changed = False
    for fn in package.all_functions():
        if fn.returns_host or isinstance(fn.node, ast.Lambda) \
                or not _may_launder(package, fn):
            continue
        saved = fn.device_params
        fn.device_params = set(fn.all_params) - {"self", "cls"}
        try:
            dt = DeviceTaint(fn, package)
            dt.probe = True
            dt.run()
        finally:
            fn.device_params = saved
        if not dt.return_tainted:
            fn.returns_host = True
            changed = True
    return changed


def _may_launder(package: Package, fn: FunctionInfo) -> bool:
    """A cheap filter for :func:`_host_summaries`: ``fn`` returns a
    value and calls a host converter (or a host-summarized function)
    somewhere in its body."""
    cached = getattr(fn, "_may_launder", None)
    if cached is None:
        returns = False
        calls = []
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Return) and node.value is not None:
                returns = True
            elif isinstance(node, ast.Call):
                calls.append(node)
        fn._launder_calls = calls if returns else []
        cached = fn._may_launder = False
    for call in fn._launder_calls:
        if launders_to_host(package, fn.module, fn, call):
            fn._may_launder = True
            return True
        res = package.resolve_callee(fn.module, fn, call.func)
        if res is not None and res[0] == "fn" and res[1].returns_host:
            return True
    return False


def _device_fixpoint(package: Package, max_passes: int):
    for _ in range(max_passes):
        changed = False
        for fn in package.all_functions():
            dt = DeviceTaint(fn, package).run()
            if dt.return_tainted and not fn.returns_device:
                fn.returns_device = True
                changed = True
            if dt.return_jit is not None and fn.returns_jit is None:
                fn.returns_jit = dt.return_jit
                changed = True
            if dt.jit_names != fn.jit_locals:
                fn.jit_locals = dict(dt.jit_names)
                changed = True
            if dt.tainted != fn.device_locals:
                fn.device_locals = set(dt.tainted)
                changed = True
            # higher-order injection: lambdas mapped over device trees
            for target, _call, any_tainted in dt.fn_args:
                if any_tainted:
                    params = set(target.all_params) - {"self", "cls"}
                    if params - target.device_params:
                        target.device_params |= params
                        changed = True
        if not changed:
            break
