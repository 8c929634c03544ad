"""torchlint's num family: the lintfix contract on the torch fixtures,
flagged lines against the JAX fixtures, and the lattice held to torch.

The port's numrules fire on what torch does, not on what JAX does: a
Python scalar *or a 0-dim tensor* never promotes a dimensioned tensor
of its own category (``bf16 * torch.tensor(0.5)`` stays bf16, where
JAX's ``jnp.asarray(0.5)`` promotes).  So the promotion lattice is
checked against ``torch.result_type`` on the CPU over a grid of dtypes
and ranks, and the promotion fixtures are run: each of their functions
takes a float32 tensor and mixes a bf16 copy with something, and a rule
fires inside the function exactly where torch's result is not bf16.
"""

import ast
import itertools
import os

import pytest
import torch
from test_torch_lint_base import (
    assert_line_parity,
    check_contract,
    torch_fixture,
)

from handyrl_tpu_torch.analysis import torchlint
from handyrl_tpu_torch.analysis.astutil import ModuleInfo, Package
from handyrl_tpu_torch.analysis.numlint import (
    DtypeFact,
    analyze_num,
    parse_dtype,
    promote,
)
from handyrl_tpu_torch.analysis.numrules import NUM_RULES
from torchfix import one_torch_thread  # noqa: F401  (autouse)

RULE_IDS = sorted(NUM_RULES)

TORCH_ONLY = {
    "implicit-upcast": {16: "a .float() master copy mixed into bf16"},
    "weak-type-promotion": {15: "torch.full with a Python fill value"},
    "lowp-accum": {16: "a bf16 accumulator carried across a loop"},
    "unguarded-cast": {11: "the .byte() spelling of a uint8 cast"},
    "nonfinite-risk": {12: "a division by a bare mask count",
                       16: "the method spelling .exp(), unclamped"},
}


@pytest.mark.parametrize("kind", ["pos", "neg", "supp"])
@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fixture(rule_id, kind):
    check_contract(torch_fixture("num", rule_id, kind), rule_id, kind,
                   num=True)


@pytest.mark.parametrize("jax_id", RULE_IDS)
def test_flagged_lines_match_the_jax_fixture(jax_id):
    assert_line_parity("numlint", "num", jax_id, {"num": True}, {},
                       TORCH_ONLY)


def test_num_registry_keeps_the_jax_ids():
    from handyrl_tpu.analysis.numrules import NUM_RULES as JAX_NUM

    assert set(RULE_IDS) == set(JAX_NUM)


# -- the lattice against torch ------------------------------------------

_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "float64": torch.float64,
          "uint8": torch.uint8, "int8": torch.int8, "int": torch.int64,
          "bool": torch.bool}
_PY = {"float32": 0.5, "int": 2, "bool": True}


def _operand(dtype, kind):
    """A torch operand of the lattice point ``(dtype, kind)``."""
    if kind == "scalar":
        return _PY[dtype]
    shape = () if kind == "zero" else (3,)
    return torch.ones(shape, dtype=_TORCH[dtype])


def _fact(dtype, kind):
    return DtypeFact(dtype, weak=(kind == "scalar"), zero=(kind == "zero"))


def _canon(dtype):
    for name, value in _TORCH.items():
        if value == dtype:
            return name
    if dtype in (torch.int16, torch.int32):
        return "int"
    raise AssertionError(dtype)


_POINTS = [(d, k) for d in _TORCH for k in ("dim", "zero")] + [
    (d, "scalar") for d in _PY]


@pytest.mark.parametrize("left,right", [
    (a, b) for a, b in itertools.combinations_with_replacement(_POINTS, 2)
    if not (a[1] == "scalar" and b[1] == "scalar")])
def test_promote_is_torch_result_type(left, right):
    got = promote(_fact(*left), _fact(*right))
    want = torch.result_type(_operand(*left), _operand(*right)) \
        if left[1] != "scalar" else torch.result_type(
            _operand(*right), _operand(*left))
    assert got is not None and got.dtype == _canon(want), (
        left, right, got, want)
    assert promote(_fact(*right), _fact(*left)).dtype == got.dtype


def _function_spans(tree):
    return [(node.name, node.lineno, node.end_lineno)
            for node in tree.body if isinstance(node, ast.FunctionDef)]


@pytest.mark.parametrize("rule_id", ["implicit-upcast",
                                     "weak-type-promotion"])
@pytest.mark.parametrize("kind", ["pos", "neg"])
def test_promotion_rules_fire_where_torch_changes_the_dtype(rule_id, kind):
    path = torch_fixture("num", rule_id, kind)
    with open(path, encoding="utf-8") as f:
        source = f.read()
    namespace = {}
    exec(compile(source, path, "exec"), namespace)
    lines = {f.line for f in torchlint.lint_paths([path], num=True)
             if f.rule == rule_id}
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    spans = _function_spans(ast.parse(source))
    assert spans
    for name, lo, hi in spans:
        out = namespace[name](x)
        fired = any(lo <= line <= hi for line in lines)
        assert fired == (out.dtype != torch.bfloat16), (name, out.dtype)


# -- the lattice machinery -----------------------------------------------

def _analyze(src):
    package = Package([ModuleInfo("m", "m", src)])
    return analyze_num(package), package


def _fn(package, qname):
    return next(fn for fn in package.all_functions() if fn.qname == qname)


def test_parse_dtype_reads_torch_spellings():
    assert parse_dtype("torch.bfloat16") == "bfloat16"
    assert parse_dtype("torch.float") == "float32"
    assert parse_dtype("torch.half") == "float16"
    assert parse_dtype("torch.long") == "int"
    assert parse_dtype("torch.uint8") == "uint8"
    assert parse_dtype("nonsense") is None


def test_config_facts_flow_through_getattr_torch():
    an, package = _analyze(
        "import torch\n"
        "class Trainer:\n"
        "    def __init__(self):\n"
        "        self.compute_dtype = 'bfloat16'\n"
        "    def cast(self, x):\n"
        "        dtype = getattr(torch, self.compute_dtype)\n"
        "        return x.to(dtype)\n")
    fn = _fn(package, "m:Trainer.cast")
    assert an.config_facts["compute_dtype"] == frozenset({"bfloat16"})
    assert an.returns[fn] == DtypeFact("bfloat16")


def test_autocast_gives_matmuls_the_autocast_dtype():
    an, package = _analyze(
        "import torch\n"
        "def f(a, b):\n"
        "    with torch.autocast('cuda', dtype=torch.bfloat16):\n"
        "        y = torch.matmul(a.float(), b.float())\n"
        "    return y\n")
    assert an.returns[_fn(package, "m:f")] == DtypeFact("bfloat16")


def test_the_port_lattice_is_populated():
    """The gate would be vacuously clean if the lattice saw nothing:
    the compute-dtype config fact, the casts of the update step and
    the loss path inside the compute set must all be found."""
    package, _supp, _err = torchlint.load_package(
        [os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "handyrl_tpu_torch")])
    an = analyze_num(package)
    assert "bfloat16" in an.config_facts["compute_dtype"]
    names = {fn.qname for fn in an.compute_fns}
    assert any(q.startswith("handyrl_tpu_torch.ops.losses:")
               for q in names)
    casts = set().union(*(an.fn_casts[fn] for fn in package.all_functions()
                          if fn.module.name.startswith(
                              "handyrl_tpu_torch.ops.")))
    assert {"float32"} <= casts
