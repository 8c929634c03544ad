"""torchlint's comm family against the JAX linter's.

commlint and commrules are framework-free, so the port's copy must
find what the JAX one finds: on every JAX fixture (the port reading it
with ``jaxlint:`` rewritten to ``torchlint:``) and on the port package
itself, as ``(rule, file, line)`` sets.  Two clauses are retargeted to
torch and get torch fixtures instead (``tests/fixtures/torch/comm``):
``fork-unsafe``'s "live jax state" becomes "a module that initializes
CUDA", and ``unpicklable-payload``'s device fact becomes a CUDA tensor
from the base rules' device taint.
"""

import pytest
from test_torch_lint_base import (
    assert_line_parity,
    both_on_jax_fixture,
    both_on_the_port,
    check_contract,
    jax_fixture,
    torch_fixture,
    translate,
)

from handyrl_tpu_torch.analysis.commrules import COMM_RULES

RULE_IDS = sorted(COMM_RULES)
# the two retargets: torch fixtures, and listed here
RETARGETED = {
    "fork-unsafe": "a fork in a module that initializes CUDA replaces "
                   "a fork in a jax-importing module",
    "unpicklable-payload": "a CUDA tensor replaces a jax device array",
}
TORCH_ONLY = {"fork-unsafe": {34: "a fork after torch.cuda.init()"}}


@pytest.mark.parametrize("kind", ["pos", "neg", "supp"])
@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fixture(rule_id, kind, tmp_path):
    if rule_id in RETARGETED:
        path = torch_fixture("comm", rule_id, kind)
    else:
        src = jax_fixture("commlint", rule_id, kind)
        path = translate(src, str(tmp_path / "fixture.py"), "jaxlint:",
                         "torchlint:")
    check_contract(path, rule_id, kind, comm=True)


@pytest.mark.parametrize("kind", ["pos", "neg", "supp"])
@pytest.mark.parametrize("rule_id", sorted(set(RULE_IDS) - set(RETARGETED)))
def test_findings_equal_the_jax_linter_on_its_fixtures(rule_id, kind,
                                                      tmp_path):
    jax, port = both_on_jax_fixture(tmp_path, "commlint", rule_id, kind,
                                    "comm")
    assert port == jax


@pytest.mark.parametrize("rule_id", sorted(RETARGETED))
def test_retargeted_fixtures_keep_the_jax_lines(rule_id):
    assert_line_parity("commlint", "comm", rule_id, {"comm": True}, {},
                       TORCH_ONLY)


def test_findings_equal_the_jax_linter_on_the_port(tmp_path):
    jax, port = both_on_the_port(tmp_path, "comm", RULE_IDS)
    assert port == jax == set()


def test_comm_registry_keeps_the_jax_ids():
    from handyrl_tpu.analysis.commrules import COMM_RULES as JAX_COMM

    assert set(RULE_IDS) == set(JAX_COMM)
