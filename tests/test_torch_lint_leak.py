"""torchlint's leak family against the JAX linter's.

leaklint and leakrules are framework-free, so the port's copy must
find what the JAX one finds: on every JAX fixture (the port reading it
with ``jaxlint:`` rewritten to ``torchlint:``) and on the port package
itself, as ``(rule, file, line)`` sets; and each JAX fixture holds the
lintfix contract under the port's linter.
"""

import pytest
from test_torch_lint_base import (
    both_on_jax_fixture,
    both_on_the_port,
    check_contract,
    jax_fixture,
    translate,
)

from handyrl_tpu_torch.analysis.leakrules import LEAK_RULES

RULE_IDS = sorted(LEAK_RULES)


@pytest.mark.parametrize("kind", ["pos", "neg", "supp"])
@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fixture(rule_id, kind, tmp_path):
    src = jax_fixture("leaklint", rule_id, kind)
    path = translate(src, str(tmp_path / "fixture.py"), "jaxlint:",
                     "torchlint:")
    check_contract(path, rule_id, kind, leak=True)


@pytest.mark.parametrize("kind", ["pos", "neg", "supp"])
@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_findings_equal_the_jax_linter_on_its_fixtures(rule_id, kind,
                                                      tmp_path):
    jax, port = both_on_jax_fixture(tmp_path, "leaklint", rule_id, kind,
                                    "leak")
    assert port == jax


def test_findings_equal_the_jax_linter_on_the_port(tmp_path):
    jax, port = both_on_the_port(tmp_path, "leak", RULE_IDS)
    assert port == jax == set()


def test_leak_registry_keeps_the_jax_ids():
    from handyrl_tpu.analysis.leakrules import LEAK_RULES as JAX_LEAK

    assert set(RULE_IDS) == set(JAX_LEAK)
