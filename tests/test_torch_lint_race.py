"""torchlint's race family against the JAX linter's.

racelint and racerules are framework-free, so the port's copy must
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

from handyrl_tpu_torch.analysis.racerules import RACE_RULES

RULE_IDS = sorted(RACE_RULES)


@pytest.mark.parametrize("kind", ["pos", "neg", "supp"])
@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fixture(rule_id, kind, tmp_path):
    src = jax_fixture("racelint", rule_id, kind)
    path = translate(src, str(tmp_path / "fixture.py"), "jaxlint:",
                     "torchlint:")
    check_contract(path, rule_id, kind, race=True)


@pytest.mark.parametrize("kind", ["pos", "neg", "supp"])
@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_findings_equal_the_jax_linter_on_its_fixtures(rule_id, kind,
                                                      tmp_path):
    jax, port = both_on_jax_fixture(tmp_path, "racelint", rule_id, kind,
                                    "race")
    assert port == jax


def test_findings_equal_the_jax_linter_on_the_port(tmp_path):
    jax, port = both_on_the_port(tmp_path, "race", RULE_IDS)
    assert port == jax == set()


def test_race_registry_keeps_the_jax_ids():
    from handyrl_tpu.analysis.racerules import RACE_RULES as JAX_RACE

    assert set(RULE_IDS) == set(JAX_RACE)


def test_the_ports_thread_roots_include_the_prefetch_pump():
    """The twin of the JAX linter's thread-graph check: the race rules
    see the host path's prefetch threads, so the clean gate covers
    what they share with the trainer thread."""
    from test_torch_lint_base import PACKAGE

    from handyrl_tpu_torch.analysis import torchlint
    from handyrl_tpu_torch.analysis.racelint import analyze_race

    package, _, errors = torchlint.load_package([PACKAGE])
    assert errors == []
    roots = set(analyze_race(package).thread_roots)
    expected = {
        "handyrl_tpu_torch.learner:DevicePrefetcher._pump",
        "handyrl_tpu_torch.connection:QueueCommunicator._send_loop",
        "handyrl_tpu_torch.connection:QueueCommunicator._recv_loop",
    }
    assert expected <= roots, expected - roots
