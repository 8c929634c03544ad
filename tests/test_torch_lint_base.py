"""torchlint's base family against the JAX linter's, and the port's gate.

Fixture convention (tests/fixtures/torch/<family>/, the JAX suites'
``tests/lintfix.py`` contract): ``<rule>_pos.py`` must produce findings
of exactly that rule, ``<rule>_neg.py`` and ``<rule>_supp.py`` none.
Each torch fixture translates its JAX twin and keeps the twin's
flagged lines where the construct has a torch counterpart: the parity
test maps the JAX rule id through ``JAX_TO_PORT`` and asserts equal
flagged-line sets, with the lines that have no counterpart and the
torch-only lines listed beside their reasons.  Also here: the
suppression machinery, the CLI, the id table against the JAX
registries, and the gate — the port lints clean with all six families
in a fresh interpreter that never loads torch.  The fixtures are
parsed, never imported (the numerics suite runs two of them).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from handyrl_tpu.analysis import jaxlint
from handyrl_tpu_torch.analysis import torchlint
from handyrl_tpu_torch.analysis.rules import JAX_TO_PORT, RULES

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "fixtures")
PACKAGE = os.path.join(REPO, "handyrl_tpu_torch")
FLAGS = ("shard", "comm", "race", "num", "leak")

RULE_IDS = sorted(RULES)

# JAX pos-fixture lines whose construct has no torch counterpart, and
# torch pos-fixture lines with no JAX twin, per port rule
NO_COUNTERPART = {
    "retrace-risk": {
        20: "a non-hashable literal at a static position: torch.compile "
            "has no static argnums",
        24: "non-literal static_argnums: torch.compile has no static "
            "argument contract",
    },
}
TORCH_ONLY = {
    "host-sync": {54: "torch.cuda.synchronize() inside a loop"},
    "retrace-risk": {25: "a CUDAGraph built inside a loop",
                     26: "a torch.cuda.graph capture inside a loop"},
    "tracer-branch": {34: "a tensor branch inside a CUDA-graph capture"},
}


def jax_fixture(family, rule_id, kind):
    return os.path.join(FIXTURES, family,
                        f"{rule_id.replace('-', '_')}_{kind}.py")


def torch_fixture(family, rule_id, kind):
    path = os.path.join(FIXTURES, "torch", family,
                        f"{rule_id.replace('-', '_')}_{kind}.py")
    assert os.path.exists(path), f"missing fixture {path}"
    return path


def check_contract(path, rule_id, kind, **flags):
    """The lintfix contract on the port's linter."""
    findings = torchlint.lint_paths([path], **flags)
    if kind == "pos":
        assert findings, f"{rule_id} produced no findings on {path}"
        assert all(f.rule == rule_id for f in findings), (
            f"cross-rule noise on {path}: "
            f"{[(f.rule, f.line) for f in findings]}")
    else:
        assert findings == [], (
            f"{kind} fixture {path}: "
            f"{[(f.rule, f.line, f.message) for f in findings]}")


def flagged_lines(findings, rule_id):
    return {f.line for f in findings if f.rule == rule_id}


def translate(src, dst, old, new):
    """Copy a file or a tree, the suppression prefix rewritten."""
    if os.path.isfile(src):
        with open(src, encoding="utf-8") as f:
            text = f.read()
        with open(dst, "w", encoding="utf-8") as f:
            f.write(text.replace(old, new))
        return dst
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__"))
    for root, _dirs, files in os.walk(dst):
        for name in files:
            if name.endswith(".py"):
                translate(os.path.join(root, name),
                          os.path.join(root, name), old, new)
    return dst


def assert_line_parity(jax_family, torch_family, jax_id, flags,
                       no_counterpart, torch_only):
    """The port's flagged lines on a torch fixture are its JAX twin's,
    less the lines with no counterpart, plus the torch-only lines."""
    port_id = JAX_TO_PORT[jax_id]
    jax_lines = flagged_lines(
        jaxlint.lint_paths([jax_fixture(jax_family, jax_id, "pos")],
                           **flags), jax_id)
    port_lines = flagged_lines(
        torchlint.lint_paths([torch_fixture(torch_family, port_id, "pos")],
                             **flags), port_id)
    missing = set(no_counterpart.get(port_id, {}))
    extra = set(torch_only.get(port_id, {}))
    assert missing <= jax_lines and not extra & (jax_lines - missing)
    assert port_lines == (jax_lines - missing) | extra, (
        jax_id, sorted(jax_lines), sorted(port_lines))


@pytest.mark.parametrize("kind", ["pos", "neg", "supp"])
@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fixture(rule_id, kind):
    check_contract(torch_fixture("base", rule_id, kind), rule_id, kind)


@pytest.mark.parametrize("jax_id", sorted(
    ["host-sync", "tracer-branch", "retrace-risk", "debug-leftover",
     "prng-reuse", "donated-reuse"]))
def test_flagged_lines_match_the_jax_fixture(jax_id):
    assert_line_parity("jaxlint", "base", jax_id, {}, NO_COUNTERPART,
                       TORCH_ONLY)


def test_base_registry_is_the_retargeted_jax_set():
    from handyrl_tpu.analysis.rules import RULES as JAX_RULES

    assert set(RULE_IDS) == {JAX_TO_PORT[r] for r in JAX_RULES} == {
        "host-sync", "tracer-branch", "retrace-risk", "debug-leftover",
        "rng-reseed", "inplace-alias"}


def test_id_table_covers_every_jax_rule_once():
    from handyrl_tpu.analysis.commrules import COMM_RULES
    from handyrl_tpu.analysis.leakrules import LEAK_RULES
    from handyrl_tpu.analysis.numrules import NUM_RULES
    from handyrl_tpu.analysis.racerules import RACE_RULES
    from handyrl_tpu.analysis.rules import RULES as JAX_RULES
    from handyrl_tpu.analysis.shardrules import SHARD_RULES

    jax_ids = set()
    for registry in (JAX_RULES, SHARD_RULES, COMM_RULES, RACE_RULES,
                     NUM_RULES, LEAK_RULES):
        assert not jax_ids & set(registry)
        jax_ids |= set(registry)
    assert len(jax_ids) == 36 and set(JAX_TO_PORT) == jax_ids
    port = torchlint.active_registry(**{f: True for f in FLAGS})
    assert set(port) == set(JAX_TO_PORT.values())
    assert len(set(JAX_TO_PORT.values())) == 36
    # a renamed rule is the base family's alone
    renamed = {j for j, p in JAX_TO_PORT.items() if j != p}
    assert renamed == {"prng-reuse", "donated-reuse"}


# -- suppression machinery -------------------------------------------

def test_bare_suppression_is_itself_reported():
    src = ("def f(x):\n"
           "    breakpoint()  # torchlint: disable=debug-leftover\n"
           "    return x\n")
    assert [f.rule for f in torchlint.lint_source(src)] == [
        "bare-suppression"]


def test_suppression_on_previous_comment_line():
    src = ("def f(x):\n"
           "    # torchlint: disable=debug-leftover -- demo hook\n"
           "    breakpoint()\n"
           "    return x\n")
    assert torchlint.lint_source(src) == []


def test_trailing_code_does_not_extend_suppression_down():
    src = ("def f(x):\n"
           "    y = 1  # torchlint: disable=debug-leftover -- this line\n"
           "    breakpoint()\n"
           "    return x + y\n")
    assert [f.rule for f in torchlint.lint_source(src)] == [
        "debug-leftover"]


def test_jax_prefix_does_not_suppress_the_port_linter():
    src = ("def f(x):\n"
           "    # jaxlint: disable=debug-leftover -- the other linter\n"
           "    breakpoint()\n"
           "    return x\n")
    assert [f.rule for f in torchlint.lint_source(src)] == [
        "debug-leftover"]


def test_skip_file_and_bare_skip_file():
    body = ("def f(x):\n"
            "    breakpoint()\n"
            "    return x\n")
    assert torchlint.lint_source(
        "# torchlint: skip-file -- generated\n" + body) == []
    assert [f.rule for f in torchlint.lint_source(
        "# torchlint: skip-file\n" + body)] == ["bare-suppression"]


def test_docstrings_mentioning_syntax_are_not_suppressions():
    src = ('"""Suppress with ``# torchlint: disable=debug-leftover``."""\n'
           "def f(x):\n"
           "    breakpoint()\n"
           "    return x\n")
    assert [f.rule for f in torchlint.lint_source(src)] == [
        "debug-leftover"]


def test_epoch_metric_copy_regression():
    """Per-step ``.item()`` on the step's device metrics flags; one
    stacked copy after the loop does not (the learner's pattern)."""
    broken = (
        "import torch\n"
        "class Trainer:\n"
        "    def __init__(self, device):\n"
        "        self.w = torch.zeros(3, device=device)\n"
        "    def train(self, batches):\n"
        "        acc = []\n"
        "        for b in batches:\n"
        "            acc.append((self.w * b).sum())\n"
        "        return sum(m.item() for m in acc)\n")
    fixed = broken.replace(
        "        return sum(m.item() for m in acc)\n",
        "        host = torch.stack(acc).cpu().numpy()\n"
        "        return sum(float(m) for m in host)\n")
    assert [f.rule for f in torchlint.lint_source(broken)] == ["host-sync"]
    assert torchlint.lint_source(fixed) == []


# -- the device lattice ---------------------------------------------------

_LOOP = ("import numpy as np\n"
         "import torch\n"
         "def run(net, rows, device):\n"
         "    out = []\n"
         "    for r in rows:\n"
         "        {body}\n"
         "    return out\n")


@pytest.mark.parametrize("body,flagged", [
    # placed on the card: each copy back in the loop is a sync
    ("out.append(torch.zeros(3, device=device).sum().item())", True),
    ("out.append(float(torch.ones(3).to(device).sum()))", True),
    ("out.append(torch.ones(3).cuda().tolist())", True),
    ("out.append(np.asarray(net.to(device)(r)))", True),
    # built on the host, or placed on the host literally
    ("out.append(torch.zeros(3).sum().item())", False),
    ("out.append(torch.zeros(3, device='cpu').sum().item())", False),
    ("out.append(torch.ones(3).to(torch.float64).sum().item())", False),
    # an async copy does not block
    ("out.append(torch.ones(3, device=device).to('cpu', "
     "non_blocking=True))", False),
])
def test_device_lattice_places_tensors_by_what_the_code_shows(body,
                                                              flagged):
    findings = torchlint.lint_source(_LOOP.format(body=body))
    assert [f.rule for f in findings] == (["host-sync"] if flagged
                                          else [])


def test_a_host_boundary_launders_its_arguments():
    """A function that returns host data whatever it is given (the
    ``forward_numpy`` shape) launders device arguments at its call
    sites; tree_flatten's structure is host data too."""
    src = ("import torch\n"
           "from handyrl_tpu_torch.utils.tree import tree_flatten\n"
           "def download(out):\n"
           "    leaves, treedef = tree_flatten(out)\n"
           "    host = torch.cat(leaves).cpu().numpy()\n"
           "    return {'x': host, 'n': len(treedef)}\n"
           "def serve(rows, device):\n"
           "    for r in rows:\n"
           "        out = download(torch.ones(3, device=device) * r)\n"
           "        yield float(out['x'].sum())\n")
    assert torchlint.lint_source(src) == []


def test_inplace_alias_follows_each_branch_on_its_own():
    src = ("import torch\n"
           "def refresh(module, target_module, tau):\n"
           "    params = list(module.parameters())\n"
           "    target = list(target_module.parameters())\n"
           "    if tau > 0:\n"
           "        torch._foreach_lerp_(target, params, tau)\n"
           "    else:\n"
           "        torch._foreach_copy_(target, params)\n"
           "    return params\n")
    assert torchlint.lint_source(src) == []
    stale = src.replace("    return params\n", "    return target\n")
    assert [(f.rule, f.line) for f in torchlint.lint_source(stale)] == [
        ("inplace-alias", 9)]


# -- CLI ----------------------------------------------------------------

def test_cli_json_output(capsys):
    rc = torchlint.main(["--json",
                         torch_fixture("base", "debug-leftover", "pos")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out["total"] == len(out["findings"]) > 0
    assert all(f["rule"] == "debug-leftover" for f in out["findings"])


def test_cli_sarif_output(capsys):
    rc = torchlint.main(["--sarif", "--shard",
                         torch_fixture("shard", "axis-reuse", "pos")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["version"] == "2.1.0"
    assert {r["ruleId"] for r in out["runs"][0]["results"]} == {
        "axis-reuse"}


def test_cli_clean_exit_and_usage_errors(capsys):
    assert torchlint.main(
        [torch_fixture("base", "debug-leftover", "neg")]) == 0
    assert "clean" in capsys.readouterr().out
    assert torchlint.main(["--select", "no-such-rule", PACKAGE]) == 2
    assert torchlint.main(["--json", "--sarif", PACKAGE]) == 2
    assert torchlint.main(["no/such/path.py"]) == 2


def test_cli_list_rules_prints_six_families(capsys):
    assert torchlint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for family in ("base", "shard", "comm", "race", "num", "leak"):
        assert f"[{family}] 6 rules" in out
    for port_id in JAX_TO_PORT.values():
        assert f"\n{port_id}" in out or out.startswith(port_id)
    assert "rng-reseed (JAX: prng-reuse)" in out
    assert "inplace-alias (JAX: donated-reuse)" in out


# -- the gate ------------------------------------------------------------

GATE = (
    "import sys\n"
    "from handyrl_tpu_torch.analysis import torchlint\n"
    "rc = torchlint.main(['--shard', '--comm', '--race', '--num',\n"
    "                     '--leak', 'handyrl_tpu_torch'])\n"
    "loaded = sorted(m for m in sys.modules\n"
    "                if m.split('.')[0] in ('torch', 'jax', 'numpy',\n"
    "                                       'handyrl_tpu'))\n"
    "print('LOADED', loaded)\n"
    "sys.exit(rc)\n")


def test_the_port_lints_clean_with_all_six_families():
    """The port's gate: every finding of the six families is fixed or
    carries a reasoned suppression, and the scan never loads torch."""
    proc = subprocess.run([sys.executable, "-c", GATE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert "torchlint: clean" in proc.stdout
    assert "LOADED []" in proc.stdout


def test_every_port_suppression_names_a_rule_and_a_reason():
    package, suppressions, errors = torchlint.load_package([PACKAGE])
    assert errors == []
    registry = torchlint.active_registry(**{f: True for f in FLAGS})
    count = 0
    for supp in suppressions.values():
        assert supp.bare == []
        for rules, _comment_only, _line in supp.by_line.values():
            assert rules <= set(registry), rules
            count += 1
    assert count >= 17  # 14 unbounded-recv + three of the port's own


# -- helpers of the framework-free families (comm, race, leak) ------------

def _keyed(findings, root):
    return {(f.rule, os.path.relpath(f.path, root), f.line)
            for f in findings}


def both_on_jax_fixture(tmp_path, jax_family, rule_id, kind, flag):
    """``(jax, port)`` findings on one JAX fixture, as ``(rule, file,
    line)`` sets: the JAX linter reads the fixture, the port's linter
    the same text with ``jaxlint:`` rewritten to ``torchlint:``."""
    src = jax_fixture(jax_family, rule_id, kind)
    dst = translate(src, str(tmp_path / os.path.basename(src)),
                    "jaxlint:", "torchlint:")
    jax = jaxlint.lint_paths([src], **{flag: True})
    port = torchlint.lint_paths([dst], **{flag: True})
    return (_keyed(jax, os.path.dirname(src)),
            _keyed(port, os.path.dirname(dst)))


def both_on_the_port(tmp_path, flag, rule_ids):
    """``(jax, port)`` findings of ``rule_ids`` on the port package: the
    port's linter reads it, the JAX linter a copy with ``torchlint:``
    rewritten to ``jaxlint:``, so the port's suppressions hold for
    both."""
    copy = translate(PACKAGE, str(tmp_path / "handyrl_tpu_torch"),
                     "torchlint:", "jaxlint:")
    jax = jaxlint.lint_paths([copy], select=rule_ids, **{flag: True})
    port = torchlint.lint_paths([PACKAGE], select=rule_ids,
                                **{flag: True})
    return _keyed(jax, copy), _keyed(port, PACKAGE)
