"""torchlint — AST-based PyTorch/CUDA correctness analyzer (CLI + driver).

Runs the rule set in :mod:`.rules` over a package directory (or single
files), with per-line suppression comments and text/JSON/SARIF output.
Stdlib only; torch is never imported.

Usage::

    python -m handyrl_tpu_torch.analysis.torchlint handyrl_tpu_torch/
    python -m handyrl_tpu_torch.analysis.torchlint --json handyrl_tpu_torch/
    python -m handyrl_tpu_torch.analysis.torchlint \
        --shard --comm --race --num --leak handyrl_tpu_torch/
    python -m handyrl_tpu_torch.analysis.torchlint --sarif handyrl_tpu_torch/
    python -m handyrl_tpu_torch.analysis.torchlint --list-rules
    handyrl-torchlint handyrl_tpu_torch/     # console-script entry

``--shard`` additionally runs the mesh/collective-consistency rule set
(:mod:`.shardrules` — mesh-axis validity, placement tuples, collective
groups, layout contracts, rank-divergent collectives, divisibility),
``--comm`` the control-plane protocol/concurrency rule set
(:mod:`.commrules` — unhandled/dead verbs, reply wedges, unbounded
recvs, unpicklable payloads, fork safety), ``--race`` the
thread-safety rule set (:mod:`.racerules`), ``--num`` the
dtype/precision-flow rule set (:mod:`.numrules` — promotions torch
really makes, bf16 accumulation, unguarded lossy casts, split-brain
return dtypes, nonfinite producers) and ``--leak`` the
resource-lifecycle rule set (:mod:`.leakrules`); the flags compose.
``--sarif`` emits SARIF 2.1.0; ``--exclude`` drops path prefixes (e.g.
test fixtures) from directory scans.  ``--list-rules`` always prints
all six rule families.

Exit status: 0 when clean, 1 when any finding survives suppression,
2 on usage/IO errors.

Suppression syntax (the reason after ``--`` is REQUIRED — a
suppression that doesn't say why is itself reported)::

    x = foo()  # torchlint: disable=host-sync -- once per epoch, by design
    # torchlint: disable=tracer-branch,rng-reseed -- trace-time constant
    # torchlint: skip-file -- generated code

A ``disable`` comment applies to its own line; a comment-only line
also covers the next line (so long statements can carry the
suppression above their first line).  ``disable=all`` silences every
rule.  ``skip-file`` (first 10 lines) skips the whole file.
"""

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from .astutil import (
    ModuleInfo,
    Package,
    compute_device_summaries,
    compute_tracer_taint,
)
from .rules import JAX_TO_PORT, RULES, Finding

_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*(disable|skip-file)"
    r"(?:\s*=\s*([\w\-]+(?:\s*,\s*[\w\-]+)*))?"
    r"(?:\s+--\s+(\S.*))?")


def _iter_comments(source: str) -> List[Tuple[int, str]]:
    """``(lineno, comment_text)`` for every real comment token.

    Falls back to whole-line scanning only if tokenization fails (the
    file already parsed as AST before we get here, so that is rare)."""
    import io
    import tokenize

    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return [(lineno, line)
                for lineno, line in enumerate(source.splitlines(), 1)
                if "#" in line]
    return out


class Suppressions:
    """Per-file suppression map parsed from REAL comment tokens — a
    docstring or string literal that merely documents the syntax (this
    module's own docstring, say) must neither suppress anything nor
    count as a bare suppression."""

    def __init__(self, source: str, path: str):
        self.path = path
        self.skip_file = False
        self.by_line: Dict[int, Tuple[set, bool, int]] = {}
        bare: List[Tuple[int, str]] = []
        lines = source.splitlines()
        for lineno, comment in _iter_comments(source):
            match = _SUPPRESS_RE.search(comment)
            if match is None:
                continue
            line = lines[lineno - 1] if lineno <= len(lines) else comment
            verb, rules_str, reason = match.groups()
            if verb == "skip-file":
                if lineno <= 10:
                    self.skip_file = True
                if not reason:
                    bare.append((lineno, "skip-file"))
                continue
            rules = {r.strip() for r in (rules_str or "all").split(",")
                     if r.strip()}
            comment_only = line.strip().startswith("#")
            self.by_line[lineno] = (rules, comment_only, lineno)
            if not reason:
                bare.append((lineno, "disable=" + ",".join(sorted(rules))))
        self.bare = bare

    def covers(self, rule_id: str, lineno: int) -> bool:
        for probe in (lineno, lineno - 1):
            entry = self.by_line.get(probe)
            if entry is None:
                continue
            rules, comment_only, _ = entry
            if probe == lineno - 1 and not comment_only:
                continue  # only standalone comments cover the next line
            if "all" in rules or rule_id in rules:
                return True
        return False

    def bare_findings(self) -> List[Finding]:
        return [
            Finding("bare-suppression", self.path, lineno, 0,
                    f"suppression '{what}' has no reason — append "
                    f"' -- <why this is safe>'")
            for lineno, what in self.bare
        ]


def _excluded(path: str, exclude: Optional[List[str]]) -> bool:
    if not exclude:
        return False
    norm = os.path.normpath(path)
    for prefix in exclude:
        p = os.path.normpath(prefix)
        if norm == p or norm.startswith(p + os.sep):
            return True
    return False


def _iter_py_files(paths: List[str], exclude: Optional[List[str]] = None):
    for path in paths:
        if os.path.isfile(path):
            if not _excluded(path, exclude):
                yield path
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git")
                    and not _excluded(os.path.join(root, d), exclude))
                for name in sorted(files):
                    full = os.path.join(root, name)
                    if name.endswith(".py") \
                            and not _excluded(full, exclude):
                        yield full
        else:
            raise FileNotFoundError(path)


def _module_name(path: str, roots: List[str]) -> str:
    """Dotted module name so package-relative imports resolve when a
    package directory is scanned (``handyrl_tpu_torch/ops/update.py`` ->
    ``handyrl_tpu_torch.ops.update``)."""
    norm = os.path.normpath(path)
    for root in roots:
        parent = os.path.dirname(os.path.normpath(root))
        if norm.startswith(os.path.normpath(root) + os.sep) \
                or norm == os.path.normpath(root):
            rel = os.path.relpath(norm, parent)
            break
    else:
        rel = os.path.basename(norm)
    rel = rel[:-3] if rel.endswith(".py") else rel
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def load_package(paths: List[str], exclude: Optional[List[str]] = None):
    """Parse every .py under ``paths`` into a Package + suppressions.

    Returns ``(package, suppressions_by_path, errors)`` where errors
    are (path, message) for unparseable files.
    """
    roots = [p for p in paths if os.path.isdir(p)]
    modules, suppressions, errors = [], {}, []
    for path in _iter_py_files(paths, exclude):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            module = ModuleInfo(_module_name(path, roots), path, source)
        except (SyntaxError, UnicodeDecodeError) as exc:
            errors.append((path, str(exc)))
            continue
        modules.append(module)
        suppressions[path] = Suppressions(source, path)
    return Package(modules), suppressions, errors


FAMILIES = ("base", "shard", "comm", "race", "num", "leak")


def family_registry(family: str) -> Dict[str, "object"]:
    """The rules of one family (``base`` is :mod:`.rules`)."""
    if family == "base":
        return dict(RULES)
    if family == "shard":
        from .shardrules import SHARD_RULES

        return dict(SHARD_RULES)
    if family == "comm":
        from .commrules import COMM_RULES

        return dict(COMM_RULES)
    if family == "race":
        from .racerules import RACE_RULES

        return dict(RACE_RULES)
    if family == "num":
        from .numrules import NUM_RULES

        return dict(NUM_RULES)
    if family == "leak":
        from .leakrules import LEAK_RULES

        return dict(LEAK_RULES)
    raise ValueError(f"unknown rule family {family!r}")


def active_registry(shard: bool = False,
                    comm: bool = False,
                    race: bool = False,
                    num: bool = False,
                    leak: bool = False) -> Dict[str, "object"]:
    """The rule registry in force: the base rules, plus each family
    whose flag is set (the flags compose)."""
    registry = dict(RULES)
    flags = {"shard": shard, "comm": comm, "race": race, "num": num,
             "leak": leak}
    for family in FAMILIES[1:]:
        if flags[family]:
            registry.update(family_registry(family))
    return registry


def lint_paths(paths: List[str],
               select: Optional[List[str]] = None,
               shard: bool = False,
               comm: bool = False,
               race: bool = False,
               num: bool = False,
               leak: bool = False,
               exclude: Optional[List[str]] = None) -> List[Finding]:
    """Run the (selected) rules over ``paths``; returns surviving
    findings sorted by location."""
    package, suppressions, errors = load_package(paths, exclude)
    findings = [
        Finding("parse-error", path, 1, 0, f"cannot parse: {msg}")
        for path, msg in errors
    ]
    compute_tracer_taint(package)
    compute_device_summaries(package)
    registry = active_registry(shard, comm, race, num, leak)
    active = [registry[r] for r in (select or sorted(registry))]
    for mod in package.modules.values():
        supp = suppressions[mod.path]
        if supp.skip_file:
            # a reason-less skip-file must not be a silent, zero-cost
            # bypass of the whole gate: the bare suppression itself
            # still surfaces (and fails CI) even though rules skip
            findings.extend(supp.bare_findings())
            continue
        for rule in active:
            for finding in rule.check(package, mod):
                if not supp.covers(finding.rule, finding.line):
                    findings.append(finding)
        findings.extend(supp.bare_findings())
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_source(source: str, name: str = "<string>",
                select: Optional[List[str]] = None,
                shard: bool = False,
                comm: bool = False,
                race: bool = False,
                num: bool = False,
                leak: bool = False) -> List[Finding]:
    """Lint one in-memory module (test/fixture helper)."""
    module = ModuleInfo(name, name, source)
    package = Package([module])
    compute_tracer_taint(package)
    compute_device_summaries(package)
    registry = active_registry(shard, comm, race, num, leak)
    supp = Suppressions(source, name)
    findings: List[Finding] = []
    if supp.skip_file:
        findings.extend(supp.bare_findings())
    else:
        for rule_id in (select or sorted(registry)):
            for finding in registry[rule_id].check(package, module):
                if not supp.covers(finding.rule, finding.line):
                    findings.append(finding)
        findings.extend(supp.bare_findings())
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def _print_text(findings: List[Finding], file=None):
    file = file or sys.stdout
    for f in findings:
        print(f"{f.location}: [{f.rule}] {f.message}", file=file)
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    if findings:
        by_rule = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
        print(f"\n{len(findings)} finding(s) ({by_rule})", file=file)
    else:
        print("torchlint: clean", file=file)


def _print_json(findings: List[Finding], file=None):
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    json.dump({
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "col": f.col + 1, "message": f.message}
            for f in findings
        ],
        "counts": counts,
        "total": len(findings),
    }, file or sys.stdout, indent=2)
    print(file=file or sys.stdout)


def _print_sarif(findings: List[Finding], registry, file=None):
    """SARIF 2.1.0 — the schema GitHub code scanning ingests, so CI
    lint findings render as inline PR annotations."""
    rule_ids = sorted({f.rule for f in findings} | set(registry))
    rules_meta = []
    for rule_id in rule_ids:
        rule = registry.get(rule_id)
        summary = rule.summary if rule is not None else {
            "bare-suppression": "a suppression comment with no reason",
            "parse-error": "a file the analyzer cannot parse",
        }.get(rule_id, rule_id)
        meta = {"id": rule_id,
                "shortDescription": {"text": summary}}
        if rule is not None and rule.doc:
            meta["fullDescription"] = {
                "text": " ".join(rule.doc.split())}
        rules_meta.append(meta)
    json.dump({
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "handyrl-torchlint",
                "rules": rules_meta,
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace(os.sep, "/")},
                    "region": {"startLine": f.line,
                               "startColumn": f.col + 1},
                }}],
            } for f in findings],
        }],
    }, file or sys.stdout, indent=2)
    print(file=file or sys.stdout)


def _print_rules():
    """Every family with its rules; a renamed base rule names its JAX
    counterpart."""
    port_to_jax = {port: jax for jax, port in JAX_TO_PORT.items()
                   if jax != port}
    for family in FAMILIES:
        registry = family_registry(family)
        print(f"[{family}] {len(registry)} rules")
        for rule_id in sorted(registry):
            rule = registry[rule_id]
            was = port_to_jax.get(rule_id)
            note = f" (JAX: {was})" if was else ""
            print(f"{rule_id}{note}: {rule.summary}")
            doc = " ".join((rule.doc or "").split())
            if doc:
                print(f"    {doc}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="torchlint",
        description="AST-based PyTorch/CUDA correctness analyzer")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or package directories "
                             "(default: handyrl_tpu_torch)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable JSON output")
    parser.add_argument("--sarif", action="store_true",
                        help="SARIF 2.1.0 output (GitHub code "
                             "scanning annotations)")
    parser.add_argument("--shard", action="store_true",
                        help="also run the sharding/collective-"
                             "consistency rules (shardlint)")
    parser.add_argument("--comm", action="store_true",
                        help="also run the control-plane protocol/"
                             "concurrency rules (commlint)")
    parser.add_argument("--race", action="store_true",
                        help="also run the thread-safety/lock-order "
                             "rules (racelint)")
    parser.add_argument("--num", action="store_true",
                        help="also run the dtype/precision-flow "
                             "rules (numlint)")
    parser.add_argument("--leak", action="store_true",
                        help="also run the resource-lifecycle/"
                             "ownership rules (leaklint)")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--exclude", action="append", default=None,
                        metavar="PREFIX",
                        help="path prefix to skip (repeatable), e.g. "
                             "tests/fixtures")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule registry and exit")
    args = parser.parse_args(argv)

    registry = active_registry(args.shard, args.comm, args.race,
                               args.num, args.leak)
    if args.list_rules:
        # the rule LISTING is documentation, not a gate: always show
        # every family with its doc
        _print_rules()
        return 0
    if args.json and args.sarif:
        print("torchlint: --json and --sarif are mutually exclusive",
              file=sys.stderr)
        return 2

    select = None
    if args.select:
        select = [r.strip() for r in args.select.split(",") if r.strip()]
        unknown = [r for r in select if r not in registry]
        if unknown:
            print(f"torchlint: unknown rule(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    paths = args.paths or ["handyrl_tpu_torch"]
    try:
        findings = lint_paths(paths, select=select, shard=args.shard,
                              comm=args.comm, race=args.race,
                              num=args.num, leak=args.leak,
                              exclude=args.exclude)
    except FileNotFoundError as exc:
        print(f"torchlint: no such path: {exc}", file=sys.stderr)
        return 2

    if args.sarif:
        _print_sarif(findings, registry)
        if findings:
            # stdout is redirected to the .sarif artifact in CI: a red
            # job must still show WHAT failed in its log
            _print_text(findings, file=sys.stderr)
    elif args.json:
        _print_json(findings)
    else:
        _print_text(findings)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
