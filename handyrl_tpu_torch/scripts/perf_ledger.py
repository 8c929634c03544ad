"""Perf regression ledger: append run/bench summaries, check drift.

A copy of the repository's ``scripts/perf_ledger.py``, with the same
arguments, ledger lines and verdicts.  ``append`` folds one source — a
bench tail-1 JSON (``{"metric": ..., "value": ...}`` plus sibling
scalars) or a run directory (its ``metrics.jsonl`` tail) — into one
ledger line::

    {"ts": ..., "source": ..., "metrics": {name: value, ...}}

``--check`` then compares the NEWEST entry of each source against the
rolling median of its prior entries, metric by metric, and exits 1
when any regresses past the tolerance IN ITS BAD DIRECTION — the
direction registry below says which way is bad for which family
(steps/s falling is a regression; batch-wait share rising is).
Metrics with no registered direction are archived but never gate.
Fewer than ``--min-prior`` priors = trivially green (a new source must
not fail on its first appearance).

The ledger is append-only jsonl (``runs/ledger.jsonl`` by default).
Usage: python -m handyrl_tpu_torch.scripts.perf_ledger <run_dir |
bench.json>... [--source TAG] [--ledger PATH] [--check]
"""

import argparse
import json
import os
import re
import sys
import time

DEFAULT_LEDGER = os.path.join("runs", "ledger.jsonl")

# metric-name regex -> direction ("up" = higher is better, "down" =
# lower is better).  First match wins; unmatched metrics never gate.
DIRECTIONS = [
    (r"(steps|frames|games|episodes)_per_sec", "up"),
    (r"_rps($|_)", "up"),
    (r"^rps($|_)", "up"),
    (r"speedup|_ratio$|_vs_", "up"),
    (r"^value$", "up"),
    (r"^mfu", "up"),
    (r"achieved_tflops", "up"),
    (r"tflops_est", "up"),
    (r"amortization|_amortized", "up"),
    (r"degradation", "up"),        # chaos/clean ratio, 1.0 = free
    (r"share$", "down"),           # batch_wait/residual wall shares
    (r"recovery_sec", "down"),
    (r"wait_sec", "down"),
    (r"latency|_p50|_p99|_ms($|_)", "down"),
]


def direction(name):
    for pattern, sense in DIRECTIONS:
        if re.search(pattern, name):
            return sense
    return None


def _numbers(doc):
    """Top-level numeric scalars of a bench JSON (bools excluded)."""
    out = {}
    for key, value in doc.items():
        if isinstance(value, bool):
            continue
        if isinstance(value, (int, float)):
            out[key] = value
    return out


def summarize_run(run_dir, tail=5):
    """A run directory's ledger metrics from its metrics.jsonl tail:
    throughput, MFU, and the wall-share decomposition the attribution
    layer emits (batch-wait share, untracked-residual share)."""
    path = os.path.join(run_dir, "metrics.jsonl")
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if not records:
        raise SystemExit(f"{path}: no records")
    window = records[-tail:]
    walls = [r.get("epoch_wall_sec") or 0.0 for r in window]
    metrics = {}

    def med(values):
        values = sorted(values)
        n = len(values)
        if not n:
            return None
        mid = n // 2
        return (values[mid] if n % 2
                else (values[mid - 1] + values[mid]) / 2.0)

    # steps/s from the cumulative step counter across the tail window
    first, last = window[0], window[-1]
    dsteps = (last.get("steps") or 0) - (first.get("steps") or 0)
    dwall = sum(walls[1:])
    if dsteps > 0 and dwall > 0:
        metrics["steps_per_sec"] = round(dsteps / dwall, 3)
    for key in ("mfu", "achieved_tflops", "arithmetic_intensity"):
        values = [r[key] for r in window
                  if isinstance(r.get(key), (int, float))]
        if values:
            metrics[key] = round(med(values), 4)
    for key, share in (("batch_wait_sec", "batch_wait_share"),
                       ("untracked_residual_sec", "residual_share")):
        shares = [r[key] / r["epoch_wall_sec"] for r in window
                  if isinstance(r.get(key), (int, float))
                  and (r.get("epoch_wall_sec") or 0) > 0]
        if shares:
            metrics[share] = round(med(shares), 4)
    return metrics


def load_source(path):
    """(default source name, metrics) for one append input: a bench
    tail-1 JSON file or a run directory."""
    if os.path.isdir(path):
        return os.path.basename(os.path.normpath(path)), \
            summarize_run(path)
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise SystemExit(f"{path}: expected a JSON object")
    name = doc.get("metric") or \
        os.path.splitext(os.path.basename(path))[0]
    metrics = _numbers(doc)
    if not metrics:
        raise SystemExit(f"{path}: no numeric metrics to ledger")
    return name, metrics


def read_ledger(path):
    entries = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    entries.append(json.loads(line))
    return entries


def append_entry(ledger_path, source, metrics, ts=None):
    entry = {
        "ts": round(float(ts if ts is not None else time.time()), 3),
        "source": source,
        "metrics": metrics,
    }
    parent = os.path.dirname(ledger_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(ledger_path, "a") as f:
        f.write(json.dumps(entry) + "\n")
    return entry


def _median(values):
    values = sorted(values)
    mid = len(values) // 2
    return (values[mid] if len(values) % 2
            else (values[mid - 1] + values[mid]) / 2.0)


def check(entries, tolerance=0.25, window=5, min_prior=2):
    """Regression verdicts for the newest entry of every source.

    Returns (failures, report_lines).  A metric fails when the newest
    value is past ``tolerance`` (fractional) of the rolling median of
    up to ``window`` prior same-source values, in its bad direction.
    """
    failures = []
    lines = []
    by_source = {}
    for entry in entries:
        by_source.setdefault(entry["source"], []).append(entry)
    for source in sorted(by_source):
        history = by_source[source]
        newest = history[-1]
        priors = history[:-1][-window:]
        for name in sorted(newest["metrics"]):
            value = newest["metrics"][name]
            sense = direction(name)
            prior_values = [e["metrics"][name] for e in priors
                            if isinstance(e["metrics"].get(name),
                                          (int, float))]
            if sense is None or len(prior_values) < min_prior:
                status = "skip" if sense is None else "new"
                lines.append(f"  .  {source}/{name} = {value} "
                             f"({status})")
                continue
            base = _median(prior_values)
            if base == 0:
                lines.append(f"  .  {source}/{name} = {value} "
                             "(zero baseline)")
                continue
            delta = (value - base) / abs(base)
            bad = -delta if sense == "up" else delta
            mark = "REGRESS" if bad > tolerance else "ok"
            lines.append(
                f"  {mark:>7} "
                f"{source}/{name} = {value} vs median {round(base, 4)} "
                f"({'+' if delta >= 0 else ''}{round(delta * 100, 1)}%"
                f", {sense}-is-better, n={len(prior_values)})")
            if mark == "REGRESS":
                failures.append((source, name, value, base, delta))
    return failures, lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("inputs", nargs="*",
                        help="bench tail-1 JSON files and/or run "
                             "directories to append")
    parser.add_argument("--ledger", default=DEFAULT_LEDGER)
    parser.add_argument("--source", default=None,
                        help="override the source tag (one input only)")
    parser.add_argument("--ts", type=float, default=None,
                        help="entry timestamp (default: now)")
    parser.add_argument("--check", action="store_true",
                        help="verdict the newest entry per source "
                             "against the rolling median; exit 1 on "
                             "any regression")
    parser.add_argument("--tolerance", type=float, default=0.25,
                        help="fractional regression tolerance "
                             "(default 0.25)")
    parser.add_argument("--window", type=int, default=5,
                        help="rolling-median window of prior entries")
    parser.add_argument("--min-prior", type=int, default=2,
                        help="priors needed before a metric can gate")
    args = parser.parse_args(argv)
    if args.source and len(args.inputs) > 1:
        parser.error("--source needs exactly one input")
    if not args.inputs and not args.check:
        parser.error("nothing to do: no inputs and no --check")

    for path in args.inputs:
        source, metrics = load_source(path)
        entry = append_entry(args.ledger, args.source or source,
                             metrics, ts=args.ts)
        print(f"appended {entry['source']}: "
              f"{len(entry['metrics'])} metrics -> {args.ledger}")

    if args.check:
        entries = read_ledger(args.ledger)
        if not entries:
            raise SystemExit(f"{args.ledger}: empty ledger")
        failures, lines = check(entries, tolerance=args.tolerance,
                                window=args.window,
                                min_prior=args.min_prior)
        print(f"perf ledger check ({args.ledger}, "
              f"tolerance {args.tolerance:.0%}, window {args.window}):")
        for line in lines:
            print(line)
        if failures:
            print(f"FAIL: {len(failures)} regression(s)")
            return 1
        print("ok: no regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
