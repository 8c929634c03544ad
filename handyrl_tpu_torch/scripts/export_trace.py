"""Render a run's telemetry span logs into a Perfetto trace.json.

The twin of ``scripts/export_trace.py``: the learner and every
worker/batcher child write per-process span logs
(``spans-<pid>.jsonl``) next to the run's ``metrics.jsonl``; this tool
merges them into the Trace Event Format that https://ui.perfetto.dev
and ``chrome://tracing`` load directly.  Spans carrying a propagated
trace context keep it in ``args.trace``, so one episode's worker ->
gather -> learner journey can be followed across process tracks.  The
span-log format is the JAX package's, so either package's runs render.

Usage: python -m handyrl_tpu_torch.scripts.export_trace <run_dir>
       [out.json]
"""

import sys

from ..telemetry.export import export_run


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    out = argv[1] if len(argv) > 1 else None
    path, count = export_run(argv[0], out)
    if count == 0:
        print(f"no spans found under {argv[0]} (is telemetry on and "
              f"metrics_path set?)")
        return 1
    print(f"wrote {count} events to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
