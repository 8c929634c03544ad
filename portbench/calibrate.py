"""The readings the correctness limits are set from, for one cell.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control fp8,int8] [--fault 1] [--planted-seeds N]

For each seed, in one process: the cell's set-up and first three steps
exactly as a benchmark run makes them (no window), then the compared
numbers of the program against the float32 reference: the lower
readings.  ``--control`` adds the controls, the reference itself in
the program's place computed in a precision below the configuration's
bfloat16 (``fp8``, ``int8``: ``refs/train.py``), and ``--fault 1`` the
half-batch fault planted in the reference (half the windows, the loss
doubled); each is compared with the float32 reference as the program
is, on the first ``--planted-seeds`` seeds (all by default).  The
benchmark's own runs never run this.  One JSON line per seed on
standard output.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", default="",
                        help="the controls' precisions: fp8,int8")
    parser.add_argument("--fault", type=int, default=0)
    parser.add_argument("--planted-seeds", type=int, default=None,
                        help="plant the controls and the fault on this "
                             "many of the seeds, the first")
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness import check, spec

    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(opts.workload)
    run_dir = os.path.join(ROOT, ".portbench", "run", opts.workload)
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    for i, seed in enumerate(int(s) for s in opts.seeds.split(",")):
        run = cell_mod.start(cell, cell_mod.seed_of(seed), device,
                             cache=os.path.join(ROOT, ".portbench", "cache",
                                                "episodes"))
        run.learner.stop()
        run.trainer = run.learner = run.marks = None
        cell_mod.free(device)
        line = {"workload": opts.workload, "seed": seed}
        line["program"], ref = cell_mod.readings(cell, run, device)
        episode_of = list(range(len(run.sources)))
        planted = []
        if opts.planted_seeds is not None and i >= opts.planted_seeds:
            opts.control, opts.fault = "", 0
        for precision in filter(None, opts.control.split(",")):
            planted.append(("control_" + precision,
                            {"precision": precision}))
        if opts.fault:
            planted.append(("half_batch", {"half": True}))
        for name, kw in planted:
            steps = check.reference_steps(cell, run.init, run.sources,
                                          episode_of, run.draws, device,
                                          **kw)
            line[name] = check.compare(cell, steps, ref, run.init)
        print(json.dumps(line), flush=True)
        del run, ref
        cell_mod.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
