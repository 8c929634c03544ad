"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints progress on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; ``check`` comes last, each compared number beside its
limit.  Exits non-zero with no result where CUDA is absent or has
fewer devices than the cell asks for, where the port is not beside
``portbench/``, and where JAX or the JAX package was loaded.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench", "cache")
RUNS = os.path.join(ROOT, ".portbench", "run")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "handyrl_tpu")


def since_start():
    """Seconds since this process started, from the kernel's record of
    its start; the interpreter's own start-up counts."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    now = time.clock_gettime(time.CLOCK_BOOTTIME)
    return now - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = parser.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "handyrl_tpu_torch")):
        print("portbench: the port (handyrl_tpu_torch/) is not beside "
              "portbench/", file=sys.stderr)
        return 2
    # every build and kernel cache of the program inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness import spec

    cell = spec.load(opts.workload)
    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {opts.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    run_dir = os.path.join(RUNS, opts.workload)
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)             # the trainer's models/ lands here
    result = cell_mod.run_cell(cell, cell_mod.seed_of(opts.seed),
                               opts.seconds, bool(opts.trace), "cuda",
                               since_start, power_limit,
                               os.path.join(CACHE, "episodes"))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {found}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
