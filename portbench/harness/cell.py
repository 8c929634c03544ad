"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up makes everything from the seed: the episodes (the ring's fill
and, for a streaming mix, a pool of arrivals), the initial weights on
the device, the port's ``Trainer`` with the device ring.  The trainer
takes its first three steps in an epoch of their own (the steps the
check compares), then ``warmup_steps`` more, and the window opens when
the device has finished the last of them.  In the window the harness
plays the learner (``drive.Learner``): it streams arrivals and closes
every ``epoch_steps`` steps.  With ``trace`` on, a profiled sub-window
of ``trace_steps`` steps follows the window, placed over the next epoch
close.  Then the trainer stops, the device memory peak is read, the
program's state is freed, and the reference checks the first steps.
"""

import gc
import sys
import time
from dataclasses import dataclass

import torch

from . import check, drive, episodes, spec, weights
from .trace import Tracer, summarize

CAPTURE = 3


@dataclass
class Started:
    """A cell set up and through its first steps."""
    trainer: object
    learner: drive.Learner
    marks: drive.StepMarks
    timers: drive.SectionTap
    tracer: object
    sources: list
    init: dict           # the initial weights, a host copy
    draws: list          # the first steps' rows, host arrays
    prog: dict           # the first steps' losses, the params after


class Phases:
    """Set-up's phases, timed on the host, logged to standard error."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        print(f"portbench: {name} {now - self.t:.3f} s", file=sys.stderr,
              flush=True)
        self.t = now


def start(cell, seed, device, trace=False, cache=None):
    """Set-up through the first :data:`CAPTURE` steps' epoch close; the
    episode pools kept in the directory ``cache`` (None: drawn)."""
    args = cell.train_args
    traffic = cell.traffic
    phase = Phases()
    fill, sources = episodes.make_pool(cell.config, seed, episodes.FILL,
                                       args["minimum_episodes"], cache)
    stream = []
    if traffic.get("stream_per_step", 0) > 0:
        stream = episodes.make_pool(cell.config, seed, episodes.STREAM,
                                    traffic["stream_pool"], cache)[0]
    phase("episodes")
    init = weights.init_state(drive.new_module(cell), seed, device)
    init_host = {k: v.cpu().clone() for k, v in init.items()}
    phase("weights")
    trainer = drive.build_trainer(cell, seed, device, init)
    del init
    phase("trainer")
    marks = drive.StepMarks(trainer, CAPTURE)
    draws = drive.DrawTap(trainer.device_replay, CAPTURE)
    outputs = drive.OutputTap(trainer.update_step, marks, args["batch_size"],
                              args.get("burn_in_steps", 0)
                              + args["forward_steps"])
    timers = drive.SectionTap(trainer.timers)
    tracer = Tracer(trainer, -1, traffic["trace_steps"]) if trace else None
    learner = drive.Learner(trainer, marks, cell, stream)
    snapshot = learner.first_steps(fill, CAPTURE)
    phase("fill and first steps")
    prog = {"losses": [{k: float(v) for k, v in m.items()}
                       for m in marks.metrics],
            "outputs": outputs.outputs(),
            "params": {k: v.clone()
                       for k, v in snapshot.module.state_dict().items()}}
    return Started(trainer, learner, marks, timers, tracer, sources,
                   init_host, check.host_draws(draws.draws), prog)


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(cell, run, device):
    """The compared numbers of a started run, its program state freed."""
    episode_of = list(range(len(run.sources)))  # FIFO: slot i = fill i
    ref = check.reference_steps(cell, run.init, run.sources, episode_of,
                                run.draws, device)
    out = check.compare(cell, run.prog, ref, run.init)
    out["bad_draws"] = check.bad_draws(
        run.draws, run.sources, episode_of, cell.train_args["forward_steps"],
        run.sources[0]["present"].shape[1])
    return out, ref


def run_cell(cell, seed, seconds, trace, device, since_start,
             power_limit=lambda: None, cache=None):
    """The result dict of one run: the last line's keys, ``check``
    last."""
    device = torch.device(device)
    traffic = cell.traffic
    run = start(cell, seed, device, trace, cache)
    replay = run.trainer.device_replay

    def probe():
        return {"update": run.timers.read("update"),
                "ingest": run.timers.read("ingest"),
                "episodes": replay.episodes_seen}

    first = CAPTURE + traffic["warmup_steps"] - 1
    steps, t0, t1, opened, closed = drive.window(
        run.learner, run.marks, first, seconds, probe)
    setup_s = since_start() - (time.perf_counter() - t0)
    print(f"portbench: window {steps} steps in {t1 - t0:.3f} s, set-up "
          f"{setup_s:.3f} s", file=sys.stderr, flush=True)
    summary = None
    if run.tracer is not None:
        half = traffic["trace_steps"] // 2
        close = run.learner.next_close
        while close - half <= run.trainer.steps + 2:
            close += traffic["epoch_steps"]
        run.tracer.stop = close - half + traffic["trace_steps"]
        run.tracer.start = close - half
        run.learner.run_until(run.tracer.done.is_set)
        summary = summarize(run.tracer)
        print(f"portbench: traced {summary['steps']} steps, "
              f"{summary['launch_calls']} launch calls, "
              f"{summary['launches']} kernels matched to them",
              file=sys.stderr, flush=True)
    nonfinite = sum(r.get("nonfinite_steps", 0)
                    for r in run.learner.records[1:])
    run.learner.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run.trainer = run.learner = run.marks = run.tracer = replay = None
    free(device)
    numbers, _ = readings(cell, run, device)
    correct, compared = check.judge(numbers, cell.limits)

    ctx = {"cell": cell, "costs": cell.costs(), "trace": summary,
           "steps": steps, "window_s": t1 - t0, "setup_s": setup_s,
           "samples_per_step": (cell.train_args["batch_size"]
                                * cell.train_args["forward_steps"]),
           "opened": opened, "closed": closed,
           "power_limit_w": power_limit() if summary else None}
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value, unit=m["unit"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell.workload.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(steps),
              "failed": int(nonfinite), "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["check"] = compared
    return result


def seed_of(value):
    """A command-line seed as the non-negative integer the generators
    and the trainer's seed arithmetic take: any whole number, folded
    into 40 bits (seeds up to a little over 2**31 pass
    unchanged)."""
    return int(value) % (1 << 40)
