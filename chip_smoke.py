"""Chip smoke test of the PyTorch/CUDA port (``handyrl_tpu_torch``).

Drives the port's serving path on one CUDA card, at the full published
width of the repo's headline model (GeeseNet, 32 filters x 12 TorusConv
blocks, on the 7x11x17 HungryGeese board), with random weights made
from a seed:

  1. card      — ``nvidia-smi`` name and power limit;
  2. weights   — a seeded Flax-layout numpy param tree, converted with
                 ``models.convert`` and placed on the card;
  3. forward   — 256 real observations through the card and through
                 the CPU on the same weights: max abs difference,
                 steady-state ``inference_batch`` time per bucket, and a
                 ``torch.profiler`` count of the kernels one forward
                 launches;
  4. serving   — ``InferenceService`` on the card answering two spawned
                 CPU workers, each driving a 16-episode lockstep
                 ``RolloutPool`` through ``ServedModel`` (fallback
                 "none"), with a hot swap to a second param set mid-run;
  5. --eval    — ``python -m handyrl_tpu_torch --eval`` on a checkpoint
                 in the JAX package's on-disk format.

Every phase prints one ``phaseN {json}`` line and raises on failure.
The JAX package has no Pallas kernel, so this slice ports none and the
``kernels`` line is empty.  The last line is the ``{"ok": true, ...}``
device record.  Exits non-zero, printing no result, where
``torch.cuda.is_available()`` is False or the package is missing.

Run from the repository root:  python3 chip_smoke.py
Full outputs land in chiprun_out/chip_smoke/.
"""

import json
import os
import queue
import random
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
SEED = 0
FILTERS, BLOCKS = 32, 12               # GeeseNet's published width
PARITY_ROWS = 256                      # = pipeline.max_batch
# card vs CPU on the same weights.  cuDNN runs float32 convolutions in
# TF32 by default (10-bit mantissa, ~3 decimal digits), so that bound
# scales with the output magnitude; with TF32 off only the summation
# order differs, and the bound is absolute
PARITY_RTOL = 2e-3                     # x max(1, max |CPU output|)
FP32_ATOL = 1e-4
SERVED_ATOL = 1e-5                     # same card, same shapes
BUCKETS = (8, 64, 256)
TIMED_RUNS, WARMUP_RUNS = 30, 5
WORKERS, LOCKSTEP = 2, 16              # 2 clients x 16 episodes x 4 seats
EPISODES_PER_WORKER = 96               # >= 32 in all; ~1000 dispatches
GEN_ARGS = {"observation": False, "gamma": 0.8, "compress_steps": 4,
            "episode_compress": False}
PIPELINE = {"mode": "on", "max_batch": 256, "batch_window": 0.002,
            "fallback": "none", "fallback_after": 5.0,
            "traj_slots": 4, "traj_slot_mb": 4}  # small shm footprint
# H100 SXM data sheet: TF32 tensor-core peak and HBM3 bandwidth
PEAK_TF32_FLOPS, PEAK_BYTES_PER_S = 495e12, 3.35e12


def emit(tag, record):
    print(f"{tag} {json.dumps(record, sort_keys=True)}", flush=True)


def _percentile(values, q):
    srt = sorted(values)
    return srt[min(len(srt) - 1, int(q * len(srt)))]


# ---------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------

def real_observations(n, seed):
    """``n`` HungryGeese observations: seeded resets, random steps."""
    from handyrl_tpu_torch.environment import make_env

    random.seed(seed)
    env = make_env({"env": "HungryGeese"})
    obs = []
    while len(obs) < n:
        env.reset()
        for _ in range(random.randrange(12)):
            env.step({p: random.randrange(4) for p in env.turns()})
            if env.terminal():
                break
        obs.extend(env.observation(p) for p in env.players())
    return np.stack(obs[:n])


def forward_cost(rows):
    """FLOPs and bytes one GeeseNet forward needs (convs + heads;
    norms and elementwise ops add ~1% of the FLOPs)."""
    cells = 7 * 11
    macs = cells * 9 * (17 * FILTERS + BLOCKS * FILTERS * FILTERS)
    macs += FILTERS * 4 + 2 * FILTERS
    params = (9 * 17 * FILTERS + BLOCKS * 9 * FILTERS * FILTERS
              + (BLOCKS + 1) * 2 * FILTERS + 6 * FILTERS)
    flops = 2 * macs * rows
    nbytes = 4 * (params + rows * (cells * 17 + 5))
    return flops, nbytes


def time_buckets(torch, model):
    from handyrl_tpu_torch.models.wrapper import forward_numpy

    out = []
    for rows in BUCKETS:
        obs = real_observations(rows, seed=100 + rows)
        x = torch.from_numpy(obs).to(model.device)
        for _ in range(WARMUP_RUNS):
            forward_numpy(model.module, model.device, obs)
        device_ms, wall_ms = [], []
        with torch.inference_mode():
            for _ in range(TIMED_RUNS):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                model.module(x)
                stop.record()
                torch.cuda.synchronize()
                device_ms.append(start.elapsed_time(stop))
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            model.inference_batch(obs)
            wall_ms.append(1e3 * (time.perf_counter() - t0))
        flops, nbytes = forward_cost(rows)
        bound_ms = 1e3 * max(flops / PEAK_TF32_FLOPS,
                             nbytes / PEAK_BYTES_PER_S)
        out.append({
            "bucket": rows, "runs": TIMED_RUNS,
            "device_ms_median": statistics.median(device_ms),
            "device_ms_min": min(device_ms),
            "wall_ms_median": statistics.median(wall_ms),
            "wall_ms_p90": _percentile(wall_ms, 0.9),
            "rows_per_s_wall": rows / (statistics.median(wall_ms) / 1e3),
            "flops": flops, "bytes": nbytes,
            "bound_ms_tf32": bound_ms,
            "bound_by": ("operations" if flops / PEAK_TF32_FLOPS
                         >= nbytes / PEAK_BYTES_PER_S else "bytes"),
        })
    return out


def profile_forward(torch, model, rows, runs=20, trace=None):
    """Kernels launched and device time per forward, from
    ``torch.profiler`` over ``runs`` forwards at one bucket; the busy
    share is kernel time over the host's wall clock of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(real_observations(rows, seed=7)).to(model.device)
    with torch.inference_mode():
        model.module(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                model.module(x)
            torch.cuda.synchronize()
            window_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in kernels)
    device_us = sum(e.self_device_time_total for e in kernels)
    if trace is not None:
        prof.export_chrome_trace(os.path.join(OUT_DIR, trace))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "bucket": rows, "forwards": runs,
        "kernel_launches_per_forward": launches / runs,
        "device_busy_ms_per_forward": (device_us / runs / 1e3
                                       if device_us else "not measured"),
        "device_busy_share": (device_us / window_us
                              if device_us else "not measured"),
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_us": e.self_device_time_total}
                        for e in top],
    }


# ---------------------------------------------------------------------
# phase 4: the served self-play worker (a spawned CPU process)
# ---------------------------------------------------------------------

def selfplay_worker(wid, desc, cfg_raw, model, ctrl_q, out_q, target,
                    seed):
    """One rollout worker: a RolloutPool of LOCKSTEP HungryGeese
    episodes whose every forward goes to the service.  ``model`` was
    rebuilt on this process's CPU by unpickling; it answers only if
    the service cannot (counted)."""
    import traceback

    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.generation import RolloutPool
    from handyrl_tpu_torch.pipeline import PipelineClient, PipelineConfig

    client = None
    try:
        assert str(model.device) == "cpu"
        random.seed(seed)
        cfg = PipelineConfig.from_config(cfg_raw)
        client = PipelineClient(desc, cfg)
        envs = [make_env({"env": "HungryGeese"}) for _ in range(LOCKSTEP)]
        pool = RolloutPool(envs, GEN_ARGS)
        players = envs[0].players()
        epoch = 1
        served = client.wrap(model, epoch)

        def job():
            return {"role": "g", "player": players,
                    "model_id": {p: epoch for p in players}}

        while pool.has_free_slot():
            pool.assign(job(), {p: served for p in players})
        # start together: the timed window excludes process start-up
        out_q.put(("ready", wid, None))
        ctrl_q.get(timeout=300)
        done = after_swap = steps = shipped = 0
        step_sec = 0.0
        final_epochs = Counter()
        half_sent = False
        deadline = time.monotonic() + 600
        while done < target or epoch == 1 or after_swap < 4:
            if time.monotonic() > deadline:
                raise TimeoutError(f"worker {wid}: no swap after {done} "
                                   f"episodes")
            try:
                msg = ctrl_q.get_nowait()
            except queue.Empty:
                msg = None
            if msg is not None:
                # hot swap: stop requesting, let the service adopt the
                # new snapshot, then switch every in-flight episode to
                # it — what a job carrying a newer model does on assign
                _, new_epoch, new_model = msg
                out_q.put(("paused", wid, None))
                ctrl_q.get(timeout=120)
                epoch, model = new_epoch, new_model
                served = client.wrap(model, epoch)
                pool._set_model(served)
                pool.model_epoch = epoch
            t0 = time.perf_counter()
            finished = pool.step()
            step_sec += time.perf_counter() - t0
            for _verb, episode in finished:
                if episode is None:
                    raise RuntimeError("env failure in generation")
                done += 1
                final_epochs[episode["final_model_epoch"]] += 1
                if epoch != 1:
                    after_swap += 1
                shipped += bool(client.push_episode(episode))
                pool.assign(job(), {p: served for p in players})
            steps += 1
            if not half_sent and done >= target // 2:
                out_q.put(("half", wid, None))
                half_sent = True
        out_q.put(("done", wid, {
            "episodes": done, "pool_steps": steps,
            "pool_step_sec": step_sec,
            "request_sec": client.request_sec,
            "request_share_of_step": client.request_sec / step_sec,
            "episodes_shipped": shipped,
            "episodes_spilled": client.episodes_spilled,
            "final_model_epochs": dict(final_epochs),
            "fallbacks": client.fallbacks,
            "fallback_causes": dict(client.fallback_causes),
            "local_rows": client.local_rows,
            "served_rows": client.served_rows,
            "replies_by_epoch": dict(client.replies_by_epoch),
            "torch_cuda_initialized": _cuda_initialized(),
        }))
    except BaseException:
        out_q.put(("error", wid, traceback.format_exc()))
        raise
    finally:
        if client is not None:
            client.close()


def _cuda_initialized():
    import torch

    return bool(torch.cuda.is_initialized())


def _wait_for(out_q, kind, n, procs, svc, timeout, drained):
    """Collect ``n`` messages of ``kind`` from the workers, draining
    the trajectory rings meanwhile; raise on a worker error, a dead
    worker or a dead service."""
    got = {}
    deadline = time.monotonic() + timeout
    while len(got) < n:
        drained.extend(svc.drain_trajectories())
        if time.monotonic() > deadline:
            raise TimeoutError(f"waited {timeout}s for {kind!r}: {got}")
        if svc.failure is not None:
            raise RuntimeError(f"inference service died: {svc.failure!r}")
        try:
            tag, wid, payload = out_q.get(timeout=0.05)
        except queue.Empty:
            for p in procs:
                if p.exitcode not in (None, 0):
                    raise RuntimeError(f"worker exited {p.exitcode}")
            continue
        if tag == "error":
            raise RuntimeError(f"worker {wid} failed:\n{payload}")
        if tag != kind:
            raise RuntimeError(f"worker {wid}: {tag!r} while waiting for "
                               f"{kind!r}")
        got[wid] = payload
    return got


def served_selfplay(torch, model, model2, drained):
    from handyrl_tpu_torch.connection import _mp
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.pipeline import (
        InferenceService,
        PipelineClient,
        PipelineConfig,
        build_obs_spec,
    )

    cfg = PipelineConfig.from_config(PIPELINE)
    torch.cuda.reset_peak_memory_stats()
    svc = InferenceService(model, cfg, epoch=1, device="cuda")
    svc.start()
    env = make_env({"env": "HungryGeese"})
    spec = build_obs_spec(env, LOCKSTEP * len(env.players()))
    procs, ctrl_qs = [], []
    out_q = _mp.Queue()
    check = None
    try:
        descs = [svc.attach(spec) for _ in range(WORKERS)]
        while svc.warm_pending:
            time.sleep(0.01)
        for wid, desc in enumerate(descs):
            ctrl_q = _mp.Queue()
            proc = _mp.Process(
                target=selfplay_worker,
                args=(wid, desc, PIPELINE, model, ctrl_q, out_q,
                      EPISODES_PER_WORKER, SEED + 10 + wid), daemon=True)
            proc.start()
            procs.append(proc)
            ctrl_qs.append(ctrl_q)

        def pump(kind, timeout=300):
            return _wait_for(out_q, kind, WORKERS, procs, svc, timeout,
                             drained)

        pump("ready")
        svc.epoch_stats()  # reset: count only the self-play dispatches
        rows0 = svc.rows_served
        t0 = time.perf_counter()
        for ctrl_q in ctrl_qs:
            ctrl_q.put(("start",))
        pump("half")
        for ctrl_q in ctrl_qs:
            ctrl_q.put(("swap", 2, model2))
        pump("paused")
        svc.set_model(model2, 2)
        deadline = time.monotonic() + 30
        while svc.board.epoch != 2:
            if time.monotonic() > deadline:
                raise TimeoutError("the service never adopted epoch 2")
            time.sleep(0.001)
        for ctrl_q in ctrl_qs:
            ctrl_q.put(("go",))
        results = pump("done")
        wall = time.perf_counter() - t0
        for proc in procs:
            proc.join(timeout=30)
        drained.extend(svc.drain_trajectories(max_episodes=10 ** 6))
        epoch_stats = svc.epoch_stats()
        rows = svc.rows_served - rows0

        # one served batch against the local forward on the card
        client = PipelineClient(svc.attach(spec), cfg)
        try:
            while svc.warm_pending or not client.healthy():
                time.sleep(0.01)
            obs = real_observations(64, seed=11)
            served = client.wrap(model2, 2).inference_batch(obs)
            local = model2.inference_batch(obs)
            check = {k: float(np.abs(served[k] - local[k]).max())
                     for k in ("policy", "value")}
            check_fallbacks = client.fallbacks
        finally:
            client.close()
        stats = svc.stats()
        failure = svc.failure
    finally:
        svc.close()
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
    if failure is not None:
        raise RuntimeError(f"inference service died: {failure!r}")
    return {
        "workers": results, "wall_s": wall, "rows": rows,
        "epoch_stats": epoch_stats, "stats": stats,
        "served_vs_local_max_abs_diff": check,
        "check_fallbacks": check_fallbacks,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }


# ---------------------------------------------------------------------
# phase 5: the --eval entry point
# ---------------------------------------------------------------------

def eval_entry(params):
    from handyrl_tpu_torch.durability import write_checksummed

    with tempfile.TemporaryDirectory() as cwd:
        ckpt = os.path.join(cwd, "geese.ckpt")
        write_checksummed(ckpt, {"params": params, "steps": 0, "epoch": 1})
        with open(os.path.join(cwd, "config.yaml"), "w") as f:
            f.write("env_args:\n    env: 'HungryGeese'\n")
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "handyrl_tpu_torch", "--eval", ckpt,
             "8", "1"], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "eval_stdout.txt"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"--eval exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    table = [line for line in proc.stdout.splitlines()
             if "win rate" in line or line.startswith("agent ")]
    if not any(line.startswith("agent 0: win rate") for line in table):
        raise RuntimeError("--eval printed no result table")
    return {"exit": proc.returncode, "wall_s": wall, "games": 8,
            "result_table": table}


# ---------------------------------------------------------------------

def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.convert import random_flax_params
    from handyrl_tpu_torch.models.geese_net import GeeseNet

    os.makedirs(OUT_DIR, exist_ok=True)
    report = {}

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    report["phase1"] = {"nvidia_smi": smi,
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda,
                        "device": torch.cuda.get_device_name(0),
                        "device_count": torch.cuda.device_count(),
                        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                        "matmul_allow_tf32":
                            torch.backends.cuda.matmul.allow_tf32}
    emit("phase1", report["phase1"])

    # 2. weights
    t0 = time.perf_counter()
    params = random_flax_params(GeeseNet(FILTERS, BLOCKS), seed=SEED)
    params2 = random_flax_params(GeeseNet(FILTERS, BLOCKS), seed=SEED + 1)
    model = TorchModel.from_flax(GeeseNet(FILTERS, BLOCKS), params,
                                 device="cuda")
    model2 = TorchModel.from_flax(GeeseNet(FILTERS, BLOCKS), params2,
                                  device="cuda")
    cpu_model = TorchModel.from_flax(GeeseNet(FILTERS, BLOCKS), params,
                                     device="cpu")
    n_params = sum(p.numel() for p in model.module.parameters())
    assert next(model.module.parameters()).is_cuda
    report["phase2"] = {"params": n_params, "filters": FILTERS,
                        "blocks": BLOCKS, "seed": SEED,
                        "setup_s": time.perf_counter() - t0}
    emit("phase2", report["phase2"])

    # 3. forward parity + timing
    obs = real_observations(PARITY_ROWS, seed=SEED)
    ref = cpu_model.inference_batch(obs)
    out = model.inference_batch(obs)
    diff = {k: float(np.abs(out[k] - ref[k]).max()) for k in ref}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the script's own check only
    try:
        out32 = model.inference_batch(obs)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    diff32 = {k: float(np.abs(out32[k] - ref[k]).max()) for k in ref}
    finite = all(np.isfinite(v).all() for v in out.values())
    shapes = {k: list(v.shape) for k, v in out.items()}
    scale = max(1.0, max(float(np.abs(v).max()) for v in ref.values()))
    report["phase3"] = {
        "rows": PARITY_ROWS, "max_abs_diff_vs_cpu": diff,
        "max_abs_diff_vs_cpu_tf32_off": diff32,
        "tol_tf32": PARITY_RTOL * scale, "atol_tf32_off": FP32_ATOL,
        "finite": finite, "shapes": shapes, "output_scale": scale,
        "buckets": time_buckets(torch, model),
        "profile": [profile_forward(
            torch, model, rows,
            trace="forward_trace_64.json" if rows == 64 else None)
            for rows in BUCKETS],
    }
    emit("phase3", report["phase3"])
    if not finite or shapes != {"policy": [PARITY_ROWS, 4],
                                "value": [PARITY_ROWS, 1]}:
        raise AssertionError(f"bad forward outputs: {shapes}")
    if max(diff.values()) > PARITY_RTOL * scale:
        raise AssertionError(f"card vs CPU {diff} > {PARITY_RTOL * scale}")
    if max(diff32.values()) > FP32_ATOL:
        raise AssertionError(f"card (TF32 off) vs CPU {diff32} > "
                             f"{FP32_ATOL}")

    # 4. served self-play with a hot swap
    drained = []
    served = served_selfplay(torch, model, model2, drained)
    workers = served["workers"].values()
    es = served["epoch_stats"]
    report["phase4"] = {
        "workers": WORKERS, "lockstep": LOCKSTEP,
        "episodes": sum(w["episodes"] for w in workers),
        "episodes_drained": len(drained),
        "requests": es["infer_requests"], "dispatches": es["infer_batches"],
        "batch_rows_mean": es.get("infer_batch_size_mean"),
        "batch_rows_p95": es.get("infer_batch_size_p95"),
        "queue_wait_ms_mean": 1e3 * es.get("infer_queue_wait_sec", 0.0),
        "dispatch_ms_p50": es.get("infer_dispatch_ms_p50"),
        "dispatch_ms_p99": es.get("infer_dispatch_ms_p99"),
        "rows_served": served["rows"], "wall_s": served["wall_s"],
        "rows_per_s": served["rows"] / served["wall_s"],
        "max_memory_allocated_bytes": served["max_memory_allocated_bytes"],
        "param_loads": served["stats"]["param_loads"],
        "served_vs_local_max_abs_diff":
            served["served_vs_local_max_abs_diff"],
        "per_worker": served["workers"],
    }
    emit("phase4", report["phase4"])
    for w in workers:
        if w["fallbacks"] or w["local_rows"]:
            raise AssertionError(f"a worker answered locally: {w}")
        if w["torch_cuda_initialized"]:
            raise AssertionError("a CPU worker initialized CUDA")
        if not w["replies_by_epoch"].get(2):
            raise AssertionError(f"no reply carried the new epoch: {w}")
        if not w["final_model_epochs"].get(2):
            raise AssertionError(f"no episode finished on epoch 2: {w}")
    if served["check_fallbacks"]:
        raise AssertionError("the served-batch check fell back")
    if report["phase4"]["episodes"] < 32:
        raise AssertionError("fewer than 32 episodes finished")
    if served["stats"]["param_loads"] < 2:
        raise AssertionError("the hot swap never reached the device")
    if max(served["served_vs_local_max_abs_diff"].values()) > SERVED_ATOL:
        raise AssertionError("served batch differs from the local forward")
    if len(drained) + sum(w["episodes_spilled"] for w in workers) != \
            report["phase4"]["episodes"]:
        raise AssertionError("episodes lost on the trajectory rings")

    # 5. --eval
    report["phase5"] = eval_entry(params)
    emit("phase5", report["phase5"])

    # 6. kernels: the JAX package reaches pl.pallas_call nowhere, so
    # this slice owes no hand-written kernel
    print("kernels: none — no function of handyrl_tpu reaches "
          "pl.pallas_call (grep -rn pallas handyrl_tpu is empty)")
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1, sort_keys=True, default=str)
    print(json.dumps({"kernels": []}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
