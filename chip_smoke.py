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
                 in the JAX package's on-disk format;
  6. training  — the HungryGeese episodes phase 4 drained go into the
                 device replay ring (and a CPU replica of it); at the
                 shipped train_args (128 windows x 16 steps, seat mode,
                 TD/TD): gather parity card vs CPU, three float32 steps
                 card vs CPU against float64 (losses, gradients,
                 parameter steps; the card's runs with the pinned
                 algorithm set of ``pinned_f32``: TF32 and cuDNN off;
                 all runs on the float64 run's ReLU pattern,
                 ``relu_pattern``),
                 three bf16 steps against them, then the fused replay
                 step timed with CUDA events and profiled;
  7. --train   — ``python -m handyrl_tpu_torch --train`` on the shipped
                 config.yaml cut to 3 epochs, the port's ``--eval`` of
                 ``models/3.ckpt``, and a restart from epoch 3 that
                 restores the optimizer, replays the episode WAL into
                 the ring on the card and trains a fourth epoch;
  8. resilience — (a) ``--train`` with chaos (a gather kill, the
                 inference service killed at epoch 1): both respawn;
                 SIGTERM, once two epochs and the respawned service
                 have landed, lands an emergency checkpoint, a
                 ``restart_epoch: auto`` relaunch resumes it through
                 the WAL and trains the next epoch, ``--eval`` reads it
                 back;
                 (b) ``--train-server`` under ``supervise_learner`` with
                 ``chaos.learner_kill_epoch: 2`` and ``--worker 6`` in a
                 second process: the guard relaunches the SIGKILLed
                 learner, the worker machine re-enters its session, and
                 training reaches epoch 3; no worker initializes CUDA;
  9. Geister   — GeisterNet (32 filters, DRC 3 x 3) training steps at
                 the shipped batch (128 windows x (4 burn-in + 16)
                 steps, turn mode, TD/TD): 64 Geister episodes from a
                 CPU ``RolloutPool`` into the ring on the card; gather
                 parity, float32 losses card (``pinned_f32``) vs CPU,
                 the burn-in gate, bf16 against float32; the fused bf16
                 step timed, profiled and split by layer;
 10. --train   — ``python -m handyrl_tpu_torch --train`` on the shipped
                 config.yaml with ``env: 'Geister'`` and
                 ``burn_in_steps: 4``, cut to 2 epochs of 100 and 50
                 episodes, then ``--eval`` of its checkpoint against
                 ``random`` (10 games);
 11. GRF       — GRFNet (32 filters, DRC 1 x 2) training steps on the
                 (72, 96, 16) raster: 8 GRFProxy episodes of 256 steps
                 into a uint8 ring, seat mode, UPGO/TD, 128 x (4 + 16);
                 the same gates but burn-in, and the same readings;
 12. league    — (a) ``--train`` on the shipped config with
                 ``generation_opponent: {past_epochs: 3, prob: 0.5}``,
                 4 epochs of 50 + 50 episodes: league episodes in
                 epochs 2-3, each
                 ``league_opponent_mean`` key a past epoch whose
                 checkpoint exists, no worker fallback, no worker on
                 CUDA; (b) ``scripts.make_onnx_model`` of the last
                 checkpoint and ``--eval`` of the ``.onnx``, then
                 GeeseNet 32x12 and GeisterNet (DRC 3 x 3, 3 carried
                 steps) exported from the card, the numpy runner against
                 the card's pinned float32 forward within 1e-4 of the
                 output; (c) ``scripts.aux_swa 1 4`` and ``--eval`` of
                 ``swa.ckpt``; (d) ``--eval-server 10 1`` with two
                 ``--eval-client`` processes whose seats run on the card;
 13. Anakin    — (a) the batched TicTacToe env on the card against the
                 CPU's over all 5,478 positions; at 1,024 games,
                 float32 with the pinned set, the card's rollout with
                 injected actions against the CPU's and one update of
                 each against a float64 CPU run; no host sync in a
                 rollout, the syncs of a fused step counted; (b) the
                 fused step (rollout + update) at 1,024 games, bf16,
                 pure self-play and 3 frozen snapshots, timed in
                 interleaved blocks and profiled, FLOPs from the cost
                 model; (c) ``--train`` on the shipped config.yaml with
                 ``anakin: {mode: on, num_envs: 1024}``, 3 epochs of 20
                 fused steps, workers only evaluating; (d)
                 tests/test_learning.py's Anakin loop on the card (32
                 games x 60 steps), its 0.545 win-rate floor;
 14. serving   — (a) phase 2's GeeseNet 32x12 live as epoch 2 in an
                 ``InferenceService`` on the card with two shm workers,
                 a ``ServingFrontend`` on port 0 and eight
                 ``ServeClient`` threads sending one game's four geese
                 per request for 6 s, one client in four pinned to
                 epoch 1 (the second seeded snapshot, through
                 ``model_resolver``): every ok reply equals the card's
                 local forward of its rows and snapshot (strict
                 float32), pinned replies carry epoch 1, some dispatches
                 carry network and shm rows together, ``submitted ==
                 ok + shed + errors``, ``param_loads`` == 2; (b) two
                 such replicas behind a ``RouterFrontend`` (beats 0.1 s,
                 timeout 1 s) under pinned load, one killed silently:
                 no request lost, the corpse evicted within the timeout
                 plus a beat, exact reconciliation, a generation bump on
                 respawn and both replicas serving again; (c)
                 ``--train`` on the shipped config.yaml with ``serving``
                 and ``router`` on (port 0), ``status_port``,
                 ``profile_dir`` and telemetry, 3 epochs: a client pins
                 epoch e-1 through the router while epoch e trains and
                 gets the local forward of ``models/{e-1}.ckpt``;
                 metrics.jsonl carries ``serve_*``,
                 ``untracked_residual_sec`` and ``arithmetic_intensity``;
                 the status JSON parses; ``export_trace`` holds the
                 learner's ``trainer.*``, ``infer.batch``,
                 ``serve.request`` spans and workers' ``episode.rollout``
                 linked by trace id; the profiler window holds CUDA
                 kernels; the attribution tree's heaviest rows; (d)
                 14a's load in interleaved blocks with telemetry on and
                 off (served rows/s and p99; not a gate);
 15. chaos     — (a) ``--train`` on phase 7's config (4 epochs of 50 +
                 50 episodes) with every shm fault armed (torn, full
                 and truncated pushes, stalled pops, dropped and
                 delayed beats) and a surge at epoch 2 holding uploads
                 3 s: every epoch lands, the injected faults and the
                 ring headers' counts, shm + spilled episodes equal the
                 arrivals, a hold backlog after the surge, no worker on
                 CUDA, the guard keys; (b) 14c's config (6 epochs of 50
                 + 50 episodes) with the router beating every 0.5 s and
                 ``chaos.serve_kill_epoch: 2`` under one client's load
                 through the router: kill,
                 eviction and readmission in the log and on the status
                 endpoint's clock, the announcer's generation 0 -> 1,
                 the router's counts reconciled, no call past its
                 deadline; (c) phase 6's fused replay step with the
                 retrace, numerics and host-transfer guards armed
                 against the bare step: losses bit for bit, the median
                 step in interleaved blocks, the syncs the guard counts
                 beside ``torch.cuda.set_sync_debug_mode("warn")``'s;
 16. parallel  — (a) phase 6's GeeseNet 32x12 step on phase 4's
                 episodes (128 windows x 16 steps, the shipped lr) over
                 two gloo ranks sharing the card, each on half the rows
                 (``mesh: {dp: 2}`` float32 and bf16, then ``{dp: 2,
                 fsdp: true}``), two steps against one rank on all the
                 rows (the pinned float32 set; params within rtol 2e-4 /
                 atol 2e-5, ``total`` and ``grad_norm`` within 1e-4),
                 bf16 finite and timed on two ranks and on one; fsdp
                 with its parameters and Adam moments dp-sharded; (b) the
                 same step through a one-rank NCCL group, bit for bit
                 the unsharded step's parameters, the NCCL kernels a
                 step launches (``torch.profiler``), and 20 control
                 words with no host sync (the guard and
                 ``set_sync_debug_mode("error")``); (c) phase 7's config
                 as two ``--train`` ranks of a gloo group on the card
                 (``mesh: {dp: 2}``, 2 epochs of 50 + 50 episodes, 2
                 workers per rank): both exit 0, equal loss lines, rank
                 0 alone writes ``models/`` and metrics, one step
                 signature and no resharding copy in every record.

Phase 7 also holds every epoch record to the runtime guards' keys (no
stall, no lock-order inversion, no nonfinite step, one update-step
signature).  Depth cut to make room for phases 15 and 16 (gates
unchanged): phase 7's restart, phase 8's drills, phase 10, phase 12's
league and phase 15a-b run epochs of 50 + 50 episodes, phase 13c 3
epochs of 20 fused steps, 14a's load 6 s and 14d's blocks 1 s; 8b's
worker machine starts once the learner's entry port is up; phase 8's
drills, its remote workers and phase 10's Geister run (three learners
whose gates hold no time) run together, phase 10 before phase 9, and
phase 7's ``--eval`` beside its restart.

Every phase prints one ``phaseN {json}`` line (phases 12-16 one per
part) and raises on failure.
The JAX package has no Pallas kernel, so the port owes none and the
``kernels`` line is empty.  The last line is the ``{"ok": true, ...}``
device record.  Exits non-zero, printing no result, where
``torch.cuda.is_available()`` is False or the package is missing.

Run from the repository root:  python3 chip_smoke.py
Full outputs land in chiprun_out/chip_smoke/.

``python3 chip_smoke.py --phases 1-5,13`` runs the listed phases and
every phase they need (``NEEDS``: phases 6, 15 and 16 train on phase
4's episodes with phase 2's weights, phase 14 serves phase 2's weights;
phase 1 always runs); a bad list exits 2.

``python3 chip_smoke.py --grad-error [draws]`` instead studies phase 6's
float32 gradient error on the card (ROADMAP C6): per draw, each
tensor's error against float64 with cuDNN's default algorithms, with
``cudnn.deterministic``, with the gates' pinned set (``pinned_f32``) and
on the CPU, and the kernels each card run launches.

``python3 chip_smoke.py --jax-curve`` instead runs the JAX package's
``main.py --train`` on phase 7's config, on the CPU, in a subprocess
(this script never imports JAX), and prints its per-epoch curve: the
reference the port's curve is read against.  It needs JAX and no card.
``python3 chip_smoke.py --jax-curve anakin`` prints the JAX engine's
win rates for phase 13d's loop, on the CPU, the same way.
"""

import contextlib
import json
import os
import queue
import random
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"                           # the card phases 6-7 train on
CLI_DEVICE = []                        # extra CLI args of the children
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


def card_line():
    """Print and return the card's name and power limit, as
    ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


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
             "8", "1", *CLI_DEVICE], cwd=cwd, env=env, capture_output=True, text=True,
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
# phase 6: GeeseNet training steps from the device replay ring
# ---------------------------------------------------------------------

# the shipped train_args at full size, in seat mode (HungryGeese trains
# one seat per row): 128 windows x 16 steps = 2,048 rows per step
TRAIN_ARGS = {"turn_based_training": False, "observation": False,
              "burn_in_steps": 0, "forward_steps": 16, "batch_size": 128,
              "lambda": 0.7, "gamma": 0.8, "policy_target": "TD",
              "value_target": "TD", "entropy_regularization": 0.1,
              "entropy_regularization_decay": 0.1}
RING_CFG = {"turn_based_training": False, "observation": False,
            "forward_steps": 16, "burn_in_steps": 0,
            "transfer_dtype": "bfloat16", "compute_dtype": "bfloat16"}
PARITY_STEPS, TIMED_STEPS, WARMUP_STEPS, PROFILED_STEPS = 3, 60, 10, 10
# float32 with TF32 off, card vs CPU: the first step's loss components
# agree within LOSS_RTOL.  Against a float64 CPU run of the same steps,
# the first step's losses and gradients on the card may err F64_FACTOR
# x as much as the CPU's float32 run does, or the floor, whichever is
# larger (later steps start from parameters that already differ):
LOSS_RTOL = 1e-4                   # loss components (p, v, ent, total)
GRAD_TOL = 1e-4                    # x max |grad| of each tensor
F64_FACTOR = 10.0
# Every step moves each parameter as the float64 run does, held the
# same way (F64_FACTOR x the CPU's float32 error, or DELTA_TOL x lr),
# wherever the float64 gradient exceeds MOVED_REL x its tensor's
# largest: Adam turns any gradient into a step of ~lr, so an element
# whose gradient is near float32 noise (raw gradients reach 1e2 here,
# their float32 error 1e-4) moves by up to +-lr on either device, and
# from step 2 on every run starts from parameters that already differ
DELTA_TOL = 0.05
MOVED_REL = 1e-2
# clip_frac is left out: it counts ratios rho > 1, and on on-policy
# episodes rho is 1 up to rounding, so it flips with summation order
LOSS_KEYS = ("p", "v", "ent", "total")
# bf16 total loss vs float32, relative to the loss's scale
# |p| + |v| + entropy_regularization * ent (>= |total|, never ~0)
BF16_LOSS_RTOL = 0.05
PEAK_BF16_FLOPS = 989e12           # H100 SXM dense bf16, data sheet


def _event_ms(torch, fn, reps):
    """Mean CUDA-event milliseconds of ``fn()`` over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_steps(torch, step, steps, trace=None):
    """Kernel launches, device busy time and host copies per ``step()``
    over ``steps`` calls, from ``torch.profiler``; the chrome trace
    lands in OUT_DIR/``trace`` when one is named."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    if trace is not None:
        prof.export_chrome_trace(os.path.join(OUT_DIR, trace))
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    copies = {kind: sum(e.count for e in events if kind in e.key) / steps
              for kind in ("Memcpy HtoD", "Memcpy DtoH")}
    return {
        "steps": steps,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "host_to_device_copies_per_step": copies["Memcpy HtoD"],
        "device_to_host_copies_per_step": copies["Memcpy DtoH"],
        "device_busy_ms_per_step": (device_us / steps / 1e3
                                    if device_us else "not measured"),
        "device_busy_share": (device_us / window_us if device_us
                              else "not measured"),
        "window_ms_per_step": window_us / steps / 1e3,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_us": e.self_device_time_total}
                        for e in top]}


@contextlib.contextmanager
def pinned_f32(torch):
    """The algorithm set of the card's float32 comparison runs: TF32
    off, and cuDNN off, so every convolution is PyTorch's own im2col +
    cuBLAS SGEMM, a direct sum per output as on the CPU.  With cuDNN
    on, its heuristics pick FFT convolutions for GeeseNet's float32
    backward (``fft2d_r2c_32x32``, ``fft2d_c2r_16x16`` ...), whose error
    scales with the norms of the whole transform rather than of each
    output's terms: the early blocks' weight gradients then err up to
    3.3e-4 of their largest element against float64 where the CPU errs
    6e-6 (``--grad-error``, ROADMAP C6).  The training path keeps
    cuDNN."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def relu_pattern(masks=None, net="geese_net"):
    """The ReLUs of ``handyrl_tpu_torch.models.<net>`` (GeeseNet's: 13
    per forward; ``"tictactoe_net"`` also takes the ConvBlocks' of
    ``models.blocks``) on a fixed on/off pattern.
    With ``masks`` None the forward inside runs as it is and its
    pattern is recorded into the yielded list; with ``masks`` (a
    recorded list) each ReLU in call order becomes ``x * mask``, which
    has ReLU's value and gradient wherever the pattern agrees with
    ``x > 0``, and the yielded list receives the count of decisions the
    pattern overrode.  A float32 forward decides a handful of the ~60 M
    ReLUs of a 2,048-row float64 forward the other way (pre-activations
    within rounding of zero: 7-13 per draw on the CPU), and each such
    flip moves the gradient by a whole upstream term, so the max-norm
    gradient error against float64 swings tenfold from draw to draw, on
    the card and on the CPU alike.  Phase 6's float32 gate runs both
    with the float64 run's pattern: it then measures each device's
    arithmetic, not where the flips fell (ROADMAP C7)."""
    import importlib

    import torch.nn.functional as F

    modules = [importlib.import_module(f"handyrl_tpu_torch.models.{net}")]
    if net == "tictactoe_net":
        modules.append(importlib.import_module(
            "handyrl_tpu_torch.models.blocks"))
    out = []
    pending = iter(masks or ())

    class Functional:
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def relu(x):
            if masks is None:
                out.append(x.detach() > 0)
                return F.relu(x)
            mask = next(pending).to(x.device)
            if mask.shape != x.shape:
                raise AssertionError("the ReLU pattern is another net's")
            out.append(int(((x.detach() > 0) != mask).sum()))
            return x * mask.to(x.dtype)

    for module in modules:
        module.F = Functional()
    try:
        yield out
    finally:
        for module in modules:
            module.F = F
    if next(pending, None) is not None:
        raise AssertionError("the forward ran fewer ReLUs than the pattern")


def _geese_update(torch, params, device, dtype):
    from handyrl_tpu_torch.models.convert import from_flax
    from handyrl_tpu_torch.models.geese_net import GeeseNet
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.update import (
        DEFAULT_LR,
        UpdateStep,
        make_optimizer,
    )

    net = GeeseNet(FILTERS, BLOCKS)
    net.load_state_dict(from_flax(params, net))
    net = net.to(device, torch.float64 if dtype == "float64"
                 else torch.float32)
    lr = DEFAULT_LR * TRAIN_ARGS["batch_size"] * TRAIN_ARGS["forward_steps"]
    step = UpdateStep(net, LossConfig.from_config(TRAIN_ARGS),
                      make_optimizer(net.parameters(), lr),
                      "float32" if dtype == "float64" else dtype)
    if dtype == "float64":
        # the reference: the forward in float64 (the batch's float32
        # tensors promote to it in the loss)
        step.apply_fn = lambda obs, hidden=None: net(obs.to(torch.float64))
    return step, lr


def _named(step, attr):
    """Each parameter's ``data`` or ``grad`` as a float64 CPU copy."""
    import torch

    return {n: getattr(p, attr).detach().to("cpu", torch.float64,
                                            copy=True)
            for n, p in step.module.named_parameters()}


def _max_diff(a, b):
    return float((a - b).abs().max())


def train_steps(torch, episodes, params):
    from handyrl_tpu_torch.learner import host_copy
    from handyrl_tpu_torch.ops.targets import compute_target
    from handyrl_tpu_torch.staging import (
        DeviceReplay,
        make_replay_update_step,
    )

    out = {"episodes": len(episodes), "rows_per_step":
           TRAIN_ARGS["batch_size"] * TRAIN_ARGS["forward_steps"]}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = DeviceReplay(RING_CFG, len(episodes), 4096 << 20, DEV)
    card.offer(episodes)
    card.ingest(max_episodes=10 ** 6)
    torch.cuda.synchronize()
    out["ingest_s"] = time.perf_counter() - t0
    cpu = DeviceReplay(RING_CFG, len(episodes), 4096 << 20, "cpu")
    cpu.offer(episodes)
    cpu.ingest(max_episodes=10 ** 6)
    out.update(ring_episodes=card.size, ring_t_max=card.t_max,
               ring_mib=card.nbytes / 2 ** 20,
               ring_device=str(card.buffers["ep_len"].device))
    if not out["ring_device"].startswith(DEV):
        raise AssertionError(f"the ring is not on the card: {out}")

    # (a) gather parity on injected (slots, tstarts, seats)
    rng = np.random.default_rng(SEED)
    B = TRAIN_ARGS["batch_size"]

    def draw():
        slots = rng.integers(0, card.size, B)
        cands = 1 + np.maximum(0, card.ep_len[slots] - 16)
        return [torch.from_numpy(np.asarray(a, np.int64))
                for a in (slots, rng.integers(0, cands), rng.integers(0, 4, B))]

    draws = [draw() for _ in range(PARITY_STEPS)]
    batches = {"card": [card.gather(*[a.to(DEV) for a in d])
                        for d in draws],
               "cpu": [cpu.gather(*d) for d in draws]}
    mismatched = [k for k, v in batches["card"][0].items()
                  if not torch.equal(v.cpu(), batches["cpu"][0][k])]
    out["gather_equal"] = not mismatched
    if mismatched:
        raise AssertionError(f"card gather differs from the CPU's: "
                             f"{mismatched}")

    # (b) three float32 steps from the same weights and batches on the
    # card (the pinned algorithm set) and on the CPU, both held against
    # a float64 CPU run of the same steps, all three on the float64
    # run's ReLU pattern (``relu_pattern``)
    with pinned_f32(torch):
        runs = {"card": _geese_update(torch, params, DEV, "float32")[0],
                "cpu": _geese_update(torch, params, "cpu", "float32")[0],
                "f64": _geese_update(torch, params, "cpu", "float64")[0]}
        lr = runs["cpu"].optimizer.param_groups[0]["lr"]
        # parameter-step error per mask: the gate's, and for the record
        # tier-1's (|grad| > 1e-6, test_torch_update.py) and one ten
        # times lower than the gate's
        masks = {"delta": MOVED_REL, "delta_rel_1e-3": 1e-3,
                 "delta_abs_1e-6": None}
        err = {d: dict({"loss": 0.0, "grad": 0.0},
                       **{key: 0.0 for key in masks})
               for d in ("card", "cpu")}
        card_vs_cpu_loss = 0.0
        f32_totals, f32_scales = [], []
        flips, unpinned = {}, {}
        for k in range(PARITY_STEPS):
            batch_of = {"card": batches["card"][k],
                        "cpu": batches["cpu"][k], "f64": batches["cpu"][k]}
            before = {d: _named(run, "data") for d, run in runs.items()}
            with relu_pattern() as pattern:
                losses = {"f64": runs["f64"].loss_and_grads(
                    batch_of["f64"])[0]}
            for d in ("card", "cpu"):
                with relu_pattern(pattern) as overridden:
                    losses[d] = runs[d].loss_and_grads(batch_of[d])[0]
                if k == 0:
                    flips[d] = sum(overridden)
            losses = {d: {n: float(v.detach()) for n, v in out.items()}
                      for d, out in losses.items()}
            grads = {d: _named(run, "grad") for d, run in runs.items()}
            if k == 0:
                grads0_f64 = grads["f64"]
                # for the record, not gated: the same first step with
                # each device's own ReLU decisions
                for d, dev in (("card", DEV), ("cpu", "cpu")):
                    own = _geese_update(torch, params, dev, "float32")[0]
                    own.loss_and_grads(batch_of[d])
                    unpinned[d] = max(_rel_errors(
                        _named(own, "grad"), grads0_f64).values())
            for run in runs.values():
                run.apply_grads()
            after = {d: _named(run, "data") for d, run in runs.items()}
            ref = losses["f64"]
            m = losses["card"]
            f32_totals.append(m["total"])
            f32_scales.append(abs(m["p"]) + abs(m["v"]) + TRAIN_ARGS[
                "entropy_regularization"] * abs(m["ent"]))
            for d in ("card", "cpu"):
                e = err[d]
                if k == 0:
                    e["loss"] = max(
                        abs(losses[d][n] - ref[n]) / max(abs(ref[n]), 1e-12)
                        for n in LOSS_KEYS)
                for n, g64 in grads["f64"].items():
                    scale = float(g64.abs().max())
                    if k == 0:
                        e["grad"] = max(e["grad"], _max_diff(
                            grads[d][n], g64) / scale)
                    diff = ((after[d][n] - before[d][n])
                            - (after["f64"][n] - before["f64"][n])).abs()
                    for key, rel in masks.items():
                        moved = g64.abs() > (1e-6 if rel is None
                                             else rel * scale)
                        if moved.any():
                            e[key] = max(e[key],
                                         float(diff[moved].max()) / lr)
            if k == 0:
                card_vs_cpu_loss = max(
                    abs(m[n] - losses["cpu"][n])
                    / max(abs(losses["cpu"][n]), 1e-12) for n in LOSS_KEYS)
    # for the record, not gated: the first step's gradients on the card
    # with cuDNN's own float32 algorithms (TF32 off), against float64
    with pinned_f32(torch), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        cudnn_run = _geese_update(torch, params, DEV, "float32")[0]
        cudnn_run.loss_and_grads(batches["card"][0])
    cudnn_grad_err = max(_rel_errors(_named(cudnn_run, "grad"),
                                     grads0_f64).values())
    out["f32_parity"] = {
        "card_vs_cpu_loss_rel_max": card_vs_cpu_loss,
        "vs_float64": err, "factor": F64_FACTOR,
        "floors": {"loss": LOSS_RTOL, "grad": GRAD_TOL,
                   "delta": DELTA_TOL},
        "moved_rel": MOVED_REL,
        "lr": lr, "f32_totals": f32_totals,
        "relu_flips_step0": flips,
        "own_relu_grad_vs_float64": unpinned,
        "card_cudnn_grad_vs_float64": cudnn_grad_err}
    emit("phase6_parity", out["f32_parity"])
    if card_vs_cpu_loss > LOSS_RTOL:
        raise AssertionError(f"f32 losses differ: {out['f32_parity']}")
    for key, floor in out["f32_parity"]["floors"].items():
        if err["card"][key] > max(F64_FACTOR * err["cpu"][key], floor):
            raise AssertionError(
                f"the card's float32 {key} is further from float64 than "
                f"the CPU's allows: {out['f32_parity']}")

    # (c) bf16 sanity: 3 steps from the same weights and batches
    bf16, _ = _geese_update(torch, params, DEV, "bfloat16")
    bf16_totals = [float(bf16(b)["total"]) for b in batches["card"]]
    bf16_rel = [abs(b - f) / scale for b, f, scale in zip(
        bf16_totals, f32_totals, f32_scales)]
    out["bf16"] = {"totals": bf16_totals, "rel_vs_f32": bf16_rel,
                   "rtol": BF16_LOSS_RTOL}
    if not all(np.isfinite(bf16_totals)) or max(bf16_rel) > BF16_LOSS_RTOL:
        raise AssertionError(f"bf16 steps: {out['bf16']}")

    # steady state: the fused replay step (device draw + gather + bf16
    # forward/backward + clip + Adam), the shipped setting
    step, _ = _geese_update(torch, params, DEV, "bfloat16")
    fused = make_replay_update_step(card, step, B, seed=SEED)
    state = card.device_state()
    for _ in range(WARMUP_STEPS):
        fused(state)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TIMED_STEPS)]
    metrics = []
    t0 = time.perf_counter()
    for start, stop in events:
        start.record()
        metrics.append(fused(state))
        stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in events]
    finite = all(float(m["nonfinite"]) == 0 for m in metrics)
    rows = out["rows_per_step"]
    flops, _ = forward_cost(rows)
    flops *= 3  # forward + backward (two GEMMs per forward GEMM)
    median = statistics.median(step_ms)
    out["steady"] = {
        "steps": TIMED_STEPS, "step_ms_median": median,
        "step_ms_p90": _percentile(step_ms, 0.9),
        "steps_per_s": 1e3 / median, "rows_per_s": rows * 1e3 / median,
        "wall_steps_per_s": TIMED_STEPS / wall,
        "wall_rows_per_s": rows * TIMED_STEPS / wall,
        "model_flop_per_step": flops,
        "bf16_bound_ms": 1e3 * flops / PEAK_BF16_FLOPS,
        "bf16_peak_share": flops / (median / 1e3) / PEAK_BF16_FLOPS,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "finite": finite}
    if not finite:
        raise AssertionError("a fused replay step was not finite")

    # launches per step and busy share, from torch.profiler
    out["profile"] = profile_steps(torch, lambda: fused(state),
                                   PROFILED_STEPS, "train_step_trace.json")

    # per-layer times at the step's shapes (CUDA events, mean of 20)
    d = [a.to(DEV) for a in draws[0]]
    batch = card.gather(*d)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    values = torch.rand(B, 16, 1, 1, device=DEV)
    ones = torch.ones_like(values)
    t0 = time.perf_counter()
    host_copy(step.module.state_dict())
    snapshot_ms = 1e3 * (time.perf_counter() - t0)
    out["layers_ms"] = {
        "draw": _event_ms(torch, lambda: card.draw(state, gen, B), 20),
        "gather": _event_ms(torch, lambda: card.gather(*d), 20),
        "forward_backward": _event_ms(
            torch, lambda: step.loss_and_grads(batch), 20),
        "td_targets": _event_ms(torch, lambda: compute_target(
            "TD", values, values, None, 0.7, 1.0, ones, ones, ones), 20),
        "clip_adam": _event_ms(torch, step.apply_grads, 20),
        "snapshot_host_copy": snapshot_ms,
        "ring_ingest_per_episode": 1e3 * out["ingest_s"] / len(episodes)}
    return out


# ---------------------------------------------------------------------
# phase 7: python -m handyrl_tpu_torch --train on the shipped config
# ---------------------------------------------------------------------

# what a bounded run forces; everything else is the shipped config.yaml
TRAIN_CUTS = {"epochs": 3, "metrics_path": "metrics.jsonl"}


def train_config(cuts):
    import yaml

    with open(os.path.join(ROOT, "config.yaml")) as f:
        config = yaml.safe_load(f)
    config["train_args"].update(cuts)
    return config


def run_training(cmd, cwd, config, timeout=420):
    import yaml

    with open(os.path.join(cwd, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    # a session of its own, swept afterwards: no worker outlives a run
    child = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             start_new_session=True)
    try:
        out, err = child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _stop(child)
        out, err = child.communicate()
        with open(os.path.join(OUT_DIR, "timed_out_stdout.txt"), "w") as f:
            f.write(out + "\n--- stderr ---\n" + err)
        raise RuntimeError(f"{cmd[3:]} passed its {timeout} s limit:\n"
                           f"{out[-3000:]}") from None
    finally:
        _stop(child)
    proc = subprocess.CompletedProcess(cmd, child.returncode, out, err)
    wall = time.perf_counter() - t0
    records = []
    path = os.path.join(cwd, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            records = [json.loads(line) for line in f]
    return proc, records, wall


def epoch_rows(records, steps=0):
    """Per-epoch rows of a metrics.jsonl; ``steps`` and the episode
    count are cumulative in the records (from ``steps`` and 0 at the
    run's start, the count from 0 again in a relaunched learner)."""
    rows, received = [], 0
    for r in records:
        new = r.get("episodes_received", received) - received
        if new < 0:  # a relaunched learner counts from 0 again
            new = r["episodes_received"]
        received = r.get("episodes_received", received)
        rows.append({
            "epoch": r["epoch"], "win_rate": r.get("win_rate"),
            "eval_games": r.get("eval_games"),
            "steps": r["steps"] - steps, "episodes": new or None,
            "epoch_wall_s": r["epoch_wall_sec"],
            "episodes_per_s": new / max(r["epoch_wall_sec"], 1e-9) or None,
            "loss_total": r.get("total"),
            "replay_dropped": r.get("replay_dropped"),
            "infer_dispatch_ms_p50": r.get("infer_dispatch_ms_p50")})
        steps = r["steps"]
    return rows


def train_entry():
    import shutil

    cwd = tempfile.mkdtemp(prefix="train_")
    try:
        return _train_entry(cwd)
    finally:
        shutil.rmtree(cwd, ignore_errors=True)


def _check_run(proc, tag):
    with open(os.path.join(OUT_DIR, f"{tag}_stdout.txt"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    if "WARNING: device_replay is off" in proc.stdout:
        raise AssertionError(f"{tag} took the host batcher path")


def _train_entry(cwd):
    train = [sys.executable, "-m", "handyrl_tpu_torch", "--train",
             *CLI_DEVICE]
    config = train_config(TRAIN_CUTS)
    proc, records, wall = run_training(train, cwd, config)
    _check_run(proc, "train")
    out = {"cuts": TRAIN_CUTS, "wall_s": wall, "epochs": epoch_rows(records)}
    if [r["epoch"] for r in records] != [0, 1, 2] or not os.path.exists(
            os.path.join(cwd, "models", "3.ckpt")):
        raise AssertionError(f"3 epochs did not land: {records}")
    for r in records:
        if r.get("replay") != "device" or not str(
                r.get("replay_device")).startswith(DEV):
            raise AssertionError(f"not the ring path on the card: {r}")
        if not all(np.isfinite(r[k]) for k in ("p", "v", "ent", "total")):
            raise AssertionError(f"nonfinite losses: {r}")
        if not r.get("eval_games"):
            raise AssertionError(f"no eval games counted: {r}")
    out["guards"] = guard_rows(records)
    guard_gates(records, "phase 7")
    # the workers' exit reports share one pipe, so two may land on one
    # line: read them by pattern, not by line
    workers = {int(w): {"cuda_initialized": c == "True",
                        "fallbacks": int(f), "served_rows": int(s),
                        "local_rows": int(loc)}
               for w, c, f, s, loc in re.findall(
                   r"closed worker (\d+): cuda initialized (\w+), pipeline "
                   r"fallbacks (\d+), served rows (\d+), local rows (\d+)",
                   proc.stdout)}
    stats = [json.loads(line.split("=", 1)[1]) for line in
             proc.stdout.splitlines()
             if line.startswith("inference service stats =")]
    out.update(workers=workers, service=stats[-1] if stats else None)
    if len(workers) != config["train_args"]["worker"]["num_parallel"] or any(
            w["cuda_initialized"] or w["fallbacks"]
            for w in workers.values()):
        raise AssertionError(f"worker fallbacks or CUDA in a worker: "
                             f"{workers}")
    if not stats or stats[-1]["param_loads"] < 4:
        raise AssertionError(f"the service did not load every epoch: "
                             f"{stats}")

    # the port's --eval reads the checkpoint back while the run
    # restarts from it (the --eval writes nothing)
    def read_back():
        proc_eval = subprocess.run(
            [sys.executable, "-m", "handyrl_tpu_torch", "--eval",
             "models/3.ckpt", "40", "2", *CLI_DEVICE], cwd=cwd,
            env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
            text=True, timeout=300)
        _check_run(proc_eval, "train_eval")
        return proc_eval

    # restart from epoch 3: the optimizer state resumes, the WAL refills
    # the ring on the card, one more epoch (of 50 + 50 fresh episodes,
    # phase 8's cut: the restart's gates read the resume, not the epoch)
    def restart():
        return run_training(
            train, cwd, train_config(dict(TRAIN_CUTS, epochs=4,
                                          restart_epoch=3,
                                          minimum_episodes=50,
                                          update_episodes=50)))

    done = together({"eval": read_back, "restart": restart})
    out["eval_3"] = [line for line in done["eval"][0].stdout.splitlines()
                     if line.startswith("agent ")]
    if not any("win rate" in line for line in out["eval_3"]):
        raise AssertionError("--eval of models/3.ckpt printed no result")
    steps = records[-1]["steps"]
    proc2, records2, wall2 = done["restart"][0]
    _check_run(proc2, "train_restart")
    out["restart"] = {"wall_s": wall2, "epochs": epoch_rows(
        records2[len(records):], steps=steps),
        "wal": wal_replay(proc2.stdout),
        "first_step_s": records2[-1].get("first_step_sec"),
        "training_started_s": records2[-1].get("training_started_sec"),
        "startup_s": startup(records2[len(records):])}
    if f"restored optimizer state at step {steps}" not in proc2.stdout:
        raise AssertionError("the restart did not restore the optimizer")
    if not out["restart"]["wal"]["replayed"]:
        raise AssertionError("the restart replayed no WAL episode")
    if records2[-1]["epoch"] != 3 or not os.path.exists(
            os.path.join(cwd, "models", "4.ckpt")):
        raise AssertionError("the restart trained no further epoch")
    return out


# the runtime guards' keys in every epoch record (on by default)
GUARD_KEYS = ("retrace_count", "host_transfers", "numerics_contract_breaks",
              "weak_upcasts", "nonfinite_steps", "stall_events",
              "lock_contention_sec", "lock_order_inversions", "fd_count",
              "thread_count", "shm_segments", "resource_growth")


def guard_rows(records):
    return [{k: r.get(k) for k in ("epoch", "epoch_steps") + GUARD_KEYS}
            for r in records]


def guard_gates(records, tag):
    """Every guard key in every record; no stall, no lock-order
    inversion, no nonfinite step; one update-step signature."""
    for r in records:
        missing = [k for k in GUARD_KEYS if r.get(k) is None]
        if missing:
            raise AssertionError(f"{tag}: guard keys {missing} missing "
                                 f"in epoch {r.get('epoch')}")
        if r["stall_events"] or r["lock_order_inversions"] or \
                r["nonfinite_steps"] or r["retrace_count"] != 1:
            raise AssertionError(f"{tag}: guards tripped: "
                                 f"{guard_rows([r])}")


def startup(records):
    """The first record's ``startup_<stage>_sec`` keys: host seconds of
    the learner's start-up stages (resume, CUDA context, trainer build,
    WAL replay, service start)."""
    return {k[len("startup_"):-len("_sec")]: v
            for k, v in (records[0] if records else {}).items()
            if k.startswith("startup_")}


def wal_replay(stdout):
    """The learner's ``wal: replayed N of M ... in T s (read R s,
    ingest I s)`` line: episodes replayed into the ring and the ingest
    time per episode."""
    m = re.search(r"wal: replayed (\d+) of (\d+) logged episode\(s\) "
                  r"into the backlog.* in ([\d.]+) s \(read ([\d.]+) s, "
                  r"ingest ([\d.]+) s\)", stdout)
    if m is None:
        return {"replayed": 0}
    n = int(m.group(1))
    return {"replayed": n, "logged": int(m.group(2)),
            "replay_s": float(m.group(3)), "read_s": float(m.group(4)),
            "ingest_s": float(m.group(5)),
            "ingest_ms_per_episode": 1e3 * float(m.group(5)) / max(n, 1)}


# ---------------------------------------------------------------------
# phase 8: the resilience layer — chaos drills, SIGTERM, remote workers
# ---------------------------------------------------------------------

# 8a: a gather kill at start-up and the service killed at epoch 1; the
# smoke's SIGTERM lands after two epochs (models/2.ckpt)
# 8a: SIGTERM ends the drill's run, so its epoch count only has to
# outlast the wait for two epochs and a respawned service; a respawn
# that lands after the second epoch's record pushes the signal one
# epoch later, which a run of 3 epochs would already have finished
# both configs cut the epoch to 50 + 50 episodes: a relaunch's epoch
# then waits for ~100 fresh episodes, not 600
DRILL_CUTS = {"epochs": 10, "metrics_path": "metrics.jsonl",
              "minimum_episodes": 50, "update_episodes": 50,
              "chaos": {"kill_prob": 0.2, "max_kills": 1,
                        "infer_kill_epoch": 1}}
# 8b: max_respawns 1 makes the worker machine's gather breaker trip on
# the first refused re-dial, so the machine re-enters its session
# through the entry port instead of a lone gather re-dialling
REMOTE_CUTS = {"epochs": 3, "metrics_path": "metrics.jsonl",
               "minimum_episodes": 50, "update_episodes": 50,
               "supervise_learner": True, "max_respawns": 1,
               "chaos": {"learner_kill_epoch": 2}}
WORKER_LINE = re.compile(r"closed worker (\d+): cuda initialized (\w+)")


def _popen(cmd, cwd, tag):
    """``cmd`` in a session of its own (so ``_stop`` reaches every
    process it starts), stdout and stderr into OUT_DIR."""
    log = open(os.path.join(OUT_DIR, f"{tag}_stdout.txt"), "w")
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=log,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=ROOT),
                            start_new_session=True)
    return proc, log


def _peek(log):
    """What a running child has written to its log so far."""
    log.flush()
    with open(log.name) as f:
        return f.read()


def _read(log):
    log.close()
    with open(log.name) as f:
        return f.read()


def _records(cwd):
    path = os.path.join(cwd, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        # a line still being written has no newline yet
        return [json.loads(line) for line in f if line.endswith("\n")]


def _stop(proc, timeout=60):
    """SIGTERM to the leader, then SIGKILL to whatever of its session is
    left: the smoke leaves no process behind."""
    import signal

    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _workers(stdout):
    return [(int(w), c == "True") for w, c in WORKER_LINE.findall(stdout)]


def together(jobs):
    """Run the ``{tag: fn}`` jobs at once, one thread each, and return
    ``{tag: (result, seconds)}``.  For runs of subprocesses whose gates
    hold no time, so their start-ups overlap; the first failure is
    raised once every job has ended."""
    done, errors = {}, []

    def run(tag, fn):
        t0 = time.perf_counter()
        try:
            done[tag] = fn(), time.perf_counter() - t0
        except BaseException as exc:  # re-raised below, in job order
            errors.append((list(jobs).index(tag), exc))

    threads = [threading.Thread(target=run, args=job, daemon=True)
               for job in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise min(errors, key=lambda e: e[0])[1]
    return done


def in_tmp(prefix, fn):
    """``fn`` as a job over a fresh temporary directory, removed after."""
    import shutil

    def job():
        cwd = tempfile.mkdtemp(prefix=prefix)
        try:
            return fn(cwd)
        finally:
            shutil.rmtree(cwd, ignore_errors=True)
    return job


def resilience_jobs():
    """Phase 8's two runs, the drills and the remote workers: each its
    own learner, with no port of the other's, run together."""
    return {tag: in_tmp(f"resilience_{tag}_", fn)
            for tag, fn in (("drills", _drills), ("remote", _remote))}


def _drills(cwd):
    import yaml

    train = [sys.executable, "-m", "handyrl_tpu_torch", "--train",
             *CLI_DEVICE]
    with open(os.path.join(cwd, "config.yaml"), "w") as f:
        yaml.safe_dump(train_config(DRILL_CUTS), f)
    proc, log = _popen(train, cwd, "drill")
    t0 = time.perf_counter()
    try:
        # two epochs landed, and an epoch closed after the service's
        # respawn (a burst of queued episodes can close an epoch inside
        # the respawn backoff)
        while len(_records(cwd)) < 2 or not _records(cwd)[-1].get(
                "infer_respawns"):
            if proc.poll() is not None:
                raise RuntimeError(f"the drill run exited {proc.returncode}"
                                   f" before two epochs:\n"
                                   f"{_read(log)[-3000:]}")
            if time.perf_counter() - t0 > 300:
                raise TimeoutError("two epochs did not land in 300 s")
            time.sleep(0.05)
        t_kill = time.perf_counter()
        proc.terminate()  # SIGTERM: the preemption notice
        code = proc.wait(timeout=120)
        exit_s = time.perf_counter() - t_kill
    finally:
        _stop(proc)
    stdout = _read(log)
    records = _records(cwd)
    landed = re.search(r"emergency checkpoint landed \(epoch (\d+), step "
                       r"(\d+)\)", stdout)
    save_ms = re.search(r"SIGTERM: emergency save done ([\d.]+) ms",
                        stdout)
    with open(os.path.join(cwd, "models", "manifest.json")) as f:
        latest = json.load(f)["latest"]
    stats = [json.loads(line.split("=", 1)[1]) for line in
             stdout.splitlines()
             if line.startswith("inference service stats =")]
    out = {"exit_code": code, "sigterm_to_exit_s": exit_s,
           "emergency_save_ms": float(save_ms.group(1)) if save_ms else None,
           "emergency": latest,
           "gather_respawns": stdout.count("supervisor: respawned slot"),
           "chaos_gather_kills": stdout.count("(chaos kill #"),
           "service_respawns": stdout.count("inference service respawned"),
           "service": stats[-1] if stats else None,
           "epochs": epoch_rows(records),
           "workers": _workers(stdout)}
    if code == 0 or landed is None or not latest.get("emergency"):
        raise AssertionError(f"no emergency checkpoint on SIGTERM: {out}")
    epoch, step = int(landed.group(1)), int(landed.group(2))
    if (latest["epoch"], latest["steps"]) != (epoch, step):
        raise AssertionError(f"manifest latest {latest} is not the "
                             f"emergency save ({epoch}, {step})")
    if not out["gather_respawns"] or not out["service_respawns"] or (
            stats and stats[-1]["respawns"] < 1):
        raise AssertionError(f"a killed gather or service did not "
                             f"respawn: {out}")
    if any(cuda for _, cuda in out["workers"]):
        raise AssertionError("a CPU worker initialized CUDA")

    # relaunch: resume the emergency point through the WAL and train
    # the next epoch
    cuts = {k: v for k, v in DRILL_CUTS.items() if k != "chaos"}
    proc2, records2, wall2 = run_training(
        train, cwd, train_config(dict(cuts, restart_epoch="auto",
                                      epochs=epoch + 1)))
    _check_run(proc2, "drill_relaunch")
    out["relaunch"] = {
        "wall_s": wall2, "wal": wal_replay(proc2.stdout),
        "first_step_s": records2[-1].get("first_step_sec"),
        "training_started_s": records2[-1].get("training_started_sec"),
        "startup_s": startup(records2[len(records):]),
        "epochs": epoch_rows(records2[len(records):], steps=step)}
    if f"resume: epoch {epoch} from models/latest.ckpt (emergency" \
            not in proc2.stdout:
        raise AssertionError("the relaunch did not resume the emergency "
                             "checkpoint")
    if f"restored optimizer state at step {step}" not in proc2.stdout:
        raise AssertionError("the relaunch did not restore the optimizer "
                             f"at step {step}")
    if not out["relaunch"]["wal"]["replayed"]:
        raise AssertionError("the relaunch replayed no WAL episode")
    if records2[-1]["epoch"] != epoch or not os.path.exists(
            os.path.join(cwd, "models", f"{epoch + 1}.ckpt")):
        raise AssertionError(f"the relaunch did not train epoch "
                             f"{epoch + 1}")
    # the read-back plays in one process (phase 7 drives the farm)
    proc_eval = subprocess.run(
        [sys.executable, "-m", "handyrl_tpu_torch", "--eval",
         f"models/{epoch + 1}.ckpt", "40", "1", *CLI_DEVICE], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    _check_run(proc_eval, "drill_eval")
    out["eval_relaunch"] = [line for line in proc_eval.stdout.splitlines()
                            if line.startswith("agent ")]
    if not any("win rate" in line for line in out["eval_relaunch"]):
        raise AssertionError(f"--eval of the drill's {epoch + 1}.ckpt "
                             f"printed no result")
    return out


def _remote(cwd):
    import yaml

    config = train_config(REMOTE_CUTS)
    config["worker_args"] = {"server_address": "127.0.0.1",
                             "num_parallel": 6}
    with open(os.path.join(cwd, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    t0 = time.perf_counter()
    server, slog = _popen(
        [sys.executable, "-m", "handyrl_tpu_torch", "--train-server",
         *CLI_DEVICE], cwd, "remote_server")
    machine = None
    try:
        # the worker machine starts once the learner's entry port is
        # up: started together, its retry backoff (0.5 s doubling) could
        # sleep through the learner's start-up for up to ~24 s more
        deadline = time.monotonic() + 120
        while "started entry server" not in _peek(slog):
            if server.poll() is not None or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        machine, mlog = _popen(
            [sys.executable, "-m", "handyrl_tpu_torch", "--worker", "6"],
            cwd, "remote_worker")
        code = server.wait(timeout=480)
        wall = time.perf_counter() - t0
    finally:
        _stop(server)
        if machine is not None:
            _stop(machine)
    stdout = _read(slog)
    if code != 0:
        raise RuntimeError(f"--train-server exited {code}:\n"
                           f"{stdout[-3000:]}")
    worker_out = _read(mlog)
    records = _records(cwd)
    out = {"wall_s": wall, "machine_exit": machine.returncode,
           "epochs": epoch_rows(records),
           "wal": wal_replay(stdout),
           "first_step_s": records[-1].get("first_step_sec"),
           "training_started_s": records[-1].get("training_started_sec"),
           "startup_s": startup(records[-1:]),
           "guard_relaunches": stdout.count(
               "learner guard: learner exited"),
           "session_reentries": worker_out.count(
               "gather fleet lost; re-entering the session"),
           "workers": _workers(worker_out)}
    for line in ("CHAOS: SIGKILL of the learner at epoch 2",
                 "learner guard: training finished after 1 relaunch(es)",
                 "learner guard: cuda initialized False"):
        if line not in stdout:
            raise AssertionError(f"--train-server printed no {line!r}")
    if [r["epoch"] for r in records] != [0, 1, 2] or not os.path.exists(
            os.path.join(cwd, "models", "3.ckpt")):
        raise AssertionError(f"remote training did not reach epoch 3: "
                             f"{records}")
    if not out["wal"]["replayed"]:
        raise AssertionError("the relaunched learner replayed no WAL")
    if out["session_reentries"] < 1:
        raise AssertionError("the worker machine did not re-enter")
    if len(out["workers"]) < 12 or any(c for _, c in out["workers"]):
        raise AssertionError(f"worker reports {out['workers']}: expected "
                             f"two sessions of 6, none on CUDA")
    for r in records:
        if r.get("replay") != "device" or not str(
                r.get("replay_device")).startswith(DEV):
            raise AssertionError(f"not the ring path on the card: {r}")
    return out


# ---------------------------------------------------------------------
# phases 9 and 11: recurrent training steps from the device replay ring
# ---------------------------------------------------------------------

GEISTER_EPISODES = 64                   # cut: not a filled ring
GRF_EPISODES, GRF_MAX_STEPS = 8, 256    # cut: GRF episodes run 1,000
RECURRENT_WARMUP, RECURRENT_BLOCKS, RECURRENT_BLOCK_STEPS = 5, 3, 8
RECURRENT_PROFILED = 3
# burn-in, on the card: the window's steps after the burn-in against a
# window 4 steps later that starts from the carried hidden state (the
# same operations on the same card: equal up to float32 rounding)
BURN_TOL = 1e-5                         # x max(1, max |output|)
BURN_ROWS = 32                          # windows the burn-in gate runs
# GRFProxy training as tests/test_grf_proxy.py sets it, at the shipped
# batch and window
GRF_ARGS = {"turn_based_training": False, "observation": False,
            "gamma": 0.993, "burn_in_steps": 4, "policy_target": "UPGO",
            "value_target": "TD"}


def geister_flops_per_row(filters=32, layers=3, repeats=3):
    """Multiply-adds x 2 of one GeisterNet forward row: the stem, the
    DRC's gate convs over [x, h], the move, set, value and return
    heads (norms and elementwise ops add well under 1 %)."""
    cells = 36
    macs = cells * 9 * 25 * filters                        # stem
    macs += layers * repeats * cells * 9 * 2 * filters * 4 * filters
    macs += cells * 9 * filters * 8 + cells * 8 * 4 + 70   # move, set
    macs += 2 * (cells * filters * 2 + cells * 2)          # value, return
    return 2 * macs


def grf_flops_per_row(filters=32, layers=1, repeats=2):
    """The same for GRFNet at the (72, 96, 16) raster."""
    macs = 36 * 48 * 9 * 16 * filters + 18 * 24 * 9 * filters * filters
    macs += layers * repeats * 18 * 24 * 9 * 2 * filters * 4 * filters
    macs += 2 * 18 * 24 * filters * 2 + 18 * 24 * 2 * (9 + 1)
    return 2 * macs


def recurrent_args(overrides):
    """The shipped config.yaml's train_args with ``overrides``."""
    args = train_config({})["train_args"]
    args.update(overrides)
    return args


def pool_episodes(model, env_args, count, seed, lockstep=LOCKSTEP):
    """``count`` episodes from a lockstep ``RolloutPool`` whose forwards
    run on ``model``'s device."""
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.generation import RolloutPool

    random.seed(seed)
    envs = [make_env(env_args) for _ in range(lockstep)]
    pool = RolloutPool(envs, GEN_ARGS)
    players = envs[0].players()
    job = {"role": "g", "player": players,
           "model_id": {p: 1 for p in players}}
    while pool.has_free_slot():
        pool.assign(job, {p: model for p in players})
    episodes = []
    while len(episodes) < count:
        for _verb, episode in pool.step():
            if episode is None:
                raise RuntimeError("env failure in generation")
            episodes.append(episode)
            pool.assign(job, {p: model for p in players})
    return episodes


def generator_episodes(model, env_args, count, seed):
    """``count`` episodes from the sequential ``Generator``."""
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.generation import Generator

    random.seed(seed)
    env = make_env(env_args)
    gen = Generator(env, GEN_ARGS)
    players = env.players()
    job = {"player": players, "model_id": {p: 1 for p in players}}
    episodes = []
    while len(episodes) < count:
        episode = gen.generate({p: model for p in players}, job)
        if episode is not None:
            episodes.append(episode)
    return episodes


def _rows(tree, n):
    """The first ``n`` windows of a batch."""
    from handyrl_tpu_torch.utils.tree import tree_map_leaves

    return tree_map_leaves(lambda a: a[:n], tree)


def _time_slice(tree, lo, hi):
    """Steps ``lo:hi`` of a batch (``outcome``, of one step, whole)."""
    from handyrl_tpu_torch.utils.tree import tree_map_leaves

    return {k: (tree_map_leaves(lambda a: a[:, lo:hi], v)
                if k == "observation" or v.shape[1] > 1 else v)
            for k, v in tree.items()}


def _burn_in_gate(torch, step, batch):
    """tests/test_burn_in.py's two semantics on the card, float32: the
    window's steps after the burn-in give the outputs of a window that
    starts ``b`` steps later from the hidden state carried over, and
    no gradient reaches the initial hidden state through the burn-in
    (with burn-in 0 the same check does find a path)."""
    from handyrl_tpu_torch.ops.losses import (
        forward_prediction,
        recurrent_scan,
    )

    cfg = step.cfg
    b = cfg.burn_in_steps
    cfg0 = cfg._replace(burn_in_steps=0)
    batch = _rows(batch, BURN_ROWS)
    hidden = step.init_hidden(batch)
    with torch.no_grad():
        full = forward_prediction(step.apply_fn, hidden, batch, cfg)
        _, carried = recurrent_scan(step.apply_fn, hidden,
                                    _time_slice(batch, 0, b), cfg0)
        later = forward_prediction(step.apply_fn, carried,
                                   _time_slice(batch, b, None), cfg0)
    value_err = max(
        _max_diff(full[k][:, b:], later[k])
        / max(1.0, float(later[k].abs().max())) for k in later)

    def hidden_grad(c):
        h0 = {k: (v + 0.1).requires_grad_()
              for k, v in step.init_hidden(batch).items()}
        out = forward_prediction(step.apply_fn, h0, batch, c)
        # the value heads: the masked policy carries -1e32 entries
        loss = sum((v[:, c.burn_in_steps:] ** 2).sum()
                   for k, v in out.items() if k != "policy")
        grads = torch.autograd.grad(loss, list(h0.values()),
                                    allow_unused=True)
        return float(sum(g.abs().sum() for g in grads if g is not None))

    return {"burn_in_steps": b, "value_rel_err": value_err,
            "tol": BURN_TOL, "hidden_grad_abs_sum": hidden_grad(cfg),
            "hidden_grad_abs_sum_burn_in_0": hidden_grad(cfg0)}


def recurrent_steps(torch, tag, net_cls, params, episodes, args, ring_cfg,
                    flops_per_row, burn_gate):
    """Phases 9 and 11: ``episodes`` into the ring on the card (and a
    CPU replica); gather parity; float32 step-1 losses card vs CPU with
    TF32 off; the burn-in gate (phase 9); bf16 against float32; then
    the fused bf16 replay step timed in interleaved blocks, profiled,
    and split by layer with CUDA events."""
    from handyrl_tpu_torch.models.convert import from_flax
    from handyrl_tpu_torch.ops.losses import LossConfig, compute_loss
    from handyrl_tpu_torch.ops.targets import compute_target
    from handyrl_tpu_torch.ops.update import (
        DEFAULT_LR,
        UpdateStep,
        make_optimizer,
    )
    from handyrl_tpu_torch.staging import (
        DeviceReplay,
        make_replay_update_step,
    )
    from handyrl_tpu_torch.utils.tree import tree_leaves

    B, fwd = args["batch_size"], args["forward_steps"]
    t_win = args["burn_in_steps"] + fwd
    out = {"episodes": len(episodes),
           "episode_steps_mean": statistics.mean(
               e["steps"] for e in episodes),
           "batch": B, "window": t_win, "rows_per_step": B * t_win}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = DeviceReplay(ring_cfg, len(episodes), 16384 << 20, DEV)
    card.offer(episodes)
    card.ingest(max_episodes=10 ** 6)
    torch.cuda.synchronize()
    out["ingest_s"] = time.perf_counter() - t0
    cpu = DeviceReplay(ring_cfg, len(episodes), 16384 << 20, "cpu")
    cpu.offer(episodes)
    cpu.ingest(max_episodes=10 ** 6)
    out.update(ring_episodes=card.size, ring_t_max=card.t_max,
               ring_mib=card.nbytes / 2 ** 20,
               ring_obs_dtypes=[str(d) for d in card.obs_dtypes],
               ring_device=str(card.buffers["ep_len"].device))
    if not out["ring_device"].startswith(DEV):
        raise AssertionError(f"{tag}: the ring is not on the card: {out}")

    rng = np.random.default_rng(SEED)
    slots = rng.integers(0, card.size, B)
    cands = 1 + np.maximum(0, card.ep_len[slots] - fwd)
    seats = (rng.integers(0, card.num_players, B) if card.mode == "seat"
             else np.zeros(B, np.int64))
    idx = [torch.from_numpy(np.asarray(a, np.int64))
           for a in (slots, rng.integers(0, cands), seats)]
    batch = {DEV: card.gather(*[a.to(DEV) for a in idx]),
             "cpu": cpu.gather(*idx)}
    out["gather_equal"] = all(
        torch.equal(a.cpu(), b) for a, b in zip(
            tree_leaves(batch[DEV]), tree_leaves(batch["cpu"])))
    if not out["gather_equal"]:
        raise AssertionError(f"{tag}: card gather differs from the CPU's")

    lr = DEFAULT_LR * B * fwd

    def make_step(device, dtype):
        net = net_cls()
        net.load_state_dict(from_flax(params, net))
        net.to(device)
        return UpdateStep(net, LossConfig.from_config(args),
                          make_optimizer(net.parameters(), lr), dtype)

    def losses_of(step, b):
        with torch.no_grad():
            losses, _ = compute_loss(step.apply_fn, b, step.init_hidden(b),
                                     step.cfg)
        return {k: float(v) for k, v in losses.items()}

    # float32, card (pinned algorithm set) vs CPU: the first step's
    # losses
    t0 = time.perf_counter()
    with pinned_f32(torch):
        f32 = {d: make_step(d, "float32") for d in (DEV, "cpu")}
        losses = {d: losses_of(f32[d], batch[d]) for d in f32}
        keys = [k for k in ("p", "v", "r", "ent", "total")
                if k in losses["cpu"]]
        rel = {k: abs(losses[DEV][k] - losses["cpu"][k])
               / max(abs(losses["cpu"][k]), 1e-12) for k in keys}
        out["f32_parity"] = {"card": losses[DEV], "cpu": losses["cpu"],
                             "rel": rel, "rtol": LOSS_RTOL}
        emit(f"{tag}_parity", out["f32_parity"])
        if max(rel.values()) > LOSS_RTOL:
            raise AssertionError(f"{tag}: f32 losses differ: {rel}")
        if burn_gate:
            out["burn_in"] = _burn_in_gate(torch, f32[DEV], batch[DEV])
            emit(f"{tag}_burn_in", out["burn_in"])
            g = out["burn_in"]
            if (g["value_rel_err"] > BURN_TOL or g["hidden_grad_abs_sum"]
                    or not g["hidden_grad_abs_sum_burn_in_0"]):
                raise AssertionError(f"{tag}: burn-in gate: {g}")
    out["f32_gates_s"] = time.perf_counter() - t0
    f32_card = losses[DEV]
    del f32
    torch.cuda.empty_cache()

    # bf16 against float32 on the same batch
    step = make_step(DEV, "bfloat16")
    bf16 = losses_of(step, batch[DEV])
    scale = (abs(f32_card["p"]) + abs(f32_card["v"])
             + abs(f32_card.get("r", 0.0))
             + args["entropy_regularization"] * abs(f32_card["ent"]))
    out["bf16"] = {"total": bf16["total"], "f32_total": f32_card["total"],
                   "rel_vs_f32": abs(bf16["total"] - f32_card["total"])
                   / scale, "rtol": BF16_LOSS_RTOL}
    if (not np.isfinite(bf16["total"])
            or out["bf16"]["rel_vs_f32"] > BF16_LOSS_RTOL):
        raise AssertionError(f"{tag}: bf16 vs f32: {out['bf16']}")

    # steady state: the fused bf16 replay step, timed in blocks that
    # interleave with the per-layer timings
    fused = make_replay_update_step(card, step, B, seed=SEED)
    state = card.device_state()
    for _ in range(RECURRENT_WARMUP):
        fused(state)
    torch.cuda.synchronize()
    values = torch.rand(B, fwd, batch[DEV]["value"].shape[2], 1,
                        device=DEV)
    ones = torch.ones_like(values)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    d = [a.to(DEV) for a in idx]
    layers = {}
    step_ms, finite, wall = [], True, 0.0
    for _ in range(RECURRENT_BLOCKS):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(RECURRENT_BLOCK_STEPS)]
        metrics = []
        t0 = time.perf_counter()
        for start, stop in events:
            start.record()
            metrics.append(fused(state))
            stop.record()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        step_ms += [a.elapsed_time(b) for a, b in events]
        finite &= all(float(m["nonfinite"]) == 0 for m in metrics)
        for name, fn in (
                ("draw", lambda: card.draw(state, gen, B)),
                ("gather", lambda: card.gather(*d)),
                ("forward_backward",
                 lambda: step.loss_and_grads(batch[DEV])),
                ("td_targets", lambda: compute_target(
                    "TD", values, values, None, 0.7, 1.0, ones, ones,
                    ones)),
                ("clip_adam", step.apply_grads)):
            layers.setdefault(name, []).append(_event_ms(torch, fn, 3))
    if not finite:
        raise AssertionError(f"{tag}: a fused replay step was not finite")
    rows = out["rows_per_step"]
    rows_bwd = B * fwd
    flops = flops_per_row * (rows + 2 * rows_bwd)
    median = statistics.median(step_ms)
    out["steady"] = {
        "steps": len(step_ms), "blocks": RECURRENT_BLOCKS,
        "step_ms_median": median, "step_ms_p90": _percentile(step_ms, 0.9),
        "block_medians_ms": [statistics.median(
            step_ms[i:i + RECURRENT_BLOCK_STEPS]) for i in range(
                0, len(step_ms), RECURRENT_BLOCK_STEPS)],
        "steps_per_s": 1e3 / median, "rows_per_s": rows * 1e3 / median,
        "wall_steps_per_s": len(step_ms) / wall,
        "forward_flop_per_row": flops_per_row,
        "model_flop_per_step": flops,
        "bf16_bound_ms": 1e3 * flops / PEAK_BF16_FLOPS,
        "bf16_peak_share": flops / (median / 1e3) / PEAK_BF16_FLOPS,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "finite": finite}
    out["layers_ms"] = {k: statistics.median(v) for k, v in layers.items()}
    out["layers_ms"]["ring_ingest_per_episode"] = (
        1e3 * out["ingest_s"] / len(episodes))
    # no chrome trace: ~10,000 launches a step make one of tens of MB
    out["profile"] = profile_steps(torch, lambda: fused(state),
                                   RECURRENT_PROFILED)
    return out


def geister_steps(torch, smi):
    """Phase 9: GeisterNet (32 filters, DRC 3 x 3) at the shipped batch
    with burn-in 4, turn mode, TD/TD, bf16."""
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.convert import random_flax_params
    from handyrl_tpu_torch.models.geister_net import GeisterNet

    params = random_flax_params(GeisterNet(), seed=SEED + 9)
    t0 = time.perf_counter()
    episodes = pool_episodes(
        TorchModel.from_flax(GeisterNet(), params, device="cpu"),
        {"env": "Geister"}, GEISTER_EPISODES, SEED + 9)
    gen_s = time.perf_counter() - t0
    args = recurrent_args({"burn_in_steps": 4})
    ring_cfg = dict(args, transfer_dtype="bfloat16")
    out = recurrent_steps(torch, "phase9", GeisterNet, params, episodes,
                          args, ring_cfg, geister_flops_per_row(), True)
    return dict(out, card=smi, generation_s=gen_s)


def grf_steps(torch, smi):
    """Phase 11: GRFNet (32 filters, DRC 1 x 2) on the (72, 96, 16) GRF
    raster, uint8 ring, seat mode, UPGO/TD, bf16."""
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models import RandomModel, TorchModel
    from handyrl_tpu_torch.models.convert import random_flax_params
    from handyrl_tpu_torch.models.grf_net import GRFNet

    env_args = {"env": "GRFProxy", "max_steps": GRF_MAX_STEPS}
    env = make_env(env_args)
    env.reset()
    model = TorchModel(GRFNet(), device="cpu")
    random_model = RandomModel(model, env.observation(0))
    t0 = time.perf_counter()
    episodes = generator_episodes(random_model, env_args, GRF_EPISODES,
                                  SEED + 11)
    gen_s = time.perf_counter() - t0
    params = random_flax_params(GRFNet(), seed=SEED + 11)
    args = recurrent_args(GRF_ARGS)
    ring_cfg = dict(args, transfer_dtype="uint8")
    out = recurrent_steps(torch, "phase11", GRFNet, params, episodes, args,
                          ring_cfg, grf_flops_per_row(), False)
    return dict(out, card=smi, generation_s=gen_s)


# ---------------------------------------------------------------------
# phase 10: python -m handyrl_tpu_torch --train on Geister
# ---------------------------------------------------------------------

# the shipped config.yaml with these two keys changed ...
GEISTER_CONFIG = {"env": "Geister", "burn_in_steps": 4}
# ... and what a bounded run forces: 2 epochs, closing at 200 and 300
# episodes instead of the shipped 600 and 800, and 10 games of --eval,
# to keep the whole smoke near 700 s
GEISTER_CUTS = {"epochs": 2, "metrics_path": "metrics.jsonl",
                "minimum_episodes": 50, "update_episodes": 50}
GEISTER_EVAL_GAMES = 10


def geister_train_job(smi):
    return in_tmp("geister_train_",
                  lambda cwd: dict(_geister_train_entry(cwd), card=smi))


def _geister_train_entry(cwd):
    train = [sys.executable, "-m", "handyrl_tpu_torch", "--train",
             *CLI_DEVICE]
    config = train_config(dict(GEISTER_CUTS, burn_in_steps=GEISTER_CONFIG[
        "burn_in_steps"]))
    config["env_args"]["env"] = GEISTER_CONFIG["env"]
    proc, records, wall = run_training(train, cwd, config)
    _check_run(proc, "geister_train")
    epochs = config["train_args"]["epochs"]
    out = {"config": GEISTER_CONFIG, "cuts": GEISTER_CUTS, "wall_s": wall,
           "epochs": epoch_rows(records)}
    if [r["epoch"] for r in records] != list(range(epochs)) or \
            not os.path.exists(os.path.join(cwd, "models",
                                            f"{epochs}.ckpt")):
        raise AssertionError(f"{epochs} Geister epochs did not land: "
                             f"{records}")
    for r, row in zip(records, out["epochs"]):
        if r.get("replay") != "device" or not str(
                r.get("replay_device")).startswith(DEV):
            raise AssertionError(f"not the ring path on the card: {r}")
        if row["steps"] <= 0:
            raise AssertionError(f"an epoch trained no step: {row}")
        if not all(np.isfinite(r[k]) for k in ("p", "v", "r", "total")):
            raise AssertionError(f"nonfinite losses: {r}")
    workers = {int(w): {"cuda_initialized": c == "True",
                        "fallbacks": int(f), "served_rows": int(s),
                        "local_rows": int(loc)}
               for w, c, f, s, loc in re.findall(
                   r"closed worker (\d+): cuda initialized (\w+), pipeline "
                   r"fallbacks (\d+), served rows (\d+), local rows (\d+)",
                   proc.stdout)}
    out["workers"] = workers
    if len(workers) != config["train_args"]["worker"]["num_parallel"] or any(
            w["cuda_initialized"] or w["fallbacks"]
            for w in workers.values()):
        raise AssertionError(f"worker fallbacks or CUDA in a worker: "
                             f"{workers}")
    proc_eval = subprocess.run(
        [sys.executable, "-m", "handyrl_tpu_torch", "--eval",
         f"models/{epochs}.ckpt", str(GEISTER_EVAL_GAMES), "2",
         *CLI_DEVICE], cwd=cwd, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    _check_run(proc_eval, "geister_eval")
    out["eval"] = {"exit": proc_eval.returncode,
                   "games": GEISTER_EVAL_GAMES, "result_table": [
                       line for line in proc_eval.stdout.splitlines()
                       if line.startswith("agent ")]}
    if not any("win rate" in line for line in out["eval"]["result_table"]):
        raise AssertionError("--eval of the Geister checkpoint printed no "
                             "result")
    return out


# ---------------------------------------------------------------------
# phase 12: league --train, ONNX, SWA and a network battle
# ---------------------------------------------------------------------

# the shipped config.yaml with league-lite on, and what a bounded run
# forces
LEAGUE_CUTS = {"epochs": 4, "metrics_path": "metrics.jsonl",
               "minimum_episodes": 50, "update_episodes": 50,
               "generation_opponent": {"past_epochs": 3, "prob": 0.5}}
EVAL_GAMES_12 = 20
BATTLE_GAMES = 10
ONNX_TOL = 1e-4                         # x max |card output|, pinned f32
ONNX_STEPS = 3                          # Geister's carried hidden steps
ONNX_TIMED = 20                         # timed single-state inferences
NETWORK_PORT = 9876                     # the eval server's fixed port
# a battle client through the CLI entry, capped at one seat.  The CLI's
# client takes seats until the server stops accepting, so an uncapped
# client that asks first can take both seats of the match (a start
# barrier only narrows that race); capped, each client takes one seat
# whichever connects first
BATTLE_CLIENT = """\
import sys

import handyrl_tpu_torch.evaluation as evaluation
from handyrl_tpu_torch.__main__ import main

open_seat = evaluation.open_socket_connection
seats = []


def one_seat(*args, **kwargs):
    if seats:
        raise ConnectionRefusedError("this client holds its one seat")
    seats.append(open_seat(*args, **kwargs))
    return seats[-1]


evaluation.open_socket_connection = one_seat
print("ready", flush=True)
sys.exit(main(sys.argv[1:]))
"""


def league_entry(torch, smi):
    import shutil

    cwd = tempfile.mkdtemp(prefix="league_")
    try:
        return dict(_league_entry(torch, cwd), card=smi)
    finally:
        shutil.rmtree(cwd, ignore_errors=True)


def _league_entry(torch, cwd):
    out = {}
    for part, fn in (("a", _league_train), ("b", _onnx_entry),
                     ("c", _swa_entry), ("d", _battle_entry)):
        t0 = time.perf_counter()
        out[part] = fn(torch, cwd)
        out[part]["part_s"] = time.perf_counter() - t0
        emit("phase12", dict(out[part], part=f"12{part}"))
    return out


def _cli(args, cwd, tag, timeout=300, device=True):
    proc = subprocess.run(
        [sys.executable, "-m", *args, *(CLI_DEVICE if device else [])],
        cwd=cwd,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=timeout)
    _check_run(proc, tag)
    return proc


def _result_table(stdout):
    return [line for line in stdout.splitlines()
            if line.startswith(("agent ", "    pattern "))]


def _league_train(torch, cwd):
    """12a: ``--train`` with past-self opponents, 4 epochs."""
    train = [sys.executable, "-m", "handyrl_tpu_torch", "--train",
             *CLI_DEVICE]
    config = train_config(LEAGUE_CUTS)
    proc, records, wall = run_training(train, cwd, config)
    _check_run(proc, "league_train")
    epochs = config["train_args"]["epochs"]
    if [r["epoch"] for r in records] != list(range(epochs)) or \
            not os.path.exists(os.path.join(cwd, "models",
                                            f"{epochs}.ckpt")):
        raise AssertionError(f"{epochs} league epochs did not land: "
                             f"{records}")
    rows = epoch_rows(records)
    for r, row in zip(records, rows):
        row["league_episodes"] = r.get("league_episodes")
        row["league_opponent_mean"] = r.get("league_opponent_mean")
        if r.get("replay") != "device" or not str(
                r.get("replay_device")).startswith(DEV):
            raise AssertionError(f"not the ring path on the card: {r}")
        if not all(np.isfinite(r[k]) for k in ("p", "v", "ent", "total")):
            raise AssertionError(f"nonfinite losses: {r}")
        for key in r.get("league_opponent_mean") or {}:
            past = int(key)
            if not 1 <= past < r["epoch"] or not os.path.exists(
                    os.path.join(cwd, "models", f"{past}.ckpt")):
                raise AssertionError(f"league seat of epoch {past} in "
                                     f"epoch {r['epoch']}'s record")
    if any(not records[e].get("league_episodes") for e in (2, 3)):
        raise AssertionError(f"no league episodes in epochs 2-3: {rows}")
    workers = {int(w): {"cuda_initialized": c == "True",
                        "fallbacks": int(f), "served_rows": int(s),
                        "local_rows": int(loc)}
               for w, c, f, s, loc in re.findall(
                   r"closed worker (\d+): cuda initialized (\w+), pipeline "
                   r"fallbacks (\d+), served rows (\d+), local rows (\d+)",
                   proc.stdout)}
    if len(workers) != config["train_args"]["worker"]["num_parallel"] or any(
            w["cuda_initialized"] or w["fallbacks"]
            for w in workers.values()):
        raise AssertionError(f"worker fallbacks or CUDA in a worker: "
                             f"{workers}")
    return {"cuts": LEAGUE_CUTS, "wall_s": wall, "epochs": rows,
            "league_stats": [line for line in proc.stdout.splitlines()
                             if line.startswith("league stats =")],
            "workers": workers}


def _onnx_models(torch):
    """GeeseNet 32x12 and GeisterNet at full width (32 filters, DRC
    3 x 3) on the card from seeded weights, each with ``ONNX_STEPS``
    successive observations of a seeded game."""
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.convert import random_flax_params
    from handyrl_tpu_torch.models.geese_net import GeeseNet
    from handyrl_tpu_torch.models.geister_net import GeisterNet

    out = {}
    for name, net, env_name in (
            ("GeeseNet32x12", GeeseNet(FILTERS, BLOCKS), "HungryGeese"),
            ("GeisterNet32_drc3x3", GeisterNet(), "Geister")):
        rng = random.Random(SEED)
        env = make_env({"env": env_name})
        env.reset()
        obs = []
        while len(obs) < ONNX_STEPS:
            if env.terminal():
                env.reset()
            obs.append(env.observation(env.players()[0]))
            env.step({p: rng.choice(env.legal_actions(p))
                      for p in env.turns()})
        model = TorchModel.from_flax(
            net, random_flax_params(net, seed=SEED), device=DEV)
        out[name] = (model, obs)
    return out


def _mean_ms(fn, runs=ONNX_TIMED, warmup=3):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return 1e3 * (time.perf_counter() - t0) / runs


def _onnx_entry(torch, cwd):
    """12b: ``make_onnx_model`` on the last checkpoint and ``--eval`` of
    the file; then GeeseNet 32x12 and GeisterNet exported from the card,
    the numpy runner against the card's pinned float32 forward."""
    from handyrl_tpu_torch.interop import OnnxModel, export_onnx
    from handyrl_tpu_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    made = _cli(["handyrl_tpu_torch.scripts.make_onnx_model",
                 "models/4.ckpt"], cwd, "make_onnx")
    make_s = time.perf_counter() - t0
    path = os.path.join(cwd, "models", "4.onnx")
    proc = _cli(["handyrl_tpu_torch", "--eval", "models/4.onnx",
                 str(EVAL_GAMES_12), "1"], cwd, "onnx_eval")
    out = {"make_onnx_model_s": make_s, "make_onnx_model": made.stdout
           .strip().splitlines()[-1], "ttt_file_bytes": os.path.getsize(
               path), "eval_games": EVAL_GAMES_12,
           "eval": _result_table(proc.stdout), "nets": {}}
    if not any("win rate" in line for line in out["eval"]):
        raise AssertionError("--eval of models/4.onnx printed no result")

    for name, (model, obs) in _onnx_models(torch).items():
        file = os.path.join(cwd, f"{name}.onnx")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_onnx(model, obs[0], file)
        export_ms = 1e3 * (time.perf_counter() - t0)
        runner = OnnxModel(file)
        hidden, carried = model.init_hidden(), runner.init_hidden()
        errors = []
        with pinned_f32(torch):
            for o in obs:
                ref = model.inference(o, hidden)
                got = runner.inference(o, carried)
                want = [ref[k] for k in sorted(ref) if k != "hidden"]
                have = [got[k] for k in sorted(ref) if k != "hidden"]
                if ref.get("hidden") is not None:
                    want += tree_leaves(ref["hidden"])
                    have += list(got["hidden"])
                    hidden, carried = ref["hidden"], got["hidden"]
                scale = max(float(np.abs(w).max()) for w in want)
                errors.append(max(float(np.abs(h - w).max())
                                  for h, w in zip(have, want)) / scale)
                if not all(np.isfinite(h).all() for h in have):
                    raise AssertionError(f"{name}: nonfinite outputs")
        h0, c0 = model.init_hidden(), runner.init_hidden()
        out["nets"][name] = {
            "export_ms": export_ms, "file_bytes": os.path.getsize(file),
            "rel_err_per_step": errors, "tol": ONNX_TOL,
            "runner_ms": _mean_ms(lambda: runner.inference(obs[0], c0)),
            "card_ms": _mean_ms(lambda: model.inference(obs[0], h0))}
        if max(errors) > ONNX_TOL:
            raise AssertionError(f"{name}: ONNX runner vs card "
                                 f"{errors} > {ONNX_TOL}")
    return out


def _swa_entry(torch, cwd):
    """12c: SWA over epochs 1-4 and ``--eval`` of the result."""
    swa = _cli(["handyrl_tpu_torch.scripts.aux_swa", "1", "4"], cwd,
               "aux_swa", device=False)  # no device work
    proc = _cli(["handyrl_tpu_torch", "--eval", "models/swa.ckpt",
                 str(EVAL_GAMES_12), "1"], cwd, "swa_eval")
    out = {"aux_swa": swa.stdout.strip().splitlines(),
           "eval_games": EVAL_GAMES_12, "eval": _result_table(proc.stdout)}
    if not any("win rate" in line for line in out["eval"]):
        raise AssertionError("--eval of models/swa.ckpt printed no result")
    return out


def _listening(port):
    """True once a server holds ``port``: a bind probe, which takes no
    seat at the server (a connect would)."""
    import socket

    with socket.socket() as probe:
        try:
            probe.bind(("", port))
        except OSError:
            return True
    return False


def _battle_entry(torch, cwd):
    """12d: ``--eval-server`` and two ``--eval-client`` on the card."""
    t0 = time.perf_counter()
    server, server_log = _popen(
        [sys.executable, "-m", "handyrl_tpu_torch", "--eval-server",
         str(BATTLE_GAMES), "1", *CLI_DEVICE], cwd, "battle_server")
    clients = []
    try:
        deadline = time.monotonic() + 120
        while not _listening(NETWORK_PORT):
            if server.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("the eval server never listened:\n"
                                     + _read(server_log)[-3000:])
            time.sleep(0.1)
        for _ in range(2):
            clients.append(subprocess.Popen(
                [sys.executable, "-c", BATTLE_CLIENT, "--eval-client",
                 "models/4.ckpt", "localhost", *CLI_DEVICE], cwd=cwd,
                env=dict(os.environ, PYTHONPATH=ROOT),
                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                start_new_session=True))
        for c in clients:
            for line in iter(c.stdout.readline, ""):
                if line.strip() == "ready":
                    break
            else:
                raise AssertionError("a battle client did not start")
        outs = [c.communicate(timeout=300)[0] for c in clients]
        server.wait(timeout=120)
    finally:
        for proc in [server] + clients:
            _stop(proc)
    wall = time.perf_counter() - t0
    server_out = _read(server_log)
    for i, text in enumerate(outs):
        with open(os.path.join(OUT_DIR, f"battle_client{i}_stdout.txt"),
                  "w") as f:
            f.write(text)
    games = sum(int(n) for n in re.findall(
        r"pattern default_\w+: win rate = [\d.]+ \((\d+) games\)",
        server_out.split("agent 1")[0]))
    seats = [re.findall(r"closed network client: cuda initialized (\w+)",
                        text) for text in outs]
    out = {"games": games, "wall_s": wall, "server_exit": server.returncode,
           "client_exits": [c.returncode for c in clients],
           "client_seats_cuda": seats,
           "result_table": _result_table(server_out)}
    if server.returncode != 0 or games != BATTLE_GAMES:
        raise AssertionError(f"the server counted {games} games, exit "
                             f"{server.returncode}: {server_out[-3000:]}")
    if any(c.returncode for c in clients) or any(
            not s or "False" in s for s in seats):
        raise AssertionError(f"a client failed or sat without CUDA: {out}")
    return out


# ---------------------------------------------------------------------
# phase 13: the Anakin path (fused on-device TicTacToe rollout + update)
# ---------------------------------------------------------------------

ANAKIN_ENVS = 1024                  # the JAX package's default num_envs
REACHABLE_POSITIONS = 5478
ANAKIN_POOLS = (0, 3)               # pure self-play; 3 frozen snapshots
ANAKIN_BLOCKS, ANAKIN_BLOCK_STEPS = 4, 10
ANAKIN_WARMUP, ANAKIN_PROFILED = 5, 5
ANAKIN_ATOL = 1e-5                  # selected_prob, value: card vs CPU
ANAKIN_DISCRETE = ("observation", "action", "action_mask", "episode_mask",
                   "turn_mask", "observation_mask", "outcome", "progress",
                   "reward", "return")
# the shipped config.yaml cut to 3 epochs of 20 fused steps
ANAKIN_CUTS = {"epochs": 3, "updates_per_epoch": 20,
               "metrics_path": "metrics.jsonl",
               "anakin": {"mode": "on", "num_envs": ANAKIN_ENVS}}
# the shipped config's loss keys
TTT_ARGS = {"turn_based_training": True, "observation": False,
            "burn_in_steps": 0, "gamma": 0.8, "lambda": 0.7,
            "policy_target": "TD", "value_target": "TD",
            "entropy_regularization": 0.1,
            "entropy_regularization_decay": 0.1}
# tests/test_learning.py's Anakin loop: 32 games x 60 fused steps,
# Adam at 1e-3, float32, 80 games against random at steps 50, 55, 60
LEARN = {"num_envs": 32, "steps": 60, "seed": 9, "lr": 1e-3,
         "games": 80, "eval_at": [50, 55, 60], "floor": 0.545}
LEARN_ARGS = dict(TTT_ARGS, entropy_regularization=0.05)


def ttt_engine(device, num_envs, opponent_pool=0, dtype="bfloat16",
               seed=SEED, lr=None, loss_args=None):
    """An AnakinEngine over the shipped TicTacToeNet (32 x 3) on
    ``device``, its weights the port's seeded init (the learner's)."""
    from handyrl_tpu_torch.anakin import AnakinConfig, AnakinEngine
    from handyrl_tpu_torch.envs import tictactoe_torch
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.update import (
        DEFAULT_LR,
        UpdateStep,
        make_optimizer,
    )

    model = TorchModel(TicTacToeNet(), device="cpu")
    model.init_params(seed=seed)
    net = model.module.to(device)
    # the trainer's first lr at the shipped batch: 128 x 16 rows
    lr = lr or DEFAULT_LR * 128 * 16
    step = UpdateStep(net, LossConfig.from_config(loss_args or TTT_ARGS),
                      make_optimizer(net.parameters(), lr), dtype)
    return AnakinEngine(tictactoe_torch, step, AnakinConfig.from_config(
        {"mode": "on", "num_envs": num_envs,
         "opponent_pool": opponent_pool}), compute_dtype=dtype, seed=seed)


def anakin_env_walk(torch):
    """13a: the card's env against the CPU's over every reachable
    position, each stepped with every legal action: the state, every
    view and every step output equal."""
    from handyrl_tpu_torch.envs import tictactoe_torch as E

    t0 = time.perf_counter()
    states = {d: E.init(1, d) for d in (DEV, "cpu")}
    total = transitions = 0
    mismatched = set()

    def same(name, a, b):
        if not torch.equal(a.cpu(), b):
            mismatched.add(name)

    while True:
        cpu = states["cpu"]
        total += cpu.cells.shape[0]
        for name in ("terminal", "legal_mask", "turn", "observe",
                     "outcome", "side_to_move"):
            same(name, getattr(E, name)(states[DEV]), getattr(E, name)(cpu))
        legal = E.legal_mask(cpu) & ~E.terminal(cpu)[:, None]
        idx, act = legal.nonzero(as_tuple=True)
        if not len(idx):
            break
        transitions += len(idx)
        outs = {d: E.step(E.State(*(f[idx.to(d)] for f in st)), act.to(d))
                for d, st in states.items()}
        for name, a, b in zip(
                ("cells", "count", "winner", "obs", "reward", "done",
                 "legal"), (*outs[DEV][0], *outs[DEV][1:]),
                (*outs["cpu"][0], *outs["cpu"][1:])):
            same(name, a, b)
        _, keep = np.unique(outs["cpu"][0].cells.numpy(), axis=0,
                            return_index=True)
        keep = torch.from_numpy(keep)
        states = {d: E.State(*(f[keep.to(d)] for f in out[0]))
                  for d, out in outs.items()}
    out = {"positions": total, "transitions": transitions,
           "mismatched": sorted(mismatched),
           "walk_s": time.perf_counter() - t0}
    if total != REACHABLE_POSITIONS or mismatched:
        raise AssertionError(f"the card's env differs from the CPU's: {out}")
    return out


def _ttt_f64(torch, engine):
    """A float64 CPU copy of ``engine``'s live module and optimizer
    (the reference of the float32 gates, as phase 6's)."""
    import copy

    from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer

    src = engine.update_step
    net = copy.deepcopy(src.module).to("cpu", torch.float64)
    step = UpdateStep(net, src.cfg, make_optimizer(
        net.parameters(), src.optimizer.param_groups[0]["lr"]), "float32")
    step.apply_fn = lambda obs, hidden=None: net(obs.to(torch.float64))
    return step


def anakin_gates(torch):
    """13a: at 1,024 games, float32 with the pinned algorithm set: the
    card's rollout with injected actions against the CPU's (discrete
    fields exact, prob and value within ANAKIN_ATOL), then one update
    on each device's batch against a float64 CPU run within phase 6's
    bounds, all three on the float64 run's ReLU pattern."""
    out = {"num_envs": ANAKIN_ENVS}
    with pinned_f32(torch):
        engines = {d: ttt_engine(d, ANAKIN_ENVS, dtype="float32")
                   for d in (DEV, "cpu")}
        cpu = engines["cpu"]
        with torch.no_grad():
            sampled, _, _ = cpu.rollout(cpu.update_step.module, [],
                                        cpu.init_carry(0))
        actions = sampled["action"][:, :, 0, 0].T.contiguous()
        batches, frames = {}, {}
        for d, eng in engines.items():
            with torch.no_grad():
                batches[d], _, frames[d] = eng.rollout(
                    eng.update_step.module, [], eng.init_carry(0), actions)
        card = {k: v.cpu() for k, v in batches[DEV].items()}
        out["discrete_mismatched"] = [
            k for k in ANAKIN_DISCRETE
            if not torch.equal(card[k], batches["cpu"][k])]
        out["prob_value_max_abs_diff"] = {
            k: _max_diff(card[k], batches["cpu"][k])
            for k in ("selected_prob", "value")}
        out["frames"] = {d: int(f) for d, f in frames.items()}
        emit("phase13_rollout", out)
        if out["discrete_mismatched"] or max(
                out["prob_value_max_abs_diff"].values()) > ANAKIN_ATOL or \
                out["frames"][DEV] != out["frames"]["cpu"]:
            raise AssertionError(f"the card's rollout differs: {out}")

        runs = {d: eng.update_step for d, eng in engines.items()}
        runs["f64"] = _ttt_f64(torch, cpu)
        batch_of = {DEV: batches[DEV], "cpu": batches["cpu"],
                    "f64": batches["cpu"]}
        lr = runs["cpu"].optimizer.param_groups[0]["lr"]
        before = {d: _named(run, "data") for d, run in runs.items()}
        with relu_pattern(net="tictactoe_net") as pattern:
            losses = {"f64": runs["f64"].loss_and_grads(batch_of["f64"])[0]}
        flips = {}
        for d in (DEV, "cpu"):
            with relu_pattern(pattern, net="tictactoe_net") as overridden:
                losses[d] = runs[d].loss_and_grads(batch_of[d])[0]
            flips[d] = sum(overridden)
        losses = {d: {n: float(v.detach()) for n, v in ls.items()}
                  for d, ls in losses.items()}
        grads = {d: _named(run, "grad") for d, run in runs.items()}
        for run in runs.values():
            run.apply_grads()
        after = {d: _named(run, "data") for d, run in runs.items()}
    ref = losses["f64"]
    err = {}
    for d in (DEV, "cpu"):
        e = err[d] = {"loss": max(abs(losses[d][n] - ref[n])
                                  / max(abs(ref[n]), 1e-12)
                                  for n in LOSS_KEYS),
                      "grad": 0.0, "delta": 0.0}
        for n, g64 in grads["f64"].items():
            scale = float(g64.abs().max())
            e["grad"] = max(e["grad"], _max_diff(grads[d][n], g64) / scale)
            moved = g64.abs() > MOVED_REL * scale
            diff = ((after[d][n] - before[d][n])
                    - (after["f64"][n] - before["f64"][n])).abs()
            if moved.any():
                e["delta"] = max(e["delta"], float(diff[moved].max()) / lr)
    card_vs_cpu = max(abs(losses[DEV][n] - losses["cpu"][n])
                      / max(abs(losses["cpu"][n]), 1e-12) for n in LOSS_KEYS)
    out["f32_update"] = {
        "card_vs_cpu_loss_rel_max": card_vs_cpu,
        "vs_float64": {("card" if d == DEV else d): e
                       for d, e in err.items()},
        "factor": F64_FACTOR, "lr": lr, "relu_flips": {
            ("card" if d == DEV else d): f for d, f in flips.items()},
        "floors": {"loss": LOSS_RTOL, "grad": GRAD_TOL,
                   "delta": DELTA_TOL}, "losses": losses[DEV]}
    emit("phase13_update", out["f32_update"])
    if card_vs_cpu > LOSS_RTOL:
        raise AssertionError(f"f32 losses differ: {out['f32_update']}")
    for key, floor in out["f32_update"]["floors"].items():
        if err[DEV][key] > max(F64_FACTOR * err["cpu"][key], floor):
            raise AssertionError(
                f"the card's float32 {key} is further from float64 than "
                f"the CPU's allows: {out['f32_update']}")
    out["syncs"] = anakin_syncs(torch)
    return out


def anakin_syncs(torch):
    """Host syncs of one rollout (bf16, 1,024 games, 3 snapshots) under
    ``set_sync_debug_mode("error")``, which raises at the first one, and
    of the whole fused step, counted under ``"warn"``."""
    import warnings

    engine = ttt_engine(DEV, ANAKIN_ENVS, opponent_pool=3)
    pool = engine.init_pool(engine.update_step.module)
    step, carry = engine.make_fused_step(), engine.init_carry(0)
    _, carry = step(carry, pool)                            # warm-up
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with torch.no_grad():
            engine.rollout(engine.update_step.module, pool, carry)
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(carry, pool)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    return {"rollout": 0, "fused_step": len(syncs),
            "fused_step_kinds": sorted(Counter(syncs).items())}


def anakin_timing(torch):
    """13b: the fused step at 1,024 games, bf16, pure self-play and 3
    frozen snapshots, in interleaved blocks (CUDA events per step)."""
    from handyrl_tpu_torch.telemetry import CostModel

    runs = {}
    for k in ANAKIN_POOLS:
        engine = ttt_engine(DEV, ANAKIN_ENVS, opponent_pool=k)
        runs[k] = r = {"engine": engine, "step": engine.make_fused_step(),
                       "pool": engine.init_pool(engine.update_step.module),
                       "carry": engine.init_carry(0), "ms": [], "wall": 0.0,
                       "frames": []}
        # FLOP per step: the cost model's count of the first call
        costs = CostModel(kind=torch.cuda.get_device_name(0))
        _, r["carry"] = costs.call("anakin_step", r["step"], r["carry"],
                                   r["pool"])
        r["flops"] = costs.program("anakin_step")["flops"]
        for _ in range(ANAKIN_WARMUP):
            _, r["carry"] = r["step"](r["carry"], r["pool"])
    torch.cuda.synchronize()

    def once(r):
        metrics, r["carry"] = r["step"](r["carry"], r["pool"])
        return metrics

    for block in range(ANAKIN_BLOCKS):
        for k in (ANAKIN_POOLS if block % 2 == 0
                  else ANAKIN_POOLS[::-1]):
            r = runs[k]
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(ANAKIN_BLOCK_STEPS)]
            t0 = time.perf_counter()
            for start, stop in events:
                start.record()
                r["frames"].append(once(r)["anakin_frames"])
                stop.record()
            torch.cuda.synchronize()
            r["wall"] += time.perf_counter() - t0
            r["ms"] += [a.elapsed_time(b) for a, b in events]
    out = {}
    for k, r in runs.items():
        engine = r["engine"]
        update = engine.update_step
        with torch.no_grad():
            batch, _, _ = engine.rollout(update.module, r["pool"],
                                         r["carry"])
        torch.cuda.reset_peak_memory_stats()
        once(r)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()

        def rollout():
            with torch.no_grad():
                engine.rollout(update.module, r["pool"], r["carry"])

        median = statistics.median(r["ms"])
        frames = float(torch.stack(r["frames"]).float().mean())
        out[f"K{k}"] = {
            "opponent_pool": k, "steps": len(r["ms"]),
            "step_ms_median": median,
            "step_ms_p90": _percentile(r["ms"], 0.9),
            "wall_ms_per_step": 1e3 * r["wall"] / len(r["ms"]),
            "rollout_ms": _event_ms(torch, rollout, 10),
            "update_ms": _event_ms(torch, lambda: update(batch), 10),
            "frames_per_step": frames,
            "frames_per_s": frames * 1e3 / median,
            "games_per_s": ANAKIN_ENVS * 1e3 / median,
            "max_memory_allocated_bytes": peak,
            "flop_per_step": r["flops"],
            "bf16_bound_ms": 1e3 * r["flops"] / PEAK_BF16_FLOPS,
            "bf16_peak_share": r["flops"] / (median / 1e3) / PEAK_BF16_FLOPS}
    # the profiles last: the profiler's hooks slow the host after it
    for k, r in runs.items():
        row = out[f"K{k}"]
        row["profile"] = profile_steps(torch, lambda: once(r),
                                       ANAKIN_PROFILED,
                                       f"anakin_trace_k{k}.json")
        busy = row["profile"]["device_busy_ms_per_step"]
        row["host_share"] = (1 - busy / row["step_ms_median"]
                             if isinstance(busy, float) else "not measured")
    return out


def anakin_train_entry():
    import shutil

    cwd = tempfile.mkdtemp(prefix="anakin_")
    try:
        return _anakin_train_entry(cwd)
    finally:
        shutil.rmtree(cwd, ignore_errors=True)


def _anakin_train_entry(cwd):
    """13c: ``--train`` on the shipped config with ``anakin: {mode: on,
    num_envs: 1024}``, 3 epochs of 20 fused steps; then the port's
    ``--eval`` of the last checkpoint."""
    from handyrl_tpu_torch.durability import read_verified
    from handyrl_tpu_torch.models.convert import from_flax
    from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet

    train = [sys.executable, "-m", "handyrl_tpu_torch", "--train",
             *CLI_DEVICE]
    config = train_config(ANAKIN_CUTS)
    proc, records, wall = run_training(train, cwd, config)
    _check_run(proc, "anakin_train")
    updates = ANAKIN_CUTS["updates_per_epoch"]
    epochs = ANAKIN_CUTS["epochs"]
    rows = [{"epoch": r["epoch"], "steps": r["steps"],
             "epoch_steps": r.get("epoch_steps"),
             "epoch_wall_s": r["epoch_wall_sec"],
             "anakin_frames": r.get("anakin_frames"),
             "anakin_games": r.get("anakin_games"),
             "anakin_frames_per_sec": r.get("anakin_frames_per_sec"),
             "anakin_games_per_sec": r.get("anakin_games_per_sec"),
             "win_rate": r.get("win_rate"), "eval_games": r.get("eval_games"),
             "mfu": r.get("mfu"), "achieved_tflops": r.get("achieved_tflops"),
             "device_step_sec": r.get("device_step_sec"),
             "batch_wait_sec": r.get("batch_wait_sec"),
             "queue_depth": r.get("queue_depth"),
             "roofline_verdict": r.get("roofline_verdict"),
             # the eval fleet's forwards share the card and the GIL
             "infer_requests": r.get("infer_requests"),
             "infer_batches": r.get("infer_batches"),
             "loss_total": r.get("total")} for r in records]
    out = {"cuts": ANAKIN_CUTS, "wall_s": wall, "epochs": rows}
    if [r["steps"] for r in records] != [updates * (e + 1)
                                         for e in range(epochs)]:
        raise AssertionError(f"epochs did not close on the step clock: "
                             f"{rows}")
    for r in records:
        games = ANAKIN_ENVS * r["epoch_steps"]
        if r.get("anakin_games") != games or \
                r.get("anakin_frames", 0) < 5 * games:
            raise AssertionError(f"anakin counts: {r}")
        if not all(np.isfinite(r[k]) for k in ("p", "v", "ent", "total")):
            raise AssertionError(f"nonfinite losses: {r}")
        if r.get("mfu") is None or "replay" in r:
            raise AssertionError(f"no mfu, or a replay path ran: {r}")
    if f"anakin mode: {ANAKIN_ENVS} on-device games" not in proc.stdout:
        raise AssertionError("the learner did not arm the Anakin path")
    # a worker that never attached the service reports no fallbacks
    workers = {int(w): {"cuda_initialized": c == "True",
                        "fallbacks": int(f or 0)}
               for w, c, f in re.findall(
                   r"closed worker (\d+): cuda initialized (\w+)"
                   r"(?:, pipeline fallbacks (\d+))?", proc.stdout)}
    out["workers"] = workers
    if len(workers) != config["train_args"]["worker"]["num_parallel"] or any(
            w["cuda_initialized"] or w["fallbacks"]
            for w in workers.values()):
        raise AssertionError(f"worker fallbacks or CUDA in a worker: "
                             f"{workers}")
    # the checkpoint holds the JAX package's param tree (tier-1 has the
    # JAX package read it; this card has no JAX), and the port's
    # --eval reads it back
    path = os.path.join(cwd, "models", f"{epochs}.ckpt")
    from_flax(read_verified(path)["params"], TicTacToeNet())
    proc_eval = _cli(["handyrl_tpu_torch", "--eval", f"models/{epochs}.ckpt",
                      "20", "1"], cwd, "anakin_eval")
    out["eval"] = _result_table(proc_eval.stdout)
    if not any("win rate" in line for line in out["eval"]):
        raise AssertionError("--eval of the anakin checkpoint printed no "
                             "result")
    return out


def eval_win_rate(model, games, seed):
    """Win rate against random, seats alternated, draws half
    (tests/test_learning.py's helper, on the port's agents)."""
    from handyrl_tpu_torch.agent import Agent, RandomAgent
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.evaluation import exec_match

    env = make_env({"env": "TicTacToe"})
    random.seed(seed)
    score = 0.0
    for g in range(games):
        ours, theirs = env.players()[g % 2], env.players()[1 - g % 2]
        outcome = exec_match(env, {ours: Agent(model),
                                   theirs: RandomAgent()})
        score += (outcome[ours] + 1) / 2
    return score / games


def anakin_learning(torch):
    """13d: tests/test_learning.py's Anakin loop on the card."""
    from handyrl_tpu_torch.learner import host_copy
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.tictactoe_net import TicTacToeNet

    t0 = time.perf_counter()
    engine = ttt_engine(DEV, LEARN["num_envs"], dtype="float32",
                        seed=LEARN["seed"], lr=LEARN["lr"],
                        loss_args=LEARN_ARGS)
    module = engine.update_step.module
    init = host_copy(module.state_dict())
    step, carry = engine.make_fused_step(), engine.init_carry(0)
    rates, totals = [], []
    for i in range(LEARN["steps"]):
        metrics, carry = step(carry)
        totals.append(metrics["total"])
        if i + 1 in LEARN["eval_at"]:
            snap = TorchModel(TicTacToeNet(), device="cpu")
            snap.load_params(host_copy(module.state_dict()))
            rates.append(eval_win_rate(snap, LEARN["games"],
                                       seed=77 + len(rates)))
    final = host_copy(module.state_dict())
    moved = any(not np.allclose(init[k], final[k]) for k in init)
    totals = [float(t) for t in totals]
    out = dict(LEARN, rates=rates, mean=sum(rates) / len(rates),
               moved=moved, finite=bool(np.isfinite(totals).all()),
               loss_first_last=[totals[0], totals[-1]],
               wall_s=time.perf_counter() - t0)
    if out["mean"] < LEARN["floor"] or not moved or not out["finite"]:
        raise AssertionError(f"the Anakin loop did not learn: {out}")
    return out


def anakin_entry(torch, smi):
    """Phase 13, one ``phase13 {json}`` line per part (13a-13d)."""
    out = {"card": smi}
    for part, fn in (("a", lambda: dict(walk=anakin_env_walk(torch),
                                         **anakin_gates(torch))),
                     ("b", lambda: anakin_timing(torch)),
                     ("c", anakin_train_entry),
                     ("d", lambda: anakin_learning(torch))):
        t0 = time.perf_counter()
        out[part] = fn()
        out[part]["part_s"] = time.perf_counter() - t0
        emit("phase13", dict(out[part], part=f"13{part}"))
    return out


JAX_ANAKIN_LOOP = """
import json, random, sys
import jax, jax.numpy as jnp, numpy as np
from handyrl_tpu.agent import Agent, RandomAgent
from handyrl_tpu.anakin import AnakinConfig, AnakinEngine
from handyrl_tpu.environment import make_env, make_jax_env
from handyrl_tpu.evaluation import exec_match
from handyrl_tpu.models import TPUModel
from handyrl_tpu.ops.losses import LossConfig
from handyrl_tpu.ops.update import make_optimizer

learn, loss_args = json.loads(sys.argv[1]), json.loads(sys.argv[2])
env = make_env({"env": "TicTacToe"})
env.reset()
model = TPUModel(env.net())
model.init_params(env.observation(env.players()[0]), seed=learn["seed"])
optimizer = make_optimizer(learn["lr"])
engine = AnakinEngine(
    make_jax_env({"env": "TicTacToe"}), model,
    LossConfig.from_config(loss_args), optimizer,
    AnakinConfig.from_config({"mode": "on",
                              "num_envs": learn["num_envs"]}),
    seed=learn["seed"])
step = engine.make_fused_step()
params = jax.tree.map(jnp.array, model.params)
opt_state = optimizer.init(params)
carry = engine.init_carry(0)
rates = []
for i in range(learn["steps"]):
    params, opt_state, metrics, carry = step(params, opt_state, carry, ())
    if i + 1 in learn["eval_at"]:
        snap = TPUModel(model.module, jax.tree.map(np.asarray, params))
        random.seed(77 + len(rates))
        score = 0.0
        for g in range(learn["games"]):
            ours, theirs = env.players()[g % 2], env.players()[1 - g % 2]
            outcome = exec_match(env, {ours: Agent(snap),
                                       theirs: RandomAgent()})
            score += (outcome[ours] + 1) / 2
        rates.append(score / learn["games"])
print(json.dumps({"jax_cpu_anakin_rates": rates,
                  "mean": sum(rates) / len(rates)}))
"""


def jax_anakin_curve():
    """The JAX engine's rates for 13d's loop on the CPU, in a subprocess
    (this script imports no JAX): tests/test_learning.py's Anakin test
    without its assertion."""
    proc = subprocess.run(
        [sys.executable, "-c", JAX_ANAKIN_LOOP, json.dumps(LEARN),
         json.dumps(LEARN_ARGS)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=1800)
    print(proc.stdout.strip() or proc.stderr[-3000:], flush=True)
    return proc.returncode


# ---------------------------------------------------------------------
# --grad-error: what sets phase 6's float32 gradient error (ROADMAP C6)
# ---------------------------------------------------------------------

def _rel_errors(grads, ref):
    """Each tensor's max |grad - ref| over its max |ref|."""
    return {n: _max_diff(grads[n], g) / float(g.abs().max())
            for n, g in ref.items()}


def _conv_kernels(torch, fn):
    """CUDA kernels of one ``fn()`` call, from ``torch.profiler``: name
    (the cuDNN kernel names carry the algorithm), count, device us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return sorted(({"name": e.key[:160], "count": e.count,
                    "device_us": e.self_device_time_total}
                   for e in kernels), key=lambda k: -k["device_us"])


def grad_error_study(draws=8):
    """Phase 6's first float32 step (GeeseNet 32x12, 128 x 16 rows, TF32
    off) on ``draws`` batches: each tensor's gradient error against a
    float64 CPU run, on the card with cuDNN's default algorithm choice,
    on the card with ``cudnn.deterministic`` (benchmark off), and on
    the CPU; and the kernels each card run launches."""
    import torch

    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.convert import random_flax_params
    from handyrl_tpu_torch.models.geese_net import GeeseNet
    from handyrl_tpu_torch.staging import DeviceReplay

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    card_line()
    params = random_flax_params(GeeseNet(FILTERS, BLOCKS), seed=SEED)
    model = TorchModel.from_flax(GeeseNet(FILTERS, BLOCKS), params,
                                 device=DEV)
    episodes = pool_episodes(model, {"env": "HungryGeese"}, 128, SEED)
    rings = {}
    for dev in (DEV, "cpu"):
        rings[dev] = DeviceReplay(RING_CFG, len(episodes), 4096 << 20, dev)
        rings[dev].offer(episodes)
        rings[dev].ingest(max_episodes=10 ** 6)
    B = TRAIN_ARGS["batch_size"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the card's float32 runs: cuDNN's own choice, cuDNN restricted to
    # deterministic algorithms, and the gate's pinned set (cuDNN off)
    modes = {"card": contextlib.nullcontext,
             "card_deterministic": lambda: torch.backends.cudnn.flags(
                 enabled=True, deterministic=True, allow_tf32=False),
             "card_pinned": lambda: pinned_f32(torch)}
    runs = {name: _geese_update(torch, params, DEV, "float32")[0]
            for name in modes}
    runs["cpu"] = _geese_update(torch, params, "cpu", "float32")[0]
    runs["f64"] = _geese_update(torch, params, "cpu", "float64")[0]
    compared = (*modes, "cpu")
    step_s = Counter()

    def grads_of(name, batch):
        with modes.get(name, contextlib.nullcontext)():
            t0 = time.perf_counter()
            runs[name].loss_and_grads(batch)
            if name in modes:
                torch.cuda.synchronize()
            step_s[name] += time.perf_counter() - t0
        return _named(runs[name], "grad")

    rng = np.random.default_rng(SEED)
    rows, worst = [], Counter()
    for k in range(draws):
        slots = rng.integers(0, rings[DEV].size, B)
        cands = 1 + np.maximum(0, rings[DEV].ep_len[slots] - 16)
        idx = [torch.from_numpy(np.asarray(a, np.int64)) for a in
               (slots, rng.integers(0, cands), rng.integers(0, 4, B))]
        batch = {dev: rings[dev].gather(*[a.to(dev) for a in idx])
                 for dev in rings}
        grads = {name: grads_of(name, batch[DEV if name in modes
                                            else "cpu"])
                 for name in runs}
        row = {"draw": k}
        for name in compared:
            errs = _rel_errors(grads[name], grads["f64"])
            top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
            row[name] = {"max": top[0][1], "top": top}
            worst[(name, top[0][0])] += 1
        row["card_vs_cpu_max"] = max(_rel_errors(
            grads["card"], grads["cpu"]).values())
        rows.append(row)
        emit("grad_error_draw", row)
    kernels = {}
    for name in modes:
        def one_step(name=name):
            grads_of(name, batch[DEV])
        kernels[name] = _conv_kernels(torch, one_step)
    summary = {
        "draws": draws,
        "worst_tensor_counts": {f"{a}:{b}": c for (a, b), c in
                                worst.most_common()},
        "max_over_draws": {name: max(r[name]["max"] for r in rows)
                           for name in compared},
        "median_over_draws": {name: statistics.median(
            r[name]["max"] for r in rows) for name in compared},
        "gate_fails": {name: sum(
            r[name]["max"] > max(F64_FACTOR * r["cpu"]["max"], GRAD_TOL)
            for r in rows) for name in modes},
        "forward_backward_s_per_draw": {
            name: step_s[name] / draws for name in compared},
        "kernels": kernels,
        "device": torch.cuda.get_device_name(0)}
    with open(os.path.join(OUT_DIR, "grad_error.json"), "w") as f:
        json.dump({"rows": rows, "summary": summary}, f, indent=1)
    emit("grad_error_summary", {k: v for k, v in summary.items()
                                if k != "kernels"})
    for name, ks in kernels.items():
        emit(f"grad_error_kernels_{name}", ks[:25])
    return 0


def jax_curve():
    """The JAX package's curve on the phase-7 config, on the CPU:
    ``main.py --train`` in a subprocess (this script imports no JAX)."""
    import shutil

    cwd = tempfile.mkdtemp(prefix="jax_curve_")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        proc, records, wall = run_training(
            [sys.executable, os.path.join(ROOT, "main.py"), "--train"],
            cwd, train_config(TRAIN_CUTS), timeout=1800)
    finally:
        shutil.rmtree(cwd, ignore_errors=True)
    print(json.dumps({"jax_cpu_curve": epoch_rows(records), "wall_s": wall,
                      "exit": proc.returncode}), flush=True)
    return proc.returncode


# ---------------------------------------------------------------------

# ---------------------------------------------------------------------
# phases 2-4: weights, the forward, served self-play
# ---------------------------------------------------------------------

# ---------------------------------------------------------------------
# phase 14: the network serving tier with its telemetry
# ---------------------------------------------------------------------

SERVE_CLIENTS = 8                  # ServeClient threads of 14a and 14d
SERVE_ROWS = 4                     # one game's geese per request
SERVE_SECONDS = 6.0                # 14a's load
SERVE_PIN_EVERY = 4                # one client in four pins epoch 1
TEL_BLOCKS = ("on", "off", "off", "on")   # 14d, interleaved
TEL_SECONDS = 1.0
DRILL_CLIENTS = 3                  # 14b's pinned load
DRILL = {"mode": "on", "port": 0, "heartbeat_interval": 0.1,
         "heartbeat_timeout": 1.0, "reply_timeout": 5.0,
         "replica_failures": 0, "failure_window": 5.0}
# the router learns a new checkpoint from the replica's next beat: a
# quarter-second cadence lets 14c's pins land inside the short epoch 2
SERVE_CUTS = {"epochs": 3, "metrics_path": "metrics.jsonl",
              "profile_dir": "prof",
              "serving": {"mode": "on", "port": 0},
              "router": {"mode": "on", "port": 0,
                         "heartbeat_interval": 0.25,
                         "heartbeat_timeout": 2.0}}
SERVE_TRAIN_TIMEOUT = 300


def game_batches(n, seed):
    """``n`` requests of one HungryGeese game's four observations."""
    from handyrl_tpu_torch.environment import make_env

    random.seed(seed)
    env = make_env({"env": "HungryGeese"})
    out = []
    while len(out) < n:
        env.reset()
        for _ in range(random.randrange(12)):
            env.step({p: random.randrange(4) for p in env.turns()})
            if env.terminal():
                break
        if not env.terminal():
            out.append(np.stack([env.observation(p)
                                 for p in env.players()]))
    return out


def shm_load_worker(wid, desc, cfg_raw, model, epoch, ctrl_q, out_q, seed):
    """A rollout worker whose every forward goes to the service until
    ``ctrl_q`` says stop: the shm plane's share of phase 14's load."""
    import traceback

    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.generation import RolloutPool
    from handyrl_tpu_torch.pipeline import PipelineClient, PipelineConfig

    client = None
    try:
        random.seed(seed)
        client = PipelineClient(desc, PipelineConfig.from_config(cfg_raw))
        envs = [make_env({"env": "HungryGeese"}) for _ in range(LOCKSTEP)]
        pool = RolloutPool(envs, GEN_ARGS)
        players = envs[0].players()
        served = client.wrap(model, epoch)
        job = {"role": "g", "player": players,
               "model_id": {p: epoch for p in players}}
        while pool.has_free_slot():
            pool.assign(job, {p: served for p in players})
        out_q.put(("ready", wid, None))
        ctrl_q.get(timeout=300)
        episodes = steps = 0
        while True:
            try:
                ctrl_q.get_nowait()
                break
            except queue.Empty:
                pass
            for _verb, episode in pool.step():
                episodes += 1
                pool.assign(job, {p: served for p in players})
            steps += 1
        out_q.put(("done", wid, {
            "episodes": episodes, "pool_steps": steps,
            "fallbacks": client.fallbacks, "local_rows": client.local_rows,
            "served_rows": client.served_rows,
            "torch_cuda_initialized": _cuda_initialized()}))
    except BaseException:
        out_q.put(("error", wid, traceback.format_exc()))
        raise
    finally:
        if client is not None:
            client.close()


def _client_load(port, seconds, batches, pin_every, pin, record):
    """``SERVE_CLIENTS`` ServeClient threads for ``seconds``; client
    ``i`` pins epoch ``pin`` when ``i % pin_every == 0``.  Returns the
    outcome counts and latencies; with ``record`` every ok reply is kept
    as (batch index, asked pin, served epoch, outputs)."""
    from handyrl_tpu_torch.serving import ServeClient, ServeError, ShedError

    lock = threading.Lock()
    res = {"ok": 0, "shed": 0, "error": 0, "lost": 0, "rows": 0,
           "ms": [], "replies": []}

    def run(i):
        client = ServeClient("127.0.0.1", port, timeout=30.0)
        asked = pin if i % pin_every == 0 else None
        k = i
        try:
            deadline = time.perf_counter() + seconds
            while time.perf_counter() < deadline:
                b = k % len(batches)
                k += SERVE_CLIENTS
                t0 = time.perf_counter()
                try:
                    reply = client.infer_batch(batches[b], epoch=asked)
                except ShedError:
                    outcome = "shed"
                except ServeError:
                    outcome = "error"
                except Exception:
                    outcome = "lost"
                else:
                    outcome = "ok"
                ms = 1e3 * (time.perf_counter() - t0)
                with lock:
                    res[outcome] += 1
                    if outcome == "ok":
                        res["rows"] += SERVE_ROWS
                        res["ms"].append(ms)
                        if record:
                            res["replies"].append(
                                (b, asked, reply["epoch"],
                                 reply["outputs"]))
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 120)
    res["wall_s"] = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise TimeoutError("a serving client never finished")
    return res


def _spy_cobatched(svc):
    """Count the unpinned dispatch groups (one forward each, at most
    ``max_batch`` rows) that carry network and shm rows together."""
    from handyrl_tpu_torch.serving.frontend import _NetSeat

    seen = {"groups": 0, "mixed": 0}
    inner = svc._dispatch_group

    def spy(model, epoch, items, waited):
        kinds = {isinstance(item[0], _NetSeat) for item in items}
        seen["groups"] += 1
        seen["mixed"] += kinds == {True, False}
        return inner(model, epoch, items, waited)

    svc._dispatch_group = spy
    return seen


def _stack(torch, model, model2, port=0):
    """A service on the card holding ``model2`` live as epoch 2 and
    resolving a pin on epoch 1 to ``model``, with a frontend."""
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.pipeline import InferenceService, PipelineConfig
    from handyrl_tpu_torch.serving import ServingConfig, ServingFrontend

    scfg = ServingConfig.from_config({"mode": "on", "port": port})
    svc = InferenceService(model2, PipelineConfig.from_config(PIPELINE),
                           epoch=2, device=DEV)
    svc.model_resolver = {1: model, 2: model2}.get
    svc.snapshot_cache = scfg.snapshot_cache
    svc.start()
    fe = ServingFrontend(svc, make_env({"env": "HungryGeese"}), scfg)
    fe.start()
    return svc, fe


def _local_check(torch, batches, replies, models):
    """Each ok reply against the card's local forward of the same rows
    on the same snapshot: the max abs difference per output."""
    local = {}
    worst = {"policy": 0.0, "value": 0.0}
    for b, _asked, epoch, outputs in replies:
        if (b, epoch) not in local:
            local[(b, epoch)] = models[epoch].inference_batch(batches[b])
        ref = local[(b, epoch)]
        for key in worst:
            worst[key] = max(worst[key], float(np.abs(
                np.asarray(outputs[key]) - ref[key]).max()))
    return worst


def serving_load_phase(torch, model, model2, tmp):
    """14a and 14d on one stack: the service and frontend on the card,
    two shm workers, eight network clients."""
    from handyrl_tpu_torch import telemetry
    from handyrl_tpu_torch.connection import _mp
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.pipeline import build_obs_spec

    batches = game_batches(64, seed=SEED + 14)
    svc, fe = _stack(torch, model, model2)
    seen = _spy_cobatched(svc)
    env = make_env({"env": "HungryGeese"})
    spec = build_obs_spec(env, LOCKSTEP * len(env.players()))
    procs, ctrl_qs, out_q = [], [], _mp.Queue()
    blocks = []
    try:
        descs = [svc.attach(spec) for _ in range(WORKERS)]
        for wid, desc in enumerate(descs):
            ctrl_q = _mp.Queue()
            proc = _mp.Process(
                target=shm_load_worker,
                args=(wid, desc, PIPELINE, model2, 2, ctrl_q, out_q,
                      SEED + 40 + wid), daemon=True)
            proc.start()
            procs.append(proc)
            ctrl_qs.append(ctrl_q)
        _wait_for(out_q, "ready", WORKERS, procs, svc, 300, [])
        while svc.warm_pending:
            time.sleep(0.01)
        for ctrl_q in ctrl_qs:
            ctrl_q.put(("start",))
        time.sleep(1.0)  # the workers' first steps ramp up
        telemetry.configure(enabled=True, log_dir=tmp, role="smoke")
        svc.epoch_stats()
        fe.epoch_stats()
        groups0, mixed0 = seen["groups"], seen["mixed"]
        rows0 = svc.rows_served
        load = _client_load(fe.port, SERVE_SECONDS, batches,
                            SERVE_PIN_EVERY, 1, record=True)
        a = {"clients": SERVE_CLIENTS, "rows_per_request": SERVE_ROWS,
             "seconds": SERVE_SECONDS, "pin_every": SERVE_PIN_EVERY,
             "ok": load["ok"], "shed": load["shed"],
             "errors": load["error"], "lost": load["lost"],
             "requests_per_s": load["ok"] / load["wall_s"],
             "net_rows_per_s": load["rows"] / load["wall_s"],
             "all_rows_per_s": (svc.rows_served - rows0) / load["wall_s"],
             "client_ms_p50": _percentile(load["ms"], 0.5),
             "client_ms_p99": _percentile(load["ms"], 0.99),
             "serve": fe.epoch_stats(), "infer": svc.epoch_stats(),
             "dispatch_groups": seen["groups"] - groups0,
             "cobatched_groups": seen["mixed"] - mixed0,
             "pinned_ok": sum(1 for r in load["replies"] if r[1] == 1)}
        a["cobatched_share"] = (a["cobatched_groups"]
                                / max(1, a["dispatch_groups"]))
        a["bad_epochs"] = sum(1 for _b, asked, epoch, _o in
                              load["replies"] if epoch != (asked or 2))
        a["served_vs_local_max_abs_diff"] = _local_check(
            torch, batches, load["replies"], {1: model, 2: model2})
        # 14d: telemetry on and off in interleaved blocks
        for mode in TEL_BLOCKS:
            telemetry.configure(enabled=mode == "on", log_dir=tmp,
                                role="smoke")
            fe.epoch_stats()
            rows0 = svc.rows_served
            load = _client_load(fe.port, TEL_SECONDS, batches,
                                SERVE_PIN_EVERY, 1, record=False)
            serve = fe.epoch_stats()
            blocks.append({
                "telemetry": mode, "ok": load["ok"],
                "net_rows_per_s": load["rows"] / load["wall_s"],
                "all_rows_per_s": (svc.rows_served - rows0)
                / load["wall_s"],
                "serve_p99_ms": serve.get("serve_p99_ms"),
                "client_ms_p99": _percentile(load["ms"], 0.99)})
        telemetry.configure(enabled=False)
        for ctrl_q in ctrl_qs:
            ctrl_q.put(("stop",))
        workers = _wait_for(out_q, "done", WORKERS, procs, svc, 120, [])
        stats, fstats = svc.stats(), fe.stats()
    finally:
        telemetry.configure(enabled=False)
        fe.close()
        svc.close()
        for proc in procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
    a.update(param_loads=stats["param_loads"],
             device_modules=stats["device_modules"],
             net_requests=stats["net_requests"], frontend=fstats,
             workers=workers)
    d = {"blocks": blocks, "seconds_per_block": TEL_SECONDS}
    for mode in ("on", "off"):
        rows = [b for b in blocks if b["telemetry"] == mode]
        d[f"net_rows_per_s_{mode}"] = statistics.mean(
            b["net_rows_per_s"] for b in rows)
        d[f"serve_p99_ms_{mode}"] = statistics.mean(
            b["serve_p99_ms"] or 0.0 for b in rows)
    d["rows_cost_share"] = 1.0 - (d["net_rows_per_s_on"]
                                  / d["net_rows_per_s_off"])
    return a, d


def serving_gates(a):
    f = a["frontend"]
    if f["submitted"] != f["ok"] + f["shed"] + f["errors"]:
        raise AssertionError(f"14a reconciliation broke: {f}")
    if a["lost"] or a["errors"]:
        raise AssertionError(f"14a lost or failed requests: {a}")
    if a["ok"] == 0 or a["pinned_ok"] == 0:
        raise AssertionError("14a served no (pinned) request")
    if a["bad_epochs"]:
        raise AssertionError(f"{a['bad_epochs']} replies carried the "
                             "wrong epoch")
    if max(a["served_vs_local_max_abs_diff"].values()) > SERVED_ATOL:
        raise AssertionError("served replies differ from the local "
                             f"forward: {a['served_vs_local_max_abs_diff']}")
    if a["cobatched_groups"] == 0:
        raise AssertionError("no dispatch carried network and shm rows")
    if a["param_loads"] != 2:
        raise AssertionError(f"param_loads {a['param_loads']} != the 2 "
                             "snapshots served")
    for w in a["workers"].values():
        if w["fallbacks"] or w["local_rows"] or w["torch_cuda_initialized"]:
            raise AssertionError(f"a shm worker answered locally: {w}")


def replica_drill(torch, model, model2):
    """14b: kill 1 of 2 replicas behind a router under pinned load."""
    from handyrl_tpu_torch.serving import (
        ReplicaAnnouncer,
        RouterConfig,
        RouterFrontend,
        ServeClient,
        ServeError,
        ShedError,
    )

    router = RouterFrontend(RouterConfig.from_config(DRILL))
    router.start()
    stacks, anns = [], []
    batches = game_batches(16, seed=SEED + 15)
    outcomes = {"ok": 0, "shed": 0, "error": 0, "lost": 0}
    bad = []
    stop = threading.Event()
    lock = threading.Lock()

    def until(cond, deadline=20.0, msg="condition never held"):
        limit = time.monotonic() + deadline
        while not cond():
            if time.monotonic() > limit:
                raise TimeoutError(msg)
            time.sleep(0.01)

    def load(i):
        client = ServeClient("127.0.0.1", router.port, timeout=30.0)
        k = i
        try:
            while not stop.is_set():
                k += 1
                try:
                    reply = client.infer_batch(batches[k % len(batches)],
                                               epoch=1)
                    with lock:
                        outcomes["ok"] += 1
                        if reply["epoch"] != 1:
                            bad.append(reply["epoch"])
                except ShedError:
                    with lock:
                        outcomes["shed"] += 1
                except ServeError:
                    with lock:
                        outcomes["error"] += 1
                except Exception:
                    with lock:
                        outcomes["lost"] += 1
        finally:
            client.close()

    threads = []
    try:
        for i in range(2):
            svc, fe = _stack(torch, model, model2)
            ann = ReplicaAnnouncer(
                "127.0.0.1", router.port, f"replica-{i}",
                (lambda fe=fe: fe.advert(epochs=[1, 2])),
                interval=router.cfg.heartbeat_interval, retry_interval=0.05)
            ann.start()
            stacks.append((svc, fe))
            anns.append(ann)
        until(lambda: router.registry.pool_size() == 2, msg="no pool")
        threads = [threading.Thread(target=load, args=(i,), daemon=True)
                   for i in range(DRILL_CLIENTS)]
        for t in threads:
            t.start()
        until(lambda: outcomes["ok"] >= 50, msg="load never warmed")
        anns[0].kill()
        stacks[0][1].inject_kill()
        t_kill = time.monotonic()
        until(lambda: router.registry.generation("replica-0") is None,
              msg="the corpse was never evicted")
        evict_s = time.monotonic() - t_kill
        ok_evicted = outcomes["ok"]
        until(lambda: outcomes["ok"] >= ok_evicted + 50,
              msg="the survivor never served")
        ok_before = [fe.stats()["ok"] for _svc, fe in stacks]
        stacks[0][1].respawn()
        anns[0].respawn()
        until(lambda: router.registry.generation("replica-0") == 1,
              msg="no generation bump")
        until(lambda: router.registry.pool_size() == 2,
              msg="the pool never recovered")
        until(lambda: all(fe.stats()["ok"] > ok_before[i] + 10
                          for i, (_svc, fe) in enumerate(stacks)),
              msg="both replicas never served again")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        stats = router.stats()
        for ann in anns:
            ann.close(drain=False)
        router.close()
        for svc, fe in stacks:
            fe.close()
            svc.close()
    budget = (router.cfg.heartbeat_timeout + router.cfg.heartbeat_interval
              + 2 * RouterFrontend.ACCEPT_TIMEOUT)
    return {"outcomes": outcomes, "bad_epochs": len(bad),
            "evict_s": evict_s, "evict_budget_s": budget,
            "router": {k: stats[k] for k in (
                "submitted", "ok", "shed", "errors", "shed_by",
                "reroutes", "pool_sheds", "replica_trips")},
            "evictions": stats["registry"]["evictions"],
            "registrations": stats["registry"]["registrations"],
            "generations": {n: r["generation"] for n, r in
                            stats["registry"]["replicas"].items()}}


def drill_gates(b):
    r = b["router"]
    if b["outcomes"]["lost"] or b["outcomes"]["error"]:
        raise AssertionError(f"14b lost or failed requests: {b}")
    if b["bad_epochs"]:
        raise AssertionError("14b replies carried the wrong epoch")
    if r["submitted"] != r["ok"] + r["shed"] + r["errors"]:
        raise AssertionError(f"14b reconciliation broke: {r}")
    if b["evict_s"] > b["evict_budget_s"]:
        raise AssertionError(f"eviction took {b['evict_s']:.2f} s")
    if b["evictions"] < 1 or b["generations"].get("replica-0") != 1:
        raise AssertionError(f"no eviction and rejoin: {b}")


def _status(port):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                timeout=10) as r:
        return json.loads(r.read())


def serving_train_entry(torch):
    """14c: ``--train`` on the shipped config with the serving tier,
    the status endpoint, telemetry and the profiler window on; a client
    pins epoch e-1 through the router while epoch e trains."""
    import shutil

    cwd = tempfile.mkdtemp(prefix="serve_train_")
    try:
        return _serving_train(torch, cwd)
    finally:
        shutil.rmtree(cwd, ignore_errors=True)


def _serving_train(torch, cwd):
    import yaml

    from handyrl_tpu_torch.connection import find_free_port
    from handyrl_tpu_torch.durability import read_verified
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.convert import from_flax
    from handyrl_tpu_torch.scripts.attribution_report import build_report
    from handyrl_tpu_torch.serving import ServeClient, ServeError, ShedError

    status_port = find_free_port()
    config = train_config(dict(SERVE_CUTS, status_port=status_port))
    with open(os.path.join(cwd, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    env = make_env({"env": "TicTacToe"})
    random.seed(SEED + 16)
    obs = []
    while len(obs) < SERVE_ROWS:
        env.reset()
        for _ in range(random.randrange(6)):
            env.step({p: random.choice(env.legal_actions(p))
                      for p in env.turns()})
            if env.terminal():
                break
        if not env.terminal():
            obs.append(env.observation(env.turns()[0]))
    obs = np.stack(obs)
    log = open(os.path.join(OUT_DIR, "serve_train_stdout.txt"), "w")
    # strict float32 in the learner, as in this process's local check
    child_env = dict(os.environ, PYTHONPATH=ROOT, NVIDIA_TF32_OVERRIDE="0")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "handyrl_tpu_torch", "--train",
         *CLI_DEVICE], cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
        text=True, env=child_env, start_new_session=True)
    pinned, live, statuses, failures, sheds = [], 0, 0, Counter(), 0
    client = port = None
    epoch = passes = 0
    try:
        deadline = time.monotonic() + SERVE_TRAIN_TIMEOUT
        while proc.poll() is None:
            if time.monotonic() > deadline:
                raise TimeoutError("14c --train never finished")
            passes += 1
            if client is None or passes % 5 == 0:
                try:
                    snap = _status(status_port)
                except OSError:
                    time.sleep(0.2)
                    continue
                statuses += 1
                epoch = snap["epoch"]
                if client is None and snap.get("router", {}).get("port"):
                    port = snap["router"]["port"]
                    client = ServeClient("127.0.0.1", port, timeout=30.0)
            if client is None:
                time.sleep(0.1)
                continue
            pin = epoch - 1
            try:
                if pin >= 1 and os.path.exists(
                        os.path.join(cwd, "models", f"{pin}.ckpt")):
                    reply = client.infer_batch(obs, epoch=pin)
                    pinned.append((pin, epoch, reply["epoch"],
                                   reply["outputs"]))
                else:
                    client.infer_batch(obs)
                    live += 1
            except ShedError:
                sheds += 1
            except ServeError as exc:
                # the router learns a new checkpoint at the replica's
                # next beat: a pin may briefly be unadvertised
                failures[exc.reason.split(" ")[0]] += 1
            except Exception as exc:
                # the run ending under a request
                failures[type(exc).__name__] += 1
                client.close()
                client = None
            time.sleep(0.01)
        wall = time.perf_counter() - t0
    finally:
        if client is not None:
            client.close()
        _stop(proc)
        log.close()
    with open(log.name) as f:
        stdout = f.read()
    if proc.returncode != 0:
        raise RuntimeError(f"14c --train exited {proc.returncode}:\n"
                           f"{stdout[-3000:]}")
    records = _records(cwd)
    models, worst = {}, {"policy": 0.0, "value": 0.0}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for pin, _at, served, outputs in pinned:
            if pin not in models:
                m = TorchModel(env.net(), device=DEV)
                m.load_params(from_flax(read_verified(os.path.join(
                    cwd, "models", f"{pin}.ckpt"))["params"], m.module))
                models[pin] = m.inference_batch(obs)
            for key in worst:
                worst[key] = max(worst[key], float(np.abs(
                    np.asarray(outputs[key]) - models[pin][key]).max()))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    # the exported Perfetto trace and the attribution tree
    exp = subprocess.run(
        [sys.executable, "-m", "handyrl_tpu_torch.scripts.export_trace",
         cwd], env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    with open(os.path.join(cwd, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    roles = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M"}
    names = Counter((roles.get(e["pid"], "")[:6], e["name"])
                    for e in events if e.get("ph") in ("X", "i"))
    worker_pids = {e["pid"] for e in events
                   if e.get("name") == "episode.rollout"
                   and roles.get(e["pid"], "").startswith("worker")}
    owners = {}
    for e in events:
        trace = (e.get("args") or {}).get("trace")
        if trace is not None:
            owners.setdefault(trace, set()).add(
                roles.get(e["pid"], "")[:6])
    linked = sum(1 for o in owners.values()
                 if "worker" in o and "learne" in o)
    report = build_report(cwd, top_n=12)
    prof_dir = os.path.join(cwd, "prof")
    prof_files = sorted(os.listdir(prof_dir)) if os.path.isdir(
        prof_dir) else []
    kernels, threads = 0, {}
    if prof_files:
        with open(os.path.join(prof_dir, prof_files[0])) as f:
            pevents = json.load(f)["traceEvents"]
        kernels = sum(1 for e in pevents if e.get("cat") == "kernel")
        ops = {}
        for e in pevents:
            if e.get("cat") == "cpu_op":
                ops.setdefault(str(e.get("tid")), Counter())[e["name"]] += 1
        threads = {tid: {"ops": sum(c.values()),
                         "top": [n for n, _ in c.most_common(3)]}
                   for tid, c in ops.items()}
    return {**_thread_split(cwd), **{
        "cuts": {k: v for k, v in SERVE_CUTS.items()},
        "wall_s": wall, "epochs": epoch_rows(records),
        "records": [{k: r.get(k) for k in (
            "epoch", "serve_requests", "serve_ok", "serve_shed",
            "serve_p50_ms", "serve_p99_ms", "serve_max_ms",
            "router_requests", "router_pool_size",
            "untracked_residual_sec", "epoch_wall_sec",
            "arithmetic_intensity", "roofline_verdict", "mfu",
            "profile_update_sec", "profile_ingest_sec",
            "infer_dispatch_ms_p50", "infer_dispatch_ms_p99")}
            for r in records],
        "status_reads": statuses, "router_port": port,
        "pinned_ok": len(pinned), "live_ok": live,
        "client_failures": dict(failures), "client_sheds": sheds,
        "pinned_epochs": sorted({p for p, *_ in pinned}),
        "pinned_wrong_epoch": sum(1 for p, _a, s, _o in pinned if s != p),
        "pinned_vs_local_max_abs_diff": worst,
        "export_rc": exp.returncode, "trace_events": len(events),
        "span_names": {f"{k[0]}/{k[1]}": v for k, v in names.items()},
        "worker_processes_with_rollouts": len(worker_pids),
        "traces_linking_worker_and_learner": linked,
        "attribution_top_self": report["top_self"],
        "profiler_files": prof_files, "profiler_kernel_events": kernels,
        "profiler_cpu_op_threads": threads,
    }}


def _thread_split(cwd):
    """The learner's host time by thread, from its span log: per thread
    the span names it records and the seconds its spans cover (their
    self time, so nested spans count once), and the trainer thread's
    longest gaps between its sections (time it spent outside them)."""
    from handyrl_tpu_torch.telemetry.attribution import self_time_tree
    from handyrl_tpu_torch.telemetry.export import collect_run

    roles, spans = collect_run(cwd)
    learner = [s for s in spans if s.get("role") == "learner"]
    by_tid = {}
    for s in learner:
        by_tid.setdefault(s["tid"], []).append(s)
    split = []
    for tid, recs in by_tid.items():
        tree = self_time_tree(recs)
        split.append({
            "names": [n for n, _ in Counter(
                r["name"] for r in recs).most_common(3)],
            "spans": len(recs),
            "self_s": round(sum(v["self_sec"] for v in tree.values()), 3)})
    split.sort(key=lambda t: -t["self_s"])
    trainer = sorted((s for s in learner
                      if s["name"].startswith("trainer.")),
                     key=lambda s: s["ts"])
    gaps = sorted((b["ts"] - (a["ts"] + a["dur"]), a["name"], b["name"])
                  for a, b in zip(trainer, trainer[1:]))[-5:]
    t0 = min((s["ts"] for s in learner), default=0.0)
    return {"learner_threads": split,
            "trainer_sections_s": round(sum(s["dur"] for s in trainer), 3),
            "trainer_span_s": round(trainer[-1]["ts"] + trainer[-1]["dur"]
                                    - trainer[0]["ts"], 3) if trainer else 0,
            "trainer_first_s": round(trainer[0]["ts"] - t0, 3)
            if trainer else None,
            "trainer_longest_gaps": [[round(g, 3), a, b]
                                     for g, a, b in reversed(gaps)]}


def serving_train_gates(c):
    recs = c["records"]
    if [r["epoch"] for r in recs] != [0, 1, 2]:
        raise AssertionError(f"14c: 3 epochs did not land: {recs}")
    for r in recs:
        for key in ("serve_requests", "serve_ok", "untracked_residual_sec",
                    "router_requests"):
            if r.get(key) is None:
                raise AssertionError(f"14c: {key} missing in {r}")
        if r.get("arithmetic_intensity") is None:
            raise AssertionError(f"14c: no arithmetic_intensity in {r}")
    if not c["status_reads"]:
        raise AssertionError("14c: the status endpoint never answered")
    if not c["pinned_ok"] or c["pinned_wrong_epoch"]:
        raise AssertionError(f"14c: pinned replies {c['pinned_ok']}, "
                             f"wrong epoch {c['pinned_wrong_epoch']}")
    if max(c["pinned_vs_local_max_abs_diff"].values()) > SERVED_ATOL:
        raise AssertionError("14c: pinned replies differ from the local "
                             "forward of the checkpoint: "
                             f"{c['pinned_vs_local_max_abs_diff']}")
    if c["export_rc"] != 0:
        raise AssertionError("14c: export_trace failed")
    names = c["span_names"]
    for want in ("learne/infer.batch", "learne/serve.request",
                 "learne/route.request", "learne/trainer.update"):
        if not names.get(want):
            raise AssertionError(f"14c: no {want} span in the trace")
    if c["worker_processes_with_rollouts"] < 2:
        raise AssertionError("14c: rollouts from fewer than 2 workers")
    if not c["traces_linking_worker_and_learner"]:
        raise AssertionError("14c: no trace id links worker and learner")
    if not c["profiler_kernel_events"]:
        raise AssertionError("14c: the profiler window holds no CUDA "
                             "kernel events")


def serving_entry(torch, model, model2, smi):
    """Phase 14, one ``phase14 {json}`` line per part (14a-14d)."""
    import shutil

    out = {"card": smi}
    tmp = tempfile.mkdtemp(prefix="serve_spans_")
    prev = torch.backends.cudnn.allow_tf32
    # strict float32 for the served-vs-local gate: cuDNN may pick other
    # TF32 algorithms at other batch sizes, and a request's rows ride
    # batches of any size
    torch.backends.cudnn.allow_tf32 = False
    try:
        out["a"], out["d"] = serving_load_phase(torch, model, model2, tmp)
        emit("phase14", {"a": out["a"]})
        serving_gates(out["a"])
        out["b"] = replica_drill(torch, model, model2)
        emit("phase14", {"b": out["b"]})
        drill_gates(out["b"])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
        shutil.rmtree(tmp, ignore_errors=True)
    out["c"] = serving_train_entry(torch)
    emit("phase14", {"c": out["c"]})
    serving_train_gates(out["c"])
    emit("phase14", {"d": out["d"]})
    return out


def weights_phase(torch, report):
    """2: GeeseNet 32x12 from seeded weights, on the card and the CPU."""
    from handyrl_tpu_torch.models import TorchModel
    from handyrl_tpu_torch.models.convert import random_flax_params
    from handyrl_tpu_torch.models.geese_net import GeeseNet

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
    if next(model.module.parameters()).device.type != torch.device(DEV).type:
        raise AssertionError("the model is not on the card")
    report["phase2"] = {"params": n_params, "filters": FILTERS,
                        "blocks": BLOCKS, "seed": SEED,
                        "setup_s": time.perf_counter() - t0}
    return params, model, model2, cpu_model


def forward_phase(torch, model, cpu_model, report, finish):
    """3: forward parity card vs CPU, bucket times, kernel counts."""
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
    finish(3)
    if not finite or shapes != {"policy": [PARITY_ROWS, 4],
                                "value": [PARITY_ROWS, 1]}:
        raise AssertionError(f"bad forward outputs: {shapes}")
    if max(diff.values()) > PARITY_RTOL * scale:
        raise AssertionError(f"card vs CPU {diff} > {PARITY_RTOL * scale}")
    if max(diff32.values()) > FP32_ATOL:
        raise AssertionError(f"card (TF32 off) vs CPU {diff32} > "
                             f"{FP32_ATOL}")


def served_phase(torch, model, model2, report, finish):
    """4: served self-play with a hot swap; returns the drained
    episodes phase 6 trains on."""
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
    finish(4)
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
    return drained


# ---------------------------------------------------------------------
# phase 15: chaos and guards
# ---------------------------------------------------------------------

# 15a: phase 7's config (TicTacToe 32x3, 6 workers, the pipeline, the
# WAL), 4 epochs of 50 + 50 episodes (phase 8's cut), every shm fault
# armed and a surge at epoch 2 whose upload hold browns out both planes
CHAOS_CUTS = {"epochs": 4, "metrics_path": "metrics.jsonl",
              "minimum_episodes": 50, "update_episodes": 50,
              "chaos": {"seed": 7, "shm_tear_prob": 0.05,
                        "shm_full_prob": 0.05, "shm_truncate_prob": 0.05,
                        "shm_stall_prob": 0.1, "shm_beat_drop_prob": 0.1,
                        "shm_beat_delay_prob": 0.1, "surge_epoch": 2,
                        "surge_hold_uploads": 3.0}}
CHAOS_WORKER = re.compile(
    r"closed worker (\d+): cuda initialized (\w+), pipeline fallbacks "
    r"(\d+), served rows \d+, local rows \d+, episodes shipped (\d+), "
    r"spilled (\d+), held (\d+)(?:, shm chaos torn_injected=(\d+) "
    r"full_injected=(\d+) truncated_injected=(\d+) "
    r"stalls_injected=(\d+))?")
INJECTED = ("torn_injected", "full_injected", "truncated_injected",
            "stalls_injected")
# 15b: 14c's config with the router's beats at 0.5 s (timeout 2 s) and
# the replica killed at epoch 2; epochs of 50 + 50 episodes, and 6 of
# them: the 4 after the kill outlast the respawn backoff (0.5 s) and the
# readmission even where 50 episodes arrive in a fraction of a second.
# Latency shedding is off (slo_ms 0): the drill reads the kill, and a
# breached window would shed the readmitted replica's first requests
SERVE_KILL_CUTS = {"epochs": 6, "metrics_path": "metrics.jsonl",
                   "minimum_episodes": 50, "update_episodes": 50,
                   "serving": {"mode": "on", "port": 0, "slo_ms": 0.0},
                   "router": {"mode": "on", "port": 0,
                              "heartbeat_interval": 0.5,
                              "heartbeat_timeout": 2.0},
                   "chaos": {"serve_kill_epoch": 2}}
KILL_CLIENT_TIMEOUT = 10.0         # each ServeClient call's deadline
# 15c: phase 6's fused replay step, armed and unarmed
GUARD_TIMED = 30                   # timed steps of each
GUARD_BLOCK = 10                   # interleaved blocks of this many
GUARD_WARMUP = 5
GUARD_SYNC_STEPS = 10              # armed steps under sync debug "warn"
GUARD_PARITY_STEPS = 3


def chaos_entry(torch, drained, params, smi):
    """Phase 15, one ``phase15 {json}`` line per part (15a-15c)."""
    import shutil

    out = {"card": smi}
    for tag, fn in (("a", _shm_chaos_train), ("b", _serve_kill_train)):
        cwd = tempfile.mkdtemp(prefix=f"chaos_{tag}_")
        try:
            out[tag] = fn(cwd)
        finally:
            shutil.rmtree(cwd, ignore_errors=True)
        emit("phase15", {tag: out[tag]})
        (shm_chaos_gates if tag == "a" else serve_kill_gates)(out[tag])
    out["c"] = guard_cost(torch, drained, params)
    emit("phase15", {"c": out["c"]})
    guard_cost_gates(out["c"])
    return out


def _shm_chaos_train(cwd):
    """15a: ``--train`` under shm chaos and a surge brownout."""
    train = [sys.executable, "-m", "handyrl_tpu_torch", "--train",
             *CLI_DEVICE]
    proc, records, wall = run_training(train, cwd,
                                       train_config(CHAOS_CUTS))
    _check_run(proc, "chaos_train")
    stdout = proc.stdout
    workers = {}
    for m in CHAOS_WORKER.finditer(stdout):
        counts = [int(v) if v else 0 for v in m.groups()[6:]]
        workers[int(m.group(1))] = {
            "cuda_initialized": m.group(2) == "True",
            "fallbacks": int(m.group(3)), "shipped": int(m.group(4)),
            "spilled": int(m.group(5)), "held": int(m.group(6)),
            **dict(zip(INJECTED, counts))}
    stats = [json.loads(line.split("=", 1)[1]) for line in
             stdout.splitlines()
             if line.startswith("inference service stats =")]
    service = stats[-1] if stats else {}
    injected = {k: sum(w[k] for w in workers.values())
                + service.get("chaos", {}).get(k, 0) for k in INJECTED}
    arrivals = sum(r.get("episodes_shm", 0) + r.get("episodes_spilled", 0)
                   for r in records)
    return {
        "cuts": CHAOS_CUTS, "wall_s": wall,
        "num_workers": train_config(CHAOS_CUTS)["train_args"]["worker"][
            "num_parallel"],
        "epochs": [{k: r.get(k) for k in (
            "epoch", "epoch_steps", "epoch_wall_sec", "episodes_received",
            "episodes_shm", "episodes_spilled", "upload_backlog",
            "shm_ring_full_count", "shm_torn_slots", "host_transfers",
            "infer_batches", "policy_lag_max")} for r in records],
        "guards": guard_rows(records),
        "records": records,
        "workers": workers, "injected": injected,
        "service_chaos": service.get("chaos"),
        "ring_full_count": service.get("shm_ring_full_count"),
        "ring_torn_slots": service.get("shm_torn_slots"),
        "corrupt_slots": service.get("corrupt_slots"),
        "torn_reclaimed": service.get("torn_reclaimed"),
        "arrivals_shm_plus_spilled": arrivals,
        "episodes_received": (records[-1]["episodes_received"]
                              if records else None),
        "surge_lines": sum("surge — holding" in line
                           for line in stdout.splitlines())}


def shm_chaos_gates(a):
    recs = a.pop("records")
    if [r["epoch"] for r in recs] != [0, 1, 2, 3]:
        raise AssertionError(f"15a: 4 epochs did not land: "
                             f"{[r['epoch'] for r in recs]}")
    for key in ("torn_injected", "full_injected", "truncated_injected"):
        if not a["injected"][key]:
            raise AssertionError(f"15a: no {key}: {a['injected']}")
    if not a["ring_full_count"] or not a["ring_torn_slots"]:
        raise AssertionError(
            f"15a: the ring headers counted no refused or skipped slot: "
            f"full {a['ring_full_count']}, torn {a['ring_torn_slots']}")
    if a["arrivals_shm_plus_spilled"] != a["episodes_received"]:
        raise AssertionError(
            f"15a: shm + spilled episodes {a['arrivals_shm_plus_spilled']}"
            f" != received {a['episodes_received']}")
    if not any(r.get("upload_backlog") for r in recs if r["epoch"] >= 2):
        raise AssertionError("15a: no upload_backlog after the surge: "
                             f"{[r.get('upload_backlog') for r in recs]}")
    if len(a["workers"]) != a["num_workers"] or any(
            w["cuda_initialized"] for w in a["workers"].values()):
        raise AssertionError(f"15a: worker reports {a['workers']}")
    guard_gates(recs, "15a")


def _serve_kill_train(cwd):
    """15b: ``--train`` with serving and a router; the replica is killed
    at epoch 2 while a client sends through the router.  The status
    endpoint is polled every 50 ms for the kill, the eviction (the pool
    empty) and the readmission (generation 1 routable again)."""
    import yaml

    from handyrl_tpu_torch.connection import find_free_port
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.serving import ServeClient, ServeError, ShedError

    status_port = find_free_port()
    with open(os.path.join(cwd, "config.yaml"), "w") as f:
        yaml.safe_dump(train_config(dict(SERVE_KILL_CUTS,
                                          status_port=status_port)), f)
    env = make_env({"env": "TicTacToe"})
    env.reset()
    obs = np.stack([env.observation(env.turns()[0])] * SERVE_ROWS)
    proc, log = _popen([sys.executable, "-m", "handyrl_tpu_torch",
                        "--train", *CLI_DEVICE], cwd, "serve_kill")
    calls, stop, final = [], threading.Event(), {}
    port = [None]

    def client_loop():
        client = None
        while not stop.is_set():
            if client is None:
                if port[0] is None:
                    time.sleep(0.05)
                    continue
                try:
                    client = ServeClient("127.0.0.1", port[0],
                                         timeout=KILL_CLIENT_TIMEOUT)
                except OSError:
                    time.sleep(0.1)
                    continue
            t0 = time.monotonic()
            try:
                client.infer_batch(obs)
                kind = "ok"
            except ShedError as exc:
                kind = "shed:" + str(exc).split(": ")[-1]
            except ServeError:
                kind = "error"
            except OSError:
                kind = "connection"
                client.close()
                client = None
            calls.append((t0, time.monotonic() - t0, kind))
            time.sleep(0.01)
        if client is not None:
            # the router's own counts once the load has stopped
            for _ in range(3):
                time.sleep(0.2)
                final.update(client.stats())
            client.close()

    thread = threading.Thread(target=client_loop, daemon=True)
    thread.start()
    t0 = time.monotonic()
    timeline = {}
    try:
        deadline = t0 + SERVE_TRAIN_TIMEOUT
        while proc.poll() is None:
            if time.monotonic() > deadline:
                raise TimeoutError("15b --train never finished")
            try:
                snap = _status(status_port)
            except (OSError, ValueError):
                time.sleep(0.05)
                continue
            now = time.monotonic() - t0
            router = snap.get("router") or {}
            port[0] = port[0] or router.get("port")
            ann = (snap.get("serving") or {}).get("announcer") or {}
            pool = (router.get("registry") or {}).get("pool_size")
            if "kill" not in timeline and ann and not ann.get("alive"):
                timeline["kill"] = now
            if "kill" in timeline and "evicted" not in timeline and \
                    pool == 0:
                timeline["evicted"] = now
            if "evicted" in timeline and "readmitted" not in timeline \
                    and pool and ann.get("generation") == 1:
                timeline["readmitted"] = now
                timeline["generation"] = ann.get("generation")
            if "readmitted" in timeline and not stop.is_set() and sum(
                    1 for t, _d, kind in list(calls) if kind == "ok"
                    and t - t0 > timeline["readmitted"]) >= 5:
                # served again: stop the load and read the router's
                # counts at rest
                stop.set()
                thread.join(timeout=KILL_CLIENT_TIMEOUT + 5)
            time.sleep(0.05)
        code = proc.wait()
    finally:
        stop.set()
        thread.join(timeout=KILL_CLIENT_TIMEOUT + 5)
        _stop(proc)
    stdout = _read(log)
    if code != 0:
        raise RuntimeError(f"15b --train exited {code}:\n{stdout[-3000:]}")
    records = _records(cwd)
    kill = stdout.find("CHAOS: killing the serving replica at epoch 2")
    marks = {"kill": kill,
             "evicted": min([i for i in (
                 stdout.find("marked suspect", kill),
                 stdout.find("evicted", kill)) if i >= 0] or [-1]),
             "respawned": stdout.find("serving frontend respawned", kill),
             "registered_gen1": stdout.find("registered (generation 1",
                                            kill)}
    kinds = Counter(kind for _, _, kind in calls)
    runs = []  # the calls' outcomes in order, run-length encoded
    for t, _d, kind in calls:
        if runs and runs[-1][1] == kind:
            runs[-1][2] += 1
        else:
            runs.append([round(t - t0, 3), kind, 1])
    after_readmit = sum(1 for t, _, kind in calls
                        if kind == "ok" and "readmitted" in timeline
                        and t - t0 > timeline["readmitted"])
    return {
        "cuts": SERVE_KILL_CUTS, "epochs": [r["epoch"] for r in records],
        "records": [{k: r.get(k) for k in (
            "epoch", "serve_requests", "serve_ok", "serve_respawns",
            "router_requests", "router_ok", "router_shed",
            "router_pool_size", "pool_sheds", "reroutes")}
            for r in records],
        "timeline_s": timeline,
        "eviction_delay_s": (timeline["evicted"] - timeline["kill"]
                             if "evicted" in timeline else None),
        "readmission_s": (timeline["readmitted"] - timeline["kill"]
                          if "readmitted" in timeline else None),
        "log_order": marks, "calls": dict(kinds), "call_runs": runs,
        "ok_after_readmission": after_readmit,
        "slowest_call_s": max((d for _, d, _ in calls), default=None),
        "router_final": {k: final.get(k) for k in (
            "submitted", "ok", "shed", "errors", "reroutes",
            "pool_sheds")}}


def serve_kill_gates(b):
    if b["epochs"] != list(range(SERVE_KILL_CUTS["epochs"])):
        raise AssertionError(f"15b: training did not complete: {b}")
    order = b["log_order"]
    if not (0 <= order["kill"] < order["evicted"]
            < order["registered_gen1"]) or order["respawned"] < 0:
        raise AssertionError(f"15b: the log does not show kill, eviction, "
                             f"respawn in order: {order}")
    if b["timeline_s"].get("generation") != 1:
        raise AssertionError(f"15b: the announcer's generation did not "
                             f"move 0 -> 1: {b['timeline_s']}")
    final = b["router_final"]
    if final["submitted"] is None or final["submitted"] != (
            final["ok"] + final["shed"] + final["errors"]):
        raise AssertionError(f"15b: router counts do not reconcile: "
                             f"{final}")
    if b["slowest_call_s"] is None or \
            b["slowest_call_s"] > KILL_CLIENT_TIMEOUT + 1.0:
        raise AssertionError(f"15b: a client call hung past its deadline "
                             f"({b['slowest_call_s']} s)")
    if not b["ok_after_readmission"]:
        raise AssertionError("15b: no request served after readmission")


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms and no autotuning, for the
    bitwise armed-vs-unarmed gate."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def guard_cost(torch, episodes, params):
    """15c: phase 6's fused GeeseNet replay step with RetraceGuard,
    NumericsGuard and HostTransferGuard armed against the bare step:
    the same losses bit for bit, the median step in interleaved blocks,
    and the syncs the guard counts beside those
    ``torch.cuda.set_sync_debug_mode("warn")`` reports."""
    import warnings

    from handyrl_tpu_torch.analysis import (
        HostTransferGuard,
        NumericsGuard,
        RetraceGuard,
    )
    from handyrl_tpu_torch.staging import (
        DeviceReplay,
        make_replay_update_step,
    )

    ring = DeviceReplay(RING_CFG, len(episodes), 4096 << 20, DEV)
    ring.offer(episodes)
    ring.ingest(max_episodes=10 ** 6)
    state = ring.device_state()
    batch = TRAIN_ARGS["batch_size"]

    def build(armed):
        step, _ = _geese_update(torch, params, DEV, "bfloat16")
        fused = make_replay_update_step(ring, step, batch, seed=SEED)
        if not armed:
            return fused, None
        retrace = RetraceGuard(max_compiles=1, name="replay_step")
        numerics = NumericsGuard(name="replay_step")
        return retrace.wrap(numerics.wrap(fused)), (retrace, numerics)

    def losses(metrics):
        return torch.stack([torch.stack([m[k].float() for k in LOSS_KEYS])
                            for m in metrics]).cpu()

    out = {"steps": GUARD_TIMED, "block": GUARD_BLOCK}
    # (1) the armed step is the step: losses bit for bit, from the same
    # weights and the same draws (a fresh generator per run)
    runs = {}
    with deterministic(torch):
        for tag in ("unarmed", "armed", "unarmed_again"):
            fused, _ = build(tag == "armed")
            guard = (HostTransferGuard() if tag == "armed"
                     else contextlib.nullcontext())
            with guard:
                metrics = [fused(state) for _ in range(GUARD_PARITY_STEPS)]
            runs[tag] = losses(metrics)
    out["parity"] = {
        "steps": GUARD_PARITY_STEPS,
        "armed_equals_unarmed": bool(torch.equal(runs["armed"],
                                                 runs["unarmed"])),
        "unarmed_repeats_bitwise": bool(torch.equal(
            runs["unarmed_again"], runs["unarmed"])),
        "totals": runs["unarmed"][:, LOSS_KEYS.index("total")].tolist()}

    # (2) the cost: the same step armed and bare, in interleaved blocks
    steps = {"unarmed": build(False), "armed": build(True)}
    transfer = HostTransferGuard()
    for tag, (fused, _) in steps.items():
        with (transfer if tag == "armed" else contextlib.nullcontext()):
            for _ in range(GUARD_WARMUP):
                fused(state)
    torch.cuda.synchronize()
    transfer.snapshot()
    ms = {"unarmed": [], "armed": []}
    for block in range(GUARD_TIMED // GUARD_BLOCK):
        order = ("unarmed", "armed") if block % 2 == 0 \
            else ("armed", "unarmed")
        for tag in order:
            fused = steps[tag][0]
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(GUARD_BLOCK)]
            with (transfer if tag == "armed" else contextlib.nullcontext()):
                for start, stop in events:
                    start.record()
                    fused(state)
                    stop.record()
            torch.cuda.synchronize()
            ms[tag] += [a.elapsed_time(b) for a, b in events]
    timed_transfers = transfer.snapshot()
    retrace, numerics = steps["armed"][1]
    med = {tag: statistics.median(v) for tag, v in ms.items()}
    out["timing"] = {
        "step_ms_median_unarmed": med["unarmed"],
        "step_ms_median_armed": med["armed"],
        "step_ms_p90_unarmed": _percentile(ms["unarmed"], 0.9),
        "step_ms_p90_armed": _percentile(ms["armed"], 0.9),
        "cost_share": med["armed"] / med["unarmed"] - 1.0,
        "host_transfers_per_timed_step": timed_transfers / GUARD_TIMED,
        "retrace_count": retrace.compiles,
        "numerics": numerics.stats()}

    # (3) what the guard sees beside the debug mode, over the same steps,
    # and over one epoch-end metrics copy (the trainer's)
    fused = steps["armed"][0]

    def syncs(caught):
        # the mode's own notice that it is a prototype is no sync
        return sum("synchronizing CUDA operation" in str(w.message)
                   for w in caught)

    with warnings.catch_warnings(record=True) as caught, transfer:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            metrics = [fused(state) for _ in range(GUARD_SYNC_STEPS)]
            step_warnings = syncs(caught)
            step_transfers = transfer.snapshot()
            keys = sorted(metrics[0])
            torch.stack([torch.stack([m[k].float() for k in keys])
                         for m in metrics]).cpu().numpy()
            fetch_warnings = syncs(caught) - step_warnings
            fetch_transfers = transfer.snapshot()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["syncs"] = {
        "steps": GUARD_SYNC_STEPS,
        "guard_host_transfers": step_transfers,
        "sync_debug_warnings": step_warnings,
        "epoch_fetch_guard_host_transfers": fetch_transfers,
        "epoch_fetch_sync_debug_warnings": fetch_warnings,
        "first_warnings": sorted({str(w.message)[:120]
                                  for w in caught})[:5]}
    out["finite"] = all(float(m["nonfinite"]) == 0 for m in metrics)
    return out


def guard_cost_gates(c):
    if not c["parity"]["armed_equals_unarmed"]:
        raise AssertionError(f"15c: the armed step's losses differ from "
                             f"the bare step's: {c['parity']}")
    t = c["timing"]
    if t["retrace_count"] != 1 or t["numerics"]["numerics_contract_breaks"]:
        raise AssertionError(f"15c: the guards tripped on a stable step: "
                             f"{t}")
    if not c["finite"]:
        raise AssertionError("15c: a guarded step was not finite")


# ---------------------------------------------------------------------
# 16. the parallel layer: the sharded step over two ranks on the card,
#     a one-rank NCCL group, a two-rank --train
# ---------------------------------------------------------------------

PARALLEL_STEPS = 2                 # parity steps of 16a and 16b
PARALLEL_TIMED = 5                 # timed bf16 steps after them (16a)
# 16a's runs: (name, mesh, compute dtype); each rank takes half the rows
PARALLEL_RUNS = (("dp", {"dp": 2}, "float32"),
                 ("dp_bf16", {"dp": 2}, "bfloat16"),
                 ("fsdp", {"dp": 2, "fsdp": True}, "float32"))
# two ranks vs one rank on the same rows: tier-1's tolerance (JAX's own
# in tests/test_parallel.py); the shipped lr keeps Adam's ~lr moves of
# near-zero gradients inside it
PARALLEL_RTOL, PARALLEL_ATOL, PARALLEL_TOTAL_REL = 2e-4, 2e-5, 1e-4
CONTROL_WORDS = 20                 # 16b: control words under sync checks
# 16c: phase 7's config over two ranks sharing the card (gloo), cut to 2
# epochs of 50 + 50 episodes and 2 workers per rank
PARALLEL_CUTS = {"epochs": 2, "metrics_path": "metrics.jsonl",
                 "minimum_episodes": 50, "update_episodes": 50,
                 "worker": {"num_parallel": 2}, "mesh": {"dp": 2}}
RANK_TRAIN = """\
import sys
import yaml
from handyrl_tpu_torch.learner import train_main

if __name__ == "__main__":
    with open("config.yaml") as f:
        args = yaml.safe_load(f)
    train_main(args, device="cuda", backend="gloo")
"""
RANK_STEPS = """\
import faulthandler
import sys
import chip_smoke

faulthandler.enable()

chip_smoke.rank_steps(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
"""


def _parallel_batch(episodes, seed=SEED):
    """The shipped batch (128 windows x 16 steps, seat mode) from phase
    4's episodes, drawn as the host batcher draws (host arrays)."""
    from handyrl_tpu_torch.batch import make_batch

    rng = random.Random(seed)
    steps, cmp = TRAIN_ARGS["forward_steps"], 4
    windows = []
    for _ in range(TRAIN_ARGS["batch_size"]):
        ep = episodes[rng.randrange(len(episodes))]
        st = rng.randrange(1 + max(0, ep["steps"] - steps))
        ed = min(st + steps, ep["steps"])
        windows.append({"args": ep["args"], "outcome": ep["outcome"],
                        "moment": ep["moment"][st // cmp:(ed - 1) // cmp + 1],
                        "base": st // cmp * cmp, "start": st, "end": ed,
                        "train_start": st, "total": ep["steps"]})
    return make_batch(windows, dict(TRAIN_ARGS, compress_steps=cmp))


def _device_batch(torch, batch, rows=None, dtype="float32"):
    from handyrl_tpu_torch.learner import stage_batch

    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
    return stage_batch(batch, DEV, dtype)


def _geese_on_card(torch, params):
    from handyrl_tpu_torch.models.convert import from_flax
    from handyrl_tpu_torch.models.geese_net import GeeseNet

    net = GeeseNet(FILTERS, BLOCKS)
    net.load_state_dict(from_flax(params, net))
    return net.to(DEV)


def _parallel_lr():
    from handyrl_tpu_torch.ops.update import DEFAULT_LR

    return DEFAULT_LR * TRAIN_ARGS["batch_size"] * TRAIN_ARGS["forward_steps"]


def _pinned_if_f32(torch, dtype):
    """float32 runs compare on the pinned set; bf16 runs keep cuDNN,
    as training does."""
    return pinned_f32(torch) if dtype == "float32" \
        else contextlib.nullcontext()


def _step_wall_ms(torch, step, batch, steps):
    """Median wall ms of ``steps`` synchronized calls."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def rank_steps(rank, port, run):
    """16a's rank: the sharded GeeseNet step on half the rows, over a
    gloo group of two ranks sharing the card; rank 0 writes the full
    parameters after the parity steps."""
    import pickle

    import torch
    from torch.distributed.tensor import DTensor

    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.parallel import (
        MeshSpec,
        make_mesh,
        make_sharded_update_step,
    )
    from handyrl_tpu_torch.parallel import multihost as mh
    from handyrl_tpu_torch.parallel.update import full_state_dict

    with open(os.path.join(run, "in.pkl"), "rb") as f:
        job = pickle.load(f)
    mh.init_distributed({"coordinator_address": f"127.0.0.1:{port}",
                         "num_processes": 2, "process_id": rank},
                        device=DEV, backend="gloo")
    print(f"rank {rank}: gloo group of 2 on {DEV}", flush=True)
    half = TRAIN_ARGS["batch_size"] // 2
    out = {}
    t0 = time.perf_counter()
    try:
        for name, mesh_cfg, dtype in PARALLEL_RUNS:
            spec = MeshSpec.from_config(mesh_cfg)
            net = _geese_on_card(torch, job["params"])
            step = make_sharded_update_step(
                net, LossConfig.from_config(TRAIN_ARGS),
                make_mesh(spec, device_type=DEV.split(":")[0]), job["lr"],
                dtype, fsdp=spec.fsdp)
            batch = _device_batch(
                torch, job["batch"],
                slice(rank * half, (rank + 1) * half), dtype)
            with _pinned_if_f32(torch, dtype):
                metrics = [{k: float(v) for k, v in step(batch).items()}
                           for _ in range(PARALLEL_STEPS)]
            params = {k: v.detach().cpu().numpy() for k, v in
                      full_state_dict(net).items()}
            rec = {"metrics": metrics, "params": params,
                   "sharded": sorted(
                       n for n, p in net.named_parameters()
                       if isinstance(p, DTensor)),
                   "moments_sharded": sorted(
                       n for n, p in net.named_parameters()
                       if isinstance(step.optimizer.state[p].get(
                           "exp_avg"), DTensor))}
            if dtype == "bfloat16":
                rec["step_ms"] = _step_wall_ms(torch, step, batch,
                                               PARALLEL_TIMED)
            out[name] = rec
            print(f"rank {rank}: {name} done at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        mh.shutdown()
    if rank == 0:
        with open(os.path.join(run, "out.pkl"), "wb") as f:
            pickle.dump(out, f)


def sharded_steps(torch, batch, params, cwd):
    """16a: two gloo ranks on cuda:0, each on half the rows, against
    one rank (the unsharded step) on all of them."""
    import pickle

    from handyrl_tpu_torch.connection import find_free_port
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer

    lr = _parallel_lr()
    with open(os.path.join(cwd, "in.pkl"), "wb") as f:
        pickle.dump({"batch": batch, "params": params, "lr": lr}, f)
    port = str(find_free_port())
    t0 = time.perf_counter()
    procs = [_popen([sys.executable, "-c", RANK_STEPS, str(rank), port, cwd],
                    cwd, f"parallel_rank{rank}") for rank in range(2)]
    try:
        for proc, _ in procs:
            proc.wait(timeout=300)
    finally:
        for proc, _ in procs:
            _stop(proc)
    for rank, (proc, log) in enumerate(procs):
        out = _read(log)
        if proc.returncode != 0:
            raise RuntimeError(f"16a rank {rank} exited {proc.returncode}:\n"
                               + out[-3000:])
    ranks_wall = time.perf_counter() - t0
    with open(os.path.join(cwd, "out.pkl"), "rb") as f:
        ranks = pickle.load(f)

    result = {"lr": lr, "runs": {}, "ranks_wall_s": ranks_wall}
    refs = {}   # one rank on all rows, per dtype (dp and fsdp share it)
    for name, mesh_cfg, dtype in PARALLEL_RUNS:
        got = ranks[name]
        if dtype not in refs:
            net = _geese_on_card(torch, params)
            step = UpdateStep(net, LossConfig.from_config(TRAIN_ARGS),
                              make_optimizer(net.parameters(), lr), dtype)
            full = _device_batch(torch, batch, None, dtype)
            with _pinned_if_f32(torch, dtype):
                metrics = [{k: float(v) for k, v in step(full).items()}
                           for _ in range(PARALLEL_STEPS)]
            refs[dtype] = net, step, full, metrics
        net, step, full, ref = refs[dtype]
        errs = {}
        for n, p in net.state_dict().items():
            want = p.detach().cpu().numpy()
            diff = np.abs(got["params"][n] - want)
            errs[n] = float((diff - PARALLEL_ATOL
                             - PARALLEL_RTOL * np.abs(want)).max())
        rec = {"mesh": mesh_cfg, "dtype": dtype,
               "total": [m["total"] for m in got["metrics"]],
               "total_one_rank": [m["total"] for m in ref],
               "grad_norm": [m["grad_norm"] for m in got["metrics"]],
               "grad_norm_one_rank": [m["grad_norm"] for m in ref],
               "max_param_err_over_tol": max(errs.values()),
               "sharded": got["sharded"],
               "moments_sharded": got["moments_sharded"],
               "finite": all(np.isfinite(m["total"]) for m in got["metrics"])}
        if "step_ms" in got:
            rec["step_ms_two_ranks"] = got["step_ms"]
            rec["step_ms_one_rank"] = _step_wall_ms(torch, step, full,
                                                    PARALLEL_TIMED)
        result["runs"][name] = rec
    return result


def sharded_steps_gates(a):
    runs = a["runs"]
    if not {name for name, _, _ in PARALLEL_RUNS} <= set(runs):
        raise AssertionError(f"16a: runs missing: {sorted(runs)}")
    for name, rec in runs.items():
        if not rec["finite"]:
            raise AssertionError(f"16a {name}: nonfinite loss")
        if rec["dtype"] != "float32":
            continue
        for k, (two, one) in enumerate(zip(rec["total"],
                                           rec["total_one_rank"])):
            if abs(two - one) > PARALLEL_TOTAL_REL * abs(one):
                raise AssertionError(f"16a {name} step {k}: total {two} "
                                     f"vs one rank {one}")
        for k, (two, one) in enumerate(zip(rec["grad_norm"],
                                           rec["grad_norm_one_rank"])):
            # a mean over the ranks instead of a sum would halve it
            if abs(two - one) > PARALLEL_TOTAL_REL * abs(one):
                raise AssertionError(f"16a {name} step {k}: grad_norm "
                                     f"{two} vs one rank {one}")
        if rec["max_param_err_over_tol"] > 0:
            raise AssertionError(
                f"16a {name}: parameters past rtol {PARALLEL_RTOL} / atol "
                f"{PARALLEL_ATOL} by {rec['max_param_err_over_tol']}")
        if name == "fsdp" and not (rec["sharded"] and set(
                rec["sharded"]) == set(rec["moments_sharded"])):
            raise AssertionError(f"16a fsdp: sharded params "
                                 f"{rec['sharded']}, moments "
                                 f"{rec['moments_sharded']}")


def nccl_one_rank(torch, batch, params):
    """16b: the sharded step through a one-rank NCCL group, bitwise
    against the unsharded step; the NCCL kernels one step launches; the
    control word's host syncs."""
    from torch.profiler import ProfilerActivity, profile

    from handyrl_tpu_torch.analysis import HostTransferGuard
    from handyrl_tpu_torch.connection import find_free_port
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.update import UpdateStep, make_optimizer
    from handyrl_tpu_torch.parallel import (
        MeshSpec,
        make_mesh,
        make_sharded_update_step,
    )
    from handyrl_tpu_torch.parallel import multihost as mh

    lr = _parallel_lr()
    marks = [("start", time.perf_counter())]
    full = _device_batch(torch, batch, None, "float32")
    net = _geese_on_card(torch, params)
    plain = UpdateStep(net, LossConfig.from_config(TRAIN_ARGS),
                       make_optimizer(net.parameters(), lr), "float32")
    # cuDNN's deterministic algorithms, not the pinned set: a pinned
    # step launches an im2col per row, ~10^5 kernels, which the
    # profiler takes a minute to reduce
    with deterministic(torch):
        for _ in range(PARALLEL_STEPS):
            plain(full)
        torch.cuda.synchronize()
    marks.append(("unsharded_steps", time.perf_counter()))
    mh.init_distributed({"coordinator_address":
                         f"127.0.0.1:{find_free_port()}",
                         "num_processes": 1, "process_id": 0}, device=DEV)
    marks.append(("nccl_init", time.perf_counter()))
    try:
        backend = torch.distributed.get_backend()
        net1 = _geese_on_card(torch, params)
        step = make_sharded_update_step(
            net1, LossConfig.from_config(TRAIN_ARGS),
            make_mesh(MeshSpec(), device_type=DEV.split(":")[0]), lr, "float32")
        with deterministic(torch):
            step(full)
            torch.cuda.synchronize()
            marks.append(("sharded_step", time.perf_counter()))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(full)
                torch.cuda.synchronize()
        marks.append(("profiled_step", time.perf_counter()))
        events = prof.key_averages()
        marks.append(("key_averages", time.perf_counter()))
        # the collectives ProcessGroupNCCL ran (its "nccl:<op>" ranges),
        # and the NCCL kernels they launched on the card (a one-rank
        # communicator may launch none)
        calls = [e for e in events if e.key.startswith("nccl:")]
        nccl = [e for e in events if "nccl" in e.key.lower()
                and e.device_type.name == "CUDA"]
        unequal = [n for n, p in net1.state_dict().items()
                   if not torch.equal(p, net.state_dict()[n])]
        # the control word: a CPU tensor over the gloo control group
        with HostTransferGuard() as guard:
            torch.cuda.set_sync_debug_mode("error")
            try:
                words = [mh.sync_epoch_code(mh.STEP)
                         for _ in range(CONTROL_WORDS)]
            finally:
                torch.cuda.set_sync_debug_mode("default")
        marks.append(("control_words", time.perf_counter()))
    finally:
        mh.shutdown()
    marks.append(("shutdown", time.perf_counter()))
    return {"backend": backend, "bitwise_equal": not unequal,
            "part_marks_s": {name: round(t - prev, 3) for (name, t), (_, prev)
                             in zip(marks[1:], marks[:-1])},
            "unequal_params": unequal,
            "nccl_calls_per_step": {e.key: e.count for e in calls},
            "nccl_kernel_launches_per_step": sum(e.count for e in nccl),
            "nccl_kernels": sorted({e.key[:80] for e in nccl}),
            "nccl_device_us_per_step": sum(e.self_device_time_total
                                           for e in nccl),
            "control_words": len(words),
            "control_word_host_transfers": guard.transfers}


def nccl_one_rank_gates(b):
    if b["backend"] != "nccl":
        raise AssertionError(f"16b: backend {b['backend']}")
    if not b["bitwise_equal"]:
        raise AssertionError(f"16b: params differ from the unsharded "
                             f"step: {b['unequal_params']}")
    if sum(b["nccl_calls_per_step"].values()) < 2:
        # the gradient and the metric all-reduce, at least
        raise AssertionError(f"16b: NCCL calls per step "
                             f"{b['nccl_calls_per_step']}")
    if b["control_word_host_transfers"] != 0:
        raise AssertionError(f"16b: the control word synced "
                             f"{b['control_word_host_transfers']} times")


def two_rank_train(cwd):
    """16c: phase 7's config as two ranks of one gloo group on the card,
    ``mesh: {dp: 2}``, each rank in its own directory."""
    import yaml

    from handyrl_tpu_torch.connection import find_free_port

    port = find_free_port()
    procs, dirs = [], []
    for rank in range(2):
        rdir = os.path.join(cwd, f"rank{rank}")
        os.makedirs(rdir)
        config = train_config(dict(PARALLEL_CUTS, distributed={
            "coordinator_address": f"127.0.0.1:{port}",
            "num_processes": 2, "process_id": rank}))
        with open(os.path.join(rdir, "config.yaml"), "w") as f:
            yaml.safe_dump(config, f)
        dirs.append(rdir)
        procs.append(_popen([sys.executable, "-c", RANK_TRAIN], rdir,
                            f"parallel_train{rank}"))
    t0 = time.perf_counter()
    try:
        for proc, _ in procs:
            proc.wait(timeout=400)
    finally:
        for proc, _ in procs:
            _stop(proc)
    wall = time.perf_counter() - t0
    outs = [_read(log) for _, log in procs]
    for rank, (proc, _) in enumerate(procs):
        if proc.returncode != 0:
            raise RuntimeError(f"16c rank {rank} exited {proc.returncode}:"
                               f"\n{outs[rank][-3000:]}")
    records = _records(dirs[0])
    return {
        "wall_s": wall,
        # the intake counter's "100 200 ..." may precede a loss line
        "loss_lines": [re.findall(r"loss = .*", out) for out in outs],
        "bring_up": [[line for line in out.splitlines()
                      if line.startswith("distributed: ")] for out in outs],
        "models": [sorted(os.listdir(os.path.join(d, "models")))
                   if os.path.isdir(os.path.join(d, "models")) else []
                   for d in dirs],
        "replica_metrics": os.path.exists(os.path.join(dirs[1],
                                                       "metrics.jsonl")),
        "epochs": epoch_rows(records),
        "guards": [{k: r.get(k) for k in ("retrace_count",
                                          "resharding_copies",
                                          "host_transfers", "epoch_steps")}
                   for r in records]}


def two_rank_train_gates(c):
    lines = c["loss_lines"]
    if not lines[0] or lines[0] != lines[1]:
        raise AssertionError(f"16c: loss lines differ: {lines}")
    for rank, bring in enumerate(c["bring_up"]):
        if not bring or f"process {rank} of 2, gloo on cuda" not in bring[0]:
            raise AssertionError(f"16c rank {rank}: {bring}")
    ckpts = [m for m in c["models"][0] if m.endswith(".ckpt")]
    if not {"1.ckpt", "2.ckpt", "train_state.ckpt"} <= set(ckpts):
        raise AssertionError(f"16c: rank 0 wrote {c['models'][0]}")
    if c["models"][1] or c["replica_metrics"]:
        raise AssertionError(f"16c: rank 1 wrote {c['models'][1]}")
    if len(c["guards"]) != PARALLEL_CUTS["epochs"]:
        raise AssertionError(f"16c: {len(c['guards'])} records")
    for g in c["guards"]:
        if g["retrace_count"] != 1 or g["resharding_copies"] != 0:
            raise AssertionError(f"16c: guard keys {g}")


def parallel_entry(torch, episodes, params, smi):
    import shutil

    batch = _parallel_batch(episodes)
    cwd = tempfile.mkdtemp(prefix="parallel_")
    try:
        t0 = time.perf_counter()
        a = sharded_steps(torch, batch, params, cwd)
        t1 = time.perf_counter()
        b = nccl_one_rank(torch, batch, params)
        t2 = time.perf_counter()
        c = two_rank_train(cwd)
        a["part_s"], b["part_s"] = t1 - t0, t2 - t1
        c["part_s"] = time.perf_counter() - t2
    finally:
        shutil.rmtree(cwd, ignore_errors=True)
    out = {"a": a, "b": b, "c": c, "card": smi}
    emit("phase16a", {k: v for k, v in a.items()})
    emit("phase16b", b)
    emit("phase16c", c)
    sharded_steps_gates(a)
    nccl_one_rank_gates(b)
    two_rank_train_gates(c)
    return out


ALL_PHASES = frozenset(range(1, 17))
# what a phase takes from another: phase 2's weights, phase 4's drained
# episodes; every phase reads phase 1's card line
NEEDS = {3: {2}, 4: {2}, 5: {2}, 6: {2, 4}, 14: {2}, 15: {2, 4},
         16: {2, 4}}


def parse_phases(spec):
    """``"1-5,13"`` -> the phases to run, with every phase they need
    (ValueError on anything else)."""
    chosen = {1}
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        try:
            lo, hi = int(lo), int(hi or lo)
        except ValueError:
            raise ValueError(f"{part!r} is not a phase or a range of "
                             "phases") from None
        if not 1 <= lo <= hi <= max(ALL_PHASES):
            raise ValueError(f"no phases {part!r}: the phases are "
                             f"1-{max(ALL_PHASES)}")
        chosen.update(range(lo, hi + 1))
    while True:
        needed = set().union(*(NEEDS.get(p, set()) for p in chosen))
        if needed <= chosen:
            return frozenset(chosen)
        chosen |= needed


def main(phases=ALL_PHASES):
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1

    os.makedirs(OUT_DIR, exist_ok=True)
    report = {}
    clock = [time.perf_counter()]
    start = clock[0]

    def lap():
        """Seconds since the previous phase ended."""
        now = time.perf_counter()
        elapsed, clock[0] = now - clock[0], now
        return elapsed

    def finish(n):
        """Close phase ``n``: its time, then its line (before its
        gates run, so a failing phase still prints what it read)."""
        report[f"phase{n}"]["phase_s"] = lap()
        emit(f"phase{n}", report[f"phase{n}"])

    # 1. card
    smi = card_line()
    report["phase1"] = {"nvidia_smi": smi,
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda,
                        "device": torch.cuda.get_device_name(0),
                        "device_count": torch.cuda.device_count(),
                        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                        "matmul_allow_tf32":
                            torch.backends.cuda.matmul.allow_tf32}
    finish(1)
    report["phases"] = sorted(phases)

    # 2. weights
    if 2 in phases:
        params, model, model2, cpu_model = weights_phase(torch, report)
        finish(2)
    if 3 in phases:
        forward_phase(torch, model, cpu_model, report, finish)
    if 4 in phases:
        drained = served_phase(torch, model, model2, report, finish)

    # 5. --eval
    if 5 in phases:
        report["phase5"] = eval_entry(params)
        report["phase5"]["phase_s"] = lap()
        emit("phase5", report["phase5"])

    # 6. GeeseNet training steps on the card
    if 6 in phases:
        report["phase6"] = train_steps(torch, drained, params)
        report["phase6"]["phase_s"] = lap()
        emit("phase6", report["phase6"])

    # 7. --train on the shipped config, then a restart
    if 7 in phases:
        report["phase7"] = train_entry()
        report["phase7"]["phase_s"] = lap()
        emit("phase7", report["phase7"])

    # 8. resilience: chaos drills and SIGTERM, and remote workers; 10.
    # --train on Geister, then --eval of its checkpoint.  Three learners
    # whose gates hold no time, run together: phase 8's time covers
    # both phases, phase 10's is its own run's
    jobs = {}
    if 8 in phases:
        jobs.update(resilience_jobs())
    if 10 in phases:
        jobs["geister"] = geister_train_job(smi)
    done = together(jobs)
    if 8 in phases:
        report["phase8"] = p8 = {tag: done[tag][0]
                                 for tag in ("drills", "remote")}
        p8["phase_s"] = lap()
        p8["together_with"] = sorted(phases & {10})
        emit("phase8", p8)
        a, b = p8["drills"], p8["remote"]
        print(f"resilience: gather respawns {a['gather_respawns']}, "
              f"service respawns {a['service_respawns']}, emergency save "
              f"{a['emergency_save_ms']} ms after SIGTERM; WAL replayed "
              f"{a['relaunch']['wal']['replayed']} episodes at "
              f"{a['relaunch']['wal']['ingest_ms_per_episode']:.3f} ms "
              f"each on the card, first step "
              f"{a['relaunch']['first_step_s']} s after the learner "
              f"started; remote: {b['guard_relaunches']} guard relaunch, "
              f"{b['session_reentries']} session re-entry, "
              f"{len(b['workers'])} worker reports, none on CUDA",
              flush=True)

    if 10 in phases:
        report["phase10"] = p10 = done["geister"][0]
        p10["phase_s"] = done["geister"][1]
        p10["together_with"] = sorted(phases & {8})
        if 8 not in phases:
            lap()
        emit("phase10", p10)
        print("Geister --train: " + ", ".join(
            f"epoch {r['epoch']} {r['steps']} steps "
            f"{r['epoch_wall_s']:.1f} s win rate {r['win_rate']}"
            for r in p10["epochs"]), flush=True)

    # 9. GeisterNet training steps on the card at full width
    if 9 in phases:
        report["phase9"] = p9 = geister_steps(torch, smi)
        p9["phase_s"] = lap()
        emit("phase9", p9)

    # 11. GRFNet training steps on the GRF raster
    if 11 in phases:
        report["phase11"] = p11 = grf_steps(torch, smi)
        p11["phase_s"] = lap()
        emit("phase11", p11)
    for n, tag in ((9, "GeisterNet"), (11, "GRFNet")):
        if n not in phases:
            continue
        p = report[f"phase{n}"]
        st, prof = p["steady"], p["profile"]
        print(f"{tag}: {st['step_ms_median']:.2f} ms/step median "
              f"(p90 {st['step_ms_p90']:.2f}), "
              f"{prof['kernel_launches_per_step']:.0f} launches and "
              f"{prof['device_busy_ms_per_step']} kernel ms per step, "
              f"peak {st['max_memory_allocated_bytes'] / 2 ** 30:.2f} GiB "
              f"on {smi}", flush=True)

    # 12. league --train, ONNX export and run, SWA, a network battle
    if 12 in phases:
        report["phase12"] = p12 = league_entry(torch, smi)
        p12["phase_s"] = lap()
        print("league --train: " + ", ".join(
            f"epoch {r['epoch']} {r['epoch_wall_s']:.1f} s "
            f"{r['episodes_per_s'] or 0:.1f} episodes/s {r['steps']} steps "
            f"{r['league_episodes']} league episodes"
            for r in p12["a"]["epochs"]), flush=True)
        print("ONNX: " + ", ".join(
            f"{name} export {n['export_ms']:.0f} ms, {n['file_bytes']} "
            f"bytes, max rel err {max(n['rel_err_per_step']):.2e}, runner "
            f"{n['runner_ms']:.2f} ms vs card {n['card_ms']:.2f} ms per "
            f"inference" for name, n in p12["b"]["nets"].items())
            + f"; network battle {p12['d']['games']} games in "
            f"{p12['d']['wall_s']:.1f} s; phase 12 {p12['phase_s']:.1f} s "
            f"on {smi}", flush=True)

    # 13. the Anakin path: gates, the timed fused step, --train, learning
    if 13 in phases:
        report["phase13"] = p13 = anakin_entry(torch, smi)
        p13["phase_s"] = lap()
        print("Anakin: " + ", ".join(
            f"K={r['opponent_pool']} {r['step_ms_median']:.2f} ms/step "
            f"(p90 {r['step_ms_p90']:.2f}), {r['frames_per_s']:.0f} "
            f"frames/s, host {r['host_share']}"
            for k, r in p13["b"].items() if k.startswith("K"))
            + "; --train " + ", ".join(
            f"epoch {r['epoch']} {r['anakin_frames_per_sec']} frames/s "
            f"mfu {r['mfu']} win rate {r['win_rate']}"
            for r in p13["c"]["epochs"])
            + f"; learning {p13['d']['rates']} mean {p13['d']['mean']:.3f}"
            f"; phase 13 {p13['phase_s']:.1f} s on {smi}", flush=True)
    # 14. the network serving tier with its telemetry
    if 14 in phases:
        report["phase14"] = p14 = serving_entry(torch, model, model2, smi)
        p14["phase_s"] = lap()
        a, b, c, d = p14["a"], p14["b"], p14["c"], p14["d"]
        print(f"serving: {a['requests_per_s']:.0f} requests/s, "
              f"{a['net_rows_per_s']:.0f} network rows/s "
              f"({a['all_rows_per_s']:.0f} with the shm workers), serve "
              f"p50/p99/max {a['serve'].get('serve_p50_ms')}/"
              f"{a['serve'].get('serve_p99_ms')}/"
              f"{a['serve'].get('serve_max_ms')} ms, dispatch p50/p99 "
              f"{a['infer'].get('infer_dispatch_ms_p50', 0):.2f}/"
              f"{a['infer'].get('infer_dispatch_ms_p99', 0):.2f} ms, "
              f"co-batched {a['cobatched_share']:.2f}; drill evicted in "
              f"{b['evict_s']:.2f} s, {b['outcomes']}; --train pinned "
              f"{c['pinned_ok']} replies, top self "
              f"{c['attribution_top_self'][:4]}"
              f"; telemetry on/off {d['net_rows_per_s_on']:.0f}/"
              f"{d['net_rows_per_s_off']:.0f} rows/s, p99 "
              f"{d['serve_p99_ms_on']:.2f}/{d['serve_p99_ms_off']:.2f} ms; "
              f"phase 14 {p14['phase_s']:.1f} s on {smi}", flush=True)
    # 15. chaos and guards: shm faults and the surge brownout under
    # --train, the serving-replica kill, what the guards cost
    if 15 in phases:
        report["phase15"] = p15 = chaos_entry(torch, drained, params, smi)
        p15["phase_s"] = lap()
        a, b, c = p15["a"], p15["b"], p15["c"]
        print("chaos: " + ", ".join(
            f"epoch {r['epoch']} {r['epoch_steps']} steps shm "
            f"{r['episodes_shm']} spilled {r['episodes_spilled']} backlog "
            f"{r['upload_backlog']} host_transfers {r['host_transfers']}"
            for r in a["epochs"])
            + f"; injected {a['injected']}; replica kill: evicted "
            f"{b['eviction_delay_s']} s, readmitted {b['readmission_s']} s "
            f"after the kill, router {b['router_final']}; guards: "
            f"{c['timing']['step_ms_median_armed']:.2f} ms armed vs "
            f"{c['timing']['step_ms_median_unarmed']:.2f} ms bare, "
            f"{c['syncs']['guard_host_transfers']} guard transfers vs "
            f"{c['syncs']['sync_debug_warnings']} sync warnings in "
            f"{c['syncs']['steps']} steps; phase 15 {p15['phase_s']:.1f} s "
            f"on {smi}", flush=True)
    # 16. the parallel layer: the sharded step over two ranks, a
    # one-rank NCCL group, a two-rank --train
    if 16 in phases:
        report["phase16"] = p16 = parallel_entry(torch, drained, params, smi)
        p16["phase_s"] = lap()
        a, b, c = p16["a"]["runs"], p16["b"], p16["c"]
        print("parallel: " + ", ".join(
            f"{name} max err over tol {r['max_param_err_over_tol']:.2e}"
            for name, r in a.items())
            + f"; bf16 step {a['dp_bf16']['step_ms_two_ranks']:.1f} ms on "
            f"two gloo ranks vs {a['dp_bf16']['step_ms_one_rank']:.1f} ms "
            f"on one"
            + f"; NCCL one rank bitwise {b['bitwise_equal']}, "
            f"{b['nccl_kernel_launches_per_step']} NCCL launches per step, "
            f"control word syncs {b['control_word_host_transfers']}; "
            f"two-rank --train " + ", ".join(
                f"epoch {r['epoch']} {r['steps']} steps "
                f"{r['epoch_wall_s']:.1f} s" for r in c["epochs"])
            + f"; phase 16 {p16['phase_s']:.1f} s on {smi}", flush=True)
    # kernels: the JAX package reaches pl.pallas_call nowhere, so the
    # port owes no hand-written kernel
    print("kernels: none — no function of handyrl_tpu reaches "
          "pl.pallas_call (grep -rn pallas handyrl_tpu is empty)")
    report["smoke_s"] = time.perf_counter() - start
    print(f"smoke: {report['smoke_s']:.1f} s from the card's check to the "
          f"report on {smi}", flush=True)
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1, sort_keys=True, default=str)
    print(json.dumps({"kernels": []}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--jax-curve"]:
        sys.exit(jax_curve())
    if sys.argv[1:] == ["--jax-curve", "anakin"]:
        sys.exit(jax_anakin_curve())
    if sys.argv[1:2] == ["--phases"]:
        try:
            if len(sys.argv) != 3:
                raise ValueError("give one list, e.g. --phases 1-5,13")
            chosen = parse_phases(sys.argv[2])
        except ValueError as exc:
            print(f"--phases: {exc}", file=sys.stderr)
            sys.exit(2)
        sys.exit(main(chosen))
    if sys.argv[1:2] == ["--grad-error"]:
        sys.exit(grad_error_study(*map(int, sys.argv[2:3])))
    sys.exit(main())
