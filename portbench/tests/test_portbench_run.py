"""A whole run of a cell on the CPU, the look for a card skipped.

The harness runs here at a tiny size (``tiny.py``) with the port on the
CPU.  A sound run in float32 matches the reference far inside every
limit; with the timed path broken underneath (the step returns its
state unchanged; half the batch left out, the mean taken over the
rest; the gather handing over other windows' observations) ``correct``
comes out false.  The last line carries the result's keys, traced or
not, and the command exits with no result where there is no card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench.harness import cell as cell_mod
from portbench.harness import spec
from portbench.tests.tiny import tiny_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run(cell, trace=False, seed=2 ** 31 + 77):
    t0 = time.monotonic()
    return cell_mod.run_cell(cell, seed, 1.0, trace, "cpu",
                             lambda: time.monotonic() - t0)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)      # the trainer writes models/ here


@pytest.mark.parametrize("workload,stream", [("geese_ring_b16k", None),
                                             ("grf_ring_b20k", None),
                                             ("geese_ring_b16k", 1.0)])
def test_sound_float32_run_is_correct(workload, stream):
    result = run(tiny_cell(workload, compute_dtype="float32",
                           stream=stream))
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"
    assert KEYS <= set(result)
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    for c in result["check"].values():
        assert c["value"] <= c["limit"] / 10 or c["limit"] == 0


def test_traced_run_has_the_per_layer_keys():
    result = run(tiny_cell("geese_ring_b16k"), trace=True)
    assert list(result)[-1] == "check"
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: the device readers find nothing and say nothing
    assert set(result["metrics"]) == {"step_host_ms"}


def _unchanged(monkeypatch):
    from handyrl_tpu_torch.ops import update

    def apply_grads(self):
        return self.grad_norm([p.grad for p in self.params
                               if p.grad is not None])

    monkeypatch.setattr(update.UpdateStep, "apply_grads", apply_grads)


def _half_batch(monkeypatch):
    from handyrl_tpu_torch.ops import update
    from handyrl_tpu_torch.utils.tree import tree_map_leaves

    orig = update.compute_loss

    def compute_loss(apply_fn, batch, hidden, cfg, **kw):
        n = batch["action"].shape[0] // 2
        batch = {k: tree_map_leaves(lambda a: a[:n], v)
                 for k, v in batch.items()}
        if hidden is not None:
            hidden = tree_map_leaves(lambda a: a[:n], hidden)
        losses, dcnt = orig(apply_fn, batch, hidden, cfg, **kw)
        return {k: 2 * v for k, v in losses.items()}, 2 * dcnt

    monkeypatch.setattr(update, "compute_loss", compute_loss)


def _rolled_gather(monkeypatch):
    from handyrl_tpu_torch.staging import DeviceReplay

    orig = DeviceReplay.gather

    def gather(self, slots, tstarts, seats):
        batch = orig(self, slots, tstarts, seats)
        batch["observation"] = batch["observation"].roll(1, dims=0)
        return batch

    monkeypatch.setattr(DeviceReplay, "gather", gather)


@pytest.mark.parametrize("workload", ["geese_ring_b16k", "grf_ring_b20k"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _rolled_gather])
def test_broken_step_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = run(tiny_cell(workload))
    assert result["correct"] is False, result["check"]


def test_no_card_no_result():
    """Where CUDA is absent the command exits non-zero and prints no
    result line (skipped where a card is present)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.ROOT, "portbench", "run.py"),
         "--workload", "geese_ring_b16k", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_without_the_port_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the
    command exits non-zero with no result."""
    import shutil

    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "geese_ring_b16k", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """On the card: a short run of the GeeseNet cell is correct and
    reports every end-to-end metric (run with ``python -m pytest
    portbench/tests -m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is "
                    "False")
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.ROOT, "portbench", "run.py"),
         "--workload", "geese_ring_b16k", "--seed", "3", "--seconds",
         "2", "--trace", "0"], capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and set(result["metrics"]) == {
        "train_samples_per_s", "setup_s"}
