"""The port's profiling tools against the JAX package's.

  * ``SectionTimers`` reduces the same sections to the same snapshot and
    format as the JAX timers, and records ``trainer.<name>`` spans when
    telemetry is on;
  * ``TraceWindow`` on ``torch.profiler``: one-shot over
    ``[start_step, stop_step)``, CPU activity only on the CPU, a
    Chrome/Perfetto json holding the window's ops, ``close()`` ends an
    active window, an empty directory disables it;
  * the cost model's byte count: the bytes of every aten op's tensor
    inputs and outputs (views move nothing), and the roofline verdict it
    enables against the JAX formula.
"""

import json
import os

import pytest
import torch

from handyrl_tpu.telemetry import costmodel as jcost
from handyrl_tpu.utils.profiling import SectionTimers as JaxTimers
from handyrl_tpu_torch import telemetry
from handyrl_tpu_torch.telemetry.costmodel import (
    ByteCounter,
    CostModel,
    PerfConfig,
)
from handyrl_tpu_torch.utils.profiling import SectionTimers, TraceWindow
from torchfix import one_torch_thread  # noqa: F401  (autouse)


class _Counter:
    """perf_counter stand-in shared by both timers."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.125
        return self.t


def test_section_timers_match_jax(monkeypatch):
    import handyrl_tpu.utils.profiling as jprof
    import handyrl_tpu_torch.utils.profiling as tprof

    snaps = []
    for mod, cls in ((tprof, SectionTimers), (jprof, JaxTimers)):
        monkeypatch.setattr(mod.time, "perf_counter", _Counter())
        timers = cls()
        for name in ("update", "ingest", "update", "batch_wait"):
            with timers.section(name):
                pass
        snap = timers.snapshot(reset=False)
        snaps.append((snap, timers.format(snap)))
        assert timers.snapshot() == snap and timers.snapshot() == {}
    assert snaps[0] == snaps[1]
    assert snaps[0][0]["update"] == {"sec": 0.25, "n": 2}


def test_section_timers_record_trainer_spans():
    telemetry.configure(enabled=True, role="learner")
    try:
        timers = SectionTimers()
        with timers.section("update"):
            pass
        startup = SectionTimers(span_prefix="startup.")
        with startup.section("device"):
            pass
        names = [r["name"] for r in telemetry.ring_snapshot()]
        assert names == ["trainer.update", "startup.device"]
    finally:
        telemetry.configure(enabled=False)


def _step(net):
    x = torch.randn(4, 8)
    net(x).relu().sum().backward()


def test_trace_window_captures_one_window(tmp_path):
    net = torch.nn.Linear(8, 8)
    window = TraceWindow(str(tmp_path), start_step=2, stop_step=4)
    assert window._activities() == [torch.profiler.ProfilerActivity.CPU]
    for step in range(1, 7):
        _step(net)
        window.tick()
        assert window.active == (2 <= step < 4), step
    assert window.done and window.path is not None
    assert os.listdir(tmp_path) == [os.path.basename(window.path)]
    with open(window.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and n.startswith("aten::addmm") for n in names)
    window.tick()
    assert len(os.listdir(tmp_path)) == 1       # one-shot


def test_trace_window_close_and_disabled(tmp_path):
    window = TraceWindow(str(tmp_path / "p"), start_step=1, stop_step=50)
    window.tick()
    assert window.active
    _step(torch.nn.Linear(8, 8))
    window.close()
    assert not window.active and window.done
    assert os.path.exists(window.path)
    off = TraceWindow("")
    for _ in range(30):
        off.tick()
    assert off.done and not off.active and off.path is None
    cuda = TraceWindow(str(tmp_path), device="cuda:0")
    assert torch.profiler.ProfilerActivity.CUDA in cuda._activities()


def test_byte_counter_counts_inputs_and_outputs():
    a, b = torch.ones(10), torch.ones(10)
    with ByteCounter() as moved:
        c = a + b                     # 2 x 40 B read, 40 B written
        c.view(2, 5)                  # a view moves nothing
    assert moved.bytes == 3 * 40 and moved.ops == 1
    with ByteCounter() as moved:
        torch.ones(4, 4, dtype=torch.float64) @ torch.ones(4, 4,
                                                         dtype=torch.float64)
    assert moved.bytes >= 3 * 128


@pytest.mark.parametrize("peaks", [(1.0, 1.0), (100.0, 1.0), (None, None)])
def test_roofline_verdict_follows_the_jax_formula(peaks):
    tflops, gbs = peaks
    raw = {} if tflops is None else {"peak_tflops": tflops,
                                     "peak_hbm_gbs": gbs}
    port = CostModel(PerfConfig.from_config(raw))
    ref = jcost.CostModel(jcost.PerfConfig.from_config(raw), kind="cpu")
    net = torch.nn.Linear(16, 16)

    def step(x):
        net(x).sum().backward()

    port.call("step", step, torch.ones(32, 16))
    prog = port.program("step")
    assert prog["bytes"] > 0 and prog["flops"] > 0
    ref._programs["step"] = {"flops": prog["flops"],
                             "bytes": prog["bytes"], "harvests": 1}
    assert port.epoch_metrics("step", 0.5, 10) == \
        ref.epoch_metrics("step", 0.5, 10)
    out = port.epoch_metrics("step", 0.5, 10)
    assert out["arithmetic_intensity"] == pytest.approx(
        prog["flops"] / prog["bytes"], rel=1e-3)
    assert port.stats()["programs"]["step"] == prog
