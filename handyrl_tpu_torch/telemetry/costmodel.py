"""Runtime MFU accounting for the trainer's step functions.

The runtime half of ``handyrl_tpu.telemetry.costmodel``:

  * **the peak table**, :data:`DEVICE_PEAKS`: bf16 peak TFLOP/s and
    peak memory GB/s per device kind.  The port's row is the H100's,
    keyed by ``torch.cuda.get_device_name()``; the TPU rows are the
    JAX package's data and describe no device the port runs on.
    Unknown kinds (the CPU) resolve to ``(None, None)`` unless the run
    overrides them through ``perf.peak_tflops`` / ``perf.peak_hbm_gbs``
    (:class:`PerfConfig`);
  * **the harvest**: where the JAX package asks XLA's
    ``cost_analysis()`` of each compiled program, :meth:`CostModel.call`
    runs a step function's first call for each label and input shape
    under ``torch.utils.flop_counter.FlopCounterMode`` and records the
    FLOPs that call's matmuls and convolutions did, backward included.
    In the same traced call a :class:`ByteCounter` (a
    ``TorchDispatchMode``) sums the bytes of every aten op's tensor
    inputs and outputs, views excluded.  Eager PyTorch fuses nothing,
    so this is the step's UNFUSED memory traffic, each intermediate
    counted once written and once per read: an upper bound on what the
    card must move, not XLA's post-fusion ``bytes accessed``, and the
    two packages' ``arithmetic_intensity`` values are not comparable;
  * **the epoch reduction**, :meth:`CostModel.epoch_metrics`: (steps
    this epoch, seconds inside the step calls) -> the metrics.jsonl keys
    ``mfu`` / ``achieved_tflops`` / ``arithmetic_intensity`` /
    ``roofline_verdict``, always present, None where unknowable.
"""

# bf16 peak TFLOP/s and peak memory GB/s per device kind (public
# data sheets).  Unknown kinds -> (None, None) -> mfu None.
DEVICE_PEAKS = {
    # NVIDIA H100 SXM5: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
    # the JAX package's TPU rows, kept as data
    "TPU v4": (275.0, 1228.0),
    "TPU v5": (459.0, 2765.0),
    "TPU v5 lite": (197.0, 819.0),
    "TPU v5e": (197.0, 819.0),
    "TPU v6 lite": (918.0, 1640.0),
    "TPU v6e": (918.0, 1640.0),
}


def device_kind(device):
    """``torch.cuda.get_device_name`` for a CUDA device, else ``""``
    (the CPU has no row in the table)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


class PerfConfig:
    """Validated view of the ``perf`` config section (the JAX
    package's keys).

      * ``peak_tflops``: override the device's bf16 peak TFLOP/s (0 =
        look the device kind up in :data:`DEVICE_PEAKS`);
      * ``peak_hbm_gbs``: override the peak memory bandwidth, GB/s;
      * ``cost_analysis``: count each step function's FLOPs on its
        first call per input shape (default on); off = FLOPs unknown
        and the perf keys report None.
    """

    KEYS = ("peak_tflops", "peak_hbm_gbs", "cost_analysis")

    def __init__(self, peak_tflops=0.0, peak_hbm_gbs=0.0,
                 cost_analysis=True):
        self.peak_tflops = float(peak_tflops or 0.0)
        self.peak_hbm_gbs = float(peak_hbm_gbs or 0.0)
        self.cost_analysis = bool(cost_analysis)
        if self.peak_tflops < 0:
            raise ValueError("perf.peak_tflops must be >= 0")
        if self.peak_hbm_gbs < 0:
            raise ValueError("perf.peak_hbm_gbs must be >= 0")

    @classmethod
    def from_config(cls, raw):
        raw = dict(raw or {})
        unknown = set(raw) - set(cls.KEYS)
        if unknown:
            raise ValueError(f"unknown perf keys: {sorted(unknown)}")
        return cls(**raw)


def resolve_peaks(cfg=None, kind=""):
    """(peak_tflops, peak_hbm_gbs) for this run: config overrides win,
    then the :data:`DEVICE_PEAKS` row for ``kind``, else None."""
    table = DEVICE_PEAKS.get(kind, (None, None))
    tflops = gbs = None
    if cfg is not None and cfg.peak_tflops > 0:
        tflops = cfg.peak_tflops
    elif table[0]:
        tflops = table[0]
    if cfg is not None and cfg.peak_hbm_gbs > 0:
        gbs = cfg.peak_hbm_gbs
    elif table[1]:
        gbs = table[1]
    return tflops, gbs


def _sig(value, digits=4):
    """Round to significant digits: a CPU run's MFU lives at 1e-7 and
    must not round to 0.0."""
    return float(f"{value:.{digits}g}")


def _shapes(tree):
    """The shapes of every tensor in nested args (the harvest key)."""
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return (tuple(tree.shape), str(tree.dtype))
    if isinstance(tree, dict):
        return tuple((k, _shapes(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_shapes(v) for v in tree)
    return ()


def _tensor_bytes(tree):
    import torch
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def ByteCounter():
    """A ``TorchDispatchMode`` that sums, over every aten op run inside
    it, the bytes of the op's tensor inputs and outputs (each read once,
    each written once); view ops move nothing and are skipped.  The
    total is the unfused traffic of eager execution."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                self.bytes += _tensor_bytes((args, kwargs)) \
                    + _tensor_bytes(out)
                self.ops += 1
            return out

    return _ByteCounter()


class CostModel:
    """Per-step-function FLOP registry and the per-epoch reduction.
    One per trainer, used on the trainer thread only; ``kind`` is the
    training device's kind string."""

    def __init__(self, cfg=None, kind=""):
        self.cfg = cfg if cfg is not None else PerfConfig()
        self.kind = kind
        self.peaks = resolve_peaks(self.cfg, kind)
        self._programs = {}        # label -> {flops, harvests}
        self._seen = set()         # (label, input shapes) harvested

    def call(self, label, fn, *args):
        """``fn(*args)``; its first call for each ``label`` and input
        shape runs under ``FlopCounterMode`` and records the FLOPs.
        The latest shape's count wins (a grown replay ring re-lays the
        same step at a new geometry).  An exception of ``fn`` itself
        propagates."""
        if not self.cfg.cost_analysis:
            return fn(*args)
        key = (label, _shapes(args))
        if key in self._seen:
            return fn(*args)
        self._seen.add(key)
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter, \
                ByteCounter() as moved:
            out = fn(*args)
        prog = self._programs.setdefault(
            label, {"flops": 0.0, "bytes": 0.0, "harvests": 0})
        prog["flops"] = float(counter.get_total_flops())
        prog["bytes"] = float(moved.bytes)
        prog["harvests"] += 1
        return out

    def program(self, label):
        prog = self._programs.get(label)
        return dict(prog) if prog else None

    def epoch_metrics(self, label, device_sec, steps):
        """The metrics.jsonl perf keys for one epoch of ``steps`` calls
        of step ``label`` over ``device_sec`` seconds inside the step
        calls.  Every key is always present; a quantity this run cannot
        know is None."""
        prog = self.program(label)
        peak_tflops, peak_gbs = self.peaks
        out = {
            "mfu": None,
            "achieved_tflops": None,
            "arithmetic_intensity": None,
            "roofline_verdict": "unknown",
        }
        if not prog or prog["flops"] <= 0:
            return out
        if prog.get("bytes", 0.0) > 0:
            intensity = prog["flops"] / prog["bytes"]
            out["arithmetic_intensity"] = _sig(intensity)
            if peak_tflops and peak_gbs:
                # ridge point in flops/byte: peak TFLOP/s over peak
                # GB/s is (1e12 flops/s) / (1e9 B/s) = 1e3 flops/B
                ridge = peak_tflops / peak_gbs * 1e3
                out["roofline_verdict"] = (
                    "compute-bound" if intensity >= ridge
                    else "memory-bound")
        if steps > 0 and device_sec > 0:
            achieved = prog["flops"] * steps / device_sec / 1e12
            out["achieved_tflops"] = _sig(achieved)
            if peak_tflops:
                out["mfu"] = _sig(achieved / peak_tflops)
        return out

    def stats(self):
        """Cumulative snapshot for the status endpoint's ``perf``
        section (the JAX package's keys)."""
        peak_tflops, peak_gbs = self.peaks
        return {
            "device_kind": self.kind,
            "peak_tflops": peak_tflops,
            "peak_hbm_gbs": peak_gbs,
            "cost_analysis": self.cfg.cost_analysis,
            "programs": {label: dict(prog)
                         for label, prog in self._programs.items()},
        }
