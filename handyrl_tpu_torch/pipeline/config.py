"""Typed ``pipeline.*`` configuration (the Sebulba dataflow knobs).

A copy of ``handyrl_tpu.pipeline.config``: the same keys, defaults and
validation, so one ``config.yaml`` drives either package.  Every field
is documented in docs/parameters.md.

Plain Python: read by config validation and by CPU worker processes
before they touch a device.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional

MODES = ("off", "on")
FALLBACKS = ("local", "none")


@dataclass
class PipelineConfig:
    """Knobs for the pipelined rollout dataflow (``pipeline:`` section).

    ``mode: on`` (the DEFAULT since the shm plane earned its chaos
    pedigree — torn-slot, brownout, and spill drills in tier-1)
    replaces per-worker CPU inference with the learner's batched
    inference service and ships finished trajectories over the
    zero-copy shared-memory transport; the framed pickle control plane
    keeps carrying control verbs (jobs, model fetches, heartbeats)
    only.  The auto-fallbacks make the default safe everywhere:
    remote worker machines cannot map the learner's shared memory —
    their handshake is refused and they keep the legacy
    local-inference path automatically — and recurrent nets are never
    wrapped (their hidden state lives on the worker).  ``mode: off``
    restores the legacy per-worker path wholesale.
    """

    # off | on — whether workers attempt the shm handshake and the
    # learner runs the batched inference service.  Default ON: the
    # fast path is the mainline path (ROADMAP item 3)
    mode: str = "on"
    # seconds the service waits for batch-mates after the first
    # pending request before dispatching a (possibly partial) batch:
    # the latency half of the batching-window-vs-latency trade
    batch_window: float = 0.002
    # rows per batched forward (requests past it split across
    # batches); also the bucket ceiling for the pad-to-power-of-two
    # batch shapes
    max_batch: int = 256
    # obs/action ring geometry, per worker: slot count and the minimum
    # segment size in bytes (each attach widens its slots to fit that
    # worker's lockstep rows if the floor is too small)
    ring_slots: int = 8
    slot_bytes: int = 1 << 16
    # trajectory ring geometry, per worker: slot count and segment
    # size in MiB.  An episode larger than one segment falls back to
    # the control-plane upload (counted, never dropped)
    traj_slots: int = 64
    traj_slot_mb: int = 1
    # worker behavior when the service is unreachable (death, stale
    # heartbeat, full ring): "local" answers with the worker's own
    # CPU forward (production default — the fleet degrades to
    # the legacy path instead of stalling); "none" blocks until the
    # service returns (benchmark mode: measures the pure served path)
    fallback: str = "local"
    # seconds of service-heartbeat silence before a worker declares
    # the service dead and falls back; also the reply-wait deadline
    fallback_after: float = 3.0
    # bz2-compress episode moment blocks on the shm trajectory path
    # (the legacy wire format).  Off by default: shm bandwidth is
    # free, so raw pickle blocks skip the bz2 CPU cost on both ends
    compress: bool = False
    # "auto" shards the inference dispatch over the learner's training
    # mesh in the JAX package when that mesh is one process's; the
    # port's meshes always span ranks, so (the JAX rule for multi-host
    # replicas) each rank dispatches unsharded on its own card either
    # way, and the key is validated so one config.yaml serves both
    infer_mesh: str = "auto"

    @classmethod
    def from_config(cls, raw: Optional[Dict[str, Any]]) -> "PipelineConfig":
        raw = dict(raw or {})
        known = {f for f in cls.__dataclass_fields__}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"unknown pipeline keys: {sorted(unknown)}")
        cfg = cls(**raw)
        if cfg.mode not in MODES:
            raise ValueError(f"pipeline.mode must be one of {MODES}")
        if cfg.fallback not in FALLBACKS:
            raise ValueError(
                f"pipeline.fallback must be one of {FALLBACKS}")
        if cfg.infer_mesh not in ("auto", "off"):
            raise ValueError(
                "pipeline.infer_mesh must be 'auto' or 'off'")
        if cfg.batch_window < 0:
            raise ValueError("pipeline.batch_window must be >= 0")
        if cfg.max_batch < 1:
            raise ValueError("pipeline.max_batch must be >= 1")
        for key in ("ring_slots", "slot_bytes", "traj_slots",
                    "traj_slot_mb"):
            if int(getattr(cfg, key)) < 1:
                raise ValueError(f"pipeline.{key} must be >= 1")
        if cfg.fallback_after <= 0:
            raise ValueError("pipeline.fallback_after must be > 0")
        return cfg

    @property
    def enabled(self) -> bool:
        return self.mode == "on"
