"""Typed configuration with the reference YAML schema.

A copy of ``handyrl_tpu.config``: the same ``config.yaml`` sections
(``env_args``, ``train_args``, ``worker_args``), keys, defaults and
validation, so one file drives either package, plus the derived
quantities the learner reads (``effective_eval_rate``,
``num_gathers``, ``batch_steps``).

``mesh`` (validated by ``parallel.MeshSpec``, with the JAX package's
errors) and ``distributed`` (the JAX package's keys) take effect: a
multi-process learner over ``torch.distributed``, one rank per card
(:mod:`.parallel`).  ``serving`` and ``router`` (the
network serving tier, validated by ``ServingConfig`` / ``RouterConfig``
with the JAX package's cross-checks: serving needs the pipeline, the
router needs serving) and ``status_port`` take effect as in the JAX
package.  ``anakin`` (the fused on-device rollout, validated by
``AnakinConfig``, with the JAX package's cross-check that it needs
``updates_per_epoch > 0``) and ``perf`` (the cost model's peak
overrides, validated by ``PerfConfig``) take effect as in the JAX
package.  The resilience keys take effect as in the JAX package: the
episode WAL (``wal_enabled``, ``wal_flush_interval``,
``wal_segment_mb``, ``wal_keep_episodes``), ``preempt_grace_seconds``,
``heartbeat_interval``/``heartbeat_timeout``, ``max_respawns``,
``respawn_backoff``, ``max_frame_bytes``, ``supervise_learner`` and
every ``chaos`` key (the shm faults and ``serve_kill_epoch``
included); so does ``generation_opponent`` (league-lite: past-self
opponents, validated as in the JAX package), and so do the telemetry
keys (``telemetry``, ``trace_sample_rate``, ``flightrec_spans``,
``profile_dir``).  The runtime guards take effect as in the JAX
package: ``max_update_compiles``, ``host_transfer_guard``,
``numerics_guard`` / ``max_nonfinite_steps``, ``stall_watchdog`` /
``max_stall_seconds``, ``lock_order_guard`` and ``resource_ledger`` /
``max_fd_growth``, and ``sharding_contract_guard`` /
``max_resharding_copies`` (``resharding_copies`` per epoch).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List

import yaml

from .pipeline.config import PipelineConfig

POLICY_TARGETS = ("MC", "TD", "VTRACE", "UPGO", "IMPACT")
VALUE_TARGETS = ("MC", "TD", "VTRACE", "UPGO", "IMPACT")
UPDATE_ALGORITHMS = ("standard", "impact")

@dataclass
class WorkerConfig:
    num_parallel: int = 6
    num_gathers: int = 0          # 0 -> derived: 1 + (num_parallel-1)//16
    base_worker_id: int = 0
    server_address: str = ""

    def __post_init__(self):
        if self.num_gathers <= 0:
            self.num_gathers = 1 + max(0, self.num_parallel - 1) // 16


@dataclass
class EvalConfig:
    opponent: List[str] = field(default_factory=lambda: ["random"])


@dataclass
class TrainConfig:
    turn_based_training: bool = True
    observation: bool = False
    gamma: float = 0.8
    forward_steps: int = 16
    burn_in_steps: int = 0
    compress_steps: int = 4
    entropy_regularization: float = 1e-1
    entropy_regularization_decay: float = 0.1
    update_episodes: int = 200
    batch_size: int = 128
    minimum_episodes: int = 400
    maximum_episodes: int = 100_000
    epochs: int = -1
    num_batchers: int = 2
    eval_rate: float = 0.1
    lambda_: float = 0.7
    policy_target: str = "TD"
    value_target: str = "TD"
    seed: int = 0
    # epoch to resume from (0 = fresh start), or "auto" to resume from
    # the newest valid checkpoint of the manifest
    restart_epoch: Any = 0
    worker: WorkerConfig = field(default_factory=WorkerConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    env: Dict[str, Any] = field(default_factory=dict)
    # concurrent lockstep episodes per actor process (1 = sequential)
    lockstep_episodes: int = 16
    mesh: Dict[str, int] = field(default_factory=dict)
    distributed: Dict[str, Any] = field(default_factory=dict)
    prefetch_batches: int = 2
    transfer_threads: int = 2
    # observation wire format: auto (= bfloat16 when compute_dtype is
    # bfloat16, else float32) | float32 | bfloat16 | uint8
    transfer_dtype: str = "auto"
    # the forward's dtype in the update step; params, loss and Adam
    # state stay float32
    compute_dtype: str = "bfloat16"
    metrics_path: str = ""
    profile_dir: str = ""
    columnar_cache_mb: int = 0
    # cap update steps per epoch; 0 = unlimited
    updates_per_epoch: int = 0
    # replay ring on the training device: auto | on = the ring,
    # off = host batcher processes
    device_replay: str = "auto"
    device_replay_mb: int = 4096
    device_replay_episodes: int = 0
    checkpoint_keep_last: int = 0
    checkpoint_keep_every: int = 0
    checkpoint_checksum: bool = True
    wal_enabled: bool = True
    wal_flush_interval: float = 1.0
    wal_segment_mb: int = 8
    wal_keep_episodes: int = 0
    preempt_grace_seconds: float = 5.0
    supervise_learner: bool = False
    max_update_compiles: int = 0
    host_transfer_guard: bool = True
    sharding_contract_guard: bool = True
    max_resharding_copies: int = 0
    numerics_guard: bool = True
    max_nonfinite_steps: int = 0
    heartbeat_interval: float = 2.0
    heartbeat_timeout: float = 30.0
    max_respawns: int = 5
    respawn_backoff: float = 0.5
    max_frame_bytes: int = 0
    stall_watchdog: bool = True
    max_stall_seconds: float = 60.0
    lock_order_guard: bool = True
    resource_ledger: bool = True
    max_fd_growth: int = 0
    telemetry: bool = True
    trace_sample_rate: float = 1.0
    flightrec_spans: int = 2048
    status_port: int = 0
    chaos: Dict[str, Any] = field(default_factory=dict)
    pipeline: Dict[str, Any] = field(default_factory=dict)
    serving: Dict[str, Any] = field(default_factory=dict)
    router: Dict[str, Any] = field(default_factory=dict)
    anakin: Dict[str, Any] = field(default_factory=dict)
    update_algorithm: str = "standard"
    target_update_interval: int = 0
    target_update_tau: float = 0.0
    rho_clip: float = 1.0
    c_clip: float = 1.0
    surrogate_clip: float = 0.2
    max_policy_lag: int = 0
    # league-lite: {past_epochs: K, prob: p} seats a retained past self
    # as one opponent in a fraction p (default 0.25) of generation
    # jobs; empty = pure self-play
    generation_opponent: Dict[str, Any] = field(default_factory=dict)
    perf: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        # the mesh axes and the distributed keys validate through the
        # code that runs them
        from .parallel.mesh import MeshSpec
        from .parallel.multihost import check_config

        MeshSpec.from_config(self.mesh)
        check_config(self.distributed)
        if self.policy_target not in POLICY_TARGETS:
            raise ValueError(f"unknown policy_target {self.policy_target!r}")
        if self.value_target not in VALUE_TARGETS:
            raise ValueError(f"unknown value_target {self.value_target!r}")
        if self.forward_steps < 1:
            raise ValueError("forward_steps must be >= 1")
        if self.burn_in_steps < 0:
            raise ValueError("burn_in_steps must be >= 0")
        if self.compress_steps < 1:
            raise ValueError("compress_steps must be >= 1")
        if not 0.0 <= self.eval_rate <= 1.0:
            raise ValueError("eval_rate must be in [0, 1]")
        if self.transfer_dtype not in (
                "auto", "float32", "bfloat16", "uint8"):
            raise ValueError(
                f"unknown transfer_dtype {self.transfer_dtype!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown compute_dtype {self.compute_dtype!r}")
        for key in ("columnar_cache_mb", "checkpoint_keep_last",
                    "checkpoint_keep_every", "device_replay_mb",
                    "device_replay_episodes", "updates_per_epoch",
                    "max_update_compiles", "max_resharding_copies",
                    "max_nonfinite_steps", "max_fd_growth",
                    "heartbeat_interval", "max_respawns",
                    "max_frame_bytes", "status_port",
                    "target_update_interval", "max_policy_lag",
                    "wal_flush_interval", "wal_keep_episodes",
                    "preempt_grace_seconds"):
            if getattr(self, key) < 0:
                raise ValueError(f"{key} must be >= 0")
        if self.wal_segment_mb < 1:
            raise ValueError("wal_segment_mb must be >= 1")
        if self.restart_epoch != "auto" and not (
                isinstance(self.restart_epoch, int)
                and not isinstance(self.restart_epoch, bool)
                and self.restart_epoch >= 0):
            raise ValueError(
                "restart_epoch must be an epoch number >= 0 or 'auto'")
        if self.update_algorithm not in UPDATE_ALGORITHMS:
            raise ValueError(
                f"unknown update_algorithm {self.update_algorithm!r}")
        if self.rho_clip <= 0 or self.c_clip <= 0:
            raise ValueError("rho_clip and c_clip must be > 0")
        if not 0.0 < self.surrogate_clip < 1.0:
            raise ValueError("surrogate_clip must be in (0, 1)")
        if not 0.0 <= self.target_update_tau <= 1.0:
            raise ValueError("target_update_tau must be in [0, 1]")
        if (self.update_algorithm == "impact"
                and self.target_update_interval <= 0
                and self.target_update_tau <= 0.0):
            raise ValueError(
                "update_algorithm: impact needs a target refresh — set "
                "target_update_interval > 0 or target_update_tau > 0")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError("trace_sample_rate must be in [0, 1]")
        if self.flightrec_spans < 1:
            raise ValueError("flightrec_spans must be >= 1")
        if self.respawn_backoff <= 0:
            raise ValueError("respawn_backoff must be > 0")
        if self.max_stall_seconds <= 0:
            raise ValueError("max_stall_seconds must be > 0")
        if self.heartbeat_timeout <= self.heartbeat_interval:
            raise ValueError(
                "heartbeat_timeout must exceed heartbeat_interval")
        # chaos keys and ranges validate in the dataclass the injector
        # runs with
        from .resilience.chaos import ChaosConfig

        ChaosConfig.from_config(self.chaos)
        pipeline_cfg = PipelineConfig.from_config(self.pipeline)
        # serving keys validate through the dataclass the network
        # frontend runs with; the service dependency crosses sections
        from .serving.config import RouterConfig, ServingConfig

        serving_cfg = ServingConfig.from_config(self.serving)
        if serving_cfg.enabled and not pipeline_cfg.enabled:
            raise ValueError(
                "serving.mode: on needs the batched inference service "
                "— it feeds the pipeline batching window, so "
                "pipeline.mode must be on (the default)")
        if (RouterConfig.from_config(self.router).enabled
                and not serving_cfg.enabled):
            raise ValueError(
                "router.mode: on needs a serving frontend to front — "
                "serving.mode must be on")
        if self.device_replay not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown device_replay {self.device_replay!r}")
        if self.generation_opponent:
            unknown = set(self.generation_opponent) - {
                "past_epochs", "prob"}
            if unknown:
                raise ValueError(
                    f"unknown generation_opponent keys: "
                    f"{sorted(unknown)}")
            if int(self.generation_opponent.get(
                    "past_epochs", 0)) < 1:
                raise ValueError(
                    "generation_opponent.past_epochs must be >= 1")
            prob = float(self.generation_opponent.get("prob", 0.25))
            if not 0.0 < prob <= 1.0:
                raise ValueError(
                    "generation_opponent.prob must be in (0, 1]")
        # anakin keys validate through the dataclass the engine runs
        # with; the epoch-cadence requirement crosses fields
        from .anakin.config import AnakinConfig
        from .telemetry.costmodel import PerfConfig

        if (AnakinConfig.from_config(self.anakin).enabled
                and self.updates_per_epoch <= 0):
            raise ValueError(
                "anakin mode needs updates_per_epoch > 0 — the fused "
                "loop makes its own data, so the epoch cadence is the "
                "trainer's step count, not episode intake")
        PerfConfig.from_config(self.perf)

    # at least ~update_episodes^0.85 of every update window is evaluation
    @property
    def effective_eval_rate(self) -> float:
        floor = (self.update_episodes ** 0.85) / self.update_episodes
        return max(self.eval_rate, floor)

    @property
    def batch_steps(self) -> int:
        return self.burn_in_steps + self.forward_steps

    # -- mapping-style access (keys mirror the YAML schema) --
    _ALIASES = {"lambda": "lambda_"}

    def __getitem__(self, key: str):
        key = self._ALIASES.get(key, key)
        value = getattr(self, key)
        if isinstance(value, (WorkerConfig, EvalConfig)):
            return dataclasses.asdict(value)
        return value

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
            return True
        except AttributeError:
            return False

    def get(self, key: str, default=None):
        try:
            return self[key]
        except AttributeError:
            return default

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["lambda"] = d.pop("lambda_")
        return d


def _build_train_config(train_args: Dict[str, Any],
                        env_args: Dict[str, Any]) -> TrainConfig:
    args = dict(train_args)
    if "lambda" in args:
        args["lambda_"] = args.pop("lambda")
    worker = WorkerConfig(**args.pop("worker", {}))
    eval_cfg = EvalConfig(**args.pop("eval", {}))
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = set(args) - known
    if unknown:
        raise ValueError(f"unknown train_args keys: {sorted(unknown)}")
    return TrainConfig(worker=worker, eval=eval_cfg, env=dict(env_args),
                       **args)


@dataclass
class Config:
    """Top-level config mirroring the reference's three YAML sections."""

    env_args: Dict[str, Any]
    train_args: TrainConfig
    worker_args: WorkerConfig

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        env_args = dict(raw.get("env_args", {}))
        train = _build_train_config(raw.get("train_args", {}), env_args)
        wraw = dict(raw.get("worker_args", {}))
        wraw.setdefault("num_parallel", 8)
        worker_args = WorkerConfig(**wraw)
        return cls(env_args=env_args, train_args=train,
                   worker_args=worker_args)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))
