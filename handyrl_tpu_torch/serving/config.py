"""Typed ``serving.*`` configuration (the network serving-tier knobs).

A copy of ``handyrl_tpu.serving.config``: the same keys, defaults and
validation, so one ``config.yaml`` drives either package.

Validated in one place — the dataclass the serving frontend actually
runs with — and surfaced to ``config.py`` the same way
``PipelineConfig`` is: ``TrainConfig.__post_init__`` calls
:meth:`ServingConfig.from_config` so a bad key or range fails at
config load.  Every field is documented in docs/parameters.md.

Stdlib only: this module is read by config validation.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional

MODES = ("off", "on")

SERVE_PORT = 9995   # next to the worker plane's 9998/9999
ROUTER_PORT = 9994  # the pool endpoint, next to the serving port

ROUTER_POLICIES = ("least_loaded", "hash")


@dataclass
class ServingConfig:
    """Knobs for the network serving tier (``serving:`` section).

    ``mode: on`` opens a framed-protocol TCP frontend on ``port`` that
    feeds remote inference requests into the SAME batching window as
    the colocated shm workers (``pipeline.InferenceService``), with
    per-request latency histograms, QPS, SLO-bound admission control
    (shed requests get a typed reply, counted, never silently
    dropped), and multi-model routing for epoch-pinned requests.
    Default off: a public port must be an explicit decision.  Requires
    the pipeline's inference service (``pipeline.mode: on``, the
    default) on a local, primary learner.
    """

    # off | on — whether the learner opens the network frontend
    mode: str = "off"
    # TCP port for the framed serving protocol; 0 = OS-assigned
    # (ephemeral — the bound port is printed and shown in the status
    # snapshot, for tests and single-host drives)
    port: int = SERVE_PORT
    # p99 latency SLO over the sliding request window, milliseconds;
    # while the window's p99 exceeds this the frontend SHEDS (typed
    # "shed" reply, reason "slo") all but a trickle of requests.
    # 0 = no latency-based shedding
    slo_ms: float = 100.0
    # sliding window of completed-request latencies the SLO breach
    # check runs over (exact samples, not the histogram — admission
    # must not inherit log2 quantization)
    slo_window: int = 256
    # admission cap on concurrently-admitted requests; arrivals past
    # it shed with reason "overload"
    max_inflight: int = 256
    # cap on concurrently-open client connections (each costs one
    # handler thread); connects past it are closed at accept and
    # counted — a connection sweep must not grow unbounded threads
    # next to a training learner
    max_connections: int = 256
    # while the SLO is breached, admit every Nth request (the trickle
    # that lets the window observe recovery) and shed the rest
    breach_admit_every: int = 4
    # seconds a handler waits for its batched reply before answering a
    # typed error (covers a service killed mid-request)
    reply_timeout: float = 5.0
    # LRU capacity for routed past-epoch snapshots (multi-model
    # routing; the live model rides outside this cache)
    snapshot_cache: int = 4
    # "host:port" of a pool router this frontend announces itself to
    # on a heartbeat cadence (see RouterConfig below); "" = announce
    # only to a router hosted by the SAME learner (router.mode: on),
    # or not at all when none is
    router_address: str = ""

    @classmethod
    def from_config(cls, raw: Optional[Dict[str, Any]]) -> "ServingConfig":
        raw = dict(raw or {})
        known = {f for f in cls.__dataclass_fields__}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown serving keys: {sorted(unknown)}")
        cfg = cls(**raw)
        if cfg.mode not in MODES:
            raise ValueError(f"serving.mode must be one of {MODES}")
        if cfg.port < 0:
            raise ValueError("serving.port must be >= 0")
        if cfg.slo_ms < 0:
            raise ValueError("serving.slo_ms must be >= 0")
        if cfg.slo_window < 8:
            raise ValueError("serving.slo_window must be >= 8")
        if cfg.max_inflight < 1:
            raise ValueError("serving.max_inflight must be >= 1")
        if cfg.max_connections < 1:
            raise ValueError("serving.max_connections must be >= 1")
        if cfg.breach_admit_every < 2:
            raise ValueError("serving.breach_admit_every must be >= 2")
        if cfg.reply_timeout <= 0:
            raise ValueError("serving.reply_timeout must be > 0")
        if cfg.snapshot_cache < 1:
            raise ValueError("serving.snapshot_cache must be >= 1")
        if cfg.router_address:
            host, sep, port = cfg.router_address.rpartition(":")
            if not (sep and host and port.isdigit()):
                raise ValueError(
                    "serving.router_address must be 'host:port'")
        return cfg

    @property
    def enabled(self) -> bool:
        return self.mode == "on"


@dataclass
class RouterConfig:
    """Knobs for the replica-pool router (``router:`` section).

    ``mode: on`` makes the primary learner host a
    :class:`~.router.RouterFrontend`: one framed-TCP
    endpoint presenting every registered serving replica as a single
    pool — least-loaded (or consistent-hash on ``seat``) spread for
    live traffic, epoch-pinned requests routed only to replicas
    advertising that snapshot, typed shed escalation when the whole
    pool is unhealthy, and FleetRegistry-style heartbeat expiry so a
    silent replica is evicted, never routed to.  Requires
    ``serving.mode: on`` (the hosting learner always fronts at least
    its own frontend).  See "Pool routing" in docs/serving.md.
    """

    # off | on — whether the primary learner hosts the pool router
    mode: str = "off"
    # TCP port for the router's framed protocol; 0 = OS-assigned
    port: int = ROUTER_PORT
    # seconds between replica heartbeats; the router assigns this
    # cadence in its register ack, so the pool beats at ONE rate
    heartbeat_interval: float = 2.0
    # seconds of replica silence after which the registry sweep evicts
    # it (no longer routed to); must exceed heartbeat_interval
    heartbeat_timeout: float = 6.0
    # spread policy for unpinned traffic: least_loaded (inflight x
    # p99 score) or hash (rendezvous hash on the request's seat)
    policy: str = "least_loaded"
    # forwarding attempts per request over DISTINCT replicas before
    # the router escalates to a typed pool-level shed
    max_attempts: int = 3
    # admission cap on concurrently-forwarded requests; arrivals past
    # it shed with reason "overload" (router-local, like a replica's)
    max_inflight: int = 512
    # cap on concurrently-open connections (clients + replicas)
    max_connections: int = 256
    # seconds one forwarding attempt may take (connect + reply)
    # before the replica is marked failed and the request re-routes
    reply_timeout: float = 5.0
    # per-replica FailureWindow: more than this many transport
    # failures inside failure_window seconds marks the replica
    # suspect — drained from routing until its next heartbeat
    replica_failures: int = 2
    failure_window: float = 10.0

    @classmethod
    def from_config(cls, raw: Optional[Dict[str, Any]]) -> "RouterConfig":
        raw = dict(raw or {})
        known = {f for f in cls.__dataclass_fields__}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown router keys: {sorted(unknown)}")
        cfg = cls(**raw)
        if cfg.mode not in MODES:
            raise ValueError(f"router.mode must be one of {MODES}")
        if cfg.port < 0:
            raise ValueError("router.port must be >= 0")
        if cfg.heartbeat_interval <= 0:
            raise ValueError("router.heartbeat_interval must be > 0")
        if cfg.heartbeat_timeout <= cfg.heartbeat_interval:
            raise ValueError(
                "router.heartbeat_timeout must exceed "
                "router.heartbeat_interval")
        if cfg.policy not in ROUTER_POLICIES:
            raise ValueError(
                f"router.policy must be one of {ROUTER_POLICIES}")
        if cfg.max_attempts < 1:
            raise ValueError("router.max_attempts must be >= 1")
        if cfg.max_inflight < 1:
            raise ValueError("router.max_inflight must be >= 1")
        if cfg.max_connections < 1:
            raise ValueError("router.max_connections must be >= 1")
        if cfg.reply_timeout <= 0:
            raise ValueError("router.reply_timeout must be > 0")
        if cfg.replica_failures < 0:
            raise ValueError("router.replica_failures must be >= 0")
        if cfg.failure_window <= 0:
            raise ValueError("router.failure_window must be > 0")
        return cfg

    @property
    def enabled(self) -> bool:
        return self.mode == "on"
