"""Typed ``anakin.*`` configuration: a copy of
``handyrl_tpu.anakin.config`` (same keys, defaults and errors)."""

from dataclasses import dataclass


@dataclass
class AnakinConfig:
    # off (default) = the worker path generates episodes; on = require
    # the fused on-device rollout (error if the env has no device twin);
    # auto = use it when the env has one, fall back loudly otherwise
    mode: str = "off"
    # concurrent self-play games on the device's env axis (the fused
    # step's batch dimension)
    num_envs: int = 1024
    # env steps per fused rollout segment; 0 = the env's MAX_STEPS.
    # Segments are episode-aligned: every game must be able to finish
    # inside one segment, so the engine rejects values below MAX_STEPS
    unroll_length: int = 0
    # frozen past-snapshot opponents: num_envs factors as
    # (opponent_pool + 1) groups; group 0 plays pure self-play, group k
    # plays the learner seat against frozen snapshot k (refreshed
    # oldest-out at each epoch boundary).  0 = pure self-play only
    opponent_pool: int = 0

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @classmethod
    def from_config(cls, cfg) -> "AnakinConfig":
        cfg = dict(cfg or {})
        unknown = set(cfg) - {
            "mode", "num_envs", "unroll_length", "opponent_pool"}
        if unknown:
            raise ValueError(
                f"unknown anakin keys: {sorted(unknown)}")
        num_envs = cfg.get("num_envs", 1024)
        self = cls(
            mode=str(cfg.get("mode", "off") or "off"),
            # an explicit 0 must be refused below, not defaulted
            num_envs=int(1024 if num_envs is None else num_envs),
            unroll_length=int(cfg.get("unroll_length", 0) or 0),
            opponent_pool=int(cfg.get("opponent_pool", 0) or 0),
        )
        if self.mode not in ("off", "on", "auto"):
            raise ValueError(f"unknown anakin.mode {self.mode!r}")
        if self.num_envs < 1:
            raise ValueError("anakin.num_envs must be >= 1")
        if self.unroll_length < 0:
            raise ValueError("anakin.unroll_length must be >= 0")
        if self.opponent_pool < 0:
            raise ValueError("anakin.opponent_pool must be >= 0")
        if (self.opponent_pool
                and self.num_envs % (self.opponent_pool + 1) != 0):
            raise ValueError(
                "anakin.num_envs must divide evenly into "
                f"opponent_pool + 1 = {self.opponent_pool + 1} groups "
                "(the opponent axis is a static factor of the env axis)")
        return self
