"""Fault injection: kill children, corrupt control-plane frames.

A copy of ``handyrl_tpu.resilience.chaos`` without its shm-plane
hooks.  The chaos harness makes failure a configured input:

  * :class:`ChaosMonkey` kills supervised gathers at a configured
    rate/point and fires scheduled surges (burst kills + a respawn
    hold);
  * :class:`LearnerKillSwitch` SIGKILLs the learner itself mid-epoch,
    once per run directory (the durability drill);
  * :class:`ChaosConnection` wraps a connection and drops, delays, or
    truncates whole frames, driving the receiver's ``FrameError`` /
    dead-peer paths.

:class:`ChaosConfig` parses the JAX package's full key set.  The keys
of hooks the port does not have yet — the shm rings and board
(``shm_*``) and the serving-replica kill (``serve_kill_epoch``) — are
refused with "not ported yet" when set, never silently ignored.

All randomness flows through one injectable RNG (``seed`` in the
config), so chaos tests are seedable.
"""

import os
import pickle
import random
import signal
import struct
import time
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Optional


# keys whose hooks the port does not have yet: refused when set
_NOT_PORTED = ("shm_tear_prob", "shm_full_prob", "shm_truncate_prob",
               "shm_stall_prob", "shm_beat_drop_prob",
               "shm_beat_delay_prob", "serve_kill_epoch")


@dataclass
class ChaosConfig:
    """The ``chaos:`` config section (docs/parameters.md).

    Everything defaults off; a run with an empty section is exactly a
    run without one.  Probabilities are per opportunity: per
    supervision tick for ``kill_prob``, per sent frame for the
    ``frame_*`` knobs.
    """

    kill_prob: float = 0.0        # P(kill one running child) per tick
    kill_after: float = 0.0       # seconds after arm before kills start
    max_kills: int = 0            # total kill budget; 0 = unlimited
    frame_drop_prob: float = 0.0      # P(frame silently vanishes)
    frame_truncate_prob: float = 0.0  # P(frame cut mid-payload + close)
    frame_delay_prob: float = 0.0     # P(frame delayed by frame_delay)
    frame_delay: float = 0.05         # seconds per injected delay
    # -- scheduled surge (a preemption wave, not a dice roll): fires
    # ONCE when the learner epoch reaches surge_epoch
    surge_epoch: int = 0          # epoch that triggers the surge; 0 = off
    surge_kills: int = 0          # gathers burst-killed at the surge
    surge_respawn_hold: float = 0.0   # seconds respawns stay held after it
    surge_hold_uploads: float = 0.0   # seconds gathers sit on their upload
    #                                   backlog after seeing the surge epoch
    # -- scheduled LEARNER kill (durability chaos): a hard SIGKILL of
    # the learner process itself mid-epoch — the preemption the
    # manifest/WAL/auto-resume machinery exists to survive.  Fires
    # exactly once per run directory (a marker file under models/
    # guards relaunches, so the supervised resume is not re-killed)
    learner_kill_epoch: int = 0   # learner epoch that arms the kill; 0 = off
    learner_kill_after_episodes: int = 1  # episodes received past the armed
    #                                       epoch before the SIGKILL lands
    # -- scheduled INFERENCE-SERVER kill (pipeline chaos): the batched
    # inference service dies without a parting heartbeat when the
    # learner epoch reaches this — workers must fall back to local CPU
    # inference and the learner must respawn the service.  Fires once
    infer_kill_epoch: int = 0     # learner epoch of the kill; 0 = off
    # -- scheduled SERVING-REPLICA kill (pool-routing chaos): this
    # learner's serving frontend AND its registry announcer die
    # silently when the learner epoch reaches this — the pool router
    # must evict the silent replica within its heartbeat timeout and
    # re-route (pins included) to the survivors; the learner's serving
    # tick then respawns both and the re-registration bumps the
    # replica's registry generation.  Fires once
    serve_kill_epoch: int = 0     # learner epoch of the kill; 0 = off
    # -- shm-plane fault injection (the pipeline's seqlock rings and
    # heartbeat board; ChaosRing/ChaosBoard wrap the endpoints when
    # any of these are armed).  Probabilities are per opportunity:
    # per push for the producer faults, per pop for the consumer
    # stall, per beat for the board faults.  One uniform draw per
    # opportunity picks at most one fault, so each group must sum
    # to <= 1 (same discipline as the frame_* knobs)
    shm_tear_prob: float = 0.0      # P(push reserves the slot, then
    #                                 "dies" mid-RESERVE-THEN-FILL:
    #                                 odd stamp + head bump, no payload)
    shm_full_prob: float = 0.0      # P(push refused as if the ring
    #                                 were full — forced backpressure,
    #                                 counted in the shm header)
    shm_truncate_prob: float = 0.0  # P(push lands a payload cut in
    #                                 half under a full-length header —
    #                                 the consumer must skip, not crash)
    shm_stall_prob: float = 0.0     # P(pop pretends nothing is
    #                                 readable — a stalled consumer)
    shm_beat_drop_prob: float = 0.0   # P(a service heartbeat is withheld)
    shm_beat_delay_prob: float = 0.0  # P(a beat backdated by shm_beat_delay)
    shm_beat_delay: float = 0.5       # seconds each delayed beat backdates
    seed: int = 0                 # seeds the shared chaos RNG

    @classmethod
    def from_config(cls, raw: Optional[Dict[str, Any]]) -> "ChaosConfig":
        raw = dict(raw or {})
        known = {f.name for f in fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown chaos keys: {sorted(unknown)}")
        cfg = cls(**raw)
        unported = [f.name for f in fields(cls)
                    if f.name in _NOT_PORTED and getattr(cfg, f.name)]
        if unported:
            raise ValueError(
                f"chaos keys {unported} set: not ported yet to "
                f"handyrl_tpu_torch (the shm and serving chaos hooks; "
                f"use main.py for the JAX package)")
        for name in ("kill_prob", "frame_drop_prob",
                     "frame_truncate_prob", "frame_delay_prob",
                     "shm_tear_prob", "shm_full_prob",
                     "shm_truncate_prob", "shm_stall_prob",
                     "shm_beat_drop_prob", "shm_beat_delay_prob"):
            p = getattr(cfg, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"chaos.{name} must be in [0, 1]")
        for name in ("kill_after", "frame_delay", "surge_respawn_hold",
                     "surge_hold_uploads", "max_kills", "surge_epoch",
                     "surge_kills", "learner_kill_epoch",
                     "learner_kill_after_episodes",
                     "infer_kill_epoch", "serve_kill_epoch",
                     "shm_beat_delay"):
            if getattr(cfg, name) < 0:
                raise ValueError(f"chaos.{name} must be >= 0")
        for group, names in (
                ("frame", ("frame_drop_prob", "frame_truncate_prob",
                           "frame_delay_prob")),
                ("shm push", ("shm_tear_prob", "shm_full_prob",
                              "shm_truncate_prob")),
                ("shm beat", ("shm_beat_drop_prob",
                              "shm_beat_delay_prob"))):
            total = sum(getattr(cfg, n) for n in names)
            if total > 1.0:
                # one uniform draw picks at most one fault per
                # opportunity, so the configured rates only hold when
                # they sum to <= 1
                raise ValueError(
                    f"chaos {group} probabilities must sum to <= 1 "
                    f"(got {total:g})")
        return cfg

    @property
    def kills_enabled(self) -> bool:
        return self.kill_prob > 0.0

    @property
    def frames_enabled(self) -> bool:
        return (self.frame_drop_prob > 0.0
                or self.frame_truncate_prob > 0.0
                or self.frame_delay_prob > 0.0)

    @property
    def surges_enabled(self) -> bool:
        return self.surge_epoch > 0

    @property
    def learner_kill_enabled(self) -> bool:
        return self.learner_kill_epoch > 0

    @property
    def infer_kill_enabled(self) -> bool:
        return self.infer_kill_epoch > 0


class ChaosMonkey:
    """Kills supervised children on a seeded schedule, and fires
    scheduled SURGES.

    Drive it from the supervision loop: ``maybe_kill(supervisor)`` and
    ``maybe_surge(supervisor)`` once per tick; the learner reports its
    epoch via :meth:`note_epoch`.  Kills route through
    ``Supervisor.kill_slot`` so the victim dies exactly the way a
    preempted host does — and the normal failure -> backoff -> respawn
    path takes over.  A surge is a PREEMPTION WAVE, not a dice roll:
    when the observed epoch reaches ``surge_epoch`` it burst-kills
    ``surge_kills`` gathers ONCE (deterministically the lowest slots)
    and holds every respawn for ``surge_respawn_hold`` seconds, so the
    fleet stays degraded for a window instead of bouncing straight
    back.
    """

    def __init__(self, cfg: ChaosConfig,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.rng = rng if rng is not None else random.Random(cfg.seed)
        self.clock = clock
        self.armed_at = clock()
        self.kills = 0            # dice-roll kills (capped by max_kills)
        self.surge_kill_count = 0  # scheduled-surge kills (uncapped)
        self.epoch = 0
        self.surged = False

    def maybe_kill(self, supervisor, now: Optional[float] = None) -> bool:
        cfg = self.cfg
        if not cfg.kills_enabled:
            return False
        if cfg.max_kills and self.kills >= cfg.max_kills:
            return False
        if now is None:
            now = self.clock()
        if now - self.armed_at < cfg.kill_after:
            return False
        if self.rng.random() >= cfg.kill_prob:
            return False
        targets = supervisor.running_children()
        if not targets:
            return False
        index, _ = targets[self.rng.randrange(len(targets))]
        self.kills += 1
        supervisor.kill_slot(index, reason=f"chaos kill #{self.kills}")
        return True

    def note_epoch(self, epoch: int):
        """Learner-reported epoch: the surge trigger's clock."""
        self.epoch = max(self.epoch, int(epoch))

    def maybe_surge(self, supervisor, now: Optional[float] = None) -> bool:
        """Fire the scheduled surge once the noted epoch reaches it."""
        cfg = self.cfg
        if not cfg.surges_enabled or self.surged:
            return False
        if self.epoch < cfg.surge_epoch:
            return False
        self.surged = True
        if now is None:
            now = self.clock()
        targets = supervisor.running_children()
        # deterministic victims (lowest slots): a surge is a scheduled
        # event the e2e must replay exactly, so no RNG is involved.
        # Counted apart from `kills` — the surge is a scheduled wave,
        # not a dice roll, so it must not consume the max_kills budget
        # reserved for the random kills
        for index, _ in sorted(targets)[:cfg.surge_kills]:
            self.surge_kill_count += 1
            supervisor.kill_slot(
                index, reason=f"chaos surge at epoch {self.epoch}")
        if cfg.surge_respawn_hold > 0:
            supervisor.hold_respawns(cfg.surge_respawn_hold, now=now)
        return True


class LearnerKillSwitch:
    """Schedules a hard SIGKILL of the LEARNER process mid-epoch.

    The durability counterpart of :class:`ChaosMonkey`: where the
    monkey preempts actors, the kill switch preempts the learner host
    itself — no cleanup, no signal handler, exactly an eviction.  The
    learner ticks :meth:`note` from its intake path; the kill lands
    ``learner_kill_after_episodes`` arrivals after the noted epoch
    reaches ``learner_kill_epoch``, which is deterministically
    MID-window (between two checkpoints), the state the WAL exists to
    recover.  A marker file (fsync'd before the kill) makes the switch
    once-per-run-directory, so a supervised relaunch resumes instead
    of being re-killed at the same epoch.  ``kill`` is injectable for
    unit tests."""

    def __init__(self, cfg: ChaosConfig, marker_path: str,
                 kill: Optional[Callable[[], None]] = None):
        self.cfg = cfg
        self.marker_path = marker_path
        self._kill = kill if kill is not None else self._sigkill_self
        self._kill_at: Optional[int] = None
        self.armed = (cfg.learner_kill_enabled
                      and not os.path.exists(marker_path))

    @staticmethod
    def _sigkill_self():  # pragma: no cover - exercised by the e2e
        os.kill(os.getpid(), signal.SIGKILL)

    def note(self, epoch: int, episodes_received: int) -> bool:
        """Intake tick; returns True when the kill fired (test fakes
        only — the real kill never returns)."""
        if not self.armed or epoch < self.cfg.learner_kill_epoch:
            return False
        if self._kill_at is None:
            self._kill_at = (episodes_received
                             + self.cfg.learner_kill_after_episodes)
        if episodes_received < self._kill_at:
            return False
        self.armed = False
        os.makedirs(os.path.dirname(self.marker_path), exist_ok=True)
        with open(self.marker_path, "w") as f:
            f.write(f"epoch {epoch} after {episodes_received} episodes\n")
            f.flush()
            os.fsync(f.fileno())
        print(f"CHAOS: SIGKILL of the learner at epoch {epoch} "
              f"({episodes_received} episodes received) — durability "
              "drill, resume should recover")
        self._kill()
        return True


class ChaosConnection:
    """A connection wrapper that injects frame-level faults on send.

    Wraps anything with the connection duck type; the truncation fault
    needs byte-level access and therefore requires the inner connection
    to be a :class:`~handyrl_tpu_torch.connection.FramedConnection` (it
    writes a header promising the full payload, ships half, and closes
    — exactly what a peer dying mid-send looks like on the wire).
    One uniform draw per frame picks at most one fault, so configured
    probabilities compose additively.
    """

    def __init__(self, inner, cfg: ChaosConfig,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        self.cfg = cfg
        self.rng = rng if rng is not None else random.Random(cfg.seed)
        self.dropped = 0
        self.truncated = 0
        self.delayed = 0

    def fileno(self):
        return self.inner.fileno()

    def close(self):
        self.inner.close()

    def recv(self):
        return self.inner.recv()

    def _send_truncated(self, data: Any):
        from ..connection import FramedConnection

        if not isinstance(self.inner, FramedConnection):
            self.dropped += 1  # pipes have no wire to cut: drop instead
            return
        payload = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
        partial = struct.pack("!I", len(payload)) \
            + payload[:max(1, len(payload) // 2)]
        try:
            self.inner.sock.sendall(partial)
        finally:
            self.inner.close()  # mid-frame death: the receiver must
            #                     see a truncated payload, not a stall

    def send(self, data: Any):
        cfg = self.cfg
        draw = self.rng.random()
        if draw < cfg.frame_drop_prob:
            self.dropped += 1
            return
        draw -= cfg.frame_drop_prob
        if draw < cfg.frame_truncate_prob:
            self.truncated += 1
            self._send_truncated(data)
            return
        draw -= cfg.frame_truncate_prob
        if draw < cfg.frame_delay_prob:
            self.delayed += 1
            time.sleep(cfg.frame_delay)
        self.inner.send(data)
