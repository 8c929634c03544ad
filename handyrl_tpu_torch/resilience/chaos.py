"""Fault injection: kill children, corrupt frames, fault the shm plane.

A copy of ``handyrl_tpu.resilience.chaos``.  The chaos harness makes
failure a configured input:

  * :class:`ChaosMonkey` kills supervised gathers at a configured
    rate/point and fires scheduled surges (burst kills + a respawn
    hold);
  * :class:`LearnerKillSwitch` SIGKILLs the learner itself mid-epoch,
    once per run directory (the durability drill);
  * :class:`ChaosConnection` wraps a connection and drops, delays, or
    truncates whole frames, driving the receiver's ``FrameError`` /
    dead-peer paths;
  * :class:`ChaosRing` / :class:`ChaosBoard` wrap the shm pipeline
    plane (:mod:`handyrl_tpu_torch.pipeline.shm`): torn slots (a
    producer dying mid-RESERVE-THEN-FILL), forced full-ring
    backpressure, truncated payloads, stalled consumers, and withheld
    or backdated service heartbeats.

:class:`ChaosConfig` parses and validates the JAX package's full key
set, and every key takes effect: the serving-replica kill
(``serve_kill_epoch``) is the learner's, the surge's upload hold
(``surge_hold_uploads``) browns out both the gathers and the workers'
shm shipping.

All randomness flows through injectable RNGs seeded from ``seed`` in
the config, with the JAX package's seeds, so the same seed injects the
same fault sequence in both packages.
"""

import os
import pickle
import random
import signal
import struct
import time
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Optional


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

    @property
    def serve_kill_enabled(self) -> bool:
        return self.serve_kill_epoch > 0

    @property
    def shm_faults_enabled(self) -> bool:
        return (self.shm_tear_prob > 0.0
                or self.shm_full_prob > 0.0
                or self.shm_truncate_prob > 0.0
                or self.shm_stall_prob > 0.0)

    @property
    def shm_beat_faults_enabled(self) -> bool:
        return (self.shm_beat_drop_prob > 0.0
                or self.shm_beat_delay_prob > 0.0)


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


class ChaosRing:
    """A :class:`~handyrl_tpu_torch.pipeline.shm.ShmRing` wrapper
    injecting shm-plane faults from the seeded chaos RNG.

    Producer faults ride ``push`` (each side of a ring only exercises
    its own role's methods, so wrapping both endpoints never doubles a
    fault class):

      * **tear**: a producer dying mid-RESERVE-THEN-FILL.  The odd
        seqlock stamp and the head bump publish the reservation, then
        nothing: no payload, no even stamp, exactly what a SIGKILLed
        writer leaves.  Returns True: a dead producer reports nothing,
        so the item is lost as it would be with a real death;
      * **full**: forced backpressure, refused and counted in the shm
        header like a genuinely full ring;
      * **truncate**: half the payload lands under a complete stamp,
        with the cut length recorded, so every codec's decode fails
        (a truncated pickle raises in ``loads``, a raw request frame in
        ``np.frombuffer``): the consumer must skip the slot, never
        crash and never read garbage silently.

    The consumer fault rides ``pop``: **stall** pretends nothing is
    readable, so the ring backs up and the producer's full-ring path
    engages on its own.  Everything else delegates to the wrapped ring.
    The layout is the JAX package's byte for byte, and so is the order
    of the RNG draws: one per push, one per pop.
    """

    def __init__(self, inner, cfg: ChaosConfig,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        self.cfg = cfg
        self.rng = rng if rng is not None else random.Random(cfg.seed)
        self.torn_injected = 0
        self.full_injected = 0
        self.truncated_injected = 0
        self.stalls_injected = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __len__(self):
        return len(self.inner)

    @staticmethod
    def _parts_bytes(parts):
        if isinstance(parts, (bytes, bytearray, memoryview)):
            return bytes(parts)
        return b"".join(bytes(p) for p in parts)

    def _fits(self, length, shm):
        ring = self.inner
        head = ring._get(shm._HEAD)
        return (length <= ring.slot_bytes
                and head - ring._get(shm._TAIL) < ring.slots)

    def _tear(self, shm):
        """The real push's reservation prefix, then nothing; a consumer
        with evidence the writer is gone reclaims it (``skip_torn``)."""
        ring = self.inner
        head = ring._get(shm._HEAD)
        shm._put(ring._buf, shm._Q, ring._slot_off(head), 2 * head + 1)
        ring._set(shm._HEAD, head + 1)
        self.torn_injected += 1
        return True

    def _truncate(self, payload, shm):
        """A complete-looking slot (even stamp) holding the first half
        of the payload, with the CUT length recorded: a full length
        would hand the raw request codec a stale tail that decodes
        silently into wrong observations."""
        ring = self.inner
        head = ring._get(shm._HEAD)
        off = ring._slot_off(head)
        cut = max(1, len(payload) // 2)
        shm._put(ring._buf, shm._Q, off, 2 * head + 1)
        ring._set(shm._HEAD, head + 1)
        shm._put(ring._buf, shm._Q, off + 8, cut)
        pos = off + shm._SLOT_HDR
        ring._buf[pos:pos + cut] = payload[:cut]
        shm._put(ring._buf, shm._Q, off, 2 * head + 2)
        self.truncated_injected += 1
        return True

    def push(self, parts) -> bool:
        from ..pipeline import shm

        cfg = self.cfg
        draw = self.rng.random()
        if draw < (cfg.shm_tear_prob + cfg.shm_full_prob
                   + cfg.shm_truncate_prob):
            ring = self.inner
            if ring._buf is None:
                return False  # closed: delegate semantics
            payload = self._parts_bytes(parts)
            if not self._fits(len(payload), shm):
                # a genuinely full/oversize ring refuses before any
                # fault could fire: keep the real (counted) refusal
                return ring.push(parts)
            if draw < cfg.shm_tear_prob:
                return self._tear(shm)
            draw -= cfg.shm_tear_prob
            if draw < cfg.shm_full_prob:
                ring._set(shm._FULL, ring._get(shm._FULL) + 1)
                self.full_injected += 1
                return False
            return self._truncate(payload, shm)
        return self.inner.push(parts)

    def pop(self, loads=bytes):
        if self.rng.random() < self.cfg.shm_stall_prob:
            self.stalls_injected += 1
            return None  # stalled consumer: the item stays queued
        return self.inner.pop(loads)


class ChaosBoard:
    """A :class:`~handyrl_tpu_torch.pipeline.shm.ShmBoard` wrapper that
    withholds or backdates heartbeats: workers watching the board see
    the beat age out (drop) or jitter old (delay) while the service is
    in fact alive, the ambiguity the fallback and self-degradation
    paths have to resolve.  Reads delegate untouched."""

    def __init__(self, inner, cfg: ChaosConfig,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        self.cfg = cfg
        self.rng = rng if rng is not None else random.Random(cfg.seed)
        self.beats_dropped = 0
        self.beats_delayed = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def beat(self, epoch=None, now=None):
        cfg = self.cfg
        draw = self.rng.random()
        if draw < cfg.shm_beat_drop_prob:
            self.beats_dropped += 1
            return  # withheld: the board's age keeps growing
        draw -= cfg.shm_beat_drop_prob
        if draw < cfg.shm_beat_delay_prob:
            self.beats_delayed += 1
            now = ((time.monotonic() if now is None else now)
                   - cfg.shm_beat_delay)
        self.inner.beat(epoch=epoch, now=now)


def maybe_chaos_ring(ring, cfg: Optional[ChaosConfig],
                     rng: Optional[random.Random] = None):
    """``ring`` in a :class:`ChaosRing` when shm faults are armed,
    otherwise untouched (zero overhead off)."""
    if cfg is None or not cfg.shm_faults_enabled:
        return ring
    return ChaosRing(ring, cfg, rng=rng)


def maybe_chaos_board(board, cfg: Optional[ChaosConfig],
                      rng: Optional[random.Random] = None):
    """``board`` in a :class:`ChaosBoard` when beat faults are armed,
    otherwise untouched."""
    if cfg is None or not cfg.shm_beat_faults_enabled:
        return board
    return ChaosBoard(board, cfg, rng=rng)


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
