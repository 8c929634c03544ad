"""Zero-copy shared-memory transport: SPSC rings with seqlock headers.

The pipelined dataflow's data plane.  Each worker owns three rings
against the learner's inference service — obs requests (worker ->
service), action replies (service -> worker), finished trajectories
(worker -> learner intake) — all fixed-size slot rings over one
``multiprocessing.shared_memory`` segment each, created learner-side
and attached by name (the shm handshake rides the framed control
plane, verb ``"shm"``).

Design constraints, and how the layout meets them:

  * **Single producer, single consumer** per ring.  No atomic RMW
    exists in pure Python, so the protocol never needs one: ``head``
    is written only by the producer, ``tail`` only by the consumer,
    and each side only *reads* the other's cursor.  On x86/ARM64 the
    8-byte aligned cursor stores are single stores, and CPython's
    eval loop orders them after the payload stores they publish.
  * **Torn-write detection** via a per-slot seqlock: the producer
    stamps the slot sequence ODD (``2n+1``) before touching the
    payload and EVEN (``2n+2``) after.  A consumer that finds the
    expected even stamp knows the payload is complete; an odd stamp
    is a write in progress — or a producer that died mid-write, which
    the consumer may ``skip_torn()`` past once it has independent
    evidence (dead process, stale heartbeat) that no writer remains.
  * **Backpressure, never overwrite**: ``push`` refuses (and counts,
    in the shm header where the peer can read it) when the ring is
    full.  A full ring means the consumer is behind; the producer
    falls back to the control plane or retries — data is never torn
    out from under a slow reader.
  * **Crash reclaim**: both cursors and all counters live in the
    segment itself, so a crashed reader's successor ``attach``\\ es by
    name and resumes exactly where the dead reader stopped — nothing
    buffered in a lost process heap.

Zero-copy: ``pop`` hands the payload to its ``loads`` callable as a
memoryview over the mapped segment — ``pickle.loads`` / ``np.frombuffer``
consume it in place, and the slot is only released (tail advanced)
after ``loads`` returns.

Plain Python and numpy: workers use it before they touch a device.
"""

import pickle
import struct
import time
from multiprocessing import shared_memory

_HDR = 64                 # ring header bytes
_SLOT_HDR = 16            # per-slot: seq (uint64) + length (uint64)
_Q = struct.Struct("<Q")
_D = struct.Struct("<d")

def _put(buf, fmt, off, value):
    """Publish one 8-byte field in a single copy.  ``struct.pack_into``
    zero-fills the field before it writes the value, so a reader in
    another process can catch a 0 (or a half-written value) mid-write:
    measured, a beat stamp read as 0.0 — "service dead" — in about one
    read in a hundred under a busy writer.  Packing first and copying
    the 8 bytes in one slice assignment never exposes a zero."""
    buf[off:off + 8] = fmt.pack(value)


def _stable(buf, fmt, off):
    """Read one 8-byte field until two consecutive reads agree, so a
    read that overlaps a write is retried instead of returned."""
    value = fmt.unpack_from(buf, off)[0]
    while True:
        again = fmt.unpack_from(buf, off)[0]
        if again == value:
            return value
        value = again


# header offsets (all uint64 unless noted)
_HEAD = 0        # items ever pushed          (producer-owned)
_TAIL = 8        # items ever consumed        (consumer-owned)
_FULL = 16       # pushes refused, ring full  (producer-owned)
_TORN = 24       # torn slots skipped         (consumer-owned)


# NOTE on the resource tracker: every attacher in this design is a
# descendant of the learner through the spawn chain (learner -> gather
# -> worker), so they all inherit the learner's resource-tracker
# process.  An attach therefore RE-registers the same name in the same
# tracker (a set add, no-op) and needs no unregister: the learner's
# close()+unlink() balances the one live entry.  Do NOT "fix" attach
# with resource_tracker.unregister (the usual bpo-38119 workaround) —
# with a shared tracker that unbalances the creator's entry and the
# final unlink logs a KeyError from the tracker process.


class ShmRing:
    """Fixed-slot SPSC ring over one shared-memory segment.

    Exactly one producer process/thread may ``push`` and exactly one
    consumer may ``pop``/``skip_torn`` at a time; which side a process
    plays is the caller's contract (the handshake descriptor says).
    """

    def __init__(self, shm, slots, slot_bytes, owner):
        self._shm = shm
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self.owner = owner
        self._buf = shm.buf

    # -- construction -------------------------------------------------
    @classmethod
    def create(cls, slots, slot_bytes):
        size = _HDR + slots * (_SLOT_HDR + slot_bytes)
        shm = shared_memory.SharedMemory(create=True, size=size)
        ring = cls(shm, slots, slot_bytes, owner=True)
        ring._buf[:_HDR] = bytes(_HDR)  # cursors + counters start at 0
        return ring

    @classmethod
    def attach(cls, name, slots, slot_bytes):
        shm = shared_memory.SharedMemory(name=name)
        return cls(shm, slots, slot_bytes, owner=False)

    @property
    def name(self):
        return self._shm.name

    def descriptor(self):
        """The attach recipe the control-plane handshake ships."""
        return {"name": self.name, "slots": self.slots,
                "slot_bytes": self.slot_bytes}

    # -- header accessors (each field single-writer) -------------------
    def _get(self, off):
        if self._buf is None:
            return 0  # closed ring: counters read as empty/zero
        return _Q.unpack_from(self._buf, off)[0]

    def _set(self, off, value):
        _put(self._buf, _Q, off, value)

    @property
    def full_count(self):
        return self._get(_FULL)

    @property
    def torn_count(self):
        return self._get(_TORN)

    def __len__(self):
        return max(0, self._get(_HEAD) - self._get(_TAIL))

    def _slot_off(self, n):
        return _HDR + (n % self.slots) * (_SLOT_HDR + self.slot_bytes)

    # -- producer side ------------------------------------------------
    def push(self, parts) -> bool:
        """Write one item (a bytes-like, or a list of bytes-likes laid
        out back to back) into the next slot.  False when the ring is
        full or the item exceeds the slot size — counted in the shm
        header either way, so the consumer side can report
        ``shm_ring_full_count`` without a control-plane message."""
        if self._buf is None:
            return False  # closed (e.g. a reaped client's ring)
        if isinstance(parts, (bytes, bytearray, memoryview)):
            parts = (parts,)
        length = sum(len(p) for p in parts)
        head = self._get(_HEAD)
        if length > self.slot_bytes or head - self._get(_TAIL) >= self.slots:
            self._set(_FULL, self._get(_FULL) + 1)
            return False
        off = self._slot_off(head)
        # reserve-then-fill: the odd stamp and the head bump publish
        # the RESERVATION before the payload lands, so a producer that
        # dies mid-write leaves a detectable torn slot (odd stamp,
        # head past it) instead of an invisible half-frame
        _put(self._buf, _Q, off, 2 * head + 1)          # seqlock: odd
        self._set(_HEAD, head + 1)
        _put(self._buf, _Q, off + 8, length)
        pos = off + _SLOT_HDR
        for p in parts:
            n = len(p)
            self._buf[pos:pos + n] = p
            pos += n
        _put(self._buf, _Q, off, 2 * head + 2)          # seqlock: even
        return True

    # -- consumer side ------------------------------------------------
    def pop(self, loads=bytes):
        """Consume the next item, or None when the ring is empty or the
        next slot's write is still in progress (odd seqlock stamp —
        transient with a live producer, permanent with a dead one; see
        ``skip_torn``).  ``loads`` receives a memoryview over the
        mapped segment and runs BEFORE the slot is released, so it may
        deserialize in place with zero intermediate copies."""
        tail = self._get(_TAIL)
        if tail >= self._get(_HEAD):
            return None
        off = self._slot_off(tail)
        seq = _Q.unpack_from(self._buf, off)[0]
        if seq != 2 * tail + 2:
            return None  # odd: mid-write (or torn by a dead producer)
        length = _Q.unpack_from(self._buf, off + 8)[0]
        view = self._buf[off + _SLOT_HDR: off + _SLOT_HDR + length]
        try:
            out = loads(view)
        finally:
            view.release()
        self._set(_TAIL, tail + 1)                      # release slot
        return out

    def readable(self) -> bool:
        """Is a complete item waiting?  (Pop would return non-None.)"""
        tail = self._get(_TAIL)
        return (tail < self._get(_HEAD)
                and _Q.unpack_from(
                    self._buf, self._slot_off(tail))[0] == 2 * tail + 2)

    def pending(self) -> bool:
        """Is ANY item outstanding, complete or torn?  True with a
        mid-write slot — the signal ``skip_torn`` needs."""
        return self._get(_TAIL) < self._get(_HEAD)

    def skip_torn(self) -> bool:
        """Advance past a torn slot (odd seqlock stamp).  Only valid
        once the caller knows the producer is gone — with a live
        producer an odd stamp is a write in flight, and skipping it
        would desynchronize the seqlock.  Counted in the header."""
        tail = self._get(_TAIL)
        if tail >= self._get(_HEAD):
            return False
        off = self._slot_off(tail)
        if _Q.unpack_from(self._buf, off)[0] == 2 * tail + 2:
            return False  # complete, not torn: pop it instead
        self._set(_TORN, self._get(_TORN) + 1)
        self._set(_TAIL, tail + 1)
        return True

    def skip_one(self) -> bool:
        """Advance past the next slot UNCONDITIONALLY, counting it as
        torn.  For a slot whose seqlock stamp is complete (even) but
        whose payload the consumer could not decode — truncation, bit
        rot, a corrupt pickle: ``pop`` leaves such a slot in place
        (its ``loads`` raised before the tail advanced), and without
        this escape the poisoned slot would wedge the ring forever."""
        if self._buf is None:
            return False
        tail = self._get(_TAIL)
        if tail >= self._get(_HEAD):
            return False
        self._set(_TORN, self._get(_TORN) + 1)
        self._set(_TAIL, tail + 1)
        return True

    # -- lifecycle ----------------------------------------------------
    def close(self):
        if self._shm is None:
            return
        self._buf = None
        self._shm.close()
        if self.owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover - double close
                pass
        self._shm = None


class ShmBoard:
    """Tiny single-writer bulletin board: the inference service's
    liveness heartbeat + installed snapshot epoch, readable by every
    attached worker without a control-plane round trip.  The beat is a
    CLOCK_MONOTONIC stamp — system-wide on Linux, so cross-process age
    comparisons are skew-free (same property telemetry relies on)."""

    _BEAT = 0      # float64 monotonic stamp
    _EPOCH = 8     # uint64 installed model epoch
    _GEN = 16      # uint64 service incarnation (respawn counter)
    SIZE = 64

    def __init__(self, shm, owner):
        self._shm = shm
        self.owner = owner
        self._buf = shm.buf

    @classmethod
    def create(cls):
        shm = shared_memory.SharedMemory(create=True, size=cls.SIZE)
        board = cls(shm, owner=True)
        board._buf[:cls.SIZE] = bytes(cls.SIZE)
        return board

    @classmethod
    def attach(cls, name):
        shm = shared_memory.SharedMemory(name=name)
        return cls(shm, owner=False)

    @property
    def name(self):
        return self._shm.name

    def beat(self, epoch=None, now=None):
        if epoch is not None:
            _put(self._buf, _Q, self._EPOCH, int(epoch))
        _put(self._buf, _D, self._BEAT,
                     time.monotonic() if now is None else now)

    def bump_generation(self):
        _put(self._buf, _Q, self._GEN,
             _Q.unpack_from(self._buf, self._GEN)[0] + 1)

    @property
    def generation(self):
        if self._buf is None:
            return 0
        return _stable(self._buf, _Q, self._GEN)

    @property
    def epoch(self):
        if self._buf is None:
            return -1  # closed board never matches a pinned epoch
        return _stable(self._buf, _Q, self._EPOCH)

    def age(self, now=None) -> float:
        """Seconds since the last beat (inf before the first one, and
        after close — a gone board reads as a dead service)."""
        if self._buf is None:
            return float("inf")
        stamp = _stable(self._buf, _D, self._BEAT)
        if stamp == 0.0:
            return float("inf")
        return (time.monotonic() if now is None else now) - stamp

    def close(self):
        if self._shm is None:
            return
        self._buf = None
        self._shm.close()
        if self.owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover - double close
                pass
        self._shm = None


# -- payload codecs ----------------------------------------------------
#
# Obs request frames are RAW: a tiny struct header plus each leaf's
# contiguous bytes back to back, in the leaf order fixed by the attach
# spec.  The service rebuilds rows with np.frombuffer straight off the
# mapped segment — no pickle on the per-step hot path.  Replies and
# trajectories are pickled (protocol 5) and deserialized in place from
# the slot view; both are either small (a few action rows) or
# per-episode (amortized), so structure-bearing pickle is the right
# trade there.

_REQ = struct.Struct("<QI")   # request seq, row count


def pack_request(seq, rows, leaves):
    """Request frame parts for ShmRing.push (no intermediate join)."""
    parts = [_REQ.pack(seq, rows)]
    for leaf in leaves:
        parts.append(memoryview(leaf).cast("B"))
    return parts


def unpack_request(view, leaf_specs):
    """(seq, rows, leaves) from a request frame view; each leaf is a
    fresh ndarray COPY (the slot is released right after this runs)."""
    import numpy as np

    seq, rows = _REQ.unpack_from(view, 0)
    off = _REQ.size
    leaves = []
    for shape, dtype in leaf_specs:
        dt = np.dtype(dtype)
        count = rows * int(np.prod(shape, dtype=np.int64))
        nbytes = count * dt.itemsize
        arr = np.frombuffer(view, dtype=dt, count=count,
                            offset=off).reshape((rows,) + tuple(shape))
        leaves.append(arr.copy())
        off += nbytes
    return seq, rows, leaves


def dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads_view(view):
    """pickle.loads straight off the mapped slot (zero intermediate
    buffer copy)."""
    return pickle.loads(view)
