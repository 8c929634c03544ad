"""Checkpoint files: the JAX package's on-disk format, read and written.

The counterpart of the checkpoint half of ``handyrl_tpu.durability``:
a pickle written atomically (tmp + fsync + rename) with a sha256
footer after the payload, ``#hrlck:<hexdigest>``.  ``pickle.load``
reads exactly one stream and ignores the footer, so footer-less legacy
files load too.  :class:`CheckpointManifest` indexes the landed
checkpoints and :func:`resolve_restart` turns ``restart_epoch`` (an
epoch or ``"auto"``) into a verified resume point.  :class:`EpisodeWAL`
logs admitted episodes so a restarted learner replays its backlog
into the replay ring instead of re-generating it; its segments are the
JAX package's byte for byte, so either package replays the other's
``models/wal/``.

Reading a checkpoint never imports JAX.  The JAX learner's snapshots
hold numpy leaves in plain dicts, but a params tree pickled straight
off the device holds ``jax.Array`` leaves, whose pickle calls
``jax._src.array._reconstruct_array``, and older Flax versions pickle
``FrozenDict`` containers.  :class:`_CheckpointUnpickler` resolves both
to numpy arrays and plain dicts.
"""

import hashlib
import io
import json
import os
import pickle
import struct
import time
import zlib

CKPT_MAGIC = b"#hrlck:"
MANIFEST_NAME = "manifest.json"
_FOOTER_LEN = len(CKPT_MAGIC) + 64  # magic + sha256 hexdigest

# WAL record framing: payload length, crc32 of the payload, and a
# monotonically increasing per-WAL sequence number (the dedup key that
# makes double replay of a sealed segment idempotent)
_WAL_REC = struct.Struct("!IIQ")
_WAL_SUFFIX = ".wal"


class CorruptCheckpointError(Exception):
    """A checkpoint file failed digest verification (or unpickling)."""


class _TeeHash:
    """File wrapper that hashes bytes as pickle streams them."""

    __slots__ = ("f", "h")

    def __init__(self, f):
        self.f = f
        self.h = hashlib.sha256()

    def write(self, data):
        self.h.update(data)
        return self.f.write(data)


def write_checksummed(path, state, checksum=True):
    """Atomic checkpoint write (pickle tmp + fsync + rename), with a
    sha256 footer stamped after the payload when ``checksum`` is on.
    Returns the payload digest ("" when checksumming is off)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        if checksum:
            tee = _TeeHash(f)
            pickle.dump(state, tee, protocol=pickle.HIGHEST_PROTOCOL)
            digest = tee.h.hexdigest()
            f.write(CKPT_MAGIC + digest.encode("ascii"))
        else:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
            digest = ""
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return digest


def _read_footer(f, size):
    """Footer digest of an open checkpoint file, or None (legacy)."""
    if size <= _FOOTER_LEN:
        return None
    f.seek(size - _FOOTER_LEN)
    tail = f.read(_FOOTER_LEN)
    if tail[: len(CKPT_MAGIC)] != CKPT_MAGIC:
        return None
    return tail[len(CKPT_MAGIC):].decode("ascii", "replace")


def _hash_payload(f, payload_len, chunk=1 << 20):
    """sha256 of the first ``payload_len`` bytes, streamed in chunks."""
    h = hashlib.sha256()
    f.seek(0)
    left = payload_len
    while left > 0:
        block = f.read(min(chunk, left))
        if not block:
            break
        h.update(block)
        left -= len(block)
    return h.hexdigest()


def _reconstruct_jax_array(fun, args, arr_state, aval_state):
    """numpy stand-in for ``jax._src.array._reconstruct_array``: the
    pickled state is an ndarray's, the device placement is dropped."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


def _frozen_dict(mapping=None, *_):
    return dict(mapping or {})


class _CheckpointUnpickler(pickle.Unpickler):
    """Resolves JAX and Flax containers to numpy without importing
    either; every other global resolves as ``pickle`` would."""

    _SUBSTITUTES = {
        ("jax._src.array", "_reconstruct_array"): _reconstruct_jax_array,
        ("flax.core.frozen_dict", "FrozenDict"): _frozen_dict,
    }

    def find_class(self, module, name):
        substitute = self._SUBSTITUTES.get((module, name))
        if substitute is not None:
            return substitute
        if module.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(
                f"checkpoint needs {module}.{name}, which the port does "
                f"not read")
        return super().find_class(module, name)


def _verify_open(f, path, expect_digest):
    """Check the footer and the manifest digest of an open file;
    returns the footer digest (None for a legacy file)."""
    size = os.fstat(f.fileno()).st_size
    if size == 0:
        raise CorruptCheckpointError(f"{path}: zero-length file")
    footer = _read_footer(f, size)
    payload_len = size - _FOOTER_LEN if footer is not None else size
    if footer is not None or expect_digest:
        actual = _hash_payload(f, payload_len)
        if footer is not None and actual != footer:
            raise CorruptCheckpointError(
                f"{path}: content does not match its checksum footer")
        if expect_digest and actual != expect_digest:
            raise CorruptCheckpointError(
                f"{path}: content does not match the manifest digest")
    return footer


def read_verified(path, expect_digest=None):
    """Load a checkpoint, verifying its footer (and, when given, the
    manifest-recorded ``expect_digest``).  Raises
    :class:`CorruptCheckpointError` on any mismatch, truncation, or
    unpickling failure; OSError passes through for missing files."""
    with open(path, "rb") as f:
        _verify_open(f, path, expect_digest)
        f.seek(0)
        try:
            return _CheckpointUnpickler(f).load()
        except Exception as exc:  # truncated/garbage pickle streams
            # raise a zoo (UnpicklingError, EOFError, ValueError, ...)
            raise CorruptCheckpointError(f"{path}: {exc!r}") from exc


def verify_file(path, expect_digest=None):
    """True iff the checkpoint at ``path`` is intact; never raises.
    A digest (footer or manifest) is the proof; only a legacy
    footer-less file without one is unpickled to vouch for it."""
    try:
        with open(path, "rb") as f:
            if _verify_open(f, path, expect_digest) is not None \
                    or expect_digest:
                return True
            f.seek(0)
            _CheckpointUnpickler(f).load()
            return True
    except Exception:  # garbage pickle streams raise a zoo; any of
        return False   # them means "not a valid checkpoint"


class CheckpointManifest:
    """``manifest.json``: the durable index of landed checkpoints.

    One JSON document, rewritten transactionally (tmp + fsync +
    rename) on every commit: ``entries`` maps epoch -> {path, digest,
    steps, wall_time, train_state_digest}, and ``latest`` points at
    the newest resume point.  A missing or corrupt manifest reads as
    empty (resume then falls back to ``latest.ckpt``)."""

    def __init__(self, models_dir):
        self.models_dir = models_dir
        self.path = os.path.join(models_dir, MANIFEST_NAME)

    def load(self):
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {"version": 1, "entries": {}, "latest": None}
        data.setdefault("entries", {})
        data.setdefault("latest", None)
        return data

    def _write(self, data):
        os.makedirs(self.models_dir, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def commit(self, epoch, path, digest, steps, train_state_digest="",
               emergency=False):
        """Record one landed checkpoint and re-point ``latest``.  The
        train-state digest proves at restore time that the one
        ``train_state.ckpt`` on disk pairs with THIS epoch's params."""
        data = self.load()
        entry = {"path": path, "digest": digest, "steps": int(steps),
                 "wall_time": time.time(),
                 "train_state_digest": train_state_digest}
        if not emergency:
            data["entries"][str(int(epoch))] = entry
        data["latest"] = {"epoch": int(epoch), "path": path,
                          "digest": digest, "steps": int(steps),
                          "train_state_digest": train_state_digest,
                          "emergency": bool(emergency)}
        self._write(data)

    def forget(self, epochs):
        """Drop pruned epochs from the index (checkpoint retention)."""
        epochs = {str(int(e)) for e in epochs}
        data = self.load()
        kept = {e: v for e, v in data["entries"].items()
                if e not in epochs}
        if len(kept) != len(data["entries"]):
            data["entries"] = kept
            self._write(data)

    def valid_entries(self):
        """Yield (epoch, entry) newest-first whose files still match
        their recorded digests."""
        data = self.load()
        for epoch_str, entry in sorted(
                data["entries"].items(), key=lambda kv: -int(kv[0])):
            path = os.path.join(self.models_dir,
                                os.path.basename(entry["path"]))
            if verify_file(path, entry.get("digest")):
                yield int(epoch_str), dict(entry, path=path)

    def newest_valid(self, below=None):
        """Newest (epoch, entry) that verifies, optionally restricted
        to epochs strictly below ``below``; None when nothing does."""
        for epoch, entry in self.valid_entries():
            if below is not None and epoch >= below:
                continue
            return epoch, entry
        return None


class ResumePoint:
    """Resolved restart decision: the epoch to resume as, the model
    file to load (None = fresh init), where the decision came from
    (``fresh`` / ``requested`` / ``manifest`` / ``emergency`` /
    ``latest`` / ``fallback``), and the manifest-recorded digest of
    the train state that pairs with these params ("" = unknown)."""

    __slots__ = ("epoch", "model_file", "source", "train_state_digest")

    def __init__(self, epoch, model_file, source, train_state_digest=""):
        self.epoch = int(epoch)
        self.model_file = model_file
        self.source = source
        self.train_state_digest = train_state_digest or ""

    def __repr__(self):
        return f"ResumePoint(epoch={self.epoch}, source={self.source!r})"


def resolve_restart(models_dir, requested, latest_name="latest.ckpt"):
    """Turn ``restart_epoch`` (int or "auto") into a verified
    :class:`ResumePoint`, falling back LOUDLY when the preferred
    checkpoint is corrupt or missing.

    * ``auto``: the manifest's ``latest`` if its file verifies, else
      the newest valid manifest entry, else a verifiable
      ``latest.ckpt``, else a fresh start.
    * explicit epoch N: ``models/N.ckpt`` if it verifies, else the
      newest valid manifest entry below N; raises
      :class:`CorruptCheckpointError` when nothing valid exists.
    """
    manifest = CheckpointManifest(models_dir)
    if requested in (0, "0", None, ""):
        return ResumePoint(0, None, "fresh")

    def _entry_point(epoch, entry, source):
        print(f"resume: epoch {epoch} from {entry['path']} "
              f"({source}, steps {entry.get('steps', '?')})")
        return ResumePoint(
            epoch, entry["path"], source,
            train_state_digest=entry.get("train_state_digest", ""))

    if requested == "auto":
        latest = manifest.load().get("latest")
        if latest:
            path = os.path.join(models_dir,
                                os.path.basename(latest["path"]))
            if verify_file(path, latest.get("digest")):
                source = ("emergency" if latest.get("emergency")
                          else "manifest")
                return _entry_point(latest["epoch"],
                                    dict(latest, path=path), source)
            print(f"WARNING: manifest latest (epoch "
                  f"{latest.get('epoch')}) failed verification; "
                  "falling back to older entries")
        newest = manifest.newest_valid()
        if newest is not None:
            return _entry_point(*newest, "manifest")
        latest_path = os.path.join(models_dir, latest_name)
        try:
            state = read_verified(latest_path)
        except (OSError, CorruptCheckpointError):
            state = None
        if state is not None:
            epoch = int(state.get("epoch", 0) or 0)
            if epoch > 0:
                print(f"resume: epoch {epoch} from {latest_path} "
                      "(no manifest)")
                return ResumePoint(epoch, latest_path, "latest")
        print("restart_epoch: auto — no valid checkpoint found; "
              "starting fresh")
        return ResumePoint(0, None, "fresh")

    epoch = int(requested)
    path = os.path.join(models_dir, f"{epoch}.ckpt")
    entry = manifest.load()["entries"].get(str(epoch)) or {}
    if verify_file(path, entry.get("digest") or None):
        return ResumePoint(
            epoch, path, "requested",
            train_state_digest=entry.get("train_state_digest", ""))
    print(f"WARNING: checkpoint for restart_epoch {epoch} is corrupt "
          f"or missing ({path})")
    newest = manifest.newest_valid(below=epoch)
    if newest is not None:
        fallback_epoch, entry = newest
        print(f"WARNING: falling back to the newest valid checkpoint, "
              f"epoch {fallback_epoch} (optimizer state for epoch "
              f"{epoch} will cold-start unless it matches)")
        return _entry_point(fallback_epoch, entry, "fallback")
    raise CorruptCheckpointError(
        f"restart_epoch {epoch}: no valid checkpoint at {path} and "
        "no valid manifest entry to fall back to")


class EpisodeWAL:
    """Segmented, checksummed write-ahead log of admitted episodes.

    Appends happen on the learner's server thread at intake, BEFORE
    the episode enters the replay ring (write-ahead).  Each record is
    framed ``(len, crc32, seq)`` and written with ONE ``write()`` call
    so a signal handler (or a preemption) can interleave only at
    record boundaries; fsync happens on the ``flush_interval`` cadence
    (0 = every append).  ``roll()`` cuts the active segment when a
    checkpoint lands, and ``retire(keep_episodes)`` drops the oldest
    sealed segments once the newer ones alone cover the replay
    buffer's capacity.

    Replay (:meth:`replay`) verifies every record's crc: a torn or
    corrupt record ends THAT segment's replay with a notice (the tail
    after a bad record is untrusted) and continues with the next
    segment.  The per-record ``seq`` makes replay idempotent: pass one
    ``seen`` set across calls and each episode is yielded once."""

    def __init__(self, wal_dir, segment_bytes=8 << 20,
                 flush_interval=1.0, clock=time.monotonic):
        self.dir = wal_dir
        self.segment_bytes = max(1, int(segment_bytes))
        self.flush_interval = max(0.0, float(flush_interval))
        self.clock = clock
        self._f = None
        self._f_path = None
        self._f_bytes = 0
        self._f_count = 0
        self._dirty = False
        self._last_flush = 0.0
        self.appended = 0          # cumulative for this process
        self.flushes = 0
        self._seg_counts = {}      # sealed segment -> episode count
        self.seq = 0
        self._scan_existing()

    # -- bookkeeping --------------------------------------------------
    def _scan_existing(self):
        """Recover the sequence counter and per-segment episode counts
        from a previous incarnation's segments: frames and crcs only,
        no unpickling (the replay pass deserializes every record
        anyway)."""
        for path in self.segments():
            count = 0
            for seq, _ in _iter_records(path, notice=False,
                                        payloads=False):
                self.seq = max(self.seq, seq)
                count += 1
            self._seg_counts[path] = count

    def segments(self):
        """Segment paths, oldest first (index-ordered filenames)."""
        try:
            names = [n for n in os.listdir(self.dir)
                     if n.endswith(_WAL_SUFFIX)]
        except OSError:
            return []
        return [os.path.join(self.dir, n)
                for n in sorted(names, key=_seg_index)]

    def episode_count(self):
        return sum(self._seg_counts.values()) + self._f_count

    # -- append path --------------------------------------------------
    def _open_segment(self):
        os.makedirs(self.dir, exist_ok=True)
        segs = self.segments()
        index = _seg_index(os.path.basename(segs[-1])) + 1 if segs else 0
        self._f_path = os.path.join(
            self.dir, f"seg-{index:06d}{_WAL_SUFFIX}")
        self._f = open(self._f_path, "ab")
        self._f_bytes = 0
        self._f_count = 0

    def append(self, episode):
        """Log one admitted episode; returns its sequence number."""
        if self._f is None:
            self._open_segment()
        self.seq += 1
        payload = pickle.dumps(episode, protocol=pickle.HIGHEST_PROTOCOL)
        record = _WAL_REC.pack(
            len(payload), zlib.crc32(payload), self.seq) + payload
        self._f.write(record)  # ONE write: interleave-safe boundary
        self._f_bytes += len(record)
        self._f_count += 1
        self.appended += 1
        self._dirty = True
        if self._f_bytes >= self.segment_bytes:
            self.roll()
        else:
            self.maybe_flush()
        return self.seq

    def maybe_flush(self, now=None):
        """fsync the active segment if the cadence says so."""
        if not self._dirty or self._f is None:
            return False
        if now is None:
            now = self.clock()
        if (self.flush_interval > 0
                and now - self._last_flush < self.flush_interval):
            return False
        self._f.flush()
        os.fsync(self._f.fileno())
        self._dirty = False
        self._last_flush = now
        self.flushes += 1
        return True

    def seal(self):
        """Force-fsync the active segment (SIGTERM grace window)."""
        if self._f is None:
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self._dirty = False
        self.flushes += 1

    def roll(self):
        """Cut the active segment: it becomes a sealed, retirable unit
        and the next append opens a fresh one.  No-op while empty."""
        if self._f is None or self._f_count == 0:
            return
        self.seal()
        self._f.close()
        self._seg_counts[self._f_path] = self._f_count
        self._f = None
        self._f_path = None
        self._f_bytes = 0
        self._f_count = 0

    def retire(self, keep_episodes):
        """Drop the oldest SEALED segments whose episodes the newer
        ones already cover: a segment retires only when the segments
        after it hold >= ``keep_episodes`` episodes.  Returns the paths
        removed."""
        keep_episodes = max(0, int(keep_episodes))
        sealed = [p for p in self.segments() if p in self._seg_counts
                  and p != self._f_path]
        removed = []
        for i, path in enumerate(sealed):
            newer = sum(self._seg_counts[p] for p in sealed[i + 1:])
            newer += self._f_count
            if newer < keep_episodes:
                break
            try:
                os.remove(path)
            except OSError:
                break
            removed.append(path)
            del self._seg_counts[path]
        if removed:
            print(f"wal: retired {len(removed)} segment(s) "
                  f"({self.episode_count()} episodes retained)")
        return removed

    def checkpoint_landed(self, keep_episodes):
        """Epoch-boundary hook: roll the active segment, then retire
        what the landed checkpoint made dead weight."""
        self.roll()
        self.retire(keep_episodes)

    def close(self):
        if self._f is not None:
            self.seal()
            self._f.close()
            self._f = None

    # -- replay -------------------------------------------------------
    def replay(self, seen=None):
        """Yield ``(seq, episode)`` for every intact logged record,
        oldest first, deduplicated against ``seen``."""
        if seen is None:
            seen = set()
        for path in self.segments():
            for seq, episode in _iter_records(path, notice=True):
                if seq in seen:
                    continue
                seen.add(seq)
                yield seq, episode

    def stats(self):
        return {
            "wal_appended": self.appended,
            "wal_flushes": self.flushes,
            "wal_segments": len(self.segments()),
            "wal_episodes": self.episode_count(),
        }


def _seg_index(name):
    base = os.path.basename(name)
    try:
        return int(base[len("seg-"):-len(_WAL_SUFFIX)])
    except ValueError:
        return -1


class _RecordUnpickler(pickle.Unpickler):
    """A WAL record's loader: episodes are numpy arrays, bytes and
    plain containers, so a record naming a JAX or Flax global is
    refused (it fails that record) instead of importing either."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(
                f"WAL record needs {module}.{name}, which the port does "
                f"not read")
        return super().find_class(module, name)


def _iter_records(path, notice=True, payloads=True):
    """Records of one segment; stops at the first torn/corrupt record
    (the rest of that segment is untrusted).  ``payloads=False`` walks
    frames and checks crcs without unpickling (yielding ``(seq,
    None)``)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return
    name = os.path.basename(path)
    offset = 0
    while offset + _WAL_REC.size <= len(data):
        length, crc, seq = _WAL_REC.unpack_from(data, offset)
        start = offset + _WAL_REC.size
        payload = data[start:start + length]
        if len(payload) < length:
            if notice:
                print(f"wal: {name}: torn record at byte {offset} "
                      "(crash tail); replay of this segment stops here")
            return
        if zlib.crc32(payload) != crc:
            if notice:
                print(f"WARNING: wal: {name}: crc mismatch at byte "
                      f"{offset}; dropping the segment's remaining "
                      "records")
            return
        episode = None
        if payloads:
            try:
                episode = _RecordUnpickler(io.BytesIO(payload)).load()
            except Exception:  # garbage pickle streams raise a zoo
                if notice:
                    print(f"WARNING: wal: {name}: unreadable record at "
                          f"byte {offset}; dropping the segment's "
                          "remaining records")
                return
        yield seq, episode
        offset = start + length
    if offset < len(data) and notice:
        print(f"wal: {name}: {len(data) - offset} trailing bytes (torn "
              "header) ignored")
