"""Checkpoint files: the JAX package's on-disk format, read and written.

The counterpart of the checkpoint half of ``handyrl_tpu.durability``:
a pickle written atomically (tmp + fsync + rename) with a sha256
footer after the payload, ``#hrlck:<hexdigest>``.  ``pickle.load``
reads exactly one stream and ignores the footer, so footer-less legacy
files load too.  :class:`CheckpointManifest` indexes the landed
checkpoints and :func:`resolve_restart` turns ``restart_epoch`` (an
epoch or ``"auto"``) into a verified resume point.  The episode WAL
comes with the resilience item.

Reading a checkpoint never imports JAX.  The JAX learner's snapshots
hold numpy leaves in plain dicts, but a params tree pickled straight
off the device holds ``jax.Array`` leaves, whose pickle calls
``jax._src.array._reconstruct_array``, and older Flax versions pickle
``FrozenDict`` containers.  :class:`_CheckpointUnpickler` resolves both
to numpy arrays and plain dicts.
"""

import hashlib
import json
import os
import pickle
import time

CKPT_MAGIC = b"#hrlck:"
MANIFEST_NAME = "manifest.json"
_FOOTER_LEN = len(CKPT_MAGIC) + 64  # magic + sha256 hexdigest


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
