"""Checkpoint files: the JAX package's on-disk format, read and written.

The counterpart of the checkpoint half of ``handyrl_tpu.durability``:
a pickle written atomically (tmp + fsync + rename) with a sha256
footer after the payload, ``#hrlck:<hexdigest>``.  ``pickle.load``
reads exactly one stream and ignores the footer, so footer-less legacy
files load too.  The manifest, auto-resume and the episode WAL come
with the learner.

Reading a checkpoint never imports JAX.  The JAX learner's snapshots
hold numpy leaves in plain dicts, but a params tree pickled straight
off the device holds ``jax.Array`` leaves, whose pickle calls
``jax._src.array._reconstruct_array``, and older Flax versions pickle
``FrozenDict`` containers.  :class:`_CheckpointUnpickler` resolves both
to numpy arrays and plain dicts.
"""

import hashlib
import os
import pickle

CKPT_MAGIC = b"#hrlck:"
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


def read_verified(path, expect_digest=None):
    """Load a checkpoint, verifying its footer (and, when given, the
    manifest-recorded ``expect_digest``).  Raises
    :class:`CorruptCheckpointError` on any mismatch, truncation, or
    unpickling failure; OSError passes through for missing files."""
    with open(path, "rb") as f:
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
        f.seek(0)
        try:
            return _CheckpointUnpickler(f).load()
        except Exception as exc:  # truncated/garbage pickle streams
            # raise a zoo (UnpicklingError, EOFError, ValueError, ...)
            raise CorruptCheckpointError(f"{path}: {exc!r}") from exc
