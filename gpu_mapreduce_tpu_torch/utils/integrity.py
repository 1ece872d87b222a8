"""Checksums of durable artifacts: stamped on write, verified on read
(the port's copy of ``gpu_mapreduce_tpu/utils/integrity.py``).

Checkpoint frames (``core/checkpoint.py``) carry per-frame file digests
and per-shard row digests; spill runs (``core/external.py`` through
``exec/spill.atomic_save``) carry the crc of the bytes their writer put on
disk, checked before the merge reads them.  A digest is
``"crc32:xxxxxxxx"`` over the same bytes as the JAX package's, so a
checkpoint written by either package verifies in the other.
``MRTPU_VERIFY=0`` skips the read-side checks; stamps are always written.
Detections are counted per artifact (:func:`integrity_failures` and
``mrtpu_integrity_failures_total{artifact}``).
"""

from __future__ import annotations

import threading
import zlib
from typing import Optional

import numpy as np

_LABEL = "crc32"


class IntegrityError(OSError):
    """A durable artifact failed its checksum."""

    def __init__(self, artifact: str, path: str, expected: str,
                 actual: str):
        super().__init__(
            f"integrity: {artifact} {path!r} checksum mismatch "
            f"(expected {expected}, read {actual})")
        self.artifact = artifact
        self.path = path


def verify_enabled() -> bool:
    """The ``MRTPU_VERIFY`` knob: read-side verification, default on."""
    from .env import env_flag
    return env_flag("MRTPU_VERIFY", True)


def digest_bytes(data) -> str:
    """Stamp of a bytes-like payload."""
    return f"{_LABEL}:{zlib.crc32(bytes(data)) & 0xFFFFFFFF:08x}"


def array_digest(*arrays) -> str:
    """Stamp of arrays' raw C-order bytes, chained (the per-shard row
    digest of checkpoint manifests)."""
    c = 0
    for arr in arrays:
        a = np.ascontiguousarray(np.asarray(arr))
        c = zlib.crc32(a.view(np.uint8).reshape(-1).data, c)
    return f"{_LABEL}:{c & 0xFFFFFFFF:08x}"


def file_digest(path: str, chunk: int = 1 << 20) -> str:
    """crc of a file's bytes, read in ``chunk``-byte pieces."""
    c = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            c = zlib.crc32(block, c)
    return f"{_LABEL}:{c & 0xFFFFFFFF:08x}"


class ChecksumWriter:
    """A binary file handle that crcs every byte written through it, for
    sequential writers (``np.save``; ``np.savez`` seeks and is stamped by
    :func:`file_digest` instead)."""

    def __init__(self, fh):
        self._fh = fh
        self._crc = 0

    def write(self, data) -> int:
        b = bytes(data)
        self._crc = zlib.crc32(b, self._crc)
        return self._fh.write(b)

    def digest(self) -> str:
        return f"{_LABEL}:{self._crc & 0xFFFFFFFF:08x}"

    def __getattr__(self, name):
        return getattr(self._fh, name)


_FAILURES: dict = {}
_FAILURES_LOCK = threading.Lock()


def record_integrity_failure(artifact: str) -> None:
    """Count one detection for ``artifact`` (checkpoint, spill), here and
    in ``mrtpu_integrity_failures_total{artifact}`` (a direct feed: it
    counts before the metrics are armed, and never raises)."""
    with _FAILURES_LOCK:
        _FAILURES[artifact] = _FAILURES.get(artifact, 0) + 1
    try:
        from ..obs.metrics import get_registry
        get_registry().counter(
            "mrtpu_integrity_failures_total",
            "durable artifacts that failed checksum verification on "
            "read, by artifact kind", ("artifact",)).inc(artifact=artifact)
    except Exception:
        pass


def integrity_failures() -> dict:
    """Detections so far, by artifact."""
    with _FAILURES_LOCK:
        return dict(_FAILURES)


def verify_file(path: str, expected: Optional[str], artifact: str) -> None:
    """Check a file against its stamp: a no-op without a stamp or with
    ``MRTPU_VERIFY=0``; raises :class:`IntegrityError` (and counts it)
    on a mismatch."""
    if expected is None or not verify_enabled():
        return
    actual = file_digest(path)
    if actual != expected:
        record_integrity_failure(artifact)
        raise IntegrityError(artifact, path, expected, actual)
