"""Content-addressed store (CAS): one directory of immutable chunks named
by the sha256 of their bytes (the port's copy of
``gpu_mapreduce_tpu/utils/cas.py``; object names and the quarantine
layout are the same, so either package reads what the other wrote).

Two tiers ride on it in the port:

* the **persistent plan cache** (``plan/cache.PersistentPlanCache``)
  keeps compiled-plan speculation state under ``<root>/plan/``, so a
  fresh process's first run of a known plan goes warm;
* **checkpoint/spill chunk dedup** (:func:`CASStore.dedup_file`): the
  frame files written by ``core/checkpoint.py`` and the run files of
  ``exec/spill.py`` are re-homed as hardlinks to their content object,
  so N saves of the same dataset pay the bytes once.

Refcounting is the filesystem's: every consumer of a chunk holds a
hardlink to it, so an object's ``st_nlink`` is its reference count plus
one (the store's own link).  Releasing a reference is ``os.unlink`` of
the consumer's path.  GC removes objects whose only remaining link is
the store's own (``st_nlink == 1``) after a grace period
(:meth:`CASStore.gc_candidates`, then :meth:`CASStore.gc_finish`, which
re-checks each candidate and is idempotent).

Integrity: objects are self-verifying (name = sha256 of content).
Reads under ``MRTPU_VERIFY`` (default on) re-hash, and a mismatch bumps
``mrtpu_integrity_failures_total{artifact="cas"}``, quarantines the
chunk and reads as a miss: callers recompute, never use wrong bytes.

Everything here is an optimisation: any failure (cross-device link,
read-only root, concurrent GC) degrades to the uncached path.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Dict, List, Optional

from .env import env_flag, env_str
from .integrity import record_integrity_failure, verify_enabled


def cas_root() -> Optional[str]:
    """The store root: ``MRTPU_CAS_DIR`` wins; a fleet
    (``MRTPU_FLEET_DIR``) defaults to ``<fleet>/cas`` so every replica
    shares one store; otherwise the tier is off (None)."""
    root = env_str("MRTPU_CAS_DIR", "")
    if root:
        return root
    fleet = env_str("MRTPU_FLEET_DIR", "")
    if fleet:
        return os.path.join(fleet, "cas")
    return None


def cas_enabled() -> bool:
    """``MRTPU_CAS`` (default on) gates every tier at once — the
    one-knob kill switch when a shared store misbehaves."""
    return env_flag("MRTPU_CAS", True) and cas_root() is not None


def sha256_bytes(data) -> str:
    return hashlib.sha256(bytes(data)).hexdigest()


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


class CASStore:
    """One content-addressed chunk directory (see module docstring).
    Thread-safe; safe for concurrent use by multiple processes (every
    mutation is an atomic link/rename/unlink)."""

    def __init__(self, root: str):
        self.root = root
        self.objects = os.path.join(root, "objects")
        self.quarantine_dir = os.path.join(root, "quarantine")
        self._lock = threading.Lock()
        # process-local telemetry (``stats()``)
        self.dedup_hits = 0      # chunks that already existed on put
        self.stores = 0          # chunks newly written
        self.reads = 0
        self.quarantined = 0
        self.gc_removed = 0
        self.gc_bytes = 0

    # -- paths -------------------------------------------------------------
    def _opath(self, digest: str) -> str:
        return os.path.join(self.objects, digest[:2], digest)

    # -- writes ------------------------------------------------------------
    def put_bytes(self, data: bytes) -> str:
        """Store a chunk; returns its digest.  Existing chunks are not
        rewritten (the dedup hit)."""
        digest = sha256_bytes(data)
        path = self._opath(digest)
        if os.path.exists(path):
            with self._lock:
                self.dedup_hits += 1
            return digest
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with self._lock:
            self.stores += 1
        return digest

    def adopt_file(self, path: str, digest: Optional[str] = None) -> str:
        """Adopt an existing file as a chunk WITHOUT copying: hardlink
        it into the store (the file keeps working at its own path; the
        object shares its inode).  Returns the digest."""
        digest = digest or sha256_file(path)
        opath = self._opath(digest)
        if not os.path.exists(opath):
            os.makedirs(os.path.dirname(opath), exist_ok=True)
            try:
                os.link(path, opath)
                with self._lock:
                    self.stores += 1
            except FileExistsError:
                with self._lock:
                    self.dedup_hits += 1
        else:
            with self._lock:
                self.dedup_hits += 1
        return digest

    def dedup_file(self, path: str) -> Optional[str]:
        """Re-home a freshly written chunk file through the store: if
        its content already exists, atomically replace ``path`` with a
        hardlink to the shared object (freeing the duplicate bytes);
        otherwise adopt it as the object.  Returns the digest, or None
        when dedup was impossible (cross-device root, permissions) —
        the file is untouched and correct either way."""
        try:
            digest = sha256_file(path)
            opath = self._opath(digest)
            if os.path.exists(opath):
                st_obj = os.stat(opath)
                st_f = os.stat(path)
                if (st_obj.st_ino, st_obj.st_dev) == \
                        (st_f.st_ino, st_f.st_dev):
                    return digest        # already the same inode
                tmp = f"{path}.cas.{os.getpid()}.{threading.get_ident()}"
                os.link(opath, tmp)
                os.replace(tmp, path)    # atomic: readers never gap
                with self._lock:
                    self.dedup_hits += 1
            else:
                self.adopt_file(path, digest)
            return digest
        except OSError:
            return None

    def materialize(self, digest: str, dest: str) -> bool:
        """Hardlink (fallback: copy) a chunk to ``dest``; False when
        the chunk is absent or corrupt.  The verified-read path: the
        chunk is re-hashed under MRTPU_VERIFY before use."""
        data = self.get_bytes(digest)
        if data is None:
            return False
        opath = self._opath(digest)
        tmp = f"{dest}.cas.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
            try:
                os.link(opath, tmp)
            except OSError:
                with open(tmp, "wb") as f:    # cross-device fallback
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, dest)
            return True
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False

    # -- reads -------------------------------------------------------------
    def get_bytes(self, digest: str) -> Optional[bytes]:
        """Verified read: None when absent — or when corrupt, in which
        case the chunk is quarantined and
        ``mrtpu_integrity_failures_total{artifact="cas"}`` bumps (the
        caller recomputes; a bit-flip can never become a wrong
        answer)."""
        path = self._opath(digest)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        with self._lock:
            self.reads += 1
        if verify_enabled() and sha256_bytes(data) != digest:
            record_integrity_failure("cas")
            self._quarantine(digest)
            return None
        return data

    def contains(self, digest: str) -> bool:
        return os.path.exists(self._opath(digest))

    def refcount(self, digest: str) -> int:
        """External references = hardlinks beyond the store's own."""
        try:
            return max(0, os.stat(self._opath(digest)).st_nlink - 1)
        except OSError:
            return 0

    def _quarantine(self, digest: str) -> None:
        """Move a corrupt chunk aside (evidence for the operator) so
        the next writer can re-store clean bytes under the same name."""
        try:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            os.replace(self._opath(digest),
                       os.path.join(self.quarantine_dir, digest))
        except OSError:
            try:
                os.remove(self._opath(digest))
            except OSError:
                pass
        with self._lock:
            self.quarantined += 1

    # -- GC ----------------------------------------------------------------
    def gc_candidates(self, grace_s: float,
                      now: Optional[float] = None) -> List[str]:
        """Digests safe to sweep: no external hardlink (``st_nlink ==
        1``) and untouched past the grace period (a chunk stored but
        not yet linked by its writer must not vanish mid-publish)."""
        now = time.time() if now is None else now
        out: List[str] = []
        try:
            shards = os.listdir(self.objects)
        except OSError:
            return out
        for shard in shards:
            sdir = os.path.join(self.objects, shard)
            try:
                names = os.listdir(sdir)
            except OSError:
                continue
            for name in names:
                if name.endswith(".tmp") or ".tmp." in name:
                    continue
                try:
                    st = os.stat(os.path.join(sdir, name))
                except OSError:
                    continue
                if st.st_nlink <= 1 and now - st.st_mtime >= grace_s:
                    out.append(name)
        return out

    def gc_finish(self, digests: List[str]) -> int:
        """Second half of a journaled sweep (idempotent — also the
        kill -9 recovery path): re-check each candidate is STILL
        unreferenced, then unlink.  A chunk re-linked since the intent
        record was written survives; refcounts cannot go negative
        because releasing is only ever an unlink of one's own link."""
        removed = 0
        for digest in digests:
            path = self._opath(digest)
            try:
                st = os.stat(path)
            except OSError:
                continue                 # already gone: idempotent
            if st.st_nlink > 1:
                continue                 # re-referenced since intent
            try:
                os.unlink(path)
            except OSError:
                continue
            removed += 1
            with self._lock:
                self.gc_removed += 1
                self.gc_bytes += st.st_size
        return removed

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        chunks = 0
        nbytes = 0
        try:
            for shard in os.listdir(self.objects):
                sdir = os.path.join(self.objects, shard)
                try:
                    for name in os.listdir(sdir):
                        if ".tmp" in name:
                            continue
                        try:
                            nbytes += os.stat(
                                os.path.join(sdir, name)).st_size
                        except OSError:
                            continue
                        chunks += 1
                except OSError:
                    continue
        except OSError:
            pass
        with self._lock:
            return {"enabled": 1, "chunks": chunks, "bytes": nbytes,
                    "dedup_hits": self.dedup_hits, "stores": self.stores,
                    "reads": self.reads, "quarantined": self.quarantined,
                    "gc_removed": self.gc_removed,
                    "gc_bytes": self.gc_bytes}


_STORE: Optional[CASStore] = None
_STORE_ROOT: Optional[str] = None
_STORE_LOCK = threading.Lock()


def cas_store() -> Optional[CASStore]:
    """The process singleton, re-rooted if the env changed (tests);
    None when the tier is disarmed."""
    global _STORE, _STORE_ROOT
    if not cas_enabled():
        return None
    root = cas_root()
    with _STORE_LOCK:
        if _STORE is None or _STORE_ROOT != root:
            _STORE = CASStore(root)
            _STORE_ROOT = root
        return _STORE


def reset_store() -> None:
    """Test isolation: drop the singleton (counters restart)."""
    global _STORE, _STORE_ROOT
    with _STORE_LOCK:
        _STORE = None
        _STORE_ROOT = None
