"""Background spill writer with a durability barrier (the port's copy of
``gpu_mapreduce_tpu/exec/spill.py``).

``core/external.py`` pass 1 sorts each page and spills it as a run; here
the write goes to a daemon thread so the sort of run k overlaps the write
of run k-1.  Every submit returns a :class:`Pending` whose ``wait()`` the
merge calls before its first read of that run, and a writer failure
re-raises there.  Files are written through :func:`atomic_save` (tmp +
``os.replace``), so no torn file ever sits under a final name.  The
submit queue is bounded (2 pending writes by default), so a fast sorter
cannot pile unwritten pages in memory.  Each write is an
``exec.spill_write`` span under the request context of the thread that
submitted it (``obs/context.py``).  With a content store armed
(``utils/cas.py``) each run file becomes a hardlink to its content
object.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np


def atomic_save(path: str, arr: np.ndarray, allow_pickle: bool = False
                ) -> str:
    """``np.save`` through a tmp sibling + ``os.replace``; ``path`` must
    carry its ``.npy`` suffix.  Returns the crc stamp of the bytes
    written (``utils/integrity.py``).  With a content store armed
    (``utils/cas.py``) the run file is then re-homed as a hardlink to its
    content object (JAX :56-66): the same bytes, so the stamp holds; any
    failure leaves the plain file."""
    from ..utils.fsio import atomic_replace
    from ..utils.integrity import ChecksumWriter
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        cw = ChecksumWriter(f)
        np.save(cw, arr, allow_pickle=allow_pickle)
        f.flush()
        os.fsync(f.fileno())
    atomic_replace(tmp, path)
    try:
        from ..utils.cas import cas_store
        store = cas_store()
        if store is not None:
            store.dedup_file(path)
    except Exception:
        pass
    return cw.digest()


class Pending:
    """Handle of one submitted write; ``wait()`` returns once it is on
    disk (the seconds spent blocked) or re-raises its failure."""

    __slots__ = ("_done", "_error")

    def __init__(self):
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    def wait(self) -> float:
        t0 = time.perf_counter()
        self._done.wait()
        waited = time.perf_counter() - t0
        if self._error is not None:
            raise self._error
        return waited


class SpillWriter:
    """One lazily started writer thread with a bounded queue; writes run
    in submit order."""

    def __init__(self, max_pending: int = 2, path: str = "spill"):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, max_pending))
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._path = path
        self._closed = False

    def submit(self, fn: Callable[[], None]) -> Pending:
        """Queue the write closure ``fn``; blocks while ``max_pending``
        writes wait (that time counts as foreground wait)."""
        if self._closed:
            raise RuntimeError("SpillWriter is closed")
        pending = Pending()
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"mrtpu-{self._path}-writer")
                self._thread.start()
        # the writer thread is shared: the submitting request's context
        # rides each item, so a write charges the request that spilled
        from ..obs import context as _obs_ctx
        req_ctx = _obs_ctx.capture()
        t0 = time.perf_counter()
        self._q.put((fn, pending, req_ctx))
        blocked = time.perf_counter() - t0
        if blocked > 1e-4:
            from . import note_overlap
            note_overlap(self._path, wait_s=blocked)
        return pending

    def _run(self) -> None:
        from ..obs import context as _obs_ctx
        from ..obs import get_tracer
        from . import note_overlap
        tracer = get_tracer()
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, pending, req_ctx = item
            t0 = time.perf_counter()
            try:
                with _obs_ctx.use(req_ctx), \
                        tracer.span("exec.spill_write", cat="exec",
                                    path=self._path):
                    fn()
            except BaseException as e:
                pending._error = e
            finally:
                pending._done.set()
                note_overlap(self._path,
                             busy_s=time.perf_counter() - t0, items=1)

    def close(self) -> None:
        """Drain the queued writes and join the thread (idempotent; the
        drain counts as foreground wait).  Errors stay on their Pending
        handles."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            t = self._thread
        if t is not None:
            self._q.put(None)
            t0 = time.perf_counter()
            t.join(timeout=60.0)
            blocked = time.perf_counter() - t0
            if blocked > 1e-4:
                from . import note_overlap
                note_overlap(self._path, wait_s=blocked)
