"""External (out-of-core) sort and group: the reference's Spool merge
cascade (``src/mapreduce.cpp:2359-2633``), the port of
``gpu_mapreduce_tpu/core/external.py``.

* pass 1 — each page (at most ``memsize`` MB, ``dataset._split_to_budget``)
  sorts in memory and spills as a sorted run (``.npy`` files through
  ``exec/spill.SpillWriter``, verified before the merge reads them);
* pass 2 — a k-way merge: each run holds one block of
  ``memsize / (2·k·rowbytes)`` rows; every step takes all rows no greater
  than the smallest block tail (no unseen row can precede them), merges
  them with one stable sort and yields a chunk;
* :func:`group_stream` cuts the sorted chunks into KMV frames on group
  boundaries, holding back each chunk's last key until the next chunk
  proves its group complete.

A run whose sort column is dense sorts with a stable ``torch.sort`` on
the MapReduce's device, u64 bit patterns through ``ops/bits.order_key``
and ``[n, 2]`` keys as a two-column lexsort; byte and object columns sort
on the host (``ops/sort.argsort_column``).  Both give the JAX package's
order exactly: ascending, equal keys in run order then row order.  The
block cuts search numpy surrogates of the host rows, whose u64 columns
are real ``uint64``.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from .column import BytesColumn, DenseColumn, ObjectColumn, concat
from .frame import KMVFrame, KVFrame


def sort_surrogate(col) -> np.ndarray:
    """A 1-D array whose ascending order is the column's sort order:
    numeric 1-D columns as they are; ``[n, w]`` rows as structured
    records (field-lexicographic); byte rows as object rows; objects by
    their pickles."""
    if isinstance(col, ObjectColumn):
        return np.asarray(col.pickles() + [None], dtype=object)[:-1]
    if isinstance(col, BytesColumn):
        return np.asarray(col.tolist() + [None], dtype=object)[:-1]
    data = np.asarray(col.to_host().data)
    if data.ndim == 1:
        return data
    data = np.ascontiguousarray(data)
    rec = data.view([(f"f{i}", data.dtype) for i in range(data.shape[1])])
    return rec.reshape(-1)


def sort_order(col, device=None) -> np.ndarray:
    """Stable ascending argsort of a host column: a dense column with a
    stable ``torch.sort`` on ``device`` (u64 through ``order_key``, a
    ``[n, w]`` column as a lexsort, column 0 primary), anything else on
    the host."""
    if not isinstance(col, DenseColumn) or device is None:
        from ..ops.sort import argsort_column
        return argsort_column(col)
    from ..ops.bits import order_key, to_torch
    from ..ops.sort import lexsort
    data = col.data
    t = to_torch(data, device)
    cols = [t] if t.dim() == 1 else \
        [t[:, j] for j in range(t.shape[1] - 1, -1, -1)]
    order = lexsort([order_key(c, data.dtype) for c in cols])
    return order.cpu().numpy()


def _col_kind(col) -> str:
    if isinstance(col, ObjectColumn):
        return "object"
    if isinstance(col, BytesColumn):
        return "bytes"
    return "dense"


def _save_col(col, path: str) -> str:
    """One run column as ``.npy``: dense as its array, byte and object
    rows as a pickled object array.  Returns the writer's crc stamp."""
    from ..exec.spill import atomic_save
    if _col_kind(col) == "dense":
        return atomic_save(path, np.asarray(col.to_host().data))
    rows = col.tolist()
    arr = np.empty(len(rows), dtype=object)    # element-wise: tuple rows
    for i, x in enumerate(rows):               # must not become 2-D
        arr[i] = x
    return atomic_save(path, arr, allow_pickle=True)


class _Run:
    """One sorted spilled run with a block cursor.  Dense columns re-open
    with ``mmap_mode='r'`` so a refill reads only its block; byte and
    object columns re-read the pickled array.  ``pending`` is the
    background write's durability barrier: every read waits on it, then
    checks the files against the writer's stamps once."""

    def __init__(self, kpath: str, vpath: str, n: int, counters,
                 kkind: str, vkind: str):
        self.kpath, self.vpath = kpath, vpath
        self.n = n
        self.pos = 0
        self.counters = counters
        self.kkind, self.vkind = kkind, vkind
        self.buf: Optional[KVFrame] = None
        self.sur: Optional[np.ndarray] = None
        self.pending = None
        self.kdigest: Optional[str] = None
        self.vdigest: Optional[str] = None
        self._verified = False

    def wait_ready(self) -> None:
        """Block until the run is on disk, re-raising a writer failure."""
        if self.pending is None:
            return
        pending, self.pending = self.pending, None
        try:
            waited = pending.wait()
        except BaseException:
            self.pending = pending
            raise
        from ..exec import note_overlap
        note_overlap("spill", wait_s=waited)

    @staticmethod
    def _load(path: str, start: int, stop: int, kind: str):
        if kind == "dense":
            arr = np.load(path, mmap_mode="r")
            return DenseColumn(np.array(arr[start:stop]))
        rows = np.load(path, allow_pickle=True)[start:stop].tolist()
        return ObjectColumn(rows) if kind == "object" else BytesColumn(rows)

    def verify(self) -> None:
        if self._verified:
            return
        from ..utils.integrity import verify_file
        verify_file(self.kpath, self.kdigest, "spill")
        verify_file(self.vpath, self.vdigest, "spill")
        self._verified = True

    def refill(self, block_rows: int, by: str) -> None:
        if self.buf is not None or self.pos >= self.n:
            return
        self.wait_ready()
        self.verify()
        stop = min(self.pos + block_rows, self.n)
        self.buf = KVFrame(self._load(self.kpath, self.pos, stop,
                                      self.kkind),
                           self._load(self.vpath, self.pos, stop,
                                      self.vkind))
        self.sur = sort_surrogate(self.buf.key if by == "key"
                                  else self.buf.value)
        self.counters.add(rsize=self.buf.nbytes())
        self.pos = stop

    def exhausted(self) -> bool:
        return self.buf is None and self.pos >= self.n

    def take_upto(self, bound) -> Optional[KVFrame]:
        """Split off the buffered rows whose surrogate is ≤ ``bound``."""
        if self.buf is None:
            return None
        cut = int(np.searchsorted(self.sur, bound, side="right"))
        if cut == 0:
            return None
        out = self.buf.slice(0, cut)
        if cut >= len(self.buf):
            self.buf, self.sur = None, None
        else:
            self.buf = self.buf.slice(cut, len(self.buf))
            self.sur = self.sur[cut:]
        return out

    def tail(self):
        return self.sur[-1]

    def drop(self) -> None:
        for p in (self.kpath, self.vpath,
                  self.kpath + ".tmp", self.vpath + ".tmp"):
            try:
                os.remove(p)
            except OSError:
                pass


def _write_run(fr: KVFrame, settings, counters, seq: int,
               writer=None) -> _Run:
    """Spill one sorted frame as a run: in the background through
    ``writer`` (the run carries the barrier), or right here."""
    from .dataset import _next_file_id
    os.makedirs(settings.fpath, exist_ok=True)
    base = os.path.join(settings.fpath,
                        f"mrtpu.sortrun.{_next_file_id()}.{seq}")
    kpath, vpath = base + ".k.npy", base + ".v.npy"
    nbytes = fr.nbytes()
    key, value = fr.key, fr.value
    run = _Run(kpath, vpath, len(fr), counters, _col_kind(key),
               _col_kind(value))

    def do_write():
        run.kdigest = _save_col(key, kpath)
        run.vdigest = _save_col(value, vpath)
        counters.add(wsize=nbytes)

    if writer is None:
        do_write()
    else:
        run.pending = writer.submit(do_write)
    return run


def _bound_key(x):
    """The run tails compare as tuples when they are records."""
    return x.tolist() if isinstance(x, np.void) else x


def external_sorted_chunks(frames: Iterator[KVFrame], by: str, settings,
                           counters, device=None) -> Iterator[KVFrame]:
    """Sort a stream of host frames by key or value in about one page of
    memory, yielding ASCENDING sorted chunks in global order (each about
    half a page).  Callers consume incrementally; descending callers flip
    each chunk and reverse the chunk order.  ``device``: where dense runs
    sort (None: on the host)."""
    from ..exec import spill_bg_enabled
    budget = settings.memsize * (1 << 20)
    writer = None
    if spill_bg_enabled():
        from ..exec.spill import SpillWriter
        writer = SpillWriter()
    runs: List[_Run] = []
    rowbytes = 16
    try:
        for seq, fr in enumerate(frames):
            col = fr.key if by == "key" else fr.value
            order = sort_order(col, device)
            runs.append(_write_run(fr.take(order), settings, counters,
                                   seq, writer=writer))
            if len(fr):
                # blocks sized for the widest rows seen
                rowbytes = max(rowbytes, fr.nbytes() // len(fr))
    finally:
        if writer is not None:
            writer.close()     # errors surface at the runs' barriers

    if not runs:
        return
    block_rows = max(1, budget // max(1, 2 * len(runs) * rowbytes))
    live = list(runs)
    try:
        while live:
            for r in live:
                r.refill(block_rows, by)
            live = [r for r in live if r.buf is not None]
            if not live:
                break
            bound = min((r.tail() for r in live), key=_bound_key)
            pieces = [p for r in live
                      if (p := r.take_upto(bound)) is not None]
            merged = _merge_sorted(pieces, by, device)
            counters.mem(merged.nbytes())       # the working set's peak
            counters.mem(-merged.nbytes())
            yield merged
            live = [r for r in live if not r.exhausted()]
    finally:
        for r in runs:
            r.drop()


def _merge_sorted(pieces: List[KVFrame], by: str, device=None) -> KVFrame:
    """Sorted pieces (in run order) → one sorted frame: concatenated,
    then one stable sort, so equal keys keep run order."""
    if len(pieces) == 1:
        return pieces[0]
    fr = KVFrame(concat([p.key for p in pieces]),
                 concat([p.value for p in pieces]))
    return fr.take(sort_order(fr.key if by == "key" else fr.value, device))


def group_sorted(fr: KVFrame) -> KMVFrame:
    """Group a frame already sorted by key: one group per run of equal
    keys (a ``[n, w]`` key differs where any column does; objects by
    their pickles), values in row order."""
    n = len(fr)
    if n == 0:
        return KMVFrame(fr.key, np.zeros(0, np.int64),
                        np.zeros(1, np.int64), fr.value)
    if isinstance(fr.key, DenseColumn):
        k = fr.key.data
        ne = k[1:] != k[:-1]
        new = ne if ne.ndim == 1 else np.any(ne, axis=1)
    else:
        rows = fr.key.pickles() if isinstance(fr.key, ObjectColumn) \
            else fr.key.tolist()
        new = np.fromiter((a != b for a, b in zip(rows[1:], rows[:-1])),
                          bool, count=n - 1)
    starts = np.flatnonzero(np.concatenate([[True], new]))
    offsets = np.concatenate([starts, [n]]).astype(np.int64)
    ukey = fr.key.take(starts)
    if isinstance(ukey, DenseColumn) and not isinstance(fr.value,
                                                        DenseColumn):
        # the JAX package groups such a frame by Python rows and rebuilds
        # the keys with np.asarray (ops/segment.group_bytes): the same
        # dtype here
        ukey = DenseColumn(np.asarray(ukey.tolist()))
    return KMVFrame(ukey, np.diff(offsets), offsets, fr.value)


def group_stream(chunks: Iterator[KVFrame]) -> Iterator[KMVFrame]:
    """Sorted KV chunks → KMV frames cut on group boundaries: each
    chunk's trailing group waits for the next chunk, so no group is ever
    split across frames (a group larger than a chunk stays one frame)."""
    pending: Optional[KVFrame] = None
    for chunk in chunks:
        if pending is not None:
            chunk = KVFrame(concat([pending.key, chunk.key]),
                            concat([pending.value, chunk.value]))
            pending = None
        if len(chunk) == 0:
            continue
        sur = sort_surrogate(chunk.key)
        first_of_last = int(np.searchsorted(sur, sur[-1], side="left"))
        if first_of_last > 0:
            pending = chunk.slice(first_of_last, len(chunk))
            yield group_sorted(chunk.slice(0, first_of_last))
        else:
            pending = chunk
    if pending is not None and len(pending):
        yield group_sorted(pending)
