"""Host columns: the counterpart of ``gpu_mapreduce_tpu/core/column.py``.

* :class:`DenseColumn` — a 1-D or 2-D numpy array of any numeric dtype
  (u64 stays u64 on the host).
* :class:`BytesColumn` — per-row byte strings held **packed**: one uint8
  buffer and int64 offsets ``[n+1]``, row i being
  ``buf[offsets[i]:offsets[i+1]]``.  Buffer and offsets are numpy arrays
  on the host or torch tensors on a device (``read_words`` splits a file
  on the card straight into one).
* :class:`ObjectColumn` — arbitrary Python rows, compared, grouped and
  sorted by their ``pickle.dumps(row, protocol=4)`` (the reference's
  Python wrapper pickles every key and value).

A text column interns to u64 ids for the device tiers
(``ops/hash.intern_packed``, on the column's device): the ids are
``hash_bytes64`` of the row's bytes (of its pickle for objects), and an
:class:`InternTable` maps each id back to its row.  Device-resident data
lives in the sharded frames (``parallel/sharded.py``).
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch

from .runtime import MRError


class DenseColumn:
    __slots__ = ("data",)

    def __init__(self, data):
        data = np.asarray(data)
        if data.ndim == 0:
            data = data.reshape(1)
        if data.ndim not in (1, 2):
            raise MRError(f"column rank must be 1 or 2, got {data.ndim}")
        if data.dtype == object or data.dtype.kind in "SUV":
            raise MRError(f"a dense column holds numbers, not "
                          f"{data.dtype}; text rows go in a BytesColumn")
        self.data = data

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def nbytes(self) -> int:
        return int(self.data.nbytes)

    def slice(self, start: int, stop: int) -> "DenseColumn":
        return DenseColumn(self.data[start:stop])

    def take(self, idx) -> "DenseColumn":
        return DenseColumn(self.data[np.asarray(idx)])

    def to_host(self) -> "DenseColumn":
        return self

    def tolist(self) -> list:
        if self.data.ndim == 1:
            return self.data.tolist()
        return [tuple(row) for row in self.data.tolist()]

    def __repr__(self):
        return f"DenseColumn<{self.data.dtype}{list(self.data.shape)}>"


def _to_bytes(r) -> bytes:
    if isinstance(r, bytes):
        return r
    if isinstance(r, str):
        return r.encode()
    if isinstance(r, (bytearray, memoryview)):
        return bytes(r)
    raise TypeError(f"a byte column row must be bytes or str, not "
                    f"{type(r).__name__}")


def pack_rows(rows: Sequence[bytes]):
    """Byte rows → (uint8 buffer, int64 offsets [n+1]) on the host."""
    lens = np.fromiter((len(r) for r in rows), np.int64, count=len(rows))
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    buf = np.frombuffer(b"".join(rows), np.uint8).copy()
    return buf, offsets


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(x)


class BytesColumn:
    """Packed byte-string rows (see the module docstring).  Built from a
    list of ``bytes``/``str`` (packed once, here) or, with
    :meth:`packed`, straight from a buffer and offsets."""

    __slots__ = ("buf", "offsets", "_nbytes")

    def __init__(self, rows: Sequence = ()):
        self.buf, self.offsets = pack_rows([_to_bytes(r) for r in rows])
        self._nbytes: Optional[int] = int(self.offsets[-1])

    @classmethod
    def packed(cls, buf, offsets, nbytes: Optional[int] = None
               ) -> "BytesColumn":
        """A column over ``buf``/``offsets`` as they are (both numpy, or
        both torch tensors on one device); ``nbytes`` saves a device read
        when the caller knows the rows' total length."""
        col = cls.__new__(cls)
        col.buf, col.offsets, col._nbytes = buf, offsets, nbytes
        return col

    @property
    def device(self) -> Optional[torch.device]:
        """The torch device of the buffer, or None on the host."""
        return self.buf.device if isinstance(self.buf, torch.Tensor) \
            else None

    def __len__(self) -> int:
        return int(self.offsets.shape[0]) - 1

    def nbytes(self) -> int:
        """Bytes of the rows (the reference's key/value byte count)."""
        if self._nbytes is None:
            self._nbytes = int(self.offsets[-1]) - int(self.offsets[0])
        return self._nbytes

    def to(self, device) -> "BytesColumn":
        """The same rows with buffer and offsets on torch ``device``."""
        device = torch.device(device)
        if self.device == device:
            return self
        return BytesColumn.packed(_as_tensor(self.buf).to(device),
                                  _as_tensor(self.offsets).to(device),
                                  self._nbytes)

    def to_host(self) -> "BytesColumn":
        """The rows on the host, packed from offset 0 (a slice copies
        only its own bytes)."""
        lo, hi = int(self.offsets[0]), int(self.offsets[-1])
        buf, off = self.buf[lo:hi], self.offsets - lo
        if self.device is not None:
            buf, off = buf.cpu().numpy(), off.cpu().numpy()
        return BytesColumn.packed(buf, off, hi - lo)

    def slice(self, start: int, stop: int) -> "BytesColumn":
        n = len(self)
        start, stop, _ = slice(start, stop).indices(n)
        stop = max(stop, start)
        return BytesColumn.packed(self.buf, self.offsets[start:stop + 1])

    def take(self, idx) -> "BytesColumn":
        """The rows at ``idx``, packed anew on the column's side."""
        buf, off = _as_tensor(self.buf), _as_tensor(self.offsets)
        idx = _as_tensor(np.asarray(idx, np.int64)
                         if not isinstance(idx, torch.Tensor) else idx)
        idx = idx.to(off.device, torch.int64)
        out_buf, out_off = gather_rows(buf, off, idx)
        if self.device is None:
            return BytesColumn.packed(out_buf.numpy(), out_off.numpy())
        return BytesColumn.packed(out_buf, out_off)

    def tolist(self) -> List[bytes]:
        host = self.to_host()
        raw, off = host.buf.tobytes(), host.offsets.tolist()
        return [raw[a:b] for a, b in zip(off[:-1], off[1:])]

    def intern(self, device=None):
        """Rows → (u64 ids as int64 bits [n] on ``device`` (default: the
        column's), :class:`InternTable` of kind ``"bytes"``).  The hash,
        the id sort and the collision check run on that device; only the
        unique rows' bytes come back to build the table."""
        from ..ops.hash import intern_packed
        col = self.to(device if device is not None
                      else (self.device or "cpu"))
        ids, uniq, first = intern_packed(col.buf, col.offsets)
        rows = BytesColumn.packed(*gather_rows(col.buf, col.offsets,
                                               first)).tolist()
        return ids, InternTable(zip(_u64_list(uniq), rows), kind="bytes")

    def __repr__(self):
        where = self.device or "host"
        return f"BytesColumn<n={len(self)}@{where}>"


def gather_rows(buf: torch.Tensor, offsets: torch.Tensor,
                idx: torch.Tensor):
    """Rows ``idx`` of a packed column → (buffer, offsets [len(idx)+1]),
    packed, on the column's device."""
    starts = offsets[:-1][idx]
    lens = offsets[1:][idx] - starts
    out_off = torch.zeros(idx.numel() + 1, dtype=torch.int64,
                          device=offsets.device)
    torch.cumsum(lens, 0, out=out_off[1:])
    total = int(out_off[-1]) if idx.numel() else 0
    if total == 0:
        return buf[:0].clone(), out_off
    pos = torch.repeat_interleave(starts - out_off[:-1], lens,
                                  output_size=total)
    pos += torch.arange(total, dtype=torch.int64, device=buf.device)
    return buf[pos], out_off


def _u64_list(ids: torch.Tensor) -> List[int]:
    """int64 bit patterns → Python ints of their u64 values."""
    return ids.cpu().numpy().view(np.uint64).tolist()


class InternTable(dict):
    """id → row table of an interned column; ``kind`` says whether the
    rows are raw bytes or arbitrary objects, so decoding rebuilds the
    right column type."""

    def __init__(self, *a, kind: str = "bytes", **kw):
        super().__init__(*a, **kw)
        self.kind = kind

    def decode_batch(self, ids) -> list:
        return [self[int(h)] for h in ids]


def dest_of_ids(ids: np.ndarray, P: int) -> np.ndarray:
    """The aggregate's destination shard of each u64 id: the host twin of
    the exchange's ``default_hash(keys) % P`` (``ops/hash.default_hash``),
    bit-equal to it."""
    from ..ops.hash import hash_u64
    ids = np.ascontiguousarray(np.asarray(ids, np.uint64))
    h = hash_u64(torch.from_numpy(ids.view(np.int64)))
    return (h % P).numpy().astype(np.int32)


class ShardTables:
    """Dest-sharded id → row tables of a mesh frame's interned column
    (the JAX package's ``ShardTables``, core/column.py:250-...): the
    entry of id h lives in ``tables[dest_of_ids(h) % P]``, the shard the
    default-hash aggregate routes h to, so after such an aggregate shard
    d's rows decode from ``tables[d]`` alone.  Every lookup routes by the
    same hash, so decoding is right on every path.  Reads like an
    :class:`InternTable` (``[]``, ``get``, ``in``, ``decode_batch``,
    ``keys``/``values``/``items``, ``kind``)."""

    def __init__(self, P: int, kind: str = "bytes"):
        self.P = P
        self.kind = kind
        self.tables = [InternTable(kind=kind) for _ in range(P)]

    @classmethod
    def from_table(cls, table, P: int) -> "ShardTables":
        """A one-device frame's table (or another ShardTables) routed
        over P shards."""
        out = cls(P, kind=table.kind)
        ids = np.fromiter(table.keys(), np.uint64, len(table))
        out.absorb(ids, table.decode_batch(ids))
        return out

    def absorb(self, ids: np.ndarray, rows: list) -> None:
        """Route (id, row) pairs into their tables; an id already held
        with another row (by bytes, or by pickle for objects) is a 64-bit
        intern collision (``ValueError``)."""
        if not len(ids):
            return
        dests = dest_of_ids(ids, self.P)
        for h, d, row in zip(np.asarray(ids, np.uint64).tolist(),
                             dests.tolist(), rows):
            t = self.tables[d]
            if h in t:
                prev = t[h]
                if self.kind == "object":
                    same = pickle.dumps(prev, protocol=4) == \
                        pickle.dumps(row, protocol=4)
                else:
                    same = prev == row
                if not same:
                    raise ValueError(
                        f"64-bit intern collision: {prev!r} vs {row!r}")
                continue
            t[h] = row

    def merge(self, other) -> "ShardTables":
        """Union with another table of the same id domain."""
        kind = "object" if "object" in (self.kind, other.kind) else "bytes"
        out = ShardTables(self.P, kind=kind)
        for src in (self, other):
            ids = np.fromiter(src.keys(), np.uint64, len(src))
            out.absorb(ids, src.decode_batch(ids))
        return out

    def shard(self, d: int) -> InternTable:
        return self.tables[d]

    def __getitem__(self, h):
        d = int(dest_of_ids(np.array([h], np.uint64), self.P)[0])
        return self.tables[d][h]

    def get(self, h, default=None):
        try:
            return self[h]
        except KeyError:
            return default

    def __contains__(self, h) -> bool:
        try:
            self[h]
            return True
        except KeyError:
            return False

    def __len__(self) -> int:
        return sum(len(t) for t in self.tables)

    def decode_batch(self, ids) -> list:
        """One destination computation for the whole id array, then the
        per-shard lookups."""
        ids = np.asarray(ids, np.uint64)
        dests = dest_of_ids(ids, self.P)
        tabs = self.tables
        return [tabs[d][h] for h, d in zip(ids.tolist(), dests.tolist())]

    def keys(self):
        for t in self.tables:
            yield from t.keys()

    def values(self):
        for t in self.tables:
            yield from t.values()

    def items(self):
        for t in self.tables:
            yield from t.items()

    def __repr__(self):
        return (f"ShardTables(P={self.P}, kind={self.kind}, "
                f"sizes={[len(t) for t in self.tables]})")


class ObjectColumn:
    """Arbitrary Python rows.  They compare, group and sort by their
    pickles (the reference's Python wrapper pickles every key and value,
    ``python/mrmpi.py:17-45``), so keys need not be hashable or
    orderable themselves."""

    __slots__ = ("data", "_pickles")

    def __init__(self, rows: Sequence = ()):
        self.data = list(rows)
        self._pickles: Optional[List[bytes]] = None

    def __len__(self) -> int:
        return len(self.data)

    def pickles(self) -> List[bytes]:
        """Per-row pickles, computed once."""
        if self._pickles is None:
            self._pickles = [pickle.dumps(x, protocol=4) for x in self.data]
        return self._pickles

    def nbytes(self) -> int:
        return int(sum(len(p) for p in self.pickles()))

    def slice(self, start: int, stop: int) -> "ObjectColumn":
        return ObjectColumn(self.data[start:stop])

    def take(self, idx) -> "ObjectColumn":
        return ObjectColumn([self.data[int(i)] for i in np.asarray(idx)])

    def to_host(self) -> "ObjectColumn":
        return self

    def tolist(self) -> list:
        return list(self.data)

    def intern(self, device=None):
        """Rows → (ids on ``device``, InternTable of kind ``"object"``):
        the pickles pack once and intern as bytes do."""
        from ..ops.hash import intern_packed
        buf, off = pack_rows(self.pickles())
        device = torch.device(device or "cpu")
        ids, uniq, first = intern_packed(torch.from_numpy(buf).to(device),
                                         torch.from_numpy(off).to(device))
        rows = [self.data[i] for i in first.tolist()]
        return ids, InternTable(zip(_u64_list(uniq), rows), kind="object")

    def __repr__(self):
        return f"ObjectColumn<n={len(self)}>"


TEXT_COLUMNS = (BytesColumn, ObjectColumn)


def _concat_bytes(cols: List[BytesColumn]) -> BytesColumn:
    """Packed concat: on the first device column's device when any
    column is on a device, else on the host."""
    device = next((c.device for c in cols if c.device is not None), None)
    if device is None:
        bufs, offs, base = [], [np.zeros(1, np.int64)], 0
        for c in cols:
            lo, hi = int(c.offsets[0]), int(c.offsets[-1])
            bufs.append(c.buf[lo:hi])
            offs.append(c.offsets[1:] - lo + base)
            base += hi - lo
        return BytesColumn.packed(np.concatenate(bufs), np.concatenate(offs),
                                  base)
    cols = [c.to(device) for c in cols]
    bufs, offs, base = [], [torch.zeros(1, dtype=torch.int64,
                                        device=device)], 0
    for c in cols:
        lo, hi = int(c.offsets[0]), int(c.offsets[-1])
        bufs.append(c.buf[lo:hi])
        offs.append(c.offsets[1:] - lo + base)
        base += hi - lo
    return BytesColumn.packed(torch.cat(bufs), torch.cat(offs), base)


def concat(cols):
    """Rows of several columns in order.  Bytes with objects promote to
    objects (bytes are picklable objects); text with numbers raises
    ``TypeError``."""
    cols = [c for c in cols if len(c) > 0] or list(cols[:1])
    if len(cols) == 1:
        return cols[0]
    if any(isinstance(c, ObjectColumn) for c in cols):
        if not all(isinstance(c, TEXT_COLUMNS) for c in cols):
            raise TypeError("cannot concat object rows with numeric rows")
        return ObjectColumn([r for c in cols for r in c.tolist()])
    if isinstance(cols[0], BytesColumn):
        if not all(isinstance(c, BytesColumn) for c in cols):
            raise TypeError("cannot concat byte rows with numeric rows")
        return _concat_bytes(cols)
    if not all(isinstance(c, DenseColumn) for c in cols):
        raise TypeError("cannot concat numeric rows with byte or object "
                        "rows")
    return DenseColumn(np.concatenate([c.data for c in cols], axis=0))


def as_column(x):
    """Coerce user data to a column: bytes/str (or a sequence starting
    with one, or an object array) → BytesColumn; numbers → DenseColumn."""
    if isinstance(x, (DenseColumn, BytesColumn, ObjectColumn)):
        return x
    if isinstance(x, (bytes, str)):
        return BytesColumn([x])
    if isinstance(x, np.ndarray):
        return BytesColumn(x.tolist()) if x.dtype == object \
            else DenseColumn(x)
    if isinstance(x, (list, tuple)) and len(x) > 0 \
            and isinstance(x[0], (bytes, str)):
        return BytesColumn(x)
    return DenseColumn(np.asarray(x))


def empty_like(col):
    if isinstance(col, BytesColumn):
        return BytesColumn([])
    if isinstance(col, ObjectColumn):
        return ObjectColumn([])
    data = col.data
    shape = (0,) if data.ndim == 1 else (0, data.shape[1])
    return DenseColumn(np.zeros(shape, dtype=data.dtype))
