"""Device-resident frames: padded row blocks + valid counts.

The counterpart of ``gpu_mapreduce_tpu/parallel/sharded.py``.  A
one-device frame (:class:`ShardedKV`, :class:`ShardedKMV`) holds torch
tensors on its device and a host ``counts[1]`` saying how many leading
rows are valid; the rest is padding.  A mesh frame (:class:`MeshKV`,
:class:`MeshKMV`) holds one such frame per shard of a
:class:`~.mesh.Mesh`, all with one cap, so shard p's padded block and
``counts[p]`` are the JAX frame's rows ``[p*cap, (p+1)*cap)`` and its
``counts[p]``; every one-device body runs on it shard by shard.  Caps are
powers of two (min 8).

Torch has no u64 arithmetic, so a u64 key column is held as int64 with
the same bits; ``key_dtype``/``value_dtype`` name the logical numpy dtype
and the host copies (``to_host``) are reinterpreted as it.

Byte and object columns live on the device as interned u64 ids
(``core/column.py``): ``key_decode``/``value_decode`` hold the id → row
:class:`~..core.column.InternTable` (a mesh frame's, a dest-sharded
:class:`~..core.column.ShardTables`), and the host copies decode through
it (``head(n)`` decodes only its n rows).  A frame's ``nbytes`` is that
of its padded tensors, as in the JAX package.  :class:`SyncStats` counts
the mesh ops' host pulls of device metadata.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..core.column import (BytesColumn, DenseColumn, InternTable,
                           ObjectColumn, ShardTables, TEXT_COLUMNS)
from ..core.frame import KMVFrame, KVFrame
from ..ops.bits import storage_dtype, to_numpy, to_torch


class SyncStats:
    """Host pulls of device metadata in the mesh tier (the JAX package's
    ``SyncStats``, parallel/sharded.py:46-67): an exchange pulls its
    count matrix once and a mesh convert its group counts once — the
    reference ends each op in one MPI_Allreduce
    (src/mapreduce.cpp:557-558)."""

    pulls = 0
    _lock = threading.Lock()

    @classmethod
    def bump(cls, n: int = 1) -> None:
        with cls._lock:
            cls.pulls += n

    @classmethod
    def snapshot(cls) -> int:
        return cls.pulls

    @classmethod
    def delta(cls, snap: int) -> int:
        return cls.pulls - snap


def _decode_col(table: InternTable, ids: np.ndarray):
    """id → row decode; the table's kind (never a first-row guess) picks
    a byte or an object column."""
    rows = table.decode_batch(ids)
    return ObjectColumn(rows) if table.kind == "object" \
        else BytesColumn(rows)


def _host_col(t: torch.Tensor, dtype, table):
    """Device rows → a host column in the logical dtype, decoded when the
    column is interned."""
    arr = to_numpy(t, dtype)
    return _decode_col(table, arr) if table is not None \
        else DenseColumn(arr)


def _tensor_nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def round_cap(n: int) -> int:
    """Round a capacity up to a power of two (min 8)."""
    cap = 8
    while cap < n:
        cap <<= 1
    return cap


@dataclass
class ShardedKV:
    """KV frame on one device: ``key``/``value`` [cap] + ``counts`` [1]."""

    key: torch.Tensor
    value: torch.Tensor
    counts: np.ndarray
    key_dtype: np.dtype = np.dtype(np.uint64)
    value_dtype: np.dtype = np.dtype(np.uint64)
    key_decode: InternTable = None      # id → key row (interned keys)
    value_decode: InternTable = None    # id → value row (interned values)

    nprocs = 1

    @property
    def device(self) -> torch.device:
        return self.key.device

    @property
    def cap(self) -> int:
        return self.key.shape[0]

    def __len__(self) -> int:
        return int(self.counts.sum())

    def nbytes(self) -> int:
        """Bytes of the padded key and value tensors."""
        return _tensor_nbytes(self.key, self.value)

    def to_host(self) -> KVFrame:
        """Exact host KVFrame of the valid rows, in logical dtypes,
        interned columns decoded."""
        return self._host_rows(len(self))

    def _host_rows(self, n: int) -> KVFrame:
        return KVFrame(_host_col(self.key[:n], self.key_dtype,
                                 self.key_decode),
                       _host_col(self.value[:n], self.value_dtype,
                                 self.value_decode))

    def shard_to_host(self, p: int) -> KVFrame:
        if p != 0:
            raise IndexError(f"shard {p} of a one-device frame")
        return self.to_host()

    def valid_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The valid (key, value) rows on the device."""
        n = len(self)
        return self.key[:n], self.value[:n]

    def head(self, n: int) -> KVFrame:
        """The first ``n`` valid pairs on the host (one small copy; only
        those rows decode)."""
        return self._host_rows(min(n, len(self)))

    def pairs(self) -> Iterator[Tuple[object, object]]:
        yield from self.to_host().pairs()

    def __repr__(self):
        return (f"ShardedKV(cap={self.cap}, counts={self.counts.tolist()}, "
                f"device={self.device})")


@dataclass
class ShardedKMV:
    """KMV frame on one device: groups ``ukey[:gcounts[0]]`` with value
    runs in ``values`` located by ``voffsets``/``nvalues``."""

    ukey: torch.Tensor        # [gcap]
    nvalues: torch.Tensor     # [gcap] int32
    voffsets: torch.Tensor    # [gcap] int32
    values: torch.Tensor      # [vcap]
    gcounts: np.ndarray       # host [1]
    vcounts: np.ndarray       # host [1]
    key_dtype: np.dtype = np.dtype(np.uint64)
    value_dtype: np.dtype = np.dtype(np.uint64)
    key_decode: InternTable = None      # see ShardedKV
    value_decode: InternTable = None

    nprocs = 1

    @property
    def device(self) -> torch.device:
        return self.ukey.device

    @property
    def gcap(self) -> int:
        return self.ukey.shape[0]

    @property
    def vcap(self) -> int:
        return self.values.shape[0]

    def __len__(self) -> int:
        return int(self.gcounts.sum())

    @property
    def nvalues_total(self) -> int:
        return int(self.vcounts.sum())

    def nbytes(self) -> int:
        """Bytes of the padded tensors: group keys, sizes, offsets and
        values."""
        return _tensor_nbytes(self.ukey, self.nvalues, self.voffsets,
                              self.values)

    def to_host(self) -> KMVFrame:
        """Exact host KMVFrame: one ragged gather of each group's run,
        interned columns decoded."""
        g = len(self)
        nv = self.nvalues[:g].cpu().numpy().astype(np.int64)
        vo = self.voffsets[:g].cpu().numpy().astype(np.int64)
        vals = to_numpy(self.values[:self.nvalues_total], self.value_dtype)
        offsets = np.concatenate([[0], np.cumsum(nv)]).astype(np.int64)
        idx = (np.repeat(vo - offsets[:-1], nv)
               + np.arange(int(offsets[-1]), dtype=np.int64))
        vals = vals[idx]
        values = _decode_col(self.value_decode, vals) \
            if self.value_decode is not None else DenseColumn(vals)
        return KMVFrame(_host_col(self.ukey[:g], self.key_dtype,
                                  self.key_decode), nv, offsets, values)

    def shard_to_host(self, p: int) -> KMVFrame:
        if p != 0:
            raise IndexError(f"shard {p} of a one-device frame")
        return self.to_host()

    def groups(self):
        yield from self.to_host().groups()

    def group_values(self, i: int):
        return self.to_host().group_values(i)

    def __repr__(self):
        return (f"ShardedKMV(gcap={self.gcap}, g={len(self)}, "
                f"n={self.nvalues_total}, device={self.device})")


def pad_rows(t: torch.Tensor, cap: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``cap`` rows (itself when it
    has them already)."""
    if t.shape[0] == cap:
        return t
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:t.shape[0]] = t
    return out


def place_column(col, device):
    """A host column → (tensor on ``device``, logical dtype, intern table
    or None): a byte or object column interns on the device."""
    if isinstance(col, TEXT_COLUMNS):
        ids, table = col.intern(device)
        return ids, np.dtype(np.uint64), table
    return to_torch(col.data, device), col.data.dtype, None


def shard_frame(frame: KVFrame, device) -> ShardedKV:
    """Place a host KVFrame on ``device`` (padded to a power-of-two cap),
    interning byte and object columns."""
    n = len(frame)
    cap = round_cap(n)
    k, kd, kt = place_column(frame.key, device)
    v, vd, vt = place_column(frame.value, device)
    return ShardedKV(pad_rows(k, cap), pad_rows(v, cap),
                     np.array([n], np.int32), kd, vd, kt, vt)


def shard_frames(frames: Sequence[KVFrame], device) -> ShardedKV:
    """Host frames of dense columns of one dtype and row shape → one
    frame on ``device``: each frame's rows copy straight into its place
    in the padded tensors (no concatenation on the host)."""
    n = sum(len(f) for f in frames)
    cap = round_cap(n)
    cols = []
    for name in ("key", "value"):
        first = getattr(frames[0], name).data
        out = torch.zeros((cap,) + first.shape[1:],
                          dtype=storage_dtype(first.dtype), device=device)
        at = 0
        for f in frames:
            data = getattr(f, name).data
            out[at:at + len(data)] = to_torch(data, "cpu")
            at += len(data)
        cols.append(out)
    return ShardedKV(cols[0], cols[1], np.array([n], np.int32),
                     frames[0].key.data.dtype, frames[0].value.data.dtype)


def _logical_dtype(t: torch.Tensor, dtype) -> np.dtype:
    if dtype is not None:
        return np.dtype(dtype)
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def tensor_frame(key: torch.Tensor, value: torch.Tensor, key_dtype=None,
                 value_dtype=None) -> ShardedKV:
    """Key/value tensors (all rows valid) as a frame on their device,
    padded to a power-of-two cap; a ``None`` logical dtype is the
    tensor's own."""
    if key.shape[0] != value.shape[0]:
        from ..core.runtime import MRError
        raise MRError(f"key/value lengths differ: {key.shape[0]} vs "
                      f"{value.shape[0]}")
    n = key.shape[0]
    cap = round_cap(n)
    return ShardedKV(pad_rows(key, cap), pad_rows(value, cap),
                     np.array([n], np.int32),
                     _logical_dtype(key, key_dtype),
                     _logical_dtype(value, value_dtype))


def concat_sharded(frames: Sequence[ShardedKV]) -> ShardedKV:
    """Valid rows of several device frames, in order, as one frame.
    Interned columns align their id domains first and their tables merge
    (``parallel/devkernels._align_domains``).  Mesh frames concatenate
    shard by shard (``parallel/backend.concat_mesh``)."""
    if isinstance(frames[0], MeshKV):
        from .backend import concat_mesh
        return concat_mesh(list(frames))
    from .devkernels import _align_domains
    first = frames[0]
    keys, kt = _align_domains(frames, "key")
    values, vt = _align_domains(frames, "value")
    n = sum(len(f) for f in frames)
    cap = round_cap(n)
    key = keys[0].new_zeros((cap,) + tuple(keys[0].shape[1:]))
    value = values[0].new_zeros((cap,) + tuple(values[0].shape[1:]))
    at = 0
    for f, k, v in zip(frames, keys, values):
        m = len(f)             # straight into the padded result: one copy
        key[at:at + m] = k[:m]
        value[at:at + m] = v[:m]
        at += m
    return ShardedKV(key, value, np.array([n], np.int32), first.key_dtype,
                     first.value_dtype, kt, vt)


# ---------------------------------------------------------------------------
# mesh frames: one one-device frame per shard, one cap
# ---------------------------------------------------------------------------

def _host_concat(arrs, dtype, table):
    """Per-shard host arrays → one column in shard order, decoded once
    when the column is interned."""
    arr = np.concatenate(arrs) if arrs else np.zeros(0, dtype)
    return _decode_col(table, arr) if table is not None \
        else DenseColumn(arr)


@dataclass
class MeshKV:
    """KV frame over a mesh: ``shards[p]`` is a one-device
    :class:`ShardedKV` on ``mesh.devices[p]``; every shard has the same
    cap, dtypes and decode tables.  ``exchange_stats`` carries the
    telemetry of the exchange that made it, if one did."""

    mesh: object
    shards: List[ShardedKV]
    exchange_stats: object = field(default=None, compare=False)

    @property
    def nprocs(self) -> int:
        return len(self.shards)

    @property
    def cap(self) -> int:
        return self.shards[0].cap

    @property
    def counts(self) -> np.ndarray:
        return np.array([int(s.counts[0]) for s in self.shards], np.int32)

    @property
    def key_dtype(self):
        return self.shards[0].key_dtype

    @property
    def value_dtype(self):
        return self.shards[0].value_dtype

    @property
    def key_decode(self):
        return self.shards[0].key_decode

    @property
    def value_decode(self):
        return self.shards[0].value_decode

    def __len__(self) -> int:
        return int(self.counts.sum())

    def nbytes(self) -> int:
        """Bytes of every shard's padded key and value blocks."""
        return sum(s.nbytes() for s in self.shards)

    def to_host(self) -> KVFrame:
        """Exact host KVFrame of the valid rows, shard by shard."""
        return self._host_rows([int(c) for c in self.counts])

    def _host_rows(self, ns) -> KVFrame:
        ks = [to_numpy(s.key[:n], s.key_dtype)
              for s, n in zip(self.shards, ns)]
        vs = [to_numpy(s.value[:n], s.value_dtype)
              for s, n in zip(self.shards, ns)]
        return KVFrame(_host_concat(ks, self.key_dtype, self.key_decode),
                       _host_concat(vs, self.value_dtype,
                                    self.value_decode))

    def shard_to_host(self, p: int) -> KVFrame:
        """Host KVFrame of shard p's valid rows."""
        return self.shards[p].to_host()

    def valid_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every shard's valid (key, value) rows in shard order, joined on
        the first shard's device."""
        dev = self.shards[0].device
        rows = [s.valid_rows() for s in self.shards]
        return tuple(torch.cat([r[c].to(dev, non_blocking=True)
                                for r in rows]) for c in (0, 1))

    def joined(self) -> ShardedKV:
        """The valid rows in shard order as one frame on the first
        shard's device (the rows :meth:`to_host` gives, kept on the
        device)."""
        s = self.shards[0]
        return ShardedKV(*(pad_rows(t, round_cap(len(self)))
                           for t in self.valid_rows()),
                         np.array([len(self)], np.int32), s.key_dtype,
                         s.value_dtype, s.key_decode, s.value_decode)

    def head(self, n: int) -> KVFrame:
        """The first ``n`` valid pairs in shard order (only they copy and
        decode)."""
        ns = []
        for c in self.counts:
            take = min(int(c), n)
            ns.append(take)
            n -= take
        return self._host_rows(ns)

    def pairs(self) -> Iterator[Tuple[object, object]]:
        yield from self.to_host().pairs()

    def __repr__(self):
        return (f"MeshKV(P={self.nprocs}, cap={self.cap}, "
                f"counts={self.counts.tolist()})")


@dataclass
class MeshKMV:
    """KMV frame over a mesh: ``shards[p]`` is a one-device
    :class:`ShardedKMV` on ``mesh.devices[p]``, every shard with the same
    gcap (the mesh-wide one) and vcap."""

    mesh: object
    shards: List[ShardedKMV]

    @property
    def nprocs(self) -> int:
        return len(self.shards)

    @property
    def gcap(self) -> int:
        return self.shards[0].gcap

    @property
    def vcap(self) -> int:
        return self.shards[0].vcap

    @property
    def gcounts(self) -> np.ndarray:
        return np.array([int(s.gcounts[0]) for s in self.shards], np.int32)

    @property
    def vcounts(self) -> np.ndarray:
        return np.array([int(s.vcounts[0]) for s in self.shards], np.int32)

    @property
    def key_dtype(self):
        return self.shards[0].key_dtype

    @property
    def value_dtype(self):
        return self.shards[0].value_dtype

    @property
    def key_decode(self):
        return self.shards[0].key_decode

    @property
    def value_decode(self):
        return self.shards[0].value_decode

    def __len__(self) -> int:
        return int(self.gcounts.sum())

    @property
    def nvalues_total(self) -> int:
        return int(self.vcounts.sum())

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.shards)

    def to_host(self) -> KMVFrame:
        """Exact host KMVFrame: the shards' groups in shard order."""
        parts = [s.to_host() for s in self.shards]
        from ..core.column import concat
        nv = np.concatenate([p.nvalues for p in parts]).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(nv)]).astype(np.int64)
        return KMVFrame(concat([p.key for p in parts]), nv, offsets,
                        concat([p.values for p in parts]))

    def shard_to_host(self, p: int) -> KMVFrame:
        return self.shards[p].to_host()

    def groups(self):
        for s in self.shards:
            yield from s.groups()

    def group_values(self, i: int):
        return self.to_host().group_values(i)

    def __repr__(self):
        return (f"MeshKMV(P={self.nprocs}, gcap={self.gcap}, g={len(self)}, "
                f"n={self.nvalues_total})")


def mesh_tables(table, P: int):
    """A decode table as the dest-sharded tables of a P-shard mesh frame
    (None stays None)."""
    if table is None or (isinstance(table, ShardTables) and table.P == P):
        return table
    return ShardTables.from_table(table, P)


def mesh_kv(mesh, keys: Sequence[torch.Tensor],
            values: Sequence[torch.Tensor], counts, key_dtype, value_dtype,
            key_decode=None, value_decode=None, cap: int = None) -> MeshKV:
    """A mesh frame from each shard's rows (tensors on the shard's
    device, at least ``counts[p]`` rows): every block padded with zeros
    to ``cap`` (default: the power of two over the largest count)."""
    counts = [int(c) for c in counts]
    if cap is None:
        cap = round_cap(max(counts) if counts else 0)
    shards = []
    for k, v, n in zip(keys, values, counts):
        kb = k.new_zeros((cap,) + tuple(k.shape[1:]))
        vb = v.new_zeros((cap,) + tuple(v.shape[1:]))
        kb[:n] = k[:n]
        vb[:n] = v[:n]
        shards.append(ShardedKV(kb, vb, np.array([n], np.int32),
                                np.dtype(key_dtype), np.dtype(value_dtype),
                                key_decode, value_decode))
    return MeshKV(mesh, shards)


def split_to_mesh(skv: ShardedKV, mesh, counts=None) -> MeshKV:
    """A one-device frame's valid rows over the mesh: shard p takes the
    next ``counts[p]`` rows (default: the contiguous ``ceil(n/P)`` split
    of ``shard_frame``, JAX parallel/sharded.py:344-353), copied device to
    device; decode tables become dest-sharded."""
    P = mesh.size
    n = len(skv)
    if counts is None:
        per = -(-n // P) if n else 0
        starts = np.minimum(np.arange(P) * per, n)
        counts = np.minimum(starts + per, n) - starts
    counts = np.asarray(counts, np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    keys, values = [], []
    for p, dev in enumerate(mesh.devices):
        lo, hi = int(offs[p]), int(offs[p + 1])
        keys.append(skv.key[lo:hi].to(dev, non_blocking=True))
        values.append(skv.value[lo:hi].to(dev, non_blocking=True))
    return mesh_kv(mesh, keys, values, counts, skv.key_dtype,
                   skv.value_dtype, mesh_tables(skv.key_decode, P),
                   mesh_tables(skv.value_decode, P))


def shard_frame_mesh(frame: KVFrame, mesh) -> MeshKV:
    """A host KVFrame over the mesh, contiguous ``ceil(n/P)`` split; text
    columns intern on the first shard's device before the split (the JAX
    package's ``_intern_frame`` then ``shard_frame``)."""
    return split_to_mesh(shard_frame(frame, mesh.devices[0]), mesh)


def shard_frame_with_counts(frame: KVFrame, mesh, counts) -> MeshKV:
    """A host KVFrame over the mesh with an explicit partition: shard p
    takes the next ``counts[p]`` rows (JAX parallel/sharded.py:356-376)."""
    return split_to_mesh(shard_frame(frame, mesh.devices[0]), mesh, counts)
