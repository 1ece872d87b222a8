"""KV and KMV frames on the host: the in-memory unit of data.

The counterpart of ``gpu_mapreduce_tpu/core/frame.py``, over dense, byte
and object columns (``core/column.py``): ``pairs()`` and ``groups()``
yield Python scalars, tuples, ``bytes`` or the objects.  KMV layout:
unique keys ``[g]``, per-group counts ``[g]``, exclusive offsets
``[g+1]`` and a flat value column whose rows are grouped contiguously.
:class:`BlockedMultivalue` hands a reduce callback one large group in
blocks (the reference's multi-page "extended" KMV).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .column import DenseColumn, as_column
from .runtime import MRError


class KVFrame:
    """Immutable batch of (key, value) pairs."""

    __slots__ = ("key", "value")

    def __init__(self, key, value):
        key, value = as_column(key), as_column(value)
        if len(key) != len(value):
            raise MRError(f"key/value lengths differ: {len(key)} vs "
                          f"{len(value)}")
        self.key = key
        self.value = value

    def __len__(self) -> int:
        return len(self.key)

    def nbytes(self) -> int:
        """Bytes of the rows: numbers by their width, byte rows by their
        length, objects by their pickle's."""
        return self.key.nbytes() + self.value.nbytes()

    def is_dense(self) -> bool:
        return isinstance(self.key, DenseColumn) and \
            isinstance(self.value, DenseColumn)

    def to_host(self) -> "KVFrame":
        """The frame with every column on the host (a byte column split
        on a device comes back)."""
        return KVFrame(self.key.to_host(), self.value.to_host())

    def take(self, idx) -> "KVFrame":
        return KVFrame(self.key.take(idx), self.value.take(idx))

    def slice(self, start: int, stop: int) -> "KVFrame":
        return KVFrame(self.key.slice(start, stop),
                       self.value.slice(start, stop))

    def head(self, n: int) -> "KVFrame":
        """The first ``n`` pairs."""
        return self.slice(0, n)

    def pairs(self) -> Iterator[Tuple[object, object]]:
        """(key, value) as Python scalars — the per-pair callback view."""
        yield from zip(self.key.tolist(), self.value.tolist())

    def __repr__(self):
        return f"KVFrame(n={len(self)}, key={self.key!r}, value={self.value!r})"


class KMVFrame:
    """Immutable batch of (key, multivalue) groups; group i's values are
    ``values[offsets[i]:offsets[i+1]]``."""

    __slots__ = ("key", "nvalues", "offsets", "values")

    def __init__(self, key, nvalues, offsets, values):
        self.key = as_column(key)
        self.nvalues = np.asarray(nvalues, dtype=np.int64)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.values = as_column(values)
        if len(self.offsets) != len(self.key) + 1:
            raise MRError("KMVFrame offsets must have one entry per group "
                          "plus one")

    def __len__(self) -> int:
        return len(self.key)

    @property
    def nvalues_total(self) -> int:
        return len(self.values)

    def nbytes(self) -> int:
        return self.key.nbytes() + self.values.nbytes() + \
            int(self.nvalues.nbytes)

    def is_dense(self) -> bool:
        return isinstance(self.key, DenseColumn) and \
            isinstance(self.values, DenseColumn)

    def to_host(self) -> "KMVFrame":
        return KMVFrame(self.key.to_host(), self.nvalues, self.offsets,
                        self.values.to_host())

    def group_values(self, i: int):
        return self.values.slice(int(self.offsets[i]),
                                 int(self.offsets[i + 1]))

    def groups(self) -> Iterator[Tuple[object, list]]:
        """(key, [values]) per group — the per-group reduce view."""
        keys = self.key.tolist()
        vals = self.values.tolist()
        for i, k in enumerate(keys):
            yield k, vals[int(self.offsets[i]):int(self.offsets[i + 1])]

    def blocks_of(self, i: int, block_rows: int) -> Iterator[object]:
        """Group ``i``'s values in blocks of at most ``block_rows`` rows
        (reference multivalue_blocks()/multivalue_block(),
        src/mapreduce.cpp:1874-1925)."""
        start, stop = int(self.offsets[i]), int(self.offsets[i + 1])
        for s in range(start, stop, block_rows):
            yield self.values.slice(s, min(s + block_rows, stop))

    def __repr__(self):
        return (f"KMVFrame(g={len(self)}, n={self.nvalues_total}, "
                f"key={self.key!r}, values={self.values!r})")


class BlockedMultivalue:
    """What a reduce callback gets instead of a value list for a group of
    more than ``block_rows`` values (the reference signals it with
    ``nvalues == 0`` and the callback pulls the pages,
    src/mapreduce.cpp:1874-1925): iterating yields one value list per
    block."""

    __slots__ = ("_frame", "_i", "block_rows")

    def __init__(self, frame: KMVFrame, i: int, block_rows: int):
        self._frame = frame
        self._i = i
        self.block_rows = block_rows

    @property
    def nvalues_total(self) -> int:
        return int(self._frame.nvalues[self._i])

    def __len__(self) -> int:
        return self.nvalues_total

    def __iter__(self):
        for col in self._frame.blocks_of(self._i, self.block_rows):
            yield col.tolist()


def iter_blocks(multivalue) -> Iterator[list]:
    """Value-list blocks of a reduce callback's multivalue, whether it is
    a plain list or a :class:`BlockedMultivalue` (oink/blockmacros.h's
    block loop as one generator)."""
    if isinstance(multivalue, BlockedMultivalue):
        yield from multivalue
    else:
        yield multivalue


def empty_kv() -> KVFrame:
    return KVFrame(np.zeros(0, np.uint64), np.zeros(0, np.uint64))
