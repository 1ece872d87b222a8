"""KeyValue / KeyMultiValue datasets: frame lists with an add/complete
protocol, held in core (out-of-core spill comes with a later slice).

The in-core subset of ``gpu_mapreduce_tpu/core/dataset.py``.  A dataset's
frames are host ``KVFrame``/``KMVFrame``s or device-resident
``ShardedKV``/``ShardedKMV`` (``parallel/sharded.py``).  Byte counts
follow the JAX package: a host frame counts its rows (text by its
length, objects by their pickles), a device frame its padded tensors.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from .column import BytesColumn, DenseColumn, ObjectColumn, concat
from .frame import KVFrame, empty_kv


def rows_to_array(rows: list) -> np.ndarray:
    """np.asarray for scalar/tuple rows that refuses numpy's silent
    int→float64 fallback: a Python-int list straddling 2^63 (u64 ids next
    to small counts) becomes exact uint64 instead."""
    arr = np.asarray(rows)

    def _u64able(e):
        return isinstance(e, (int, np.integer)) and 0 <= int(e) < (1 << 64)

    if arr.dtype == np.float64 and all(
            _u64able(r) or (isinstance(r, tuple)
                            and all(_u64able(e) for e in r))
            for r in rows):
        arr = np.asarray(rows, dtype=np.uint64)
    return arr


def _coerce_rows(rows: list):
    """A Python add buffer → a column: bytes/str → BytesColumn; None →
    u8 zeros (the NULL value); numbers and uniform tuples → DenseColumn;
    anything else (mixed types, ragged tuples, dicts, ...) → ObjectColumn,
    the pickle tier (reference python/mrmpi.py:17-45)."""
    first = rows[0]
    if isinstance(first, (bytes, str, bytearray)):
        if all(isinstance(r, (bytes, str, bytearray, memoryview))
               for r in rows):
            return BytesColumn(rows)
        # mixed with non-string rows: arbitrary objects
        return ObjectColumn(rows)
    if first is None:
        return DenseColumn(np.zeros(len(rows), dtype=np.uint8))
    try:
        arr = rows_to_array(rows)
    except (ValueError, OverflowError):
        return ObjectColumn(rows)
    if arr.dtype == object or arr.dtype.kind in "USV":
        # numpy stringifies mixed tuples like ('a', 1): keep the rows
        return ObjectColumn(rows)
    return DenseColumn(arr)


def _merge_frames(frames: List[KVFrame]) -> KVFrame:
    if len(frames) == 1:
        return frames[0]
    return KVFrame(concat([f.key for f in frames]),
                   concat([f.value for f in frames]))


class KeyValue:
    """Append-only KV dataset.  ``device`` is where its MapReduce keeps
    data: a callback that is handed a host frame places it there."""

    def __init__(self, device=None):
        self.device = device
        self._buf_k: list = []
        self._buf_v: list = []
        self._batches: list = []
        self._frames: list = []
        self.nkv = 0
        self.complete_done = False

    def add(self, key, value) -> None:
        """Add one pair (reference kv->add)."""
        self._buf_k.append(key)
        self._buf_v.append(value)

    def add_batch(self, keys, values, key_dtype=None,
                  value_dtype=None) -> None:
        """Add a batch of pairs as arrays.  Host arrays become a host
        frame; torch tensors stay on their device as a device frame,
        their logical dtypes given by ``key_dtype``/``value_dtype``
        (default: the tensor's own, so pass ``np.uint64`` for u64 bit
        patterns held in int64)."""
        self._flush_scalars()
        if isinstance(keys, torch.Tensor):
            from ..parallel.sharded import tensor_frame
            frame = tensor_frame(keys, values, key_dtype, value_dtype)
        else:
            frame = KVFrame(keys, values)
        if len(frame):
            self._batches.append(frame)

    def add_frame(self, frame) -> None:
        """Append a pre-built frame (a KVFrame or a ShardedKV)."""
        self._flush_scalars()
        self._batches.append(frame)

    def _flush_scalars(self) -> None:
        if self._buf_k:
            self._batches.append(KVFrame(_coerce_rows(self._buf_k),
                                         _coerce_rows(self._buf_v)))
            self._buf_k, self._buf_v = [], []

    def complete(self) -> int:
        """Finalise: host batches merge into one frame; device frames are
        kept as they are."""
        self._flush_scalars()
        plain = [b for b in self._batches if isinstance(b, KVFrame)]
        device = [b for b in self._batches if not isinstance(b, KVFrame)]
        self._batches = []
        self._frames += ([_merge_frames(plain)] if plain else []) + device
        self.nkv = sum(len(f) for f in self._frames)
        self.complete_done = True
        return self.nkv

    def append(self) -> None:
        """Reopen a completed dataset for more adds (``addflag``)."""
        self.complete_done = False

    def frames(self) -> Iterator[object]:
        yield from self._frames

    def nbytes(self) -> int:
        """Bytes of the frames: a host frame's rows, a device frame's
        padded tensors."""
        return sum(f.nbytes() for f in self._frames)

    def one_frame(self):
        """The whole dataset as one frame: the sole frame itself; several
        host frames merge on the host; once any frame is on a device, the
        host frames move to that device (text columns interning there) and
        all concatenate there, intern tables merged."""
        frames = self._frames
        if not frames:
            return empty_kv()
        if len(frames) == 1:
            return frames[0]
        device = next((f.device for f in frames
                       if not isinstance(f, KVFrame)), None)
        if device is None:
            return _merge_frames(frames)
        from ..parallel.sharded import concat_sharded, shard_frame
        return concat_sharded([shard_frame(f, device)
                               if isinstance(f, KVFrame) else f
                               for f in frames])

    def replace_frames(self, frame) -> None:
        """Swap the dataset's frames for one frame holding the same pairs."""
        self.free()
        self._frames = [frame]
        self.nkv = len(frame)
        self.complete_done = True

    def free(self) -> None:
        self._frames = []
        self._batches = []
        self.nkv = 0


class KeyMultiValue:
    """Grouped dataset: a list of KMV frames."""

    def __init__(self):
        self._frames: list = []
        self.nkmv = 0

    def push(self, fr) -> None:
        self._frames.append(fr)

    def complete(self) -> int:
        self.nkmv = sum(len(f) for f in self._frames)
        return self.nkmv

    def frames(self) -> Iterator[object]:
        yield from self._frames

    def nvalues(self) -> int:
        """Values over every group."""
        return sum(f.nvalues_total for f in self._frames)

    def nbytes(self) -> int:
        """Bytes of the frames: a host frame's groups (keys, int64 sizes
        and values), a device frame's padded tensors."""
        return sum(f.nbytes() for f in self._frames)

    def free(self) -> None:
        self._frames = []
        self.nkmv = 0
