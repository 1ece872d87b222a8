"""KeyValue / KeyMultiValue datasets: frame lists with an add/complete
protocol, held in core (out-of-core spill comes with a later slice).

The in-core subset of ``gpu_mapreduce_tpu/core/dataset.py``.  A dataset's
frames are host ``KVFrame``/``KMVFrame``s or device-resident
``ShardedKV``/``ShardedKMV`` (``parallel/sharded.py``).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from .column import concat
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


def _frame_nbytes(frame) -> int:
    n = len(frame)
    if isinstance(frame, KVFrame):
        return frame.key.data[:n].nbytes + frame.value.data[:n].nbytes
    return sum(t[:n].numel() * t.element_size()
               for t in (frame.key, frame.value))


def _merge_frames(frames: List[KVFrame]) -> KVFrame:
    if len(frames) == 1:
        return frames[0]
    return KVFrame(concat([f.key for f in frames]),
                   concat([f.value for f in frames]))


class KeyValue:
    """Append-only KV dataset."""

    def __init__(self):
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
            self._batches.append(KVFrame(rows_to_array(self._buf_k),
                                         rows_to_array(self._buf_v)))
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
        """Bytes of the valid key and value rows."""
        return sum(_frame_nbytes(f) for f in self._frames)

    def one_frame(self):
        """The whole dataset as one frame: the sole frame itself; several
        device frames concatenate on the device; a mix compacts to the
        host."""
        frames = self._frames
        if not frames:
            return empty_kv()
        if len(frames) == 1:
            return frames[0]
        from ..parallel.sharded import ShardedKV, concat_sharded
        if all(isinstance(f, ShardedKV) for f in frames):
            return concat_sharded(frames)
        return _merge_frames([f.to_host() for f in frames])

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

    def free(self) -> None:
        self._frames = []
        self.nkmv = 0
