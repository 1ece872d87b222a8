"""Host columns: the dense subset of ``gpu_mapreduce_tpu/core/column.py``.

A ``DenseColumn`` is a 1-D or 2-D numpy array of any numeric dtype
(u64 stays u64 on the host).  Device-resident data lives in the sharded
frames (``parallel/sharded.py``); byte-string columns and interning come
with a later slice of the port.
"""

from __future__ import annotations

import numpy as np

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
            raise MRError("byte-string and object columns are not ported "
                          "yet; keys and values must be numeric")
        self.data = data

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def slice(self, start: int, stop: int) -> "DenseColumn":
        return DenseColumn(self.data[start:stop])

    def tolist(self) -> list:
        if self.data.ndim == 1:
            return self.data.tolist()
        return [tuple(row) for row in self.data.tolist()]

    def __repr__(self):
        return f"DenseColumn<{self.data.dtype}{list(self.data.shape)}>"


def as_column(x) -> DenseColumn:
    return x if isinstance(x, DenseColumn) else DenseColumn(x)


def concat(cols) -> DenseColumn:
    return DenseColumn(np.concatenate([c.data for c in cols], axis=0))
