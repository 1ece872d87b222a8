"""Sorting for columns of logical numpy dtypes.

``torch.sort`` orders int64 as signed; a u64 column sorts through
``bits.order_key`` so its order is unsigned.  :func:`lexsort` follows
numpy's convention (the LAST key is primary) as a chain of stable sorts.
:func:`argsort_column` is the host sort of a host column (the counterpart
of ``gpu_mapreduce_tpu/ops/sort.argsort_column``): byte rows by their
bytes, objects by their pickles, or any rows by a comparator
``cmp(a, b) → -1/0/1`` (the reference's appcompare).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Indices that sort by ``keys[-1]``, then ``keys[-2]``, ...; each key
    already in a native-order form (see ``bits.order_key``; bools sort
    False first).  Ties keep their input order."""
    order = None
    for k in keys:
        k = k if order is None else k[order]
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        o = torch.sort(k, stable=True).indices
        order = o if order is None else order[o]
    return order



def argsort_column(col, descending: bool = False,
                   cmp: Optional[Callable] = None) -> np.ndarray:
    """Stable argsort of a host column (a [n, w] column lexicographically
    by its columns).  Descending: byte and object rows keep equal rows in
    row order (Python's ``sorted(reverse=True)``); numbers reverse the
    ascending order, as the JAX package does."""
    from ..core.column import BytesColumn, ObjectColumn
    n = len(col)
    if cmp is not None:
        rows = col.tolist()
        order = sorted(range(n), key=functools.cmp_to_key(
            lambda i, j: cmp(rows[i], rows[j])))
        return np.asarray(order, dtype=np.int64)
    if isinstance(col, (BytesColumn, ObjectColumn)):
        rows = col.tolist() if isinstance(col, BytesColumn) \
            else col.pickles()
        order = sorted(range(n), key=rows.__getitem__, reverse=descending)
        return np.asarray(order, dtype=np.int64)
    data = col.data
    if data.ndim == 1:
        idx = np.argsort(data, kind="stable")
    else:
        idx = np.lexsort(tuple(data[:, j]
                               for j in range(data.shape[1] - 1, -1, -1)))
    return idx[::-1] if descending else idx
