"""IntCount — integer-key counting over binary data.

The counterpart of ``gpu_mapreduce_tpu/apps/intcount.py``, after the
reference's ``cpu/IntCount.cpp``: each file is read as u32 words, every
word a key with value 1, then aggregate + convert + a count reduce and an
optional top-N.  Maximum key cardinality, minimum payload per key: a pure
shuffle/group stress.  Under ``fuse=1`` (``MRTPU_FUSE=1``) convert and
count run as one fused group (on a mesh of P > 1 with the aggregate's
exchange), whose warm run takes the group table (``ops/cuda/group.py``,
one launch a shard).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..core.mapreduce import MapReduce
from ..ops.reduces import count
from .common import top_n


def _map_file(itask, filename, kv, ptr):
    data = np.fromfile(filename, dtype=np.uint32)
    kv.add_batch(data.astype(np.uint64), np.ones(len(data), np.uint32))


def intcount(paths: Sequence[str], ntop: int = 0, device=None, comm=None
             ) -> Tuple[int, int, List[Tuple[int, int]]]:
    """Count u32 keys across binary files.  Returns (nints, nunique,
    top) where top is the ntop most frequent (key, count) pairs, count
    descending, then key descending.  ``device=None`` runs on the card
    and raises ``MRError`` without one; ``comm=mesh`` runs over a mesh
    (each shard reads its slice of the files)."""
    mr = MapReduce(device, comm=comm)
    nints = mr.map_files(list(paths), _map_file)
    mr.aggregate(None)
    mr.convert()
    nunique = mr.reduce(count, batch=True)
    top: List[Tuple[int, int]] = []
    if ntop:
        top = [(int(k), int(v)) for k, v in top_n(mr, ntop)]
    return nints, int(nunique), top
