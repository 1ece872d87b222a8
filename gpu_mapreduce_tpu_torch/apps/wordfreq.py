"""Word frequency — the reference's hello-world pipeline
(``examples/wordfreq.cpp:64-121``): map files → collate → reduce(sum) →
sort by count → top-N.  The counterpart of
``gpu_mapreduce_tpu/apps/wordfreq.py``.

* :func:`wordfreq` — the host-callback path: a file callback emits one
  (word, 1) pair per word, a per-group callback sums; the words intern
  on the device when collate moves them there.
* :func:`wordfreq_interned` — the device path: each file's words split
  and intern on the device (``utils/io.split_words``,
  ``BytesColumn.intern``), collate and a count reduce run on the ids, and
  only the top-N rows decode.

Both return ``(nwords, nunique, top)`` with ``top`` a list of
``(word bytes, count)``, count descending, equal counts by u64 id
descending.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.column import InternTable
from ..core.mapreduce import MapReduce
from ..ops.reduces import count
from ..utils.io import read_words, split_words
from .common import top_n


def _fileread(itask, filename, kv, ptr):
    """Emit (word, 1) per word of the file (reference fileread,
    examples/wordfreq.cpp:125-151)."""
    with open(filename, "rb") as f:
        for w in read_words(f.read()):
            kv.add(w, 1)


def _sum(key, values, kv, ptr):
    """(word, [1, 1, ...]) → (word, count) (reference sum,
    examples/wordfreq.cpp:158-162)."""
    kv.add(key, sum(values))


def wordfreq(files: Sequence[str], ntop: int = 10, device=None,
             quiet: bool = True, comm=None
             ) -> Tuple[int, int, List[Tuple[bytes, int]]]:
    """(total words, unique words, top ntop (word, count)) by host
    callbacks; ``comm=mesh`` runs over a mesh."""
    mr = MapReduce(device=device, comm=comm)
    nwords = mr.map_files(list(files), _fileread)
    mr.collate()
    nunique = mr.reduce(_sum)
    top = [(k, int(v)) for k, v in top_n(mr, ntop)]
    if not quiet:
        print(f"{nwords} total words, {nunique} unique words")
        for w, c in top:
            print(f"{c} {w.decode(errors='replace')}")
    return nwords, nunique, top


def wordfreq_interned(files: Sequence[str], ntop: int = 10, device=None,
                      comm=None) -> Tuple[int, int, List[Tuple[bytes, int]]]:
    """wordfreq on the device path: u64-interned words, a count reduce
    on the ids, the id → word table decoding the top-N; ``comm=mesh``
    runs over a mesh (each shard splits and interns its files on its
    device)."""
    mr = MapReduce(device=device, comm=comm)
    vocab = InternTable()

    def fileread_ids(itask, filename, kv, ptr):
        col = split_words(np.fromfile(filename, np.uint8), kv.device)
        ids, table = col.intern(kv.device)
        for h, w in table.items():       # the cross-file collision check
            prev = vocab.setdefault(h, w)
            if prev != w:
                raise ValueError(
                    "64-bit intern collision between %r and %r" % (prev, w))
        kv.add_batch(ids, torch.ones_like(ids), key_dtype=np.uint64,
                     value_dtype=np.int64)

    nwords = mr.map_files(list(files), fileread_ids)
    mr.collate()
    nunique = mr.reduce(count, batch=True)
    top = [(vocab[int(k)], int(v)) for k, v in top_n(mr, ntop)]
    return nwords, nunique, top
