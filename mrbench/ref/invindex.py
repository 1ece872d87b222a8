"""Plain reference of the InvertedIndex job (Mars-MR-MPI
``cuda/InvertedIndex.cu``): every URL of every ``<a href="`` reference,
grouped by URL, with its number of references and the set of files (by
index in the job's file list) it appears in.  URLs are named by their
64-bit lookup3 intern id (:mod:`mrbench.ref.lookup3`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..gen.html import file_urls
from .lookup3 import intern_ids


def index(paths: Sequence[str], max_url: int = 256
          ) -> Dict[int, Tuple[int, Tuple[int, ...]]]:
    """{url id: (references, sorted file indices)} over the files, each
    URL the bytes up to the first quote within ``max_url`` bytes."""
    counts: Dict[bytes, int] = {}
    docs: Dict[bytes, set] = {}
    for i, urls in enumerate(file_urls(paths, max_url)):
        for u in urls:
            counts[u] = counts.get(u, 0) + 1
            docs.setdefault(u, set()).add(i)
    keys: List[bytes] = list(counts)
    ids = intern_ids(keys).tolist()
    out = {}
    for h, u in zip(ids, keys):
        if h in out:
            raise ValueError("two URLs share a 64-bit id")
        out[h] = (counts[u], tuple(sorted(docs[u])))
    return out


def totals(idx: Dict[int, Tuple[int, Tuple[int, ...]]]) -> Tuple[int, int]:
    """(references, distinct URLs): what a run returns."""
    return sum(c for c, _ in idx.values()), len(idx)


def mismatches(got: Dict[int, Tuple[int, Tuple[int, ...]]],
               want: Dict[int, Tuple[int, Tuple[int, ...]]]) -> int:
    """URLs whose count or file set differ, or that one side lacks."""
    keys = set(got) | set(want)
    return sum(got.get(k) != want.get(k) for k in keys)


def as_index(ids: np.ndarray, counts: np.ndarray, group_ids: np.ndarray,
             group_docs: Sequence[Sequence[int]]
             ) -> Dict[int, Tuple[int, Tuple[int, ...]]]:
    """A run's output as the reference's mapping: the counts by id, the
    file sets from the groups the counts were made from (an id missing
    on one side has no file set)."""
    docs = {int(k): tuple(sorted(set(int(v) for v in vals)))
            for k, vals in zip(group_ids.tolist(), group_docs)}
    return {int(k): (int(c), docs.get(int(k), ()))
            for k, c in zip(ids.tolist(), counts.tolist())}
