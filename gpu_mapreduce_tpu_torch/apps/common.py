"""Shared app helpers (the counterpart of ``gpu_mapreduce_tpu/apps/common.py``)."""

from __future__ import annotations

from typing import List, Tuple


def top_n(mr, ntop: int) -> List[Tuple[object, object]]:
    """Gather to one proc, sort by value descending, take the first ntop
    (key, value) pairs — the reference's top-N tail (gather(1) +
    sort_values + bounded print, examples/wordfreq.cpp:100-116).  Only
    the first ntop pairs leave the device, and only they decode."""
    mr.gather(1)
    mr.sort_values(-1)
    top: List[Tuple[object, object]] = []

    def take(frame, ptr):
        if len(top) < ntop:
            top.extend(frame.head(ntop - len(top)).pairs())

    mr.scan_kv(take, batch=True)
    return top
