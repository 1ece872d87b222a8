"""Device staging for the fused graph engines, on one device.

The counterpart of ``gpu_mapreduce_tpu/parallel/staging.py``.  The fused
PageRank and cc engines keep their state in dense vectors over vertex
ranks 0..n-1; staging turns the edge KV (``[rows, 2]`` u64 keys) into

* :func:`unique_verts` — the sorted unique endpoint ids (one sort of the
  2E endpoints in unsigned order, first-of-run marks, one compaction);
* :func:`rank_edges` — each edge's endpoints as ranks into that table
  (``searchsorted``), in the frame's row order.

The edge columns stay on the device; only the vertex count ``n`` is read
by the host.  ``drop_self`` (luby) drops self-loop rows before the
unique, so a vertex with only self-loops gets no rank; ``need_weights``
(sssp) carries the value column as float64 weights, row for row.  One
device holds no padded rows between shards, so rows are compacted where
the JAX mesh path carries a ``valid`` mask, and its padding sentinel
(vertex id 2^64-1) is an ordinary id here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.bits import M32, from_order_key, order_key, widen64
from .sharded import ShardedKV


class StagedGraph:
    """Result of :func:`stage_graph`: the sorted vertex table ``verts``
    [n] (u64 ids in int64), the ranked edges ``src``/``dst`` [E] (int64)
    and, when asked for, their float64 ``weights`` [E], all on the
    device."""

    __slots__ = ("verts", "n", "src", "dst", "weights")

    def __init__(self, verts, n, src, dst, weights=None):
        self.verts, self.n, self.src, self.dst = verts, n, src, dst
        self.weights = weights


def staged_frame(mr) -> Optional[ShardedKV]:
    """mr's KV as one device frame (aggregating a host dataset onto the
    device first), or None when the dataset is empty."""
    kv = mr.kv
    if kv is None or not kv.nkv:
        return None
    fr = kv.one_frame()
    if not isinstance(fr, ShardedKV):
        mr.aggregate()
        fr = mr.kv.one_frame()
    return fr


def stage_graph(mr, drop_self: bool = False, need_weights: bool = False
                ) -> Optional[StagedGraph]:
    """The fused graph commands' shared staging: mr's edge KV → vertex
    table + ranked edges on the device, or None for an empty dataset.
    With ``drop_self`` the self-loop rows leave first (a graph of only
    self-loops stages as n = 0); with ``need_weights`` the value column
    comes along as float64 weights."""
    fr = staged_frame(mr)
    if fr is None:
        return None
    n = len(fr)
    key = fr.key[:n]
    value = fr.value[:n] if need_weights else None
    if drop_self:
        keep = key[:, 0] != key[:, 1]
        key = key[keep]
        value = value[keep] if need_weights else None
    weights = None if value is None else as_float64(value, fr.value_dtype)
    verts, n = unique_verts(key, fr.key_dtype)
    src, dst = rank_edges(key, verts, fr.key_dtype)
    return StagedGraph(verts, n, src, dst, weights)


def as_float64(x: torch.Tensor, dtype) -> torch.Tensor:
    """Values of logical numpy ``dtype`` as float64, each rounded once
    (a u64 through its two 32-bit halves, as numpy converts it)."""
    dt = np.dtype(dtype)
    if dt.kind == "u" and dt.itemsize == 8:
        hi = ((x >> 32) & M32).to(torch.float64)
        return hi * float(1 << 32) + (x & M32).to(torch.float64)
    return widen64(x, dt).to(torch.float64) if dt.kind in "iu" \
        else x.to(torch.float64)


def unique_verts(key: torch.Tensor, key_dtype) -> Tuple[torch.Tensor, int]:
    """Sorted unique endpoint ids of [rows, 2] edge keys (ascending
    unsigned) and their count, the one value read by the host."""
    ok = order_key(key.reshape(-1), key_dtype)
    s = torch.sort(ok).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    verts = from_order_key(s[first], key_dtype, key.dtype)
    return verts, int(verts.numel())


def rank_edges(key: torch.Tensor, verts: torch.Tensor, key_dtype
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge endpoints as vertex ranks: (src, dst), each [rows] int64 in
    the keys' row order."""
    table = order_key(verts, key_dtype)
    return tuple(torch.searchsorted(table, order_key(key[:, c].contiguous(),
                                                      key_dtype))
                 for c in (0, 1))
