"""Device staging for the fused graph engines, on one device.

The counterpart of ``gpu_mapreduce_tpu/parallel/staging.py``.  The fused
PageRank and cc engines keep their state in dense vectors over vertex
ranks 0..n-1; staging turns the edge KV (``[rows, 2]`` u64 keys) into

* :func:`unique_verts` — the sorted unique endpoint ids (one sort of the
  2E endpoints in unsigned order, first-of-run marks, one compaction);
* :func:`rank_edges` — each edge's endpoints as ranks into that table
  (``searchsorted``), in the frame's row order.

The edge columns stay on the device; only the vertex count ``n`` is read
by the host.  One device holds no padded rows between shards, so the JAX
package's padding sentinel (vertex id 2^64-1) is not reserved here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.bits import from_order_key, order_key
from .sharded import ShardedKV


class StagedGraph:
    """Result of :func:`stage_graph`: the sorted vertex table ``verts``
    [n] (u64 ids in int64) and the ranked edges ``src``/``dst`` [E]
    (int64), all on the device."""

    __slots__ = ("verts", "n", "src", "dst")

    def __init__(self, verts, n, src, dst):
        self.verts, self.n, self.src, self.dst = verts, n, src, dst


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


def stage_graph(mr) -> Optional[StagedGraph]:
    """The fused graph commands' shared staging: mr's edge KV → vertex
    table + ranked edges on the device, or None for an empty dataset."""
    fr = staged_frame(mr)
    if fr is None:
        return None
    verts, n = unique_verts(fr)
    src, dst = rank_edges(fr, verts)
    return StagedGraph(verts, n, src, dst)


def unique_verts(fr: ShardedKV) -> Tuple[torch.Tensor, int]:
    """Sorted unique endpoint ids of a [rows, 2] edge frame (ascending
    unsigned) and their count, the one value read by the host."""
    ok = order_key(fr.key[:len(fr)].reshape(-1), fr.key_dtype)
    s = torch.sort(ok).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    verts = from_order_key(s[first], fr.key_dtype, fr.key.dtype)
    return verts, int(verts.numel())


def rank_edges(fr: ShardedKV, verts: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge endpoints as vertex ranks: (src, dst), each [rows] int64 in
    the frame's row order."""
    table = order_key(verts, fr.key_dtype)
    key = fr.key[:len(fr)]
    return tuple(torch.searchsorted(table, order_key(key[:, c].contiguous(),
                                                      fr.key_dtype))
                 for c in (0, 1))

