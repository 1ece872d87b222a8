"""Device staging for the fused graph engines, on one device or a mesh.

The counterpart of ``gpu_mapreduce_tpu/parallel/staging.py``.  The fused
engines keep their state in dense vectors over vertex ranks 0..n-1;
staging turns the edge KV (``[rows, 2]`` u64 keys) into

* :func:`unique_verts` — the sorted unique endpoint ids, one table for
  every shard;
* :func:`rank_edges` — each shard's edges as ranks into that table
  (``searchsorted``), in the shard's own row order.

On a mesh each shard first sorts and uniques its own endpoints on its
device; only those unique ids travel, to the first shard's device, where
one sort of their concatenation and one first-of-run mark give the table.
A vertex appears once a shard there, against up to its degree times in
the 2E endpoints, so this moves fewer bytes between cards than gathering
every endpoint, and each shard's sort is a P-th of the work.  The table
is then copied once to each other device the shards use, and every shard
ranks its valid rows there.  Only the vertex count ``n`` is read by the
host.

``drop_self`` (luby) drops self-loop rows before the unique, so a vertex
with only self-loops gets no rank; ``need_weights`` (sssp) carries the
value column as float64 weights, row for row.  Rows are compacted to each
shard's valid count, where the JAX mesh path carries a ``valid`` mask
over padded blocks, so the JAX padding sentinel (vertex id 2^64-1, which
its mesh staging refuses) is an ordinary id here, as on the JAX package's
serial path.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.tracer import get_tracer
from ..ops.bits import M32, from_order_key, order_key, widen64
from .collectives import replicate
from .sharded import MeshKV, ShardedKV


class EdgeShard(NamedTuple):
    """One shard's ranked edges on its device: ``src``/``dst`` [E_p]
    (int64 ranks) and ``weights`` [E_p] float64, or None."""

    src: torch.Tensor
    dst: torch.Tensor
    weights: Optional[torch.Tensor]


class StagedGraph:
    """Result of :func:`stage_graph`: the sorted vertex table ``verts``
    [n] (u64 ids in int64, on the first shard's device) and its length
    ``n``, and the ranked edges of each shard (``shards``, one
    :class:`EdgeShard` a shard).  ``src``/``dst``/``weights`` are every
    shard's rows joined in shard order on the first shard's device (one
    shard's own tensors on one device)."""

    __slots__ = ("verts", "n", "shards")

    def __init__(self, verts, n, shards: List[EdgeShard]):
        self.verts, self.n, self.shards = verts, n, shards

    def _joined(self, name: str):
        parts = [getattr(s, name) for s in self.shards]
        if parts[0] is None or len(parts) == 1:
            return parts[0]
        dev = self.verts.device
        return torch.cat([t.to(dev, non_blocking=True) for t in parts])

    @property
    def src(self) -> torch.Tensor:
        return self._joined("src")

    @property
    def dst(self) -> torch.Tensor:
        return self._joined("dst")

    @property
    def weights(self) -> Optional[torch.Tensor]:
        return self._joined("weights")


def staged_frame(mr):
    """mr's KV as one device frame: a mesh frame on a mesh of P > 1, else
    a one-device frame (a dataset held otherwise is aggregated first:
    onto the device, or over the mesh by the hash exchange), or None when
    the dataset is empty."""
    kv = mr.kv
    if kv is None or not kv.nkv:
        return None
    want = MeshKV if mr.nprocs > 1 else ShardedKV
    fr = kv.one_frame()
    if not isinstance(fr, want):
        mr.aggregate()
        fr = mr.kv.one_frame()
    return fr


def stage_graph(mr, drop_self: bool = False, need_weights: bool = False
                ) -> Optional[StagedGraph]:
    """The fused graph commands' shared staging: mr's edge KV → vertex
    table + ranked edges a shard, or None for an empty dataset.  With
    ``drop_self`` the self-loop rows leave first (a graph of only
    self-loops stages as n = 0); with ``need_weights`` the value column
    comes along as float64 weights.  Traced, the body is a
    ``graph.stage`` span over the shards' ``graph.unique``, the
    ``graph.merge`` and a ``graph.rank`` a shard (a shard's ranked
    edges; the table's copies to the other devices, queued just before,
    lie under ``graph.stage``).  Attributes come from what the host
    already holds: it reads no device value for them."""
    tr = get_tracer()
    with tr.span("graph.stage", cat="graph") as sp:
        fr = staged_frame(mr)
        if fr is None:
            return None
        blocks = fr.shards if isinstance(fr, MeshKV) else [fr]
        counts = [int(b.counts[0]) for b in blocks]
        sp.set(shards=len(blocks), rows=sum(counts))
        keys, values = [], []
        for b, c in zip(blocks, counts):
            key = b.key[:c]
            value = b.value[:c] if need_weights else None
            if drop_self:
                keep = key[:, 0] != key[:, 1]
                key = key[keep]
                value = value[keep] if need_weights else None
            keys.append(key)
            values.append(None if value is None
                          else as_float64(value, fr.value_dtype))
        verts, n = unique_verts(keys, fr.key_dtype)
        tables = replicate(verts, [k.device for k in keys])
        shards = []
        for p, (k, t, w) in enumerate(zip(keys, tables, values)):
            with tr.span("graph.rank", cat="graph", shard=p):
                shards.append(EdgeShard(*rank_edges(k, t, fr.key_dtype), w))
        sp.set(n=n)
        return StagedGraph(verts, n, shards)


def as_float64(x: torch.Tensor, dtype) -> torch.Tensor:
    """Values of logical numpy ``dtype`` as float64, each rounded once
    (a u64 through its two 32-bit halves, as numpy converts it)."""
    dt = np.dtype(dtype)
    if dt.kind == "u" and dt.itemsize == 8:
        hi = ((x >> 32) & M32).to(torch.float64)
        return hi * float(1 << 32) + (x & M32).to(torch.float64)
    return widen64(x, dt).to(torch.float64) if dt.kind in "iu" \
        else x.to(torch.float64)


def _sorted_unique(ok: torch.Tensor) -> torch.Tensor:
    """The distinct values of ``ok``, ascending (one sort, first-of-run
    marks, one compaction)."""
    s = torch.sort(ok).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return s[first]


def unique_verts(keys: Sequence[torch.Tensor], key_dtype
                 ) -> Tuple[torch.Tensor, int]:
    """Sorted unique endpoint ids (ascending unsigned) over every shard's
    ``[rows, 2]`` edge keys, on the first shard's device, and their
    count, the one value read by the host.  Each shard's unique is a
    ``graph.unique`` span; on several shards the merge on the first
    shard's device is a ``graph.merge`` span."""
    tr = get_tracer()
    parts = []
    for p, k in enumerate(keys):
        with tr.span("graph.unique", cat="graph", shard=p, rows=k.shape[0]):
            parts.append(_sorted_unique(order_key(k.reshape(-1),
                                                  key_dtype)))
    if len(parts) == 1:
        s = parts[0]
    else:
        dev = keys[0].device
        with tr.span("graph.merge", cat="graph",
                     ids=sum(p.shape[0] for p in parts)):
            s = _sorted_unique(torch.cat([p.to(dev, non_blocking=True)
                                          for p in parts]))
    verts = from_order_key(s, key_dtype, keys[0].dtype)
    return verts, int(verts.numel())


def rank_edges(key: torch.Tensor, verts: torch.Tensor, key_dtype
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge endpoints as vertex ranks: (src, dst), each [rows] int64 in
    the keys' row order (``verts`` on the keys' device)."""
    table = order_key(verts, key_dtype)
    return tuple(torch.searchsorted(table, order_key(key[:, c].contiguous(),
                                                      key_dtype))
                 for c in (0, 1))
