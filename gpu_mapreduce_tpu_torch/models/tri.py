"""Triangle enumeration by degree-ordered wedge matching, on one device
(on a mesh, over the shards' edges joined on the first shard's device).

The counterpart of ``gpu_mapreduce_tpu/models/tri.py`` (Cohen's
MapReduce algorithm, reference ``oink/tri_find.cpp:43-81``, as array
programs): every edge is oriented from its endpoint of smaller
(degree, rank), so each vertex's out-neighbourhood is small; each pair
of out-neighbours (u, w) of a centre v is a wedge, and the wedge closes a
triangle when (u, w) is an edge.  Here the wedge walk runs on the
device: the global wedge index space is cut into batches of at most
2^24, each batch finds its centres by ``searchsorted`` over the pair
offsets, inverts the triangular enumeration (``_pair_expand``) and probes
the sorted canonical edge keys with ``searchsorted``.  Hits come out in
ascending wedge index, the JAX order for any batch size, so the rows are
identical.  Edge keys ``lo * n + hi`` can pass 2^63, so every sort and
search of them goes through ``ops/bits.order_key``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.bits import unsigned_order_key

_BATCH = 1 << 24        # wedges per membership batch (bounds peak memory)


def _pair_expand(tloc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert the triangular enumeration: local pair index t → (i, j)
    with 0 <= i < j, t = j(j-1)/2 + i.  A float64 square root, then the
    JAX code's ±1 corrections make it exact."""
    j = ((1.0 + torch.sqrt(1.0 + 8.0 * tloc.to(torch.float64))) / 2.0)
    j = j.to(torch.int64)
    tj = j * (j - 1) // 2
    j = torch.where(tj > tloc, j - 1, j)
    tj = j * (j - 1) // 2
    j = torch.where(tloc - tj >= j, j + 1, j)
    i = tloc - j * (j - 1) // 2
    return i, j


def _edge_keys(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Order keys of the u64 edge keys ``lo * n + hi`` (the product wraps
    in int64; the order key restores the unsigned order)."""
    return unsigned_order_key(lo * n + hi)


def triangles_ranked(a: torch.Tensor, b: torch.Tensor, n: int,
                     verts: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Every triangle of the edges (a, b) (int64 ranks 0..n-1; duplicate
    and self-loop rows allowed), each once, as [t, 3] rows (centre, u, w)
    of the ids in ``verts`` (u64 in int64), in the JAX package's order;
    and the number of wedges walked."""
    dev = a.device
    empty = torch.zeros((0, 3), dtype=verts.dtype, device=dev)
    if n == 0 or a.numel() == 0:
        return empty, 0
    if n >= 1 << 32:
        raise ValueError(f"triangles_ranked: {n} vertices overflow the u64 "
                         f"rank packing")
    lo0, hi0 = torch.minimum(a, b), torch.maximum(a, b)
    keep = lo0 != hi0
    lo0, hi0 = lo0[keep], hi0[keep]
    # canonical edges: sorted unique (lo, hi), the JAX np.unique of lo*n+hi
    ekey, order = torch.sort(_edge_keys(lo0, hi0, n))
    first = torch.ones_like(ekey, dtype=torch.bool)
    first[1:] = ekey[1:] != ekey[:-1]
    ekey = ekey[first]
    a, b = lo0[order][first], hi0[order][first]
    del lo0, hi0, order, first, keep
    if ekey.numel() == 0:
        return empty, 0

    deg = torch.bincount(a, minlength=n) + torch.bincount(b, minlength=n)
    # orient a→b from the smaller (degree, rank): the JAX deg*n + rank
    # order, compared without the product
    da, db = deg[a], deg[b]
    swap = (da > db) | ((da == db) & (a > b))
    lo = torch.where(swap, b, a)
    hi = torch.where(swap, a, b)
    del da, db, swap, deg

    grp, order = torch.sort(lo, stable=True)    # centre per directed edge
    nbr = hi[order]                              # its out-neighbour
    del lo, hi, order
    k = torch.bincount(grp, minlength=n)         # out-degree per vertex
    group_start = torch.cumsum(k, 0) - k
    pair_start = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    pair_start[1:] = torch.cumsum(k * (k - 1) // 2, 0)
    total = int(pair_start[-1])
    out = [wedge_batch(start, min(start + _BATCH, total), pair_start,
                       group_start, grp, nbr, ekey, verts, n)
           for start in range(0, total, _BATCH)]
    out = [r for r in out if r.shape[0]]
    return (torch.cat(out) if out else empty), total


def wedge_batch(start: int, stop: int, pair_start: torch.Tensor,
                group_start: torch.Tensor, grp: torch.Tensor,
                nbr: torch.Tensor, ekey: torch.Tensor, verts: torch.Tensor,
                n: int) -> torch.Tensor:
    """The triangles closed by wedges start..stop-1, in wedge order."""
    t = torch.arange(start, stop, dtype=torch.int64, device=nbr.device)
    # the centre of each wedge: the last group starting at or before it
    g = torch.searchsorted(pair_start, t, right=True) - 1
    i, j = _pair_expand(t - pair_start[g])
    base = group_start[g]
    del t, g
    u, w = nbr[base + i], nbr[base + j]
    wkey = _edge_keys(torch.minimum(u, w), torch.maximum(u, w), n)
    pos = torch.searchsorted(ekey, wkey).clamp_(max=ekey.numel() - 1)
    hit = ekey[pos] == wkey
    return torch.stack([verts[grp[base[hit]]], verts[u[hit]],
                        verts[w[hit]]], 1)
