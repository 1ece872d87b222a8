"""Plain references of the OINK graph commands the benchmark times:
``pagerank tol maxiter alpha``, ``edge_upper`` and ``cc_find``, in plain
PyTorch on whatever device the edges are on.  They take the benchmark's
edge list and nothing the system made.

PageRank (MR-MPI OINK ``pagerank``): the vertices are the distinct
endpoints; every rank starts at 1/n; a step sends each vertex's rank,
divided by its out-degree, along its out-edges, spreads the rank of the
vertices with no out-edge evenly over all, and damps:
``r' = alpha * (inflow + dangling / n) + (1 - alpha) / n``.  The loop
stops once the largest change is at most ``tol`` or after ``maxiter``
steps.

edge_upper: each edge as (min, max), self-loops dropped, repeats culled.
cc_find: each vertex of the undirected graph labelled by the least vertex
id of its component.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def pagerank(shards: Sequence[torch.Tensor], tol: float, maxiter: int,
             alpha: float, dtype=torch.float64
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(vertex ids ascending, ranks, steps) in ``dtype`` over the edges
    of every shard (``[m_i, 2]`` ids, each shard on its own device),
    summed on the first shard's device.  Vectors are indexed by vertex id
    (ids are small), so no vertex table is built."""
    dev = shards[0].device
    size = max(int(e.max()) for e in shards if e.numel()) + 1
    present = torch.zeros(size, dtype=torch.bool, device=dev)
    deg = torch.zeros(size, dtype=dtype, device=dev)
    for e in shards:
        p = torch.zeros(size, dtype=torch.bool, device=e.device)
        p[e.reshape(-1)] = True
        present |= p.to(dev)
        deg += torch.zeros(size, dtype=dtype, device=e.device).index_add_(
            0, e[:, 0], torch.ones(e.shape[0], dtype=dtype,
                                   device=e.device)).to(dev)
    n = int(present.sum())
    has_out = deg > 0
    dangling_v = present & ~has_out
    inv_deg = torch.where(has_out, 1.0 / deg.clamp(min=1), 0.0).to(dtype)
    r = torch.where(present, 1.0 / n, 0.0).to(dtype)
    steps = 0
    while steps < maxiter:
        scaled = r * inv_deg
        inflow = torch.zeros_like(r)
        for e in shards:
            s = scaled.to(e.device)
            inflow += torch.zeros(size, dtype=dtype, device=e.device
                                  ).index_add_(0, e[:, 1], s[e[:, 0]]).to(dev)
        dangling = r[dangling_v].sum() / n
        r2 = torch.where(present, (inflow + dangling) * alpha
                         + (1.0 - alpha) / n, 0.0).to(dtype)
        delta = float((r2 - r).abs().max())
        r, steps = r2, steps + 1
        if delta <= tol:
            break
    verts = present.nonzero().squeeze(1)
    return verts, r[verts], steps


def edge_upper(edges: torch.Tensor) -> torch.Tensor:
    """[m, 2] (lo, hi) distinct, lo < hi, ascending."""
    lo = torch.minimum(edges[:, 0], edges[:, 1])
    hi = torch.maximum(edges[:, 0], edges[:, 1])
    keep = lo != hi
    packed = torch.unique((lo[keep] << 32) | hi[keep])   # ids < 2^31
    return torch.stack([packed >> 32, packed & 0xFFFFFFFF], 1)


def components(upper: torch.Tensor, max_rounds: int = -1
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(vertex ids ascending, least id of each one's component, rounds)
    by min-label propagation with pointer jumping over undirected edges.
    ``max_rounds`` >= 0 stops after that many rounds, fixed point or
    not."""
    verts, inv = torch.unique(upper.reshape(-1), return_inverse=True)
    inv = inv.reshape(-1, 2)
    a, b = inv[:, 0], inv[:, 1]
    n = int(verts.numel())
    label = torch.arange(n, dtype=torch.int64, device=upper.device)
    rounds = 0
    while rounds != max_rounds:
        rounds += 1
        la, lb = label[a], label[b]
        lo = torch.minimum(la, lb)
        new = label.clone()
        new.scatter_reduce_(0, a, lo, "amin")
        new.scatter_reduce_(0, b, lo, "amin")
        new.scatter_reduce_(0, la, lo, "amin")
        new.scatter_reduce_(0, lb, lo, "amin")
        while True:                      # jump to the root's label
            nxt = new[new]
            if torch.equal(nxt, new):
                break
            new = nxt
        if torch.equal(new, label):
            break
        label = new
    # ranks are ascending ids, so the least rank names the least id
    return verts, verts[label], rounds
