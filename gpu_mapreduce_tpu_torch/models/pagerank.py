"""PageRank: dense float32 ranks over ranked edges, on one device or a
mesh.

The counterpart of ``gpu_mapreduce_tpu/models/pagerank.py``.  One step
gathers each edge's source rank scaled by 1/out-degree, sums it onto the
destination (``index_add_``, the JAX ``segment_sum``), redistributes the
dangling vertices' mass uniformly and damps.  The loop runs on the
device; the host reads one scalar a step, the largest rank change, and
stops exactly where the JAX ``while_loop``'s condition would (``delta >
tol`` in float32, at most ``maxiter`` steps).

On a mesh (:func:`pagerank_sharded`, JAX ``pagerank_sharded``) every
shard holds its own edges and a copy of the ranks on its device: the
out-degrees and each step's inflow are summed per shard, then across the
shards (``parallel/collectives.allreduce``, the JAX ``psum``); the
dangling mass, the damping and the largest change run on the replicated
ranks, once a device, and the change is read from the first shard's
device only.  One device is the one-shard case.

Float32 sums on the card are not reproducible bit for bit: ``index_add_``
adds in the order its atomics land, so ranks differ in their last bits
from run to run and the step count may move by one near ``tol``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..parallel.collectives import allreduce, per_device, replicate


def out_degrees(src: torch.Tensor, n: int) -> torch.Tensor:
    """Out-degree per vertex (float32) from the edges' source ranks."""
    deg = torch.zeros(n, dtype=torch.float32, device=src.device)
    return deg.index_add_(0, src, torch.ones(src.shape, dtype=torch.float32,
                                             device=src.device))


def inv_outdegrees(deg: torch.Tensor) -> torch.Tensor:
    """1/out-degree with 0 for dangling (degree-0) vertices."""
    return torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                       torch.zeros_like(deg))


def _dangling_mass(ranks: torch.Tensor, inv_outdeg: torch.Tensor
                   ) -> torch.Tensor:
    """Rank mass sitting on dangling vertices, spread uniformly."""
    n = ranks.shape[0]
    return (ranks.sum() - (ranks * torch.sign(inv_outdeg)).sum()) / n


def pagerank_step(ranks: List[torch.Tensor], shards,
                  inv: List[torch.Tensor], damping: float = 0.85
                  ) -> List[torch.Tensor]:
    """One damped power-iteration step over every shard.  ``ranks`` and
    ``inv`` (1/out-degree) are replicated (one tensor a shard, shared by
    the shards of a device); ``shards`` are ``(src, dst, edge_scale)`` a
    shard, ``edge_scale`` being ``inv[src]``, gathered once for every
    step."""
    n = ranks[0].shape[0]
    inflow = allreduce([
        torch.zeros(n, dtype=torch.float32, device=r.device).index_add_(
            0, dst, r[src].mul_(scale))
        for r, (src, dst, scale) in zip(ranks, shards)], "sum")
    base = float(np.float32((1.0 - damping) / n))
    d = float(np.float32(damping))
    return per_device(lambda f, r, i: f.add_(_dangling_mass(r, i)).mul_(d)
                      .add_(base), inflow, ranks, inv)


def pagerank(src: torch.Tensor, dst: torch.Tensor, n: int, tol: float = 1e-6,
             maxiter: int = 100, damping: float = 0.85
             ) -> Tuple[torch.Tensor, int]:
    """The convergence loop on the edges' device.  Returns (ranks [n]
    float32, iterations)."""
    return pagerank_sharded([(src, dst)], n, tol, maxiter, damping)


def pagerank_sharded(shards: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     n: int, tol: float = 1e-6, maxiter: int = 100,
                     damping: float = 0.85) -> Tuple[torch.Tensor, int]:
    """The convergence loop over ``(src, dst)`` rank edges a shard, each
    pair on its shard's device.  Returns (ranks [n] float32 on the first
    shard's device, iterations)."""
    deg = allreduce([out_degrees(src, n) for src, _ in shards], "sum")
    inv = per_device(inv_outdegrees, deg)
    steps = [(src, dst, i[src]) for (src, dst), i in zip(shards, inv)]
    r = replicate(torch.full((n,), 1.0 / n, dtype=torch.float32,
                             device=deg[0].device), [d.device for d in deg])
    tol32 = np.float32(tol)
    delta, it = np.inf, 0
    while delta > tol32 and it < maxiter:
        r2 = pagerank_step(r, steps, inv, damping)
        delta = (r2[0] - r[0]).abs_().max().item()
        r, it = r2, it + 1
    return r[0], it
