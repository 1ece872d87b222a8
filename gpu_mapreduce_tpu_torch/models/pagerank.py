"""PageRank on one device: dense float32 ranks over ranked edges.

The counterpart of ``gpu_mapreduce_tpu/models/pagerank.py``.  One step
gathers each edge's source rank scaled by 1/out-degree, sums it onto the
destination (``index_add_``, the JAX ``segment_sum``), redistributes the
dangling vertices' mass uniformly and damps.  The loop runs on the
device; the host reads one scalar a step, the largest rank change, and
stops exactly where the JAX ``while_loop``'s condition would (``delta >
tol`` in float32, at most ``maxiter`` steps).

Float32 sums on the card are not reproducible bit for bit: ``index_add_``
adds in the order its atomics land, so ranks differ in their last bits
from run to run and the step count may move by one near ``tol``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def pagerank_step(ranks: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  inv_outdeg: torch.Tensor, edge_scale: torch.Tensor,
                  damping: float = 0.85) -> torch.Tensor:
    """One damped power-iteration step.  ``edge_scale`` is
    ``inv_outdeg[src]``, gathered once for every step."""
    n = ranks.shape[0]
    contrib = ranks[src].mul_(edge_scale)
    inflow = torch.zeros(n, dtype=torch.float32, device=ranks.device)
    inflow.index_add_(0, dst, contrib)
    base = float(np.float32((1.0 - damping) / n))
    d = float(np.float32(damping))
    return inflow.add_(_dangling_mass(ranks, inv_outdeg)).mul_(d).add_(base)


def pagerank(src: torch.Tensor, dst: torch.Tensor, n: int, tol: float = 1e-6,
             maxiter: int = 100, damping: float = 0.85
             ) -> Tuple[torch.Tensor, int]:
    """The convergence loop on the edges' device.  Returns (ranks [n]
    float32, iterations)."""
    inv = inv_outdegrees(out_degrees(src, n))
    edge_scale = inv[src]
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=src.device)
    tol32 = np.float32(tol)
    delta, it = np.inf, 0
    while delta > tol32 and it < maxiter:
        r2 = pagerank_step(r, src, dst, inv, edge_scale, damping)
        delta = (r2 - r).abs_().max().item()
        r, it = r2, it + 1
    return r, it
