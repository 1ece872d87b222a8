"""Single-source shortest paths by Bellman-Ford relaxation on one device.

The counterpart of ``gpu_mapreduce_tpu/models/sssp.py``: ``dist`` is a
dense float64 vector over vertex ranks (inf where unreached) and
``pred`` an int32 one (-1 for the source and the unreached).  One round
relaxes every edge: a ``scatter_reduce_(..., "amin")`` of ``dist[src] +
w`` onto ``dst``, then a second ``amin`` picks the least source index
that realises each improved distance as its predecessor.  Min is exact
and each sum is one float64 addition, so dist, pred and the round count
equal the JAX package's bit for bit.  The edges are staged once and
every source reuses them; the host reads one flag a round (whether any
distance improved).
"""

from __future__ import annotations

from typing import Tuple

import torch

_INT32_MAX = torch.iinfo(torch.int32).max


def _round(dist: torch.Tensor, pred: torch.Tensor, src: torch.Tensor,
           dst: torch.Tensor, w: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One relaxation round → (dist, pred, whether any improved)."""
    n = dist.shape[0]
    relax = dist[src] + w
    m = torch.full((n,), float("inf"), dtype=torch.float64,
                   device=dist.device).scatter_reduce_(0, dst, relax, "amin")
    nd = torch.minimum(dist, m)
    improved = nd < dist
    cand = torch.where(relax == nd[dst], src.to(torch.int32), n)
    pm = torch.full((n,), _INT32_MAX, dtype=torch.int32,
                    device=dist.device).scatter_reduce_(0, dst, cand, "amin")
    return nd, torch.where(improved, pm, pred), improved.any()


def bellman_ford(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                 n: int, source: int, maxiter: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Rounds from rank ``source`` until no distance improves (at most
    ``maxiter``, default n).  Returns (dist [n] float64, pred [n] int32,
    rounds); pred is -1 for the source and the unreached."""
    maxiter = maxiter or max(n, 1)
    dist = torch.full((n,), float("inf"), dtype=torch.float64,
                      device=src.device)
    dist[source] = 0.0
    pred = torch.full((n,), -1, dtype=torch.int32, device=src.device)
    changed, it = True, 0
    while changed and it < maxiter:
        dist, pred, improved = _round(dist, pred, src, dst, w)
        changed, it = bool(improved), it + 1
    return dist, pred, it
