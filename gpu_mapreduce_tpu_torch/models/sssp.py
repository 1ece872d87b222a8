"""Single-source shortest paths by Bellman-Ford relaxation, on one
device or a mesh.

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

On a mesh (:func:`bellman_ford_sharded`, JAX ``_bf_sharded_fn`` /
``prepare_bellman_ford``) each shard relaxes its own edges against its
device's copy of ``dist``, and both mins of a round are taken per shard
and then across the shards (``parallel/collectives.allreduce``, the JAX
``pmin``); the flag is read once a round from the first shard's device.
Min is exact, so the results equal one device's.  One device is the
one-shard case.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..parallel.collectives import allreduce, per_device, replicate

_INT32_MAX = torch.iinfo(torch.int32).max


def _round(dist: List[torch.Tensor], pred: List[torch.Tensor],
           shards: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
           ) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """One relaxation round over each shard's edges (src, dst, w), with
    ``dist``/``pred`` replicated (one tensor a shard, shared by the shards
    of a device) → (dist, pred, whether any improved, on the first
    shard's device)."""
    n = dist[0].shape[0]
    relax = [d[src] + w for d, (src, _, w) in zip(dist, shards)]
    m = allreduce([torch.full((n,), float("inf"), dtype=torch.float64,
                              device=r.device).scatter_reduce_(
                                  0, dst, r, "amin")
                   for r, (_, dst, _) in zip(relax, shards)], "min")
    nd = per_device(torch.minimum, dist, m)
    pm = allreduce([torch.full((n,), _INT32_MAX, dtype=torch.int32,
                               device=r.device).scatter_reduce_(
        0, dst, torch.where(r == d[dst], src.to(torch.int32), n), "amin")
        for r, d, (src, dst, _) in zip(relax, nd, shards)], "min")
    improved = per_device(torch.lt, nd, dist)
    npred = per_device(torch.where, improved, pm, pred)
    return nd, npred, improved[0].any()


def bellman_ford(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                 n: int, source: int, maxiter: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Rounds from rank ``source`` until no distance improves (at most
    ``maxiter``, default n).  Returns (dist [n] float64, pred [n] int32,
    rounds); pred is -1 for the source and the unreached."""
    return bellman_ford_sharded([(src, dst, w)], n, source, maxiter)


def bellman_ford_sharded(shards: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]],
                         n: int, source: int, maxiter: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`bellman_ford` over ``(src, dst, w)`` edges a shard, each on
    its shard's device; the staged edges serve every source.  Returns
    (dist, pred, rounds), the vectors on the first shard's device."""
    maxiter = maxiter or max(n, 1)
    devices = [src.device for src, _, _ in shards]
    dist = torch.full((n,), float("inf"), dtype=torch.float64,
                      device=devices[0])
    dist[source] = 0.0
    dist = replicate(dist, devices)
    pred = replicate(torch.full((n,), -1, dtype=torch.int32,
                                device=devices[0]), devices)
    changed, it = True, 0
    while changed and it < maxiter:
        dist, pred, improved = _round(dist, pred, shards)
        changed, it = bool(improved), it + 1
    return dist[0], pred[0], it
