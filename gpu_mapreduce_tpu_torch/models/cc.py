"""Connected components by label propagation, on one device or a mesh.

The counterpart of ``gpu_mapreduce_tpu/models/cc.py``: labels are a
dense int32 vector over vertex ranks; each round every edge pulls both
endpoints toward the smaller label (two ``scatter_reduce_(..., "amin")``,
the JAX ``segment_min``) and one pointer-jumping hop ``min(lab,
lab[lab])`` shortens label chains.  At the fixpoint every vertex holds
the least rank of its component.  Min is exact, so labels and the round
count equal the JAX package's on any device.  The host reads one flag a
round (whether any label changed).

On a mesh (:func:`cc_sharded`, JAX ``cc_sharded``) each shard runs the
whole round, pointer jump included, over its own edges and its device's
copy of the labels, and the shards' labels then meet in one min across
shards (``parallel/collectives.allreduce``, the JAX ``pmin``); the
"changed" flag is read once a round, from the first shard's device.
Labels at the fixpoint are those of one device; the round count follows
the edges' layout over the shards, as the JAX package's does.  One
device is the one-shard case.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..parallel.collectives import allreduce, replicate

_INT32_MAX = torch.iinfo(torch.int32).max


def _segment_min(vals: torch.Tensor, seg: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """Min of ``vals`` per segment id in [0, n); empty segments hold the
    int32 maximum, as ``jax.ops.segment_min`` leaves them."""
    out = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amin")


def _propagate(lab: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
               ) -> torch.Tensor:
    """One round: both endpoints of every edge move to the smaller label,
    then one pointer-jump hop."""
    n = lab.shape[0]
    m1 = _segment_min(lab[src], dst, n)
    m2 = _segment_min(lab[dst], src, n)
    nl = torch.minimum(lab, torch.minimum(m1, m2))
    return torch.minimum(nl, nl[nl.long()])


def cc(src: torch.Tensor, dst: torch.Tensor, n: int, maxiter: int = 0
       ) -> Tuple[torch.Tensor, int]:
    """Rounds until no label changes (at most ``maxiter``, default n).
    Returns (labels [n] int32, iterations); labels[v] is the least rank
    in v's component."""
    return cc_sharded([(src, dst)], n, maxiter)


def cc_sharded(shards: Sequence[Tuple[torch.Tensor, torch.Tensor]], n: int,
               maxiter: int = 0) -> Tuple[torch.Tensor, int]:
    """:func:`cc` over ``(src, dst)`` rank edges a shard, each pair on its
    shard's device.  Returns (labels [n] int32 on the first shard's
    device, iterations)."""
    maxiter = maxiter or max(n, 1)
    devices = [src.device for src, _ in shards]
    lab = replicate(torch.arange(n, dtype=torch.int32, device=devices[0]),
                    devices)
    changed, it = n > 0, 0
    while changed and it < maxiter:
        nl = _round(lab, shards)
        changed = bool((nl[0] != lab[0]).any())
        lab, it = nl, it + 1
    return lab[0], it


def _round(lab: List[torch.Tensor],
           shards: Sequence[Tuple[torch.Tensor, torch.Tensor]]
           ) -> List[torch.Tensor]:
    """One round over every shard: each shard's :func:`_propagate` on its
    device's labels, then the min across shards (replicated in and
    out)."""
    return allreduce([_propagate(lb, src, dst)
                      for lb, (src, dst) in zip(lab, shards)], "min")
