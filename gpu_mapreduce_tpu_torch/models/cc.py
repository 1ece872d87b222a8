"""Connected components by label propagation on one device.

The counterpart of ``gpu_mapreduce_tpu/models/cc.py``: labels are a
dense int32 vector over vertex ranks; each round every edge pulls both
endpoints toward the smaller label (two ``scatter_reduce_(..., "amin")``,
the JAX ``segment_min``) and one pointer-jumping hop ``min(lab,
lab[lab])`` shortens label chains.  At the fixpoint every vertex holds
the least rank of its component.  Min is exact, so labels and the round
count equal the JAX package's on any device.  The host reads one flag a
round (whether any label changed).
"""

from __future__ import annotations

from typing import Tuple

import torch

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
    maxiter = maxiter or max(n, 1)
    lab = torch.arange(n, dtype=torch.int32, device=src.device)
    changed, it = n > 0, 0
    while changed and it < maxiter:
        nl = _propagate(lab, src, dst)
        changed = bool((nl != lab).any())
        lab, it = nl, it + 1
    return lab, it
