"""Luby maximal independent set on one device.

The counterpart of ``gpu_mapreduce_tpu/models/luby.py``: the state is an
int8 vector over vertex ranks (0 undecided, 1 in the set, 2 excluded).
Each round an undecided vertex joins when its (priority, rank) is
lexicographically below every undecided neighbour's: a float64
``scatter_reduce_(..., "amin")`` finds the least neighbour priority, a
second ``amin`` the least neighbour rank among the holders of it, and an
``amax`` marks the neighbours of the winners excluded.  A vertex whose
undecided neighbourhood empties sees +inf and joins (maximality).  Min
and max are exact and the priorities stay float64 end to end, so the set
and the round count equal the JAX package's bit for bit.

Where the JAX round masks the edges with a decided endpoint (sending
them to a dump segment), each round here first drops them from the edge
list: a decided vertex never becomes undecided again, so a dropped edge
would never count again, and the later rounds touch only the edges still
alive (a dump segment would take every dead edge's atomic update on one
address).  The host reads the surviving edge count and one flag (whether
any vertex is undecided) a round.
"""

from __future__ import annotations

from typing import Tuple

import torch

_INT32_MAX = torch.iinfo(torch.int32).max


def _round(state: torch.Tensor, prio: torch.Tensor, src: torch.Tensor,
           dst: torch.Tensor) -> torch.Tensor:
    """One round over the edges (src, dst) between undecided vertices
    (int64 ranks, both directions used); returns the next state."""
    n = state.shape[0]
    dev = state.device
    und = state == 0
    tgt = torch.cat([dst, src])           # the vertex a contribution lands on
    other = torch.cat([src, dst])         # the neighbour it comes from

    # least priority among undecided neighbours
    pv = prio[other]
    m1 = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
    m1 = m1.scatter_reduce_(0, tgt, pv, "amin")
    # least neighbour rank among the holders of that priority (tie-break)
    hold = pv == m1[tgt]
    del pv
    mid = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=dev)
    mid = mid.scatter_reduce_(0, tgt, torch.where(
        hold, other.to(torch.int32), _INT32_MAX), "amin")
    del hold

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    winner = und & ((prio < m1) | ((prio == m1) & (idx < mid)))

    # neighbours of winners are excluded (only undecided ones change)
    wn = torch.zeros(n, dtype=torch.int32, device=dev)
    wn = wn.scatter_reduce_(0, tgt, winner[other].to(torch.int32), "amax")
    lose = und & ~winner & (wn > 0)
    return torch.where(winner, 1, torch.where(lose, 2, state)).to(torch.int8)


def luby_mis(src: torch.Tensor, dst: torch.Tensor, prio: torch.Tensor,
             n: int, maxiter: int = 0) -> Tuple[torch.Tensor, int]:
    """Rounds until no vertex is undecided (at most ``maxiter``, default
    n).  ``prio``: float64 priorities over ranks (``vertex_rand`` of the
    vertex ids).  Returns (state [n] int8 of 1 in the set / 2 excluded,
    rounds)."""
    maxiter = maxiter or max(n, 1)
    state = torch.zeros(n, dtype=torch.int8, device=prio.device)
    it = 0
    while it < maxiter and bool((state == 0).any()):
        und = state == 0
        alive = und[src] & und[dst]
        src, dst = src[alive], dst[alive]
        state = _round(state, prio, src, dst)
        it += 1
    return state, it
