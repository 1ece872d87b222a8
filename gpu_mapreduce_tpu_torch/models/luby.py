"""Luby maximal independent set, on one device or a mesh.

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
address).  The host reads one small vector a round: whether any vertex
is undecided, and each shard's surviving edge count (which sizes the
compaction, so it reads nothing more).

On a mesh (:func:`luby_mis_sharded`, JAX ``luby_mis_sharded``) each shard
keeps its own edges and a copy of the state and the priorities on its
device; the three reductions of a round (the least neighbour priority,
the least tie rank, whether a neighbour won) are taken per shard and
then across the shards (``parallel/collectives.allreduce``, the JAX
``pmin``/``pmax``), in float64 and int32, so the set and the round count
equal one device's.  One device is the one-shard case.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..parallel.collectives import allreduce, per_device, replicate

_INT32_MAX = torch.iinfo(torch.int32).max


def _round(state: List[torch.Tensor], prio: List[torch.Tensor],
           shards: Sequence[Tuple[torch.Tensor, torch.Tensor]]
           ) -> List[torch.Tensor]:
    """One round over each shard's edges (src, dst) between undecided
    vertices (int64 ranks, both directions used); ``state`` and ``prio``
    are replicated (one tensor a shard, shared by the shards of a
    device).  Returns the next state, replicated."""
    n = state[0].shape[0]
    # the vertex a contribution lands on, and the neighbour it comes from
    dirs = [(torch.cat([dst, src]), torch.cat([src, dst]))
            for src, dst in shards]

    # least priority among undecided neighbours
    pv = [p[other] for p, (_, other) in zip(prio, dirs)]
    m1 = allreduce([torch.full((n,), float("inf"), dtype=torch.float64,
                               device=v.device).scatter_reduce_(
                                   0, tgt, v, "amin")
                    for v, (tgt, _) in zip(pv, dirs)], "min")
    # least neighbour rank among the holders of that priority (tie-break)
    mid = allreduce([torch.full((n,), _INT32_MAX, dtype=torch.int32,
                                device=v.device).scatter_reduce_(
        0, tgt, torch.where(v == m[tgt], other.to(torch.int32), _INT32_MAX),
        "amin") for v, m, (tgt, other) in zip(pv, m1, dirs)], "min")
    del pv

    def won(st, p, m, t):
        idx = torch.arange(n, dtype=torch.int32, device=st.device)
        return (st == 0) & ((p < m) | ((p == m) & (idx < t)))
    winner = per_device(won, state, prio, m1, mid)

    # neighbours of winners are excluded (only undecided ones change)
    wn = allreduce([torch.zeros(n, dtype=torch.int32, device=w.device)
                    .scatter_reduce_(0, tgt, w[other].to(torch.int32),
                                     "amax")
                    for w, (tgt, other) in zip(winner, dirs)], "max")

    def step(st, w, x):
        lose = (st == 0) & ~w & (x > 0)
        return torch.where(w, 1, torch.where(lose, 2, st)).to(torch.int8)
    return per_device(step, state, winner, wn)


def luby_mis(src: torch.Tensor, dst: torch.Tensor, prio: torch.Tensor,
             n: int, maxiter: int = 0) -> Tuple[torch.Tensor, int]:
    """Rounds until no vertex is undecided (at most ``maxiter``, default
    n).  ``prio``: float64 priorities over ranks (``vertex_rand`` of the
    vertex ids).  Returns (state [n] int8 of 1 in the set / 2 excluded,
    rounds)."""
    return luby_mis_sharded([(src, dst)], prio, n, maxiter)


def luby_mis_sharded(shards: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     prio: torch.Tensor, n: int, maxiter: int = 0
                     ) -> Tuple[torch.Tensor, int]:
    """:func:`luby_mis` over ``(src, dst)`` rank edges a shard, each pair
    on its shard's device (``prio`` on the first shard's).  Returns
    (state [n] int8 on the first shard's device, rounds)."""
    maxiter = maxiter or max(n, 1)
    devices = [src.device for src, _ in shards]
    prio = replicate(prio, devices)
    state = replicate(torch.zeros(n, dtype=torch.int8, device=prio[0].device),
                      devices)
    dev0, it = devices[0], 0
    while it < maxiter:
        und = per_device(lambda st: st == 0, state)
        alive = [u[src] & u[dst] for u, (src, dst) in zip(und, shards)]
        # one read: any vertex undecided, and each shard's live edges
        got = torch.stack([und[0].any().to(torch.int64)] + [
            a.sum().to(dev0, non_blocking=True) for a in alive]).tolist()
        if not got[0]:
            break
        keep = [torch.nonzero_static(a, size=c).squeeze(1)
                for a, c in zip(alive, got[1:])]
        shards = [(src[k], dst[k]) for (src, dst), k in zip(shards, keep)]
        del alive, keep
        state = _round(state, prio, shards)
        it += 1
    return state[0], it
