"""luby_find — Luby maximal independent set.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/luby.py``
(reference ``oink/luby_find.cpp:53-115``).  Each vertex's priority is
``vertex_rand(v, seed)``.  Two engines (``LubyFind.engine`` or
``GPUMR_LUBY_ENGINE``, default ``fused``):

* ``fused`` — the edge KV is staged on the device, or shard by shard on
  a mesh, without its self-loops (a self-loop vertex could never win its
  own edge) and ``models/luby.py`` iterates there;
* ``composed`` — the reference's round of four reduces (edge winner,
  vertex winner, vertex loser, emit) over MapReduce ops, with ``clone``
  and ``open``/``close``; the callbacks' bodies (below) run on the
  frame's device.  A value is an ``[other, tag]`` u64 row; an edge's
  winner is the endpoint with the smaller (priority, id).

Both give a maximal independent set, not always the same one.  Output:
one set vertex per line.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.runtime import MRError
from ...models.luby import luby_mis_sharded
from ...parallel.devkernels import (kmv_row_state, seg_any, skmv_map,
                                    skv_map, u64_lt, u64_max, u64_min)
from ...parallel.staging import stage_graph
from ..command import Command, command, select_engine
from ..kernels import print_vertex, read_edge

_M64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    c &= _M64
    return c - (1 << 64) if c >> 63 else c


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns held in int64."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def vertex_rand(v: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic per-vertex random in [0, 1): splitmix64(v + seed)
    reduced to its top 53 bits, as float64 (the reference's
    srand48(v+seed)/drand48, oink/luby_find.cpp:130-134).  ``v`` holds
    u64 ids as int64; multiplication and addition wrap mod 2^64."""
    z = v.to(torch.int64) + _i64(seed) + _i64(0x9E3779B97F4A7C15)
    z = (z ^ _shr(z, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _i64(0x94D049BB133111EB)
    z = z ^ _shr(z, 31)
    return _shr(z, 11).to(torch.float64) / float(1 << 53)


# ---------------------------------------------------------------------------
# the composed engine's callbacks (reference luby_find.cpp:140-344), each a
# device body run by parallel/devkernels.py
# ---------------------------------------------------------------------------

def _copy_edge_dev(k, v, c):
    k = k[:c]
    return k, torch.zeros(c, dtype=torch.uint8, device=k.device), \
        k[:, 0] != k[:, 1]


def copy_edge(fr, kv, ptr):
    """Eij:NULL → Eij:NULL working copy without self-loops: a self-loop
    vertex could never win its own edge, and the round would never end."""
    kv.add_frame(skv_map(fr, _copy_edge_dev, device=kv.device))


def _edge_winner_dev(uk, nv, vo, vals, gc, vc, seed):
    seg, rows_valid, groups_valid = kmv_row_state(nv, vo, vals, gc, vc)
    # round 1's values are clone's u8 NULLs, later rounds' u64 tags
    flag = vals if vals.dim() == 1 else vals[:, 0]
    alive = groups_valid & ~seg_any(flag != 0, seg, rows_valid,
                                    uk.shape[0])
    vi, vj = uk[:, 0], uk[:, 1]
    ri, rj = vertex_rand(vi, seed), vertex_rand(vj, seed)
    vi_wins = (ri < rj) | ((ri == rj) & u64_lt(vi, vj))
    w = torch.where(vi_wins, vi, vj)
    lost = torch.where(vi_wins, vj, vi)
    one = torch.ones_like(w)
    return (torch.cat([w, lost]),
            torch.cat([torch.stack([lost, one], 1),
                       torch.stack([w, one - 1], 1)]),
            torch.cat([alive, alive]))


def edge_winner(fr, kv, ptr):
    """Edge group of flags → v:[other, v-won] both ways for each edge with
    no flagged endpoint (reduce_edge_winner, luby_find.cpp:140-182);
    ``ptr`` is the seed."""
    kv.add_frame(skmv_map(fr, _edge_winner_dev, extra=(ptr,),
                          device=kv.device))


def _tag_neighbours(uk, seg, vals, rows_valid, tag):
    """other:[v, tag of v] for each row of v's group."""
    g = seg.clamp(min=0)
    return vals[:, 0], torch.stack([uk[g], tag[g].to(torch.int64)], 1), \
        rows_valid


def _vert_winner_dev(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    lost_any = seg_any(vals[:, 1] == 0, seg, rows_valid, uk.shape[0])
    return _tag_neighbours(uk, seg, vals, rows_valid, ~lost_any)


def vert_winner(fr, kv, ptr):
    """v's group of [other, v-won]: v wins every edge ⇒ a round winner;
    other:[v, v-is-winner] (reduce_vert_winner)."""
    kv.add_frame(skmv_map(fr, _vert_winner_dev, device=kv.device))


def _vert_loser_dev(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    loser = seg_any(vals[:, 1] == 1, seg, rows_valid, uk.shape[0])
    return _tag_neighbours(uk, seg, vals, rows_valid, loser)


def vert_loser(fr, kv, ptr):
    """v's group of [other, other-is-winner]: a winner neighbour ⇒ v
    loses; other:[v, v-is-loser] (reduce_vert_loser)."""
    kv.add_frame(skmv_map(fr, _vert_loser_dev, device=kv.device))


def _vert_emit_mis_dev(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, groups_valid = kmv_row_state(nv, vo, vals, gc, vc)
    survivor_nb = seg_any(vals[:, 1] == 0, seg, rows_valid, uk.shape[0])
    return uk, torch.zeros(uk.shape[0], dtype=torch.uint8,
                           device=uk.device), groups_valid & ~survivor_nb


def _vert_emit_edges_dev(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    v, u = uk[seg.clamp(min=0)], vals[:, 0]
    return (torch.stack([u64_min(v, u), u64_max(v, u)], 1), vals[:, 1],
            rows_valid)


def vert_emit(fr, kv, ptr):
    """v's group of [other, other-is-loser]: every neighbour a loser ⇒ v
    joins the set (added to the open MR ``ptr``); the next round's edges
    are rebuilt with the loser tag as their flag (reduce_vert_emit,
    luby_find.cpp:289-344)."""
    ptr.kv.add_frame(skmv_map(fr, _vert_emit_mis_dev, device=kv.device))
    kv.add_frame(skmv_map(fr, _vert_emit_edges_dev, device=kv.device))


@command("luby_find")
class LubyFind(Command):
    """luby_find seed: a maximal independent set of an undirected edge
    list (``nset`` vertices after ``niterate`` rounds)."""

    ninputs = 1
    noutputs = 1
    engine: str | None = None   # None → GPUMR_LUBY_ENGINE env (or fused)

    def params(self, args):
        if len(args) != 1:
            raise MRError("Illegal luby_find command")
        self.seed = int(args[0])

    def run(self):
        if select_engine(self.engine, "GPUMR_LUBY_ENGINE",
                         "luby_find") == "composed":
            return self._run_composed()
        obj = self.obj
        mre = obj.input(1, read_edge)
        sg = stage_graph(mre, drop_self=True)
        mrv = obj.create_mr()
        if sg is None:
            self.nset, self.niterate = 0, 0
        else:
            prio = vertex_rand(sg.verts, self.seed)
            state, self.niterate = luby_mis_sharded(
                [(s.src, s.dst) for s in sg.shards], prio, sg.n)
            mis = sg.verts[state == 1]
            self.nset = int(mis.numel())
            mrv.map(1, lambda i, kv, p: kv.add_batch(
                mis, torch.zeros(mis.shape[0], dtype=torch.uint8,
                                 device=mis.device),
                key_dtype=np.uint64))
        obj.output(1, mrv, print_vertex)
        self.message(f"Luby_find: {self.nset} MIS vertices in "
                     f"{self.niterate} iterations")
        obj.cleanup()

    def _run_composed(self):
        obj = self.obj
        mre = obj.input(1, read_edge)
        mre.aggregate()   # the edge list moves to the device once
        mrv = obj.create_mr()
        mrw = obj.create_mr()
        mrw.map_mr(mre, copy_edge, batch=True)
        mrw.clone()

        niterate = 0
        mrv.open()
        while mrw.reduce(edge_winner, ptr=self.seed, batch=True):
            mrw.collate()
            mrw.reduce(vert_winner, batch=True)
            mrw.collate()
            mrw.reduce(vert_loser, batch=True)
            mrw.collate()
            mrw.reduce(vert_emit, ptr=mrv, batch=True)
            mrw.collate()
            niterate += 1
        self.nset, self.niterate = mrv.close(), niterate
        obj.output(1, mrv, print_vertex)
        self.message(f"Luby_find: {self.nset} MIS vertices in {niterate} "
                     f"iterations")
        obj.cleanup()
