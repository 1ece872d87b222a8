"""cc_find / cc_stats — connected components by label propagation.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/cc.py`` (reference
``oink/cc_find.cpp:38-109``, ``oink/cc_stats.cpp:37-63``).  Every
component is named by its least vertex id.  Two engines
(``CCFind.engine`` or ``GPUMR_CC_ENGINE``, default ``fused``):

* ``fused`` — the edge KV is staged on the device, or shard by shard on
  a mesh (``parallel/staging.py``), and ``models/cc.py`` iterates there;
* ``composed`` — the reference's MapReduce composition, each round a
  chain of device-frame maps, collates and batch reduces whose bodies
  (below) run on the frame's device.  Values are tagged ``[tag, a, b]``
  u64 rows (tag 0 an edge payload, 1 a zone) where the reference tells
  record kinds apart by their size; the winner of two zones is the least
  id, and the reference's big-zone split (``nthresh``) is not needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.runtime import MRError
from ...models.cc import cc_sharded
from ...obs.tracer import get_tracer
from ...parallel.devkernels import (U64MAX, kmv_row_state, seg_max_u64,
                                    seg_min_u64, skmv_map, skv_map)
from ...parallel.staging import stage_graph
from ..command import Command, command, select_engine
from ..kernels import (count, edge_to_vertices, invert, print_vertex_value,
                       read_edge, read_vertex_value, value_histogram)


# ---------------------------------------------------------------------------
# the composed engine's callbacks (reference cc_find.cpp:129-260), each a
# device body run by parallel/devkernels.py
# ---------------------------------------------------------------------------

def _tagged(tag: int, a, b=None):
    """[tag, a, b] u64 rows (b = 0 when not given)."""
    b = torch.zeros_like(a) if b is None else b
    return torch.stack([torch.full_like(a, tag), a, b], 1)


def _self_zone_dev(uk, nv, vo, vals, gc, vc):
    return uk, uk, torch.arange(uk.shape[0], device=uk.device) < gc


def self_zone(fr, kv, ptr):
    """V:[..] group → V:V — every vertex starts in its own zone
    (reduce_self_zone, cc_find.cpp:132-137)."""
    kv.add_frame(skmv_map(fr, _self_zone_dev, device=kv.device))


def _edge_vert_tagged_dev(k, v, c):
    k = k[:c]
    tag0 = _tagged(0, k[:, 0], k[:, 1])
    return torch.cat([k[:, 0], k[:, 1]]), torch.cat([tag0, tag0]), None


def edge_vert_tagged(fr, kv, ptr):
    """Eij:NULL → Vi:[0,vi,vj] and Vj:[0,vi,vj] (map_edge_vert,
    cc_find.cpp:141-148, tagged instead of sized)."""
    kv.add_frame(skv_map(fr, _edge_vert_tagged_dev, device=kv.device))


def _zone_tagged_dev(k, v, c):
    return k[:c], _tagged(1, v[:c]), None


def zone_tagged(fr, kv, ptr):
    """V:zone → V:[1,zone,0] (the vertex side of the join)."""
    kv.add_frame(skv_map(fr, _zone_tagged_dev, device=kv.device))


def _edge_zone_dev(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    is_zone = vals[:, 0] == 1
    zone_of = seg_max_u64(vals[:, 1], seg, rows_valid & is_zone,
                          uk.shape[0])
    return vals[:, 1:3], zone_of[seg.clamp(min=0)], rows_valid & ~is_zone


def edge_zone(fr, kv, ptr):
    """Per-vertex group: the zone row's zone onto each edge row, Eij:zone
    (reduce_edge_zone, cc_find.cpp:152-186)."""
    kv.add_frame(skmv_map(fr, _edge_zone_dev, device=kv.device))


def _zone_winner_dev(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, groups_valid = kmv_row_state(nv, vo, vals, gc, vc)
    zmin = seg_min_u64(vals, seg, rows_valid, uk.shape[0])
    zmax = seg_max_u64(vals, seg, rows_valid, uk.shape[0])
    return zmax, zmin, groups_valid & (zmin != zmax)


def zone_winner(fr, kv, ptr):
    """Per-edge group of its endpoints' zones: where they differ, emit
    loser_zone:winner_zone, the winner the least id (reduce_zone_winner,
    cc_find.cpp:190-219).  Emits nothing once converged."""
    kv.add_frame(skmv_map(fr, _zone_winner_dev, device=kv.device))


def _invert_zone_tagged_dev(k, v, c):
    return v[:c], _tagged(0, k[:c]), None


def invert_zone_tagged(fr, kv, ptr):
    """V:zone → zone:[0,v,0] — membership rows for the reassignment
    (map_invert_multi, cc_find.cpp:223-238, without the hi-bit split)."""
    kv.add_frame(skv_map(fr, _invert_zone_tagged_dev, device=kv.device))


def _winner_tagged_dev(k, v, c):
    return k[:c], _tagged(1, v[:c]), None


def winner_tagged(fr, kv, ptr):
    """loser_zone:winner → loser_zone:[1,winner,0] (map_zone_multi,
    cc_find.cpp:242-...)."""
    kv.add_frame(skv_map(fr, _winner_tagged_dev, device=kv.device))


def _zone_reassign_dev(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    is_win = vals[:, 0] == 1
    win_zone = seg_min_u64(vals[:, 1], seg, rows_valid & is_win,
                           uk.shape[0])
    new_zone = torch.where(win_zone != U64MAX, win_zone, uk)
    return vals[:, 1], new_zone[seg.clamp(min=0)], rows_valid & ~is_win


def zone_reassign(fr, kv, ptr):
    """Per-zone group: its members move to the least winner zone when a
    winner row is present, else stay (reduce_zone_reassign)."""
    kv.add_frame(skmv_map(fr, _zone_reassign_dev, device=kv.device))


@command("cc_find")
class CCFind(Command):
    """cc_find nthresh: (Vi, Zi) with Zi the least vertex id of Vi's
    component.  ``nthresh`` (the reference's big-zone split) is accepted
    and ignored, as in the JAX package.  Traced, each round of the
    composed engine is a ``cc.round`` span (``round``, and ``changed``,
    the zones that moved), and the command's span carries ``rounds``."""

    ninputs = 1
    noutputs = 1
    engine: str | None = None   # None → GPUMR_CC_ENGINE env (or fused)

    def params(self, args):
        if len(args) != 1:
            raise MRError("Illegal cc_find command")
        self.nthresh = int(args[0])

    def run(self):
        if select_engine(self.engine, "GPUMR_CC_ENGINE",
                         "cc_find") == "composed":
            return self._run_composed()
        obj = self.obj
        mre = obj.input(1, read_edge)
        mrv = obj.create_mr()
        sg = stage_graph(mre)
        if sg is None:
            self.ncc, self.niterate = 0, 0
        else:
            labels, self.niterate = cc_sharded(
                [(s.src, s.dst) for s in sg.shards], sg.n)
            zones = sg.verts[labels.long()]   # least vertex id per component
            self.ncc = int(torch.unique(labels).numel())
            mrv.map(1, lambda i, kv, p: kv.add_batch(
                sg.verts, zones, key_dtype=np.uint64, value_dtype=np.uint64))
        obj.output(1, mrv, print_vertex_value)
        self.message(f"CC_find: {self.ncc} components in "
                     f"{self.niterate} iterations")
        obj.cleanup()
        get_tracer().annotate(rounds=self.niterate)

    def _run_composed(self):
        obj = self.obj
        mre = obj.input(1, read_edge)
        mre.aggregate()   # the edge list moves to the device once
        mrv = obj.create_mr()
        mrv.map_mr(mre, edge_to_vertices, batch=True)
        mrv.collate()
        mrv.reduce(self_zone, batch=True)

        tr = get_tracer()
        niterate = 0
        while True:
            niterate += 1
            with tr.span("cc.round", cat="oink", round=niterate) as sp:
                mrz = obj.create_mr()
                mrz.map_mr(mre, edge_vert_tagged, batch=True)
                tmp = obj.create_mr()
                tmp.map_mr(mrv, zone_tagged, batch=True)
                mrz.add(tmp)
                obj.free_mr(tmp)
                mrz.collate()
                mrz.reduce(edge_zone, batch=True)
                mrz.collate()
                nchanged = int(mrz.reduce(zone_winner, batch=True))
                sp.set(changed=nchanged)
                if not nchanged:
                    obj.free_mr(mrz)
                    break
                tmp = obj.create_mr()
                tmp.map_mr(mrv, invert_zone_tagged, batch=True)
                tmp2 = obj.create_mr()
                tmp2.map_mr(mrz, winner_tagged, batch=True)
                tmp.add(tmp2)
                tmp.collate()
                tmp.reduce(zone_reassign, batch=True)
                obj.free_mr(mrz)
                obj.free_mr(tmp2)
                obj.free_mr(mrv)
                mrv = tmp

        mrt = obj.create_mr()
        mrt.map_mr(mrv, invert, batch=True)
        self.ncc, self.niterate = mrt.collate(), niterate
        obj.output(1, mrv, print_vertex_value)
        self.message(f"CC_find: {self.ncc} components in {niterate} "
                     f"iterations")
        obj.cleanup()
        tr.annotate(rounds=niterate)


@command("cc_stats")
class CCStats(Command):
    """cc_stats: histogram of component sizes from (Vi, Zi) pairs.
    self.stats = [(size, ncomponents)] by size descending."""

    ninputs = 1

    def params(self, args):
        if args:
            raise MRError("Illegal cc_stats command")

    def run(self):
        obj = self.obj
        mrv = obj.input(1, read_vertex_value)
        mr = obj.create_mr()
        nvert = mr.map_mr(mrv, invert, batch=True)
        ncc = mr.collate()
        mr.reduce(count, batch=True)
        self.nvert, self.ncc = nvert, ncc
        self.message(f"CCStats: {ncc} components, {nvert} vertices")
        self.stats = value_histogram(mr)
        for size, n in self.stats:
            self.message(f"  {size} {n}")
        obj.cleanup()
