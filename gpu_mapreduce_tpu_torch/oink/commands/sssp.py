"""sssp — single-source shortest paths from deterministic-random sources.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/sssp.py``
(reference ``oink/sssp.cpp:49-180``).  The sources are the first
``ncnt`` vertices ordered by (``vertex_rand(v, seed)``, v).  Two engines
(``SSSPCommand.engine`` or ``GPUMR_SSSP_ENGINE``, default ``fused``):

* ``fused`` — the weighted edge KV is staged on the device once, or
  shard by shard on a mesh (``need_weights``), and ``models/sssp.py``
  relaxes it from each source;
* ``composed`` — the reference's Bellman-Ford rounds over MapReduce ops
  (``compress``, ``open``/``close``): candidate distances join the
  per-vertex state, the best (dist, pred) per vertex is kept, and the
  changed ones relax their out-edges.  Every value is a ``[tag, a, b,
  c]`` float64 row — an edge ``[0, vj, wt, 0]``, a distance ``[1, pred,
  dist, current]`` — so vertex ids pass through float64, exact below
  2^53 as in the JAX package.  The callbacks' bodies (below) run on the
  frame's device.

Output per source: ``v dist pred`` lines in ascending v (``.<cnt>``
appended to the path when ncnt > 1), inf for the unreached and pred 0
where there is none; a named-MR output holds the last source's rows
``[1, pred, dist, 1]`` with pred -1.0 (``NO_PRED``) where there is none.
``results`` ({source: {v: (dist, pred)}}) is built when first read.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.runtime import MRError
from ...models.sssp import bellman_ford_sharded
from ...ops.bits import order_key, to_numpy
from ...parallel.devkernels import (f64_to_u64, kmv_row_state, seg_any,
                                    seg_lex_min2, seg_min_with, skmv_map,
                                    skv_map)
from ...parallel.staging import as_float64, stage_graph
from ..command import Command, command, select_engine
from ..kernels import cull, edge_to_vertices, read_edge_weight
from .luby import vertex_rand

TAG_EDGE, TAG_DIST = 0.0, 1.0
NO_PRED = -1.0
_INF = float("inf")


# ---------------------------------------------------------------------------
# the composed engine's callbacks (reference sssp.cpp:187-360), each a
# device body run by parallel/devkernels.py
# ---------------------------------------------------------------------------

def _reorganize_edges_dev(k, v, c, key_dtype, value_dtype):
    k, v = k[:c], v[:c]
    z = torch.zeros(c, dtype=torch.float64, device=k.device)
    oval = torch.stack([z, as_float64(k[:, 1], key_dtype),
                        as_float64(v, value_dtype), z], 1)
    return k[:, 0], oval, None


def reorganize_edges(fr, kv, ptr):
    """Eij:wt → vi:[0, vj, wt, 0], out-edges keyed by their source
    (reorganize_edges, sssp.cpp:187-199)."""
    kv.add_frame(skv_map(fr, _reorganize_edges_dev,
                         extra=(fr.key_dtype, fr.value_dtype),
                         device=kv.device))


def _init_distance_dev(k, v, c):
    row = torch.tensor([TAG_DIST, NO_PRED, _INF, 1.0], dtype=torch.float64,
                       device=k.device)
    return k[:c], row.expand(c, 4), None


def init_distance(fr, kv, ptr):
    """v:* → v:[1, NO_PRED, inf, 1] (initialize_vertex_distances,
    sssp.cpp:231-237)."""
    kv.add_frame(skv_map(fr, _init_distance_dev, device=kv.device))


def _state_rows(dist, pred):
    one = torch.ones_like(dist)
    return torch.stack([one, pred, dist, one], 1)


def _pick_shortest_state(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, groups_valid = kmv_row_state(nv, vo, vals, gc, vc)
    wdist, wpred = seg_lex_min2(vals[:, 2], vals[:, 1], seg, rows_valid,
                                uk.shape[0], _INF, _INF)
    return uk, _state_rows(wdist, wpred), groups_valid


def _pick_shortest_changed(uk, nv, vo, vals, gc, vc):
    """The winner row again where it differs from the group's previous
    current row, or where there was none."""
    gcap = uk.shape[0]
    seg, rows_valid, groups_valid = kmv_row_state(nv, vo, vals, gc, vc)
    wdist, wpred = seg_lex_min2(vals[:, 2], vals[:, 1], seg, rows_valid,
                                gcap, _INF, _INF)
    is_cur = rows_valid & (vals[:, 3] == 1.0)
    pdist = seg_min_with(vals[:, 2], seg, is_cur, gcap, _INF)
    ppred = seg_min_with(vals[:, 1], seg, is_cur, gcap, _INF)
    has_prev = seg_any(is_cur, seg, is_cur, gcap)

    def neq(x, y):
        return ~((x == y) | (torch.isnan(x) & torch.isnan(y)))

    changed = groups_valid & (~has_prev | neq(wdist, pdist)
                              | neq(wpred, ppred))
    return uk, _state_rows(wdist, wpred), changed


def pick_shortest(fr, kv, ptr):
    """Vertex group of distance rows: the least (dist, pred) back to the
    vertex state as the current row, and into the open MR ``ptr`` where
    it changed (pick_shortest_distances, sssp.cpp:244-293)."""
    kv.add_frame(skmv_map(fr, _pick_shortest_state, device=kv.device))
    ptr.kv.add_frame(skmv_map(fr, _pick_shortest_changed,
                              device=kv.device))


def _update_adjacent_edges(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    return uk[seg.clamp(min=0)], vals, rows_valid & (vals[:, 0] == TAG_EDGE)


def _update_adjacent_relax(uk, nv, vo, vals, gc, vc):
    gcap = uk.shape[0]
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    is_dist = rows_valid & (vals[:, 0] == TAG_DIST)
    bdist, bpred = seg_lex_min2(vals[:, 2], vals[:, 1], seg, is_dist, gcap,
                                _INF, _INF)
    has_dist = seg_any(is_dist, seg, is_dist, gcap)
    g = seg.clamp(min=0)
    vj = vals[:, 1]
    vi = as_float64(uk, np.uint64)[g]
    bd = bdist[g]
    relax = (rows_valid & (vals[:, 0] == TAG_EDGE) & has_dist[g]
             & (vj != bpred[g]) & (vj != vi) & torch.isfinite(bd))
    zero = torch.zeros_like(vj)
    return (f64_to_u64(vj), torch.stack([zero + 1, vi, bd + vals[:, 2],
                                         zero], 1), relax)


def update_adjacent(fr, kv, ptr):
    """Vertex group of out-edge rows and arriving distance rows: the
    edges back unchanged, and where a distance arrived each out-edge
    relaxed into the open MR ``ptr``, except back to the predecessor and
    along a self-loop (update_adjacent_distances, sssp.cpp:299-360)."""
    kv.add_frame(skmv_map(fr, _update_adjacent_edges, device=kv.device))
    ptr.kv.add_frame(skmv_map(fr, _update_adjacent_relax, device=kv.device))


@command("sssp")
class SSSPCommand(Command):
    """sssp ncnt seed: shortest paths over a directed weighted edge list;
    ``niters[source]`` rounds per source."""

    ninputs = 1
    noutputs = 1
    engine: str | None = None   # None → GPUMR_SSSP_ENGINE env (or fused)

    def params(self, args):
        if len(args) != 2:
            raise MRError("Illegal sssp command")
        self.ncnt = int(args[0])
        self.seed = int(args[1])

    def run(self):
        composed = select_engine(self.engine, "GPUMR_SSSP_ENGINE",
                                 "sssp") == "composed"
        self._runs, self._results, self.niters = [], None, {}
        if composed:
            return self._run_composed()
        obj = self.obj
        mredge = obj.input(1, read_edge_weight)
        sg = stage_graph(mredge, need_weights=True)
        if sg is None:
            raise MRError("sssp: empty edge list")
        verts, n = sg.verts, sg.n
        # a stable sort of the unsigned-ascending table by priority: ties
        # keep ascending v, as the JAX lexsort((verts, prio)) orders them
        order = torch.sort(vertex_rand(verts, self.seed), stable=True
                           ).indices[:self.ncnt]
        dist = pred = None
        for cnt, sidx in enumerate(order.tolist()):
            source = int(to_numpy(verts[sidx:sidx + 1], np.uint64)[0])
            dist, pred, niter = bellman_ford_sharded(
                [(s.src, s.dst, s.weights) for s in sg.shards], n, sidx)
            pv = torch.where(pred >= 0, verts[pred.long().clamp(min=0)], 0)
            self._finish_source(cnt, source, niter, verts, dist, pv)
        outd = obj.outputs[0] if obj.outputs else None
        if outd is not None and outd.mr_name is not None:
            has = pred >= 0
            predf = torch.where(has, as_float64(verts[pred.long().clamp(
                min=0)], np.uint64), NO_PRED)
            rows = torch.stack([torch.full_like(dist, TAG_DIST), predf,
                                dist, torch.ones_like(dist)], 1)
            mrv = obj.create_mr()
            mrv.map(1, lambda i, kv, p: kv.add_batch(verts, rows,
                                                     key_dtype=np.uint64))
            obj.name_mr(outd.mr_name, mrv)
        obj.cleanup()

    def _run_composed(self):
        obj = self.obj
        mredge = obj.input(1, read_edge_weight)
        mredge.aggregate()   # the edge list moves to the device once

        # the vertex universe (sssp.cpp:63-66), one row a vertex
        mrvert = obj.create_mr()
        mrvert.map_mr(mredge, edge_to_vertices, batch=True)
        mrvert.collate()
        mrvert.reduce(cull, batch=True)
        verts, _ = mrvert.kv.one_frame().valid_rows()
        verts = verts[torch.sort(order_key(verts, np.uint64)).indices]
        order = torch.sort(vertex_rand(verts, self.seed), stable=True
                           ).indices[:self.ncnt]
        sources = to_numpy(verts[order], np.uint64).tolist()

        # out-edges keyed by their source (sssp.cpp:75-76)
        mradj = obj.create_mr()
        mradj.map_mr(mredge, reorganize_edges, batch=True)
        mradj.aggregate()

        device = obj.device
        src_row = torch.tensor([[TAG_DIST, NO_PRED, 0.0, 0.0]],
                               dtype=torch.float64, device=device)
        for cnt, source in enumerate(sources):
            mrvert.map_mr(mrvert, init_distance, batch=True)
            mredge_w = obj.create_mr()
            mredge_w.add(mradj)
            key = torch.tensor(np.array([source], np.uint64).view(np.int64),
                               device=device)
            mrpath = obj.create_mr()
            mrpath.map(1, lambda i, kv, p: kv.add_batch(
                key, src_row, key_dtype=np.uint64))

            niter = 0
            while True:
                mrpath.aggregate()
                mrvert.add(mrpath)
                obj.free_mr(mrpath)
                mrpath = obj.create_mr()
                mrpath.open()
                mrvert.compress(pick_shortest, ptr=mrpath, batch=True)
                nchanged = mrpath.close()
                niter += 1
                if nchanged == 0:
                    break
                mredge_w.add(mrpath)
                obj.free_mr(mrpath)
                mrpath = obj.create_mr()
                mrpath.open()
                mredge_w.compress(update_adjacent, ptr=mrpath, batch=True)
                mrpath.close()
            obj.free_mr(mrpath)
            obj.free_mr(mredge_w)

            keys, rows = mrvert.kv.one_frame().valid_rows()
            order = torch.sort(order_key(keys, np.uint64)).indices
            rows = rows[order]
            pred = rows[:, 1].clamp(min=0).to(torch.int64)
            self._finish_source(cnt, source, niter, keys[order],
                                rows[:, 2], pred)
        outd = obj.outputs[0] if obj.outputs else None
        if outd is not None and outd.mr_name is not None:
            obj.name_mr(outd.mr_name, mrvert)
        obj.cleanup()

    def _finish_source(self, cnt, source, niter, verts, dist, pred):
        """Keep one source's run (``verts`` ascending, ``pred`` the
        predecessor ids with 0 for none), report it, and write its file."""
        self._runs.append((source, verts, dist, pred))
        self.niters[source] = niter
        nlabeled = int(torch.isfinite(dist).sum())
        self.message(f"SSSP: source {source}: {niter} iterations, "
                     f"{nlabeled} vertices labeled")
        outd = self.obj.outputs[0] if self.obj.outputs else None
        if outd is not None and outd.path is not None:
            path = f"{outd.path}.{cnt}" if self.ncnt > 1 else outd.path
            v, d, p = self._host_rows(verts, dist, pred)
            with open(path, "w") as fp:
                fp.writelines(f"{a} {b:g} {c}\n" for a, b, c in zip(v, d, p))

    @staticmethod
    def _host_rows(verts, dist, pred):
        """(ids, distances, predecessor ids) as Python lists."""
        return (to_numpy(verts, np.uint64).tolist(), dist.tolist(),
                to_numpy(pred, np.uint64).tolist())

    @property
    def results(self) -> dict:
        """{source: {v: (dist, pred)}}, pred 0 where there is none (the
        JAX command's dict), built on first read."""
        if self._results is None:
            self._results = {}
            for source, verts, dist, pred in self._runs:
                v, d, p = self._host_rows(verts, dist, pred)
                self._results[source] = dict(zip(v, zip(d, p)))
        return self._results
