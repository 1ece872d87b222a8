"""tri_find / neigh_tri — triangle enumeration and per-vertex files.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/tri.py`` (reference
``oink/tri_find.cpp:43-81``, ``oink/neigh_tri.cpp:40-69``).  Two
``tri_find`` engines (``TriFind.engine`` or ``GPUMR_TRI_ENGINE``, default
``fused``), with the same triangle set:

* ``fused`` — the edge KV is staged on the device (on a mesh, the
  shards' ranked edges joined in shard order on the first shard's
  device, as the JAX command joins their valid rows) and
  ``models/tri.py`` walks the degree-ordered wedges there; rows are
  (centre, u, w), centre the low-degree vertex that emitted the wedge;
* ``composed`` — the reference's MapReduce pipeline: edges gain their
  endpoints' degrees, the low-degree endpoint emits every pair of its
  neighbours as an angle, and the angles join the original edges; rows
  are (centre, vj, vk).  The callbacks' bodies (below) run on the
  frame's device.

``neigh_tri`` writes one file per vertex from ``scan_kmv``, on the host.
Tagged ``[tag, a, b]`` u64 rows stand in for the reference's
valuebytes-discriminated unions (tag 0 an original edge or a neighbour,
1 an angle or a triangle's opposite edge).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...core.frame import KVFrame
from ...core.runtime import MRError
from ...models.tri import triangles_ranked
from ...parallel.devkernels import (kmv_row_state, seg_any, skmv_map,
                                    skv_map, u64_lt, u64_max, u64_min)
from ...parallel.staging import stage_graph
from ..command import Command, command, select_engine
from ..kernels import (_parse_cols, edge_both_directions, read_edge,
                       sum_values)


def print_tri(k, v, fp):
    fp.write(f"{k[0]} {k[1]} {k[2]}\n")


# ---------------------------------------------------------------------------
# the composed engine's callbacks (reference tri_find.cpp:116-300), each a
# device body run by parallel/devkernels.py
# ---------------------------------------------------------------------------

def _first_degree_dev(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    g = seg.clamp(min=0)
    center, d = uk[g], nv[g].to(torch.int64)
    is_i = u64_lt(center, vals)
    zero = torch.zeros_like(d)
    return (torch.stack([u64_min(center, vals), u64_max(center, vals)], 1),
            torch.stack([torch.where(is_i, d, zero),
                         torch.where(is_i, zero, d)], 1), rows_valid)


def first_degree(fr, kv, ptr):
    """Vertex group of its d neighbours: each canonical edge → (d, 0) or
    (0, d) by which end the vertex is (reduce_first_degree,
    tri_find.cpp:116-159)."""
    kv.add_frame(skmv_map(fr, _first_degree_dev, device=kv.device))


def _low_degree_dev(k, v, c):
    k, v = k[:c], v[:c]
    low_is_i = u64_lt(v[:, 0], v[:, 1]) | ((v[:, 0] == v[:, 1])
                                           & u64_lt(k[:, 0], k[:, 1]))
    return (torch.where(low_is_i, k[:, 0], k[:, 1]),
            torch.where(low_is_i, k[:, 1], k[:, 0]), None)


def low_degree(fr, kv, ptr):
    """Eij:(Di, Dj) → the lower-degree endpoint : the other, a degree tie
    going to the smaller id (map_low_degree, tri_find.cpp:185-207)."""
    kv.add_frame(skv_map(fr, _low_degree_dev, device=kv.device))


def _nsq_angles_dev(uk, nv, vo, vals, gc, vc):
    """Every pair j < k of rows of a group, as (vj, vk) canonical :
    [1, centre, 0].  The pair count is read first (one host read), so
    the expansion is sized exactly."""
    vcap = vals.shape[0]
    dev = vals.device
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    g = seg.clamp(min=0)
    r = torch.arange(vcap, device=dev)
    end = (vo.to(torch.int64) + nv)[g]                # the group's end row
    rem = torch.where(rows_valid, end - r - 1, 0).clamp(min=0)
    del end
    total = int(rem.sum())
    j_idx = torch.repeat_interleave(r, rem, output_size=total)
    off = torch.cumsum(rem, 0) - rem                  # exclusive
    del rem
    k_idx = torch.arange(total, device=dev) - off[j_idx] + j_idx + 1
    del off
    vj, vk = vals[j_idx], vals[k_idx]
    del k_idx
    center = uk[g[j_idx]]
    del j_idx
    key = torch.stack([u64_min(vj, vk), u64_max(vj, vk)], 1)
    del vj, vk
    one = torch.ones_like(center)
    return key, torch.stack([one, center, one - 1], 1), None


def nsq_angles(fr, kv, ptr):
    """Centre group: every unordered pair (vj, vk) of its neighbours is an
    angle, a triangle that lacks only the vj-vk edge: emit (vj, vk) :
    [1, centre, 0] (reduce_nsq_angles, tri_find.cpp:211-276)."""
    kv.add_frame(skmv_map(fr, _nsq_angles_dev, device=kv.device))


def _edge_null_tagged_dev(k, v, c):
    return k[:c], torch.zeros((c, 3), dtype=torch.int64, device=k.device), \
        None


def edge_null_tagged(fr, kv, ptr):
    """Eij:NULL → Eij:[0, 0, 0], the original-edge rows of the angle join
    (the reference uses a zero-size value)."""
    kv.add_frame(skv_map(fr, _edge_null_tagged_dev, device=kv.device))


def _emit_triangles_dev(uk, nv, vo, vals, gc, vc):
    seg, rows_valid, _ = kmv_row_state(nv, vo, vals, gc, vc)
    has_edge = seg_any(vals[:, 0] == 0, seg, rows_valid, uk.shape[0])
    take = rows_valid & (vals[:, 0] != 0) & has_edge[seg.clamp(min=0)]
    idx = torch.nonzero(take).squeeze(1)      # gather only the triangles
    del take
    e = uk[seg[idx]]
    okey = torch.stack([vals[idx, 1], e[:, 0], e[:, 1]], 1)
    return okey, torch.zeros(idx.shape[0], dtype=torch.uint8,
                             device=idx.device), None


def emit_triangles(fr, kv, ptr):
    """Edge group of tagged rows: with an original-edge row present,
    each angle row (centre vi) closes a triangle (vi, vj, vk)
    (reduce_emit_triangles, tri_find.cpp:280-...)."""
    kv.add_frame(skmv_map(fr, _emit_triangles_dev, device=kv.device,
                          per_value=True))


@command("tri_find")
class TriFind(Command):
    """tri_find: every triangle of an edge list once (``ntri`` rows; the
    fused engine also counts its ``nwedges``)."""

    ninputs = 1
    noutputs = 1
    engine: str | None = None   # None → GPUMR_TRI_ENGINE env (or fused)

    def params(self, args):
        if args:
            raise MRError("Illegal tri_find command")

    def run(self):
        if select_engine(self.engine, "GPUMR_TRI_ENGINE",
                         "tri_find") == "composed":
            return self._run_composed()
        obj = self.obj
        mre = obj.input(1, read_edge)
        sg = stage_graph(mre)
        mrt = obj.create_mr()
        if sg is None:
            self.ntri, self.nwedges = 0, 0
        else:
            tris, self.nwedges = triangles_ranked(sg.src, sg.dst, sg.n,
                                                  sg.verts)
            self.ntri = int(tris.shape[0])
            mrt.map(1, lambda i, kv, p: kv.add_batch(
                tris, torch.zeros(tris.shape[0], dtype=torch.uint8,
                                  device=tris.device), key_dtype=np.uint64))
        obj.output(1, mrt, print_tri)
        self.message(f"Tri_find: {self.ntri} triangles")
        obj.cleanup()

    def _run_composed(self):
        obj = self.obj
        mre = obj.input(1, read_edge)
        mre.aggregate()   # the edge list moves to the device once
        mrt = obj.create_mr()

        # each edge with its endpoints' degrees: (Eij, (Di, Dj))
        mrt.map_mr(mre, edge_both_directions, batch=True)
        mrt.collate()
        mrt.reduce(first_degree, batch=True)
        mrt.collate()
        mrt.reduce(sum_values, batch=True)

        # angles from the low-degree endpoint, joined with the edges
        mrt.map_mr(mrt, low_degree, batch=True)
        mrt.collate()
        mrt.reduce(nsq_angles, batch=True)
        tmp = obj.create_mr()
        tmp.map_mr(mre, edge_null_tagged, batch=True)
        mrt.add(tmp)
        obj.free_mr(tmp)
        mrt.collate()
        self.ntri = mrt.reduce(emit_triangles, batch=True)
        obj.output(1, mrt, print_tri)
        self.message(f"Tri_find: {self.ntri} triangles")
        obj.cleanup()


# ---------------------------------------------------------------------------
# neigh_tri
# ---------------------------------------------------------------------------

def read_adjacency(itask, filename, kv, ptr):
    """'vi vj vk ...' adjacency lines → (vi : [0, vj, 0]) tagged neighbour
    rows (NeighTri::nread, oink/neigh_tri.cpp:76-92)."""
    rows_v, rows_n = [], []
    with open(filename) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            vi = int(toks[0])
            for t in toks[1:]:
                rows_v.append(vi)
                rows_n.append(int(t))
    v = np.asarray(rows_v, np.uint64)
    nb = np.asarray(rows_n, np.uint64)
    zero = np.zeros(len(v), np.uint64)
    kv.add_batch(v, np.stack([zero, nb, zero], 1))


def read_tri(itask, filename, kv, ptr):
    """'vi vj vk' triangle lines → key [vi, vj, vk] : NULL
    (NeighTri::tread, oink/neigh_tri.cpp:96-109)."""
    vi, vj, vk = _parse_cols(filename, (np.uint64,) * 3)
    kv.add_batch(np.stack([vi, vj, vk], 1), np.zeros(len(vi), np.uint8))


def tri_to_vertex_edges(fr, kv, ptr):
    """(Vi, Vj, Vk):NULL → each corner : [1, other1, other2] tagged
    triangle-edge rows (NeighTri::map1, oink/neigh_tri.cpp:143-160)."""
    if isinstance(fr, KVFrame):
        t = fr.key.data
        one = np.ones(len(t), np.uint64)
        kv.add_batch(np.concatenate([t[:, 0], t[:, 1], t[:, 2]]),
                     np.concatenate([np.stack([one, t[:, 1], t[:, 2]], 1),
                                     np.stack([one, t[:, 0], t[:, 2]], 1),
                                     np.stack([one, t[:, 0], t[:, 1]], 1)]))
        return
    t, _ = fr.valid_rows()
    one = torch.ones_like(t[:, 0])
    kv.add_batch(torch.cat([t[:, 0], t[:, 1], t[:, 2]]),
                 torch.cat([torch.stack([one, t[:, 1], t[:, 2]], 1),
                            torch.stack([one, t[:, 0], t[:, 2]], 1),
                            torch.stack([one, t[:, 0], t[:, 1]], 1)]),
                 key_dtype=fr.key_dtype, value_dtype=fr.key_dtype)


@command("neigh_tri")
class NeighTri(Command):
    """neigh_tri dirname: per-vertex files dirname/<Vi> listing the
    vertex's neighbours ("vi vj" lines) and its triangles' opposite edges
    ("vj vk" lines).  Inputs: 1 = adjacency file(s), 2 = triangle
    file(s) from tri_find."""

    ninputs = 2
    noutputs = 0  # output is the dirname arg, matching the reference

    def params(self, args):
        if len(args) != 1:
            raise MRError("Illegal neigh_tri command")
        self.dirname = args[0]

    def run(self):
        obj = self.obj
        mrn = obj.input(1, read_adjacency)
        mrt = obj.input(2, read_tri)
        mrnplus = obj.copy_mr(mrn)
        mrnplus.map_mr(mrt, tri_to_vertex_edges, batch=True, addflag=1)
        mrnplus.collate()

        os.makedirs(self.dirname, exist_ok=True)
        nvert = [0]

        def write_vertex(key, vals, ptr):
            vi = int(key)
            with open(os.path.join(self.dirname, str(vi)), "w") as fp:
                for tag, a, b in vals:
                    if int(tag) == 0:
                        fp.write(f"{vi} {int(a)}\n")
                    else:
                        fp.write(f"{int(a)} {int(b)}\n")
            nvert[0] += 1

        mrnplus.scan_kmv(write_vertex)
        self.nvert = nvert[0]
        self.message(f"Neigh_tri: {self.nvert} vertex files in "
                     f"{self.dirname}")
        obj.cleanup()
