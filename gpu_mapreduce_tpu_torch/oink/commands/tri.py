"""tri_find / neigh_tri — triangle enumeration and per-vertex files.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/tri.py`` (reference
``oink/tri_find.cpp:43-81``, ``oink/neigh_tri.cpp:40-69``).  ``tri_find``
runs the ``fused`` engine: the edge KV is staged on the device and
``models/tri.py`` walks the degree-ordered wedges there; rows are
(centre, u, w), centre the low-degree vertex that emitted the wedge.  The
``composed`` engine (the reference's 6-stage MapReduce pipeline) is not
ported yet: asking for it (``TriFind.engine`` or
``GPUMR_TRI_ENGINE=composed``) raises ``MRError``.  ``neigh_tri`` writes
one file per vertex from ``scan_kmv``, on the host.  Tagged ``[tag, a,
b]`` u64 rows stand in for the reference's valuebytes-discriminated
unions (tag 0 a neighbour, 1 a triangle's opposite edge).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...core.frame import KVFrame
from ...core.runtime import MRError
from ...models.tri import triangles_ranked
from ...parallel.staging import stage_graph
from ..command import Command, command, require_fused
from ..kernels import _parse_cols, read_edge


def print_tri(k, v, fp):
    fp.write(f"{k[0]} {k[1]} {k[2]}\n")


@command("tri_find")
class TriFind(Command):
    """tri_find: every triangle of an edge list once (``ntri`` rows from
    ``nwedges`` wedges)."""

    ninputs = 1
    noutputs = 1
    engine: str | None = None   # None → GPUMR_TRI_ENGINE env (or fused)

    def params(self, args):
        if args:
            raise MRError("Illegal tri_find command")

    def run(self):
        require_fused(self.engine, "GPUMR_TRI_ENGINE", "tri_find")
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
    t = fr.key[:len(fr)]
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
