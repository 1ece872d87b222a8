"""edge_upper / vertex_extract / neighbor commands.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/edges.py``
(reference ``oink/edge_upper.cpp:28-65``, ``oink/vertex_extract.cpp:28-60``,
``oink/neighbor.cpp:28-115``)."""

from __future__ import annotations

from ...core.runtime import MRError
from ..command import Command, command
from ..kernels import (cull, edge_both_directions, edge_to_vertices,
                       edge_upper, print_edge, print_vertex, read_edge,
                       read_edge_weight)


@command("edge_upper")
class EdgeUpper(Command):
    """Canonicalise edges to Vi < Vj, drop self-loops, dedupe."""

    ninputs = 1
    noutputs = 1

    def params(self, args):
        if args:
            raise MRError("Illegal edge_upper command")

    def run(self):
        obj = self.obj
        mre = obj.input(1, read_edge)
        mr = obj.create_mr()
        nedge = mre.kv_stats(0)[0]
        mr.map_mr(mre, edge_upper, batch=True)
        mr.collate()
        unique = mr.reduce(cull, batch=True)
        self.nedge, self.nunique = nedge, unique
        obj.output(1, mr, print_edge)
        self.message(f"EdgeUpper: {nedge} original edges, {unique} final "
                     f"edges")
        obj.cleanup()


@command("vertex_extract")
class VertexExtract(Command):
    """The unique vertices of a weighted edge list."""

    ninputs = 1
    noutputs = 1

    def params(self, args):
        if args:
            raise MRError("Illegal vertex_extract command")

    def run(self):
        obj = self.obj
        mre = obj.input(1, read_edge_weight)
        mrv = obj.create_mr()
        mrv.map_mr(mre, edge_to_vertices, batch=True)
        mrv.collate()
        self.nvert = mrv.reduce(cull, batch=True)
        obj.output(1, mrv, print_vertex)
        obj.cleanup()


@command("neighbor")
class Neighbor(Command):
    """Adjacency lists, kept as the grouped KMV (the reference packs each
    list into one value, ``neighbor.cpp:84-116``)."""

    ninputs = 1
    noutputs = 1

    def params(self, args):
        if args:
            raise MRError("Illegal neighbor command")

    def run(self):
        obj = self.obj
        mre = obj.input(1, read_edge)
        mrn = obj.create_mr()
        mrn.map_mr(mre, edge_both_directions, batch=True)
        self.nvert = mrn.collate()
        obj.output(1, mrn, _print_neighbors)
        obj.cleanup()


def _print_neighbors(k, vals, fp):
    fp.write(" ".join([str(k)] + [str(v) for v in vals]) + "\n")
