"""degree / degree_stats / degree_weight commands.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/degree.py``
(reference ``oink/degree.cpp:36-75``, ``oink/degree_stats.cpp:35-64``,
``oink/degree_weight.cpp:28-100``)."""

from __future__ import annotations

import numpy as np

from ...core.frame import KVFrame
from ...core.runtime import MRError
from ..command import Command, command
from ..kernels import (count, edge_to_vertex, edge_to_vertices, host_kmv,
                       print_edge_value, print_vertex_value, read_edge,
                       read_vertex_weight, value_histogram)


def _vertex_counts(cmd, mre, mr) -> int:
    """Map each edge to its endpoints (only Vi when the list already holds
    both directions, dupflag 1), group and count; returns the vertex
    count."""
    mr.map_mr(mre, edge_to_vertex if cmd.duplicate == 1 else edge_to_vertices,
              batch=True)
    mr.collate()
    return mr.reduce(count, batch=True)


class _DegreeBase(Command):
    ninputs = 1

    def params(self, args):
        if len(args) != 1:
            raise MRError(f"Illegal {self.name} command")
        self.duplicate = int(args[0])


@command("degree")
class Degree(_DegreeBase):
    """degree dupflag: (vertex, degree) pairs (oink/degree.cpp:46-49)."""

    noutputs = 1

    def run(self):
        obj = self.obj
        mre = obj.input(1, read_edge)
        mrv = obj.create_mr()
        nedge = mre.kv_stats(0)[0]
        nvert = _vertex_counts(self, mre, mrv)
        self.nvert, self.nedge = nvert, nedge
        obj.output(1, mrv, print_vertex_value)
        self.message(f"Degree: {nvert} vertices, {nedge} edges")
        obj.cleanup()


@command("degree_stats")
class DegreeStats(_DegreeBase):
    """degree_stats dupflag: the degree histogram, printed by degree
    descending.  self.stats = [(degree, nvertices)]."""

    def run(self):
        obj = self.obj
        mre = obj.input(1, read_edge)
        mr = obj.create_mr()
        nedge = mre.kv_stats(0)[0]
        nvert = _vertex_counts(self, mre, mr)
        self.nvert, self.nedge = nvert, nedge
        self.message(f"DegreeStats: {nvert} vertices, {nedge} edges")
        self.stats = value_histogram(mr)
        for degree, nv in self.stats:
            self.message(f"  {degree} {nv}")
        obj.cleanup()


def _host_cols(fr):
    fr = fr if isinstance(fr, KVFrame) else fr.to_host()
    return fr.key.data, fr.value.data


@command("degree_weight")
class DegreeWeight(Command):
    """degree_weight: edges + a 'vertex degree' file → Eij : 1/degree(Vi)
    (oink/degree_weight.cpp).  Values are tagged [tag, payload] u64 rows
    (tag 0 = neighbor, 1 = degree) so both kinds share one column."""

    ninputs = 2
    noutputs = 1

    def params(self, args):
        if args:
            raise MRError("Illegal degree_weight command")

    def run(self):
        obj = self.obj
        mre = obj.input(1, read_edge)
        mrd = obj.input(2, read_vertex_weight)
        mrewt = obj.create_mr()
        nvert = mrd.kv_stats(0)[0]

        def edges_tagged(fr, kv, ptr):
            e, _ = _host_cols(fr)
            val = np.stack([np.zeros(len(e), np.uint64), e[:, 1]], 1)
            kv.add_batch(e[:, 0], val)

        def degrees_tagged(fr, kv, ptr):
            v, d = _host_cols(fr)
            val = np.stack([np.ones(len(v), np.uint64), d.astype(np.uint64)],
                           1)
            kv.add_batch(v, val)

        mrewt.map_mr(mre, edges_tagged, batch=True)
        tmp = obj.create_mr()
        tmp.map_mr(mrd, degrees_tagged, batch=True)
        mrewt.add(tmp)
        mrewt.collate()

        def inverse_degree(fr, kv, ptr):
            fr = host_kmv(fr)
            vals, keys = fr.values.data, fr.key.data      # [n, 2], [g]
            seg = np.repeat(np.arange(len(fr)), fr.nvalues)
            deg = np.zeros(len(fr), np.float64)
            isdeg = vals[:, 0] == 1
            deg[seg[isdeg]] = vals[isdeg, 1].astype(np.float64)
            nb = ~isdeg
            if np.any(deg[seg[nb]] == 0):
                missing = np.unique(keys[seg[nb]][deg[seg[nb]] == 0])
                raise MRError(
                    f"degree_weight: {len(missing)} edge source vertices "
                    f"missing from the degree file (e.g. {missing[0]})")
            vi, vj = keys[seg[nb]], vals[nb, 1]
            kv.add_batch(np.stack([vi, vj], 1), 1.0 / deg[seg[nb]])

        nedge = mrewt.reduce(inverse_degree, batch=True)
        self.nvert, self.nedge = nvert, nedge
        obj.output(1, mrewt, print_edge_value)
        self.message(f"DegreeWeight: {nvert} vertices, {nedge} edges")
        obj.cleanup()
