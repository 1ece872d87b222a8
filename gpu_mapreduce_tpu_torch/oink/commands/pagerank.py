"""pagerank — damped PageRank over a directed edge list.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/pagerank.py``
(``pagerank tol maxiter alpha``, reference ``PageRank::params``).  The
edge KV is staged on the device, or shard by shard on a mesh
(``parallel/staging.py``: the sorted vertex table and ranked edges, the
same table as the JAX command's host ``np.unique``), then the fused loop
of ``models/pagerank.py`` runs there, summing across the shards each
step.  The JAX command splits the host edge list into P blocks where
the port keeps each shard's own rows; float32 sums in another order give
ranks equal within rtol 1e-5 and a step count within one.  Edge weights are accepted in the
input ('vi vj [wt]') but rank follows link structure only.  Output:
'v rank' per vertex, ascending v.  ``ranks`` ({v: rank}, the JAX
command's attribute) is built when first read; ``verts`` and
``rank_values`` hold the same as tensors on the device.
"""

from __future__ import annotations

import numpy as np

from ...core.runtime import MRError
from ...models.pagerank import pagerank_sharded
from ...obs.tracer import get_tracer
from ...ops.bits import to_numpy
from ...parallel.staging import stage_graph
from ..command import Command, command
from ..kernels import read_edge, read_edge_weight


def _read_edges_sniff(itask, filename, kv, ptr):
    """'vi vj' or 'vi vj wt' lines → key=[vi,vj]."""
    first = []
    with open(filename, "rb") as f:
        for line in f:
            first = line.split()
            if first:
                break
    if len(first) == 3:
        read_edge_weight(itask, filename, kv, ptr)
    else:
        read_edge(itask, filename, kv, ptr)


@command("pagerank")
class PageRankCommand(Command):
    """pagerank tol maxiter alpha (oink/pagerank.cpp:67-75)."""

    ninputs = 1
    noutputs = 1

    def params(self, args):
        if len(args) != 3:
            raise MRError("Illegal pagerank command")
        self.tolerance = float(args[0])
        self.maxiter = int(args[1])
        self.alpha = float(args[2])

    def run(self):
        obj = self.obj
        mre = obj.input(1, _read_edges_sniff)
        sg = stage_graph(mre)
        if sg is None:
            raise MRError("pagerank: empty edge list")
        ranks, iters = pagerank_sharded(
            [(s.src, s.dst) for s in sg.shards], sg.n, tol=self.tolerance,
            maxiter=self.maxiter, damping=self.alpha)
        nedge = sum(len(s.src) for s in sg.shards)
        self.niterate, self.nvert, self.nedge = iters, sg.n, nedge
        self.verts, self.rank_values = sg.verts, ranks
        self._ranks = None
        mrr = obj.create_mr()
        mrr.map(1, lambda i, kv, p: kv.add_batch(
            sg.verts, ranks.double(), key_dtype=np.uint64))
        obj.output(1, mrr, lambda k, v, fp: fp.write(f"{k} {v:.8g}\n"))
        self.message(f"PageRank: {sg.n} vertices, {nedge} edges, "
                     f"{iters} iterations")
        obj.cleanup()
        get_tracer().annotate(steps=iters)

    @property
    def ranks(self) -> dict:
        """{v: rank} over every vertex (the JAX command's dict), built on
        first read from the ``verts``/``rank_values`` tensors."""
        if self._ranks is None:
            self._ranks = dict(zip(
                to_numpy(self.verts, np.uint64).tolist(),
                self.rank_values.double().tolist()))
        return self._ranks
