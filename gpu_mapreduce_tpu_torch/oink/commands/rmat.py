"""rmat / rmat2 — R-MAT matrix generation commands.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/rmat.py``
(reference ``oink/rmat.cpp:37-96``: generate → collate → cull until
2^N·Nz unique edges exist; ``oink/rmat2.cpp:36-76``: the same through a
per-round aggregate into a second MR and ``add``).  Each round's edges
are generated on the device (``models/rmat.py``, the JAX package's
threefry stream) and stay there: the map adds device tensors, and the
number still missing comes from ``collate``'s group count.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.runtime import MRError
from ...models.rmat import rmat_edges
from ...ops import prng
from ..command import Command, command
from ..kernels import cull, print_edge


class _RmatBase(Command):
    noutputs = 1

    def params(self, args):
        if len(args) != 8:
            raise MRError(f"Illegal {self.name} command")
        self.nlevels = int(args[0])
        self.nnonzero = int(args[1])
        self.abcd = tuple(float(a) for a in args[2:6])
        self.frac = float(args[6])
        self.seed = int(args[7])
        if abs(sum(self.abcd) - 1.0) > 1e-12:
            raise MRError("RMAT a,b,c,d must sum to 1")
        if self.frac >= 1.0:
            raise MRError("RMAT fraction must be < 1")
        self.order = 1 << self.nlevels

    def _rounds(self, mr, add_round):
        """The cull loop: per round, ``add_round(mr, map_fn)`` appends one
        batch of ``nremain`` candidates and returns the unique count.
        Returns (edge count, round count).

        The JAX command generates a full-size batch every round (one
        shape, one XLA compile) and keeps its first ``nremain`` edges.
        Edge i's draws depend only on the key and on i, so generating
        ``nremain`` edges gives exactly those edges, without the rest."""
        ntotal = self.order * self.nnonzero
        nremain, niterate = ntotal, 0
        root = prng.PRNGKey(self.seed)
        while nremain:
            niterate += 1
            root, sub = prng.split(root)
            vi, vj = rmat_edges(sub, nremain, self.nlevels, self.abcd,
                                self.frac, self.frac > 0.0, mr.device)
            edges = torch.stack([vi, vj], 1)
            del vi, vj
            null = torch.zeros(edges.shape[0], dtype=torch.uint8,
                               device=edges.device)

            def map_fn(itask, kv, ptr, edges=edges, null=null):
                kv.add_batch(edges, null, key_dtype=np.uint64)

            nunique = add_round(mr, map_fn)
            del edges, null
            nremain = ntotal - int(nunique)
        return ntotal, niterate

    def _finish(self, mr, ntotal, niterate, label):
        self.nunique, self.niterate = ntotal, niterate
        self.obj.output(1, mr, print_edge)
        self.message(f"{label}: {self.order} rows, {ntotal} non-zeroes, "
                     f"{niterate} iterations")
        self.obj.cleanup()


@command("rmat")
class RMAT(_RmatBase):
    """rmat N Nz a b c d frac seed (oink/rmat.cpp)."""

    def run(self):
        def add_round(mr, map_fn):
            mr.map(1, map_fn, addflag=1)
            nunique = mr.collate()
            mr.reduce(cull, batch=True)
            return nunique

        mr = self.obj.create_mr()
        self._finish(mr, *self._rounds(mr, add_round), "RMAT")


@command("rmat2")
class RMAT2(_RmatBase):
    """rmat2 N Nz a b c d frac seed (oink/rmat2.cpp): per-round aggregate
    into a fresh MR, add into the accumulator, convert + cull."""

    def run(self):
        mrnew = self.obj.create_mr()

        def add_round(mr, map_fn):
            mrnew.map(1, map_fn)
            mrnew.aggregate()
            mr.add(mrnew)
            nunique = mr.convert()
            mr.reduce(cull, batch=True)
            return nunique

        mr = self.obj.create_mr()
        self._finish(mr, *self._rounds(mr, add_round), "RMAT2")
