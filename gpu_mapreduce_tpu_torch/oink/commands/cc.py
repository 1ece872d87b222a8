"""cc_find / cc_stats — connected components by label propagation.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/cc.py`` (reference
``oink/cc_find.cpp:38-109``, ``oink/cc_stats.cpp:37-63``).  ``cc_find``
runs the ``fused`` engine: the edge KV is staged on the device
(``parallel/staging.py``) and ``models/cc.py`` iterates there; every
component is named by its least vertex id.  The ``composed`` engine (the
reference's 9-stage MapReduce composition) needs the JAX package's
``parallel/devkernels.py`` and is not ported yet: asking for it
(``CCFind.engine`` or ``GPUMR_CC_ENGINE=composed``) raises ``MRError``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...core.runtime import MRError
from ...models.cc import cc
from ...parallel.staging import stage_graph
from ..command import Command, command
from ..kernels import (count, invert, print_vertex_value, read_edge,
                       read_vertex_value, value_histogram)


@command("cc_find")
class CCFind(Command):
    """cc_find nthresh: (Vi, Zi) with Zi the least vertex id of Vi's
    component.  ``nthresh`` (the reference's big-zone split) is accepted
    and ignored, as in the JAX package."""

    ninputs = 1
    noutputs = 1
    engine: str | None = None   # None → GPUMR_CC_ENGINE env (or fused)

    def params(self, args):
        if len(args) != 1:
            raise MRError("Illegal cc_find command")
        self.nthresh = int(args[0])

    def run(self):
        engine = self.engine or os.environ.get("GPUMR_CC_ENGINE", "fused")
        if engine == "composed":
            raise MRError("cc_find: the composed engine is not ported yet "
                          "(use 'fused')")
        if engine != "fused":
            raise MRError(f"cc_find: unknown engine {engine!r} "
                          f"(use 'fused' or 'composed')")
        obj = self.obj
        mre = obj.input(1, read_edge)
        mrv = obj.create_mr()
        sg = stage_graph(mre)
        if sg is None:
            self.ncc, self.niterate = 0, 0
        else:
            labels, self.niterate = cc(sg.src, sg.dst, sg.n)
            zones = sg.verts[labels.long()]   # least vertex id per component
            self.ncc = int(torch.unique(labels).numel())
            mrv.map(1, lambda i, kv, p: kv.add_batch(
                sg.verts, zones, key_dtype=np.uint64, value_dtype=np.uint64))
        obj.output(1, mrv, print_vertex_value)
        self.message(f"CC_find: {self.ncc} components in "
                     f"{self.niterate} iterations")
        obj.cleanup()


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
