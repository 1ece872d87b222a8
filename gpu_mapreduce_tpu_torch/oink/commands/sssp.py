"""sssp — single-source shortest paths from deterministic-random sources.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/sssp.py``
(reference ``oink/sssp.cpp:49-180``).  ``sssp ncnt seed`` runs the
``fused`` engine: the weighted edge KV is staged on the device once
(``need_weights``) and ``models/sssp.py`` relaxes it from each source.
The sources are the first ``ncnt`` vertices ordered by
(``vertex_rand(v, seed)``, v).  The ``composed`` engine (the reference's
per-round MapReduce composition) is not ported yet: asking for it
(``SSSPCommand.engine`` or ``GPUMR_SSSP_ENGINE=composed``) raises
``MRError``.

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
from ...models.sssp import bellman_ford
from ...ops.bits import to_numpy
from ...parallel.staging import as_float64, stage_graph
from ..command import Command, command, require_fused
from ..kernels import read_edge_weight
from .luby import vertex_rand

TAG_DIST = 1.0
NO_PRED = -1.0


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
        require_fused(self.engine, "GPUMR_SSSP_ENGINE", "sssp")
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
        sources = order.tolist()

        self._verts, self._runs, self._results = verts, [], None
        self.niters = {}
        outd = obj.outputs[0] if obj.outputs else None
        dist = torch.full((n,), float("inf"), dtype=torch.float64,
                          device=verts.device)
        pred = torch.full((n,), -1, dtype=torch.int32, device=verts.device)
        for cnt, sidx in enumerate(sources):
            source = int(to_numpy(verts[sidx:sidx + 1], np.uint64)[0])
            dist, pred, niter = bellman_ford(sg.src, sg.dst, sg.weights, n,
                                             sidx)
            self._runs.append((source, dist, pred))
            self.niters[source] = niter
            nlabeled = int(torch.isfinite(dist).sum())
            self.message(f"SSSP: source {source}: {niter} iterations, "
                         f"{nlabeled} vertices labeled")
            if outd is not None and outd.path is not None:
                path = (f"{outd.path}.{cnt}" if self.ncnt > 1
                        else outd.path)
                v, d, p = self._host_rows(verts, dist, pred)
                with open(path, "w") as fp:
                    fp.writelines(f"{a} {b:g} {c}\n"
                                  for a, b, c in zip(v, d, p))
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

    @staticmethod
    def _host_rows(verts, dist, pred):
        """(ids, distances, predecessor ids with 0 for none) as Python
        lists in ascending id."""
        pv = torch.where(pred >= 0, verts[pred.long().clamp(min=0)], 0)
        return (to_numpy(verts, np.uint64).tolist(), dist.tolist(),
                to_numpy(pv, np.uint64).tolist())

    @property
    def results(self) -> dict:
        """{source: {v: (dist, pred)}}, pred 0 where there is none (the
        JAX command's dict), built on first read."""
        if self._results is None:
            self._results = {}
            for source, dist, pred in self._runs:
                v, d, p = self._host_rows(self._verts, dist, pred)
                self._results[source] = dict(zip(v, zip(d, p)))
        return self._results
