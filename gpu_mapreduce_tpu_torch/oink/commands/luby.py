"""luby_find — Luby maximal independent set.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/luby.py``
(reference ``oink/luby_find.cpp:53-115``).  ``luby_find seed`` runs the
``fused`` engine: the edge KV is staged on the device without its
self-loops (a self-loop vertex could never win its own edge) and
``models/luby.py`` iterates there over per-vertex priorities
``vertex_rand(v, seed)``.  The ``composed`` engine (the reference's
5-stage MapReduce round) needs the JAX package's
``parallel/devkernels.py`` and is not ported yet: asking for it
(``LubyFind.engine`` or ``GPUMR_LUBY_ENGINE=composed``) raises ``MRError``.
Output: one set vertex per line, ascending unsigned id.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.runtime import MRError
from ...models.luby import luby_mis
from ...parallel.staging import stage_graph
from ..command import Command, command, require_fused
from ..kernels import print_vertex, read_edge

_M64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    c &= _M64
    return c - (1 << 64) if c >> 63 else c


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns held in int64."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def vertex_rand(v: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic per-vertex random in [0, 1): splitmix64(v + seed)
    reduced to its top 53 bits, as float64 (the reference's
    srand48(v+seed)/drand48, oink/luby_find.cpp:130-134).  ``v`` holds
    u64 ids as int64; multiplication and addition wrap mod 2^64."""
    z = v.to(torch.int64) + _i64(seed) + _i64(0x9E3779B97F4A7C15)
    z = (z ^ _shr(z, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _i64(0x94D049BB133111EB)
    z = z ^ _shr(z, 31)
    return _shr(z, 11).to(torch.float64) / float(1 << 53)


@command("luby_find")
class LubyFind(Command):
    """luby_find seed: a maximal independent set of an undirected edge
    list (``nset`` vertices after ``niterate`` rounds)."""

    ninputs = 1
    noutputs = 1
    engine: str | None = None   # None → GPUMR_LUBY_ENGINE env (or fused)

    def params(self, args):
        if len(args) != 1:
            raise MRError("Illegal luby_find command")
        self.seed = int(args[0])

    def run(self):
        require_fused(self.engine, "GPUMR_LUBY_ENGINE", "luby_find")
        obj = self.obj
        mre = obj.input(1, read_edge)
        sg = stage_graph(mre, drop_self=True)
        mrv = obj.create_mr()
        if sg is None:
            self.nset, self.niterate = 0, 0
        else:
            prio = vertex_rand(sg.verts, self.seed)
            state, self.niterate = luby_mis(sg.src, sg.dst, prio, sg.n)
            mis = sg.verts[state == 1]
            self.nset = int(mis.numel())
            mrv.map(1, lambda i, kv, p: kv.add_batch(
                mis, torch.zeros(mis.shape[0], dtype=torch.uint8,
                                 device=mis.device),
                key_dtype=np.uint64))
        obj.output(1, mrv, print_vertex)
        self.message(f"Luby_find: {self.nset} MIS vertices in "
                     f"{self.niterate} iterations")
        obj.cleanup()
