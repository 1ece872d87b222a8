"""histo — key-frequency histogram.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/histo.py``
(reference ``oink/histo.cpp:28-80``): the unique keys with their counts
go to output 1, then the count-of-counts is printed by count
descending.  A named input is not consumed: the command works on a
copy."""

from __future__ import annotations

from ...core.runtime import MRError
from ..command import Command, command
from ..kernels import count, print_vertex_value, value_histogram


@command("histo")
class Histo(Command):
    ninputs = 1
    noutputs = 1

    def params(self, args):
        if args:
            raise MRError("Illegal histo command")

    def run(self):
        obj = self.obj
        mr = obj.input(1)
        ntotal = mr.kv_stats(0)[0]
        if obj.permanent(mr):
            mr = obj.copy_mr(mr)
        mr.collate()
        nunique = mr.reduce(count, batch=True)
        obj.output(1, mr, print_vertex_value)
        if obj.permanent(mr):
            mr = obj.copy_mr(mr)
        self.ntotal, self.nunique = ntotal, nunique
        self.message(f"Histo: {ntotal} total keys, {nunique} unique")
        self.stats = value_histogram(mr)
        for c, nk in self.stats:
            self.message(f"  {c} {nk}")
        obj.cleanup()
