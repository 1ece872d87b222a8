"""invertedindex command — the InvertedIndex app behind the script
surface.

The counterpart of ``gpu_mapreduce_tpu/oink/commands/invertedindex.py``:
``invertedindex -i v_files [-o dir]`` runs ``apps/invertedindex.py`` on
the script's device or mesh; with ``-o`` its ``part-<shard>`` index
files land under the named directory (reference myreduce,
cuda/InvertedIndex.cu:463-513).  The message carries the (files, pairs,
unique urls) triple, the same at every mesh width.
"""

from __future__ import annotations

from ...apps.invertedindex import InvertedIndex
from ...core.runtime import MRError
from ..command import Command, command


@command("invertedindex")
class InvertedIndexCmd(Command):
    ninputs = 1
    noutputs = 1

    def params(self, args):
        if args:
            raise MRError("Illegal invertedindex command")

    def run(self):
        obj = self.obj
        if not obj.inputs or obj.inputs[0].paths is None:
            raise MRError("invertedindex requires a file input (-i)")
        paths = obj.inputs[0].paths
        outdir = None
        if obj.outputs and obj.outputs[0].path is not None:
            outdir = obj.outputs[0].path
        app = InvertedIndex(device=obj.device, comm=obj.comm)
        self.npairs, self.nurl = app.run(paths, outdir=outdir)
        self.nfiles = len(app.docs)
        self.message(f"InvertedIndex: {self.nfiles} files, "
                     f"{self.npairs} pairs, {self.nurl} unique urls")
        obj.cleanup()
