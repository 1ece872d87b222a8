"""dump_trace command: write the Chrome trace-event JSON of everything
the in-memory span ring has recorded so far (the counterpart of
``gpu_mapreduce_tpu/oink/commands/dump_trace.py``).

No reference analog — the reference's only observability is printf
(``src/mapreduce.cpp:2937-3066``); this is the scripted exit point of the
obs/ tracing layer::

    dump_trace trace.json          # load in Perfetto / chrome://tracing

Tracing must be on (MRTPU_TRACE env var, or any earlier enable) for
events to exist; with tracing off the command still writes a valid,
empty trace and says so.
"""

from __future__ import annotations

from ...core.runtime import MRError
from ..command import Command, command


@command("dump_trace")
class DumpTrace(Command):
    ninputs = 0
    noutputs = 0

    def params(self, args):
        if len(args) != 1:
            raise MRError("Illegal dump_trace command")
        self.path = args[0]

    def run(self):
        from ...obs import get_tracer, write_chrome_trace
        tr = get_tracer()
        n = write_chrome_trace(self.path, tr.events())
        note = "" if tr.enabled else \
            " (tracing disabled — set MRTPU_TRACE to record spans)"
        self.message(f"DumpTrace: {n} events -> {self.path}{note}")
