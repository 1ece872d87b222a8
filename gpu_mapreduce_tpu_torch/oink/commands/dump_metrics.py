"""dump_metrics command: write the live metrics registry snapshot (the
counterpart of ``gpu_mapreduce_tpu/oink/commands/dump_metrics.py``).

The scripted exit point of the obs/metrics layer (``dump_trace``'s
twin)::

    dump_metrics metrics.json       # structured registry snapshot
    dump_metrics metrics.prom       # Prometheus exposition text

A ``.prom`` / ``.txt`` suffix selects the Prometheus text format;
anything else writes the JSON snapshot.  The command arms the registry
if nothing else has (so a script that only wants an end-of-run snapshot
needs no environment setup) — but metrics fed by spans only cover ops
run AFTER the registry was armed.
"""

from __future__ import annotations

import json

from ...core.runtime import MRError
from ..command import Command, command


@command("dump_metrics")
class DumpMetrics(Command):
    ninputs = 0
    noutputs = 0

    def params(self, args):
        if len(args) != 1:
            raise MRError("Illegal dump_metrics command")
        self.path = args[0]

    def run(self):
        from ...obs import metrics as _metrics
        armed = _metrics.enabled()
        _metrics.enable_metrics()
        if self.path.endswith((".prom", ".txt")):
            body = _metrics.prometheus_text()
            n = sum(1 for ln in body.splitlines()
                    if ln.startswith("# TYPE"))
        else:
            snap = _metrics.snapshot()
            body = json.dumps(snap, indent=2, default=str)
            n = len(snap)
        with open(self.path, "w") as f:
            f.write(body if body.endswith("\n") else body + "\n")
        note = "" if armed else \
            " (registry armed just now — earlier ops are not in " \
            "span-fed metrics)"
        self.message(f"DumpMetrics: {n} metrics -> {self.path}{note}")
