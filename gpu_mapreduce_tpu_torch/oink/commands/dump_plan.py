"""dump_plan command: print the recorded/executed plans of this process
— stages, fusion groups (fused vs eager, which segment op), cache key
and whether the plan cache hit (the counterpart of
``gpu_mapreduce_tpu/oink/commands/dump_plan.py``).

No reference analog (the reference is eager by construction); this is
the scripted exit point of the plan/ subsystem, next to dump_trace::

    set fuse 1
    mr A
    A map/file v_files wf_read
    A collate NULL
    A reduce count
    A stats                       # barrier: plan executes here
    dump_plan -                   # '-' → screen, else a file path

Plans only exist when fusion ran (``set fuse 1``, ``MRTPU_FUSE=1`` or a
``pipeline()`` block in library code); with none recorded the command
says so instead of writing an empty file.
"""

from __future__ import annotations

from ...core.runtime import MRError
from ..command import Command, command


def format_plans(history: list) -> str:
    """Human-readable multi-line rendering of plan.cache.plan_history()."""
    if not history:
        return "(no plans recorded — set fuse 1 / MRTPU_FUSE=1)"
    lines = []
    for i, h in enumerate(history):
        lines.append(f"plan {i}: {' -> '.join(h['stages'])}")
        lines.append(f"  cache: {'HIT' if h['cache_hit'] else 'miss'}"
                     + (f"  key: {h['cache_key']}" if h.get("cache_key")
                        else ""))
        for j, g in enumerate(h["groups"]):
            tag = g["kind"] if g["fused"] else "eager"
            rop = f" reduce_op={g['reduce_op']}" if g.get("reduce_op") \
                else ""
            lines.append(f"  group {j} [{tag}{rop}]: "
                         + "; ".join(g["stages"]))
    return "\n".join(lines)


@command("dump_plan")
class DumpPlan(Command):
    ninputs = 0
    noutputs = 0

    def params(self, args):
        if len(args) != 1:
            raise MRError("Illegal dump_plan command")
        self.path = args[0]

    def run(self):
        from ...plan import plan_history
        history = plan_history()
        text = format_plans(history)
        if self.path == "-":
            self.message(text)
        else:
            with open(self.path, "w") as f:
                f.write(text + "\n")
            self.message(f"DumpPlan: {len(history)} plans -> {self.path}")
