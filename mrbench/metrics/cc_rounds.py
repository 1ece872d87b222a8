"""Rounds a job of the composed cc_find, as its message reports them
(a count; it repeats exactly for one graph)."""

LAYER = "Composed engines (oink/commands/cc._run_composed, parallel/devkernels)"
UNIT = "rounds"
MOVES = "job_s"


def read(ctx):
    r = ctx.counters.get("rounds")
    return sum(r) / len(r) if r else None
