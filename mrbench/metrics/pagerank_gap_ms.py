"""Milliseconds a PageRank step that the first card sits idle inside the
port's PageRank loop: under ``pagerank.loop``
(``models/pagerank.pagerank_sharded``: the glue between steps and the
set-up before the first), ``pagerank.step`` (``pagerank_step``),
``pagerank.delta`` (the host's read of the largest change) and
``mesh.allreduce`` (the sum across the cards), and under the benchmark's
own wraps of the step and the sum while they exist, over the count of
``pagerank.step`` ranges.  Each idle gap of the traced window is charged
to the innermost range open at its middle (torch.profiler), so every gap
inside the loop counts once, whichever of these ranges is innermost.
None where the system has no such span."""

LAYER = "Fused engines (models/pagerank.pagerank_step)"
UNIT = "ms"
MOVES = "job_s"
SPANS = ("pagerank.loop", "pagerank.step", "pagerank.delta",
         "mesh.allreduce", "mrbench.pagerank_step", "mrbench.allreduce")


def read(ctx):
    t = ctx.trace
    steps = t.ranges.get("pagerank.step", (0,))[0] if t is not None else 0
    if not steps:
        return None
    return 1e3 * sum(t.idle.get(n, 0.0) for n in SPANS) / steps
