"""Milliseconds a job that the first card sits idle inside the port's own
staging spans: ``graph.stage`` (``parallel/staging.stage_graph``) and its
``graph.unique`` (a shard's sort and unique), ``graph.merge`` (the
shards' ids merged on the first card) and ``graph.rank`` (the table
copied, a shard's edges ranked).  Each idle gap of the traced window is
charged to the innermost range open at its middle (torch.profiler).
None where the system has no such span."""

LAYER = "Staging (parallel/staging.stage_graph)"
UNIT = "ms"
MOVES = "job_s"
SPANS = ("graph.stage", "graph.unique", "graph.merge", "graph.rank")


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.jobs or not any(n in t.ranges for n in SPANS):
        return None
    return 1e3 * sum(t.idle.get(n, 0.0) for n in SPANS) / ctx.jobs
