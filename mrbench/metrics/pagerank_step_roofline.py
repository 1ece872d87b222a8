"""A PageRank step's share of its bandwidth bound: the bytes the step
needs (``roofline.pagerank_step_bytes``: each edge's two endpoint ids
and three vertex vectors at 4 bytes) over 3.35 TB/s, divided by the
step's device time (``pagerank_step_ms``)."""

from mrbench import roofline, spec

_step = spec.metric_module("pagerank_step_ms")
WRAPS = _step.WRAPS

LAYER = "Kernels of the PageRank step"
UNIT = "%"
MOVES = "job_s"


def read(ctx):
    s = _step.step_s(ctx)
    verts = ctx.counters.get("vertices")
    edges = ctx.counters.get("edges")
    if s is None or not verts or not edges:
        return None
    nbytes = roofline.pagerank_step_bytes(int(edges[-1]), int(verts[-1]))
    return roofline.share_pct(nbytes, s, ctx.kind)
