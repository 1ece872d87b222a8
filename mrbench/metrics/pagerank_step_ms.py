"""Device milliseconds of one PageRank step on a card: the kernels under
the benchmark's range around each ``models/pagerank.pagerank_step`` call
(torch.profiler), over the calls and, on several cards, the mean over
them."""

LAYER = "Fused engines (models/pagerank.pagerank_step)"
UNIT = "ms"
MOVES = "job_s"
WRAPS = [{"target": "gpu_mapreduce_tpu_torch.models.pagerank:pagerank_step",
          "name": "mrbench.pagerank_step"}]


def step_s(ctx):
    """Seconds of a step on a card, or None."""
    if ctx.trace is None:
        return None
    n, s = ctx.trace.range_device_s("mrbench.pagerank_step")
    return s / n / ctx.ndevices if n and s > 0 else None


def read(ctx):
    s = step_s(ctx)
    return None if s is None else 1e3 * s
