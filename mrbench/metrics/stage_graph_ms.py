"""Device milliseconds a job in ``parallel/staging.stage_graph``, as
PageRank calls it: the kernels, copies and sets under the benchmark's
range around each call (torch.profiler), a job and a card (on several
cards, the mean over them)."""

LAYER = "Staging (parallel/staging.stage_graph)"
UNIT = "ms"
MOVES = "job_s"
WRAPS = [{"target": "gpu_mapreduce_tpu_torch.oink.commands.pagerank:stage_graph",
          "name": "mrbench.stage_graph"}]


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    n, s = ctx.trace.range_device_s("mrbench.stage_graph")
    return 1e3 * s / ctx.jobs / ctx.ndevices if n and s > 0 else None
