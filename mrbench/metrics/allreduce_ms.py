"""Device milliseconds a call of the cross-shard sum
(``parallel/collectives.allreduce``, as PageRank calls it: the
out-degrees once, then each step's inflow): the copies and kernels under
the benchmark's range around each call (torch.profiler), summed over the
cards, as the mean over the calls."""

LAYER = "Mesh data plane (parallel/collectives.allreduce)"
UNIT = "ms"
MOVES = "job_s"
WRAPS = [{"target": "gpu_mapreduce_tpu_torch.models.pagerank:allreduce",
          "name": "mrbench.allreduce"}]


def read(ctx):
    if ctx.trace is None:
        return None
    n, s = ctx.trace.range_device_s("mrbench.allreduce")
    return 1e3 * s / n if n and s > 0 else None
