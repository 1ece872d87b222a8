"""Device milliseconds a job under the system's own ``aggregate`` and
``convert`` spans (``core/mapreduce``; ``collate`` opens both), read from
torch.profiler with the system's tracer on."""

LAYER = "Group (core/mapreduce aggregate and convert, parallel/group.convert_sharded)"
UNIT = "ms"
MOVES = "job_s"


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    n, s = ctx.trace.range_device_s("aggregate", "convert")
    return 1e3 * s / ctx.jobs if n and s > 0 else None
