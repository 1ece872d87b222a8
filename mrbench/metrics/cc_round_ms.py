"""Device milliseconds a round of the composed cc_find: the kernels,
copies and sets under the port's ``cc.round`` span
(``oink/commands/cc._run_composed``, one a round), over the count of
those ranges (torch.profiler).  None where the system has no such
span."""

LAYER = "Composed engines (oink/commands/cc._run_composed, parallel/devkernels)"
UNIT = "ms"
MOVES = "job_s"


def read(ctx):
    if ctx.trace is None:
        return None
    n, s = ctx.trace.range_device_s("cc.round")
    return 1e3 * s / n if n and s > 0 else None
