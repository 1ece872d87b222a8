"""The 95th percentile of the seconds of every job in the window (host
clock; each job ends in a device synchronise)."""

import statistics

LAYER = "End to end"
UNIT = "s"
MOVES = "job_p95_s"


def read(ctx):
    t = ctx.job_times
    if len(t) < 2:
        return t[0] if t else None
    return statistics.quantiles(t, n=20, method="inclusive")[18]
