"""The window's wall seconds over the jobs completed in it, so a stall
anywhere in the window counts (host clock; each job ends in a device
synchronise)."""

LAYER = "End to end"
UNIT = "s"
MOVES = "job_s"


def read(ctx):
    return ctx.window_s / ctx.jobs if ctx.jobs else None
