"""Process start to the first timed job: imports, the CUDA context, the
kernel libraries from the build cache, the inputs made from the seed,
the system's objects and one warm job (host clock)."""

LAYER = "End to end"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return ctx.setup_s
