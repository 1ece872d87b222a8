"""``torch.cuda.max_memory_allocated`` over the window, reset at its
start, in GB (1e9 bytes); on several cards the fullest."""

LAYER = "End to end"
UNIT = "GB"
MOVES = "peak_GB"


def read(ctx):
    return ctx.peak_bytes / 1e9
