"""The share of the traced window in which no kernel, copy or set ran on
the card (torch.profiler; the mean over the cards used)."""

LAYER = "Device (one H100)"
UNIT = "%"
MOVES = "job_s"


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
