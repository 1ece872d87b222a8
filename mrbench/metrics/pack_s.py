"""Host seconds a job in the InvertedIndex's ``pack`` stage (the
``stage.pack`` span of ``apps/invertedindex``: the corpus bytes as
zero-padded u32 words, before the copy to the card), from the profiler's
range (torch.profiler).  It moves ``peak_GB``, the cell's end-to-end
metric besides ``setup_s``.  None where the system has no such span."""

LAYER = "Ingest (apps/invertedindex._build_corpus, ops/bits.to_torch)"
UNIT = "s"
MOVES = "peak_GB"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.jobs:
        return None
    n, _, host_s = t.ranges.get("stage.pack", (0, 0.0, 0.0))
    return host_s / ctx.jobs if n else None
