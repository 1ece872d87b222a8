"""Seconds a job in the InvertedIndex ingest: its stage timer's ``read``
(the files into one host corpus) and ``h2d`` (the corpus onto the
card), each ending in a device synchronise."""

LAYER = "Ingest (apps/invertedindex._build_corpus, ops/bits.to_torch)"
UNIT = "s"
MOVES = "peak_GB"


def read(ctx):
    r, h = ctx.counters.get("read_s"), ctx.counters.get("h2d_s")
    if not r or not h:
        return None
    return (sum(r) + sum(h)) / len(r)
