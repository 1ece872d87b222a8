"""The word mark's share of its bandwidth bound: the corpus bytes read
once and 4 bytes for each match written once
(``roofline.mark_words_bytes``) over 3.35 TB/s, divided by one launch's
device time (kernels named ``mark_words`` in torch.profiler)."""

from mrbench import roofline

LAYER = "Map kernel (ops/cuda/match.mark_words, csrc/mark_words.cu)"
UNIT = "%"
MOVES = "peak_GB"


def read(ctx):
    if ctx.trace is None:
        return None
    n, s = ctx.trace.kernel_s("mark_words")
    refs = ctx.counters.get("refs")
    if not n or s <= 0 or not refs:
        return None
    nbytes = roofline.mark_words_bytes(int(ctx.sizes["corpus_bytes"]),
                                       int(refs[-1]))
    return roofline.share_pct(nbytes, s / n, ctx.kind)
