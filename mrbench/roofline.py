"""Peaks of the chip and the bytes a kernel's work needs.

A roofline share is the least time the chip could take for the work
(its bytes over the peak bandwidth; none of the kernels timed here is
bound by arithmetic) over the time the kernel took.  The bytes count what
the work needs, each input byte read once and each output byte written
once, from the sizes of the work, whatever the implementation reads
again or pads: a later change to the implementation does not move the
bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense): HBM3 bandwidth, float32 outside
# the tensor cores
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_f32": 67e12},
}
DEFAULT = "NVIDIA H100 80GB HBM3"


def peak_bytes_per_s(kind: str) -> float:
    return PEAKS.get(kind, PEAKS[DEFAULT])["bytes_per_s"]


def pagerank_step_bytes(edges: int, vertices: int) -> int:
    """One PageRank step: each edge's two endpoint ids at 4 bytes (ids
    below 2^32), the ranks and the inverse out-degrees read once and the
    new ranks written once, 4 bytes each."""
    return 8 * edges + 12 * vertices


def mark_words_bytes(corpus_bytes: int, matches: int) -> int:
    """The word mark: the corpus read once, a 4-byte position written
    for each match of the pattern."""
    return corpus_bytes + 4 * matches


def share_pct(nbytes: int, seconds: float, kind: str) -> float:
    """100 x the bytes' least time over ``seconds``."""
    return 100.0 * nbytes / peak_bytes_per_s(kind) / seconds
