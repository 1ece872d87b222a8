"""Seeded HTML corpus with power-law URL popularity, frozen for the
benchmark.

Pages keep the shape of the repository's synthetic corpus: about 1 KB of
filler text, then one ``<a href="URL">x</a>`` reference.  Each reference
targets one URL of a vocabulary of ``vocab`` URLs; the URL of popularity
rank r (1-based) is drawn with probability proportional to
``r ** (-1 / (alpha - 1))``, the rank-frequency law of an in-degree
distribution with exponent ``alpha`` (2.1 for the Web graph).  Every
``long_every``-th rank is a long URL of 120-199 bytes, the rest are
26-47 bytes, so every seed gives the same share of long references; the
seed changes which URL strings the ranks hold and which ranks each page
draws; or, with an order seed, one corpus's pages in another order.
Every seed writes the same number of pages a file.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Sequence, Tuple

import numpy as np

FILLER = b"<p>" + b"lorem ipsum dolor sit amet " * 36 + b"</p>\n"
HREF = b'<a href="'
CLOSE = b'">x</a>'


def rank_cdf(vocab: int, alpha: float) -> np.ndarray:
    """Cumulative probabilities of ranks 1 .. vocab."""
    w = np.arange(1, vocab + 1, dtype=np.float64) ** (-1.0 / (alpha - 1.0))
    c = np.cumsum(w)
    return c / c[-1]


def url_of(seed: int, rank: int, long_every: int) -> bytes:
    """The URL at popularity ``rank`` (0-based) under ``seed``."""
    h = hashlib.blake2b(b"%d:%d" % (seed, rank), digest_size=16).digest()
    a = int.from_bytes(h[:8], "little")
    b = int.from_bytes(h[8:], "little")
    if rank % long_every == long_every - 1:
        # 34-byte head + 86..165 filler bytes: 120..199 bytes
        return (b"http://example.org/long/p%08x/" % (a & 0xFFFFFFFF)
                + b"x" * (86 + b % 80))
    # 26..47 bytes
    host = b"www.site%05d.com" % (a % 100000)
    path = b"/%x" % (b & ((1 << (4 * (1 + a % 8))) - 1) | 1)
    return b"http://" + host + path + b"/p" * (a >> 40 & 7)


def pages_per_file(total_bytes: int, nfiles: int) -> int:
    """Pages a file, sized on the filler alone plus a 48-byte reference."""
    return (total_bytes // nfiles) // (len(FILLER) + 48)


def draw_ranks(seed: int, n: int, vocab: int, alpha: float) -> np.ndarray:
    """``n`` popularity ranks (0-based) drawn from the seed."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return np.searchsorted(rank_cdf(vocab, alpha), rng.random(n),
                           side="right").clip(max=vocab - 1)


def make_corpus(outdir: str, seed: int, total_bytes: int, nfiles: int,
                vocab: int, alpha: float, long_every: int,
                order_seed=None) -> Tuple[List[str], dict]:
    """Write ``nfiles`` files of pages under ``outdir``.  With
    ``order_seed`` each file's pages come in an order drawn from it: the
    same files' contents, byte counts and references, another order.
    Returns (paths, {"refs", "distinct", "bytes"})."""
    npages = pages_per_file(total_bytes, nfiles)
    ranks = draw_ranks(seed, npages * nfiles, vocab, alpha)
    distinct = np.unique(ranks)
    urls = {int(r): url_of(seed, int(r), long_every)
            for r in distinct.tolist()}
    order = None if order_seed is None else \
        np.random.Generator(np.random.PCG64(order_seed))
    paths, nbytes = [], 0
    for i in range(nfiles):
        part = ranks[i * npages:(i + 1) * npages]
        part = (part if order is None else order.permutation(part)).tolist()
        data = b"".join(FILLER + HREF + urls[r] + CLOSE for r in part)
        path = os.path.join(outdir, f"part-{i:05d}.html")
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())     # written back before any window
        paths.append(path)
        nbytes += len(data)
    return paths, {"refs": int(len(ranks)), "distinct": int(len(distinct)),
                   "bytes": nbytes}


def href_urls(data: bytes, max_url: int = 256) -> List[bytes]:
    """Every URL of a page's references, in order: the bytes after each
    ``<a href="`` up to the first quote within ``max_url`` bytes (a
    reference with no quote there has no URL)."""
    out = []
    pos = data.find(HREF)
    while pos >= 0:
        s = pos + len(HREF)
        q = data.find(b'"', s, s + max_url)
        if q >= 0:
            out.append(data[s:q])
        pos = data.find(HREF, s)
    return out


def file_urls(paths: Sequence[str], max_url: int = 256) -> List[List[bytes]]:
    """:func:`href_urls` of each file."""
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(href_urls(f.read(), max_url))
    return out
