"""Deterministic synthetic HTML corpus: the benchmark's input.

The port's own copy of ``bench.make_corpus``: for the same arguments it
writes byte-identical files (checked by the tests).  Filler text with one
``<a href="...">`` reference per ~1 KB (the PUMA-style density); ``skew``
and ``dense`` shape the traffic as the docstring says.
"""

import os


def make_corpus(tmpdir: str, total_mb: int, nfiles: int = 4,
                skew: bool = False, dense: bool = False):
    """Write ``nfiles`` files of ``total_mb`` MB in all under ``tmpdir``.

    ``skew``: ~25% of references hit a 64-URL hot set (shuffle skew) and
    ~2% are 120–200 byte long-tail URLs (the two-tier window's second
    gather).

    ``dense``: ~4 refs/KB — past the extract's 1-href/KB capacity
    heuristic, so it MUST take a cap retry — and ~60% long URLs — past
    the cap/4 threshold, so the whole-corpus wide fallback MUST engage.
    Returns (paths, total refs, unique urls)."""
    per_file = (total_mb << 20) // nfiles
    filler = b"<p>" + b"lorem ipsum dolor sit amet " * 36 + b"</p>\n"  # ~1KB
    if dense:
        filler = filler[:220]  # ~4 refs/KB: above the 1/KB cap heuristic
    hot = [b"http://example.org/hot/%02d" % i for i in range(64)]
    paths = []
    uid = 0
    nref = 0
    uniq = set()
    for i in range(nfiles):
        pieces = []
        size = 0
        while size < per_file:
            if dense and nref % 5 < 3:     # ~60% long: force wide windows
                u = (b"http://example.org/long/"
                     + b"p%08d/" % uid + b"x" * (96 + uid % 80))
                uid += 1
            elif skew and nref % 50 == 49:  # checked first: ~2% long tail
                u = (b"http://example.org/long/"
                     + b"p%08d/" % uid + b"x" * (96 + uid % 80))
                uid += 1
            elif skew and nref % 4 == 3:
                u = hot[(nref // 4) % len(hot)]
            else:
                u = b"http://example.org/wiki/page-%08d" % uid
                uid += 1
            url = b'<a href="' + u + b'">x</a>'
            uniq.add(u)
            nref += 1
            pieces.append(filler)
            pieces.append(url)
            size += len(filler) + len(url)
        path = os.path.join(tmpdir, f"part-{i:05d}.html")
        with open(path, "wb") as f:
            f.write(b"".join(pieces))
        paths.append(path)
    return paths, nref, len(uniq)
