"""Bob Jenkins' lookup3 ``hashlittle`` (public domain), vectorised in
numpy over many byte strings, and the 64-bit intern id built from two
seeded passes: ``(hashlittle(s, 0) << 32) | hashlittle(s, 0xDEADBEEF)``.

The benchmark's own copy, written from the algorithm, so that the plain
InvertedIndex reference names each URL by the id the system is specified
to give it without taking anything from the system.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

U32 = np.uint32


def _rot(x, k):
    return (x << U32(k)) | (x >> U32(32 - k))


def _mix(a, b, c):
    a = a - c; a ^= _rot(c, 4); c = c + b
    b = b - a; b ^= _rot(a, 6); a = a + c
    c = c - b; c ^= _rot(b, 8); b = b + a
    a = a - c; a ^= _rot(c, 16); c = c + b
    b = b - a; b ^= _rot(a, 19); a = a + c
    c = c - b; c ^= _rot(b, 4); b = b + a
    return a, b, c


def _final(a, b, c):
    c ^= b; c = c - _rot(b, 14)
    a ^= c; a = a - _rot(c, 11)
    b ^= a; b = b - _rot(a, 25)
    c ^= b; c = c - _rot(b, 16)
    a ^= c; a = a - _rot(c, 4)
    b ^= a; b = b - _rot(a, 14)
    c ^= b; c = c - _rot(b, 24)
    return c


def hashlittle_many(keys: Sequence[bytes], initval: int = 0) -> np.ndarray:
    """hashlittle(key, len(key), initval) of each key → uint32 [n]."""
    n = len(keys)
    lens = np.fromiter((len(k) for k in keys), np.int64, n)
    nblk = np.maximum((lens + 11) // 12, 1)
    width = int(nblk.max(initial=1)) * 12
    buf = np.zeros((n, width), np.uint8)
    flat = np.frombuffer(b"".join(keys), np.uint8)
    row = np.repeat(np.arange(n), lens)
    col = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    buf[row, col] = flat
    words = buf.view("<u4").astype(U32)          # [n, width / 4]
    with np.errstate(over="ignore"):
        init = (U32(0xDEADBEEF) + lens.astype(U32) + U32(initval & 0xFFFFFFFF))
        a = init.copy(); b = init.copy(); c = init.copy()
        out = c.copy()                            # length 0 → c
        last = nblk - 1
        for t in range(width // 12):
            a0 = a + words[:, 3 * t]
            b0 = b + words[:, 3 * t + 1]
            c0 = c + words[:, 3 * t + 2]
            fin = _final(a0.copy(), b0.copy(), c0.copy())
            tail = (last == t) & (lens > 0)
            out = np.where(tail, fin, out)
            more = last > t
            am, bm, cm = _mix(a0, b0, c0)
            a = np.where(more, am, a)
            b = np.where(more, bm, b)
            c = np.where(more, cm, c)
    return out


def intern_ids(keys: Sequence[bytes]) -> np.ndarray:
    """The 64-bit id of each key as uint64."""
    hi = hashlittle_many(keys, 0).astype(np.uint64)
    lo = hashlittle_many(keys, 0xDEADBEEF).astype(np.uint64)
    return (hi << np.uint64(32)) | lo
