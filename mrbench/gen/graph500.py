"""Graph500 Kronecker edge generator (specification §3), frozen for the
benchmark, in plain PyTorch.

Each of the ``edgefactor * 2^scale`` edge draws takes, at every level, two
32-bit uniforms from a counter-based hash of (seed, level, draw, edge
index): the first picks the row half with probability C + D, the second
the column half with probability B / (A + B) in the top half and
D / (C + D) in the bottom half, the reference code's
``kronecker_generator``.  The vertex labels are then permuted by a
seeded permutation (a sort of hashed labels), as the specification asks.

Draws are integer arithmetic only (32-bit values in int64 lanes, every
product kept below 2^63), so an edge's endpoints depend on its index and
the seed alone: the same on the CPU and on the card, and the same edge
whatever range of indices a shard generates.  :func:`unique_edges`
keeps the first occurrence of each distinct directed edge in draw order,
as OINK's ``rmat`` culls repeats; :func:`shuffle` puts a graph's edges
in a seeded order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

M32 = 0xFFFFFFFF
_SPLITMIX = 0x9E3779B97F4A7C15
M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One splitmix64 output for the host-side stream keys."""
    x = (x + _SPLITMIX) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def stream_key(seed: int, *words: int) -> Tuple[int, int]:
    """Two 32-bit keys for one stream of draws (level, draw, purpose)."""
    x = _splitmix64(seed & M64)
    for w in words:
        x = _splitmix64(x ^ (w & M64))
    return x & M32, x >> 32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for u32 values in int64 lanes, without overflow:
    the constant's halves keep every product below 2^49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser over u32 values in int64 lanes."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform32(index: torch.Tensor, key: Tuple[int, int]) -> torch.Tensor:
    """A u32 draw (in int64) for each counter in ``index`` (< 2^32)."""
    return fmix32(fmix32(index ^ key[0]) ^ key[1])


def thresholds(abcd: Sequence[float]) -> Tuple[int, int, int]:
    """The three u32 thresholds of the two draws: row bit when
    u >= t_ab; column bit when u >= t_a (top) or u >= t_c (bottom)."""
    a, b, c, d = abcd
    ab = a + b
    return (round(ab * 2 ** 32), round(a / ab * 2 ** 32),
            round(c / (c + d) * 2 ** 32))


def kronecker_edges(seed: int, scale: int, start: int, count: int,
                    abcd: Sequence[float], device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Endpoints (before the label permutation) of draws
    ``start .. start + count - 1``: two int64 tensors."""
    if scale > 31 or start + count > (1 << 32):
        raise ValueError("scale above 31 or more than 2^32 draws")
    t_ab, t_a, t_c = thresholds(abcd)
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    src = torch.zeros_like(idx)
    dst = torch.zeros_like(idx)
    for level in range(scale):
        ubit = uniform32(idx, stream_key(seed, 1, level, 0)) >= t_ab
        u = uniform32(idx, stream_key(seed, 1, level, 1))
        vbit = torch.where(ubit, u >= t_c, u >= t_a)
        src |= ubit.to(torch.int64) << level
        dst |= vbit.to(torch.int64) << level
    return src, dst


def label_permutation(seed: int, scale: int, device=None) -> torch.Tensor:
    """perm[v]: the new label of vertex v, a seeded permutation of
    0 .. 2^scale - 1 (labels ordered by a 31-bit hash, ties by label)."""
    v = torch.arange(1 << scale, dtype=torch.int64, device=device)
    h = uniform32(v, stream_key(seed, 2)) >> 1
    order = torch.sort((h << 32) | v).values & M32
    perm = torch.empty_like(v)
    perm[order] = torch.arange(1 << scale, dtype=torch.int64, device=device)
    return perm


def first_occurrences(packed: torch.Tensor) -> torch.Tensor:
    """Indices of the first occurrence of each distinct value, ascending
    (so in draw order)."""
    sk, perm = torch.sort(packed, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    del sk
    return torch.sort(perm[first]).values


def unpack(packed: torch.Tensor, scale: int) -> torch.Tensor:
    """``src << scale | dst`` values → [n, 2] int64 (src, dst)."""
    return torch.stack([packed >> scale, packed & ((1 << scale) - 1)], 1)


def unique_edges(src: torch.Tensor, dst: torch.Tensor, scale: int
                 ) -> torch.Tensor:
    """The first occurrence of each distinct (src, dst), in draw order:
    [n, 2] int64."""
    packed = (src << scale) | dst
    return unpack(packed[first_occurrences(packed)], scale)


def generate_packed(seed: int, scale: int, edgefactor: int,
                    abcd: Sequence[float], device=None,
                    chunk_log2: int = 24) -> Tuple[torch.Tensor, int]:
    """The configuration's graph from ``seed``: ``edgefactor * 2^scale``
    draws, their labels permuted, repeats culled; each edge packed as
    ``src << scale | dst`` (int64, scale <= 31), in draw order.  Returns
    (packed edges, draws)."""
    ndraw = edgefactor << scale
    perm = label_permutation(seed, scale, device)
    parts = []
    step = 1 << chunk_log2
    for start in range(0, ndraw, step):
        s, d = kronecker_edges(seed, scale, start, min(step, ndraw - start),
                               abcd, device)
        parts.append((perm[s] << scale) | perm[d])
        del s, d
    del perm
    packed = torch.cat(parts)
    del parts
    return packed[first_occurrences(packed)], ndraw


def shuffle(packed: torch.Tensor, seed: int) -> torch.Tensor:
    """``packed`` in a seeded order (a sort of hashed positions, ties by
    position): the same edges, another order."""
    idx = torch.arange(packed.shape[0], dtype=torch.int64,
                       device=packed.device)
    h = uniform32(idx, stream_key(seed, 3)) >> 1
    return packed[torch.sort((h << 32) | idx).values & M32]


def generate(seed: int, scale: int, edgefactor: int,
             abcd: Sequence[float], device=None,
             chunk_log2: int = 24) -> dict:
    """:func:`generate_packed` as ``{"edges": [n, 2] int64 on device,
    "draws": int, "unique": n}``."""
    packed, ndraw = generate_packed(seed, scale, edgefactor, abcd, device,
                                    chunk_log2)
    edges = unpack(packed, scale)
    return {"edges": edges, "draws": ndraw, "unique": int(edges.shape[0])}
