"""lookup3 hashing (Bob Jenkins, public domain algorithm) in PyTorch.

The counterpart of ``gpu_mapreduce_tpu/ops/hash.py``:

* :func:`hashlittle` / :func:`hash_bytes64` — the exact scalar host
  version over ``bytes`` (a pure-Python copy).
* :func:`hash_words32`, :func:`hashlittle_masked`,
  :func:`hash_bytes64_masked` and :func:`hash_u64` — vectorised over
  tensors, bit-identical to the scalar version.

Tensor arithmetic runs on int64 lanes holding u32 values (``ops/bits``):
every add and subtract is masked back to 32 bits, and the rotates' right
shifts see only non-negative values, so they are logical.  Results are
u32 values in int64 lanes; the 64-bit ids are u64 bit patterns in int64
(``(hi << 32) | lo`` wraps into the sign bit as intended).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .bits import M32 as _M32
from .bits import to_u32_lanes


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def _mix(a: int, b: int, c: int):
    a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32
    b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32
    c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32
    a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32
    b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32
    c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32
    return a, b, c


def _final(a: int, b: int, c: int):
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return a, b, c


def hashlittle(data: bytes, initval: int = 0) -> int:
    """Exact hashlittle(key, length, initval) → uint32 (reference
    src/hash.cpp:104-228), byte-at-a-time formulation."""
    length = len(data)
    a = b = c = (0xDEADBEEF + length + initval) & _M32
    i = 0
    while length > 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & _M32
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & _M32
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & _M32
        a, b, c = _mix(a, b, c)
        i += 12
        length -= 12
    tail = data[i:]
    if length == 0:
        return c
    pad = tail + b"\x00" * (12 - len(tail))
    a = (a + int.from_bytes(pad[0:4], "little")) & _M32
    b = (b + int.from_bytes(pad[4:8], "little")) & _M32
    c = (c + int.from_bytes(pad[8:12], "little")) & _M32
    a, b, c = _final(a, b, c)
    return c


def hash_bytes64(data: bytes) -> int:
    """64-bit intern id for a byte string: two seeded hashlittle passes."""
    return (hashlittle(data, 0) << 32) | hashlittle(data, 0xDEADBEEF)


# ---------------------------------------------------------------------------
# tensor versions: u32 values in int64 lanes
# ---------------------------------------------------------------------------

def _trot(x, k: int):
    return ((x << k) & _M32) | (x >> (32 - k))


def _tmix(a, b, c):
    a = (a - c) & _M32; a = a ^ _trot(c, 4); c = (c + b) & _M32
    b = (b - a) & _M32; b = b ^ _trot(a, 6); a = (a + c) & _M32
    c = (c - b) & _M32; c = c ^ _trot(b, 8); b = (b + a) & _M32
    a = (a - c) & _M32; a = a ^ _trot(c, 16); c = (c + b) & _M32
    b = (b - a) & _M32; b = b ^ _trot(a, 19); a = (a + c) & _M32
    c = (c - b) & _M32; c = c ^ _trot(b, 4); b = (b + a) & _M32
    return a, b, c


def _tfinal(a, b, c):
    c = c ^ b; c = (c - _trot(b, 14)) & _M32
    a = a ^ c; a = (a - _trot(c, 11)) & _M32
    b = b ^ a; b = (b - _trot(a, 25)) & _M32
    c = c ^ b; c = (c - _trot(b, 16)) & _M32
    a = a ^ c; a = (a - _trot(c, 4)) & _M32
    b = b ^ a; b = (b - _trot(a, 14)) & _M32
    c = c ^ b; c = (c - _trot(b, 24)) & _M32
    return a, b, c


def hash_words32(words: torch.Tensor, initval: int = 0) -> torch.Tensor:
    """hashlittle over fixed-width keys: ``words`` [..., W] of u32 bit
    patterns, each row one key of 4*W bytes → u32 hashes [...] (int64
    lanes)."""
    words = to_u32_lanes(words)
    w = words.shape[-1]
    init = (0xDEADBEEF + 4 * w + initval) & _M32
    a = torch.full(words.shape[:-1], init, dtype=torch.int64,
                   device=words.device)
    b = c = a
    i = 0
    while w > 3:
        a = (a + words[..., i]) & _M32
        b = (b + words[..., i + 1]) & _M32
        c = (c + words[..., i + 2]) & _M32
        a, b, c = _tmix(a, b, c)
        i += 3
        w -= 3
    if w == 0:
        return c
    if w >= 1:
        a = (a + words[..., i]) & _M32
    if w >= 2:
        b = (b + words[..., i + 1]) & _M32
    if w >= 3:
        c = (c + words[..., i + 2]) & _M32
    return _tfinal(a, b, c)[2]


def _hashlittle_masked_seeds(words: torch.Tensor, lengths: torch.Tensor,
                             seeds: Sequence[int],
                             first_tail: int = -1) -> torch.Tensor:
    """hashlittle over variable-length keys for several seeds in one
    pass: → u32 hashes [len(seeds), ...] (int64 lanes).  Each row of
    ``words`` [..., T] is a key's bytes as little-endian u32 words,
    zeroed beyond its length (lookup3's tail padding).  When every row's
    last block is block ``first_tail`` or later, the blocks before it
    are full in every row: they mix with no per-row select and no
    final."""
    words = to_u32_lanes(words)
    T = words.shape[-1]
    pad = (-T) % 3
    if pad:
        words = torch.nn.functional.pad(words, (0, pad))
        T += pad
    lengths = lengths.to(torch.int64)
    seed = torch.tensor([(0xDEADBEEF + s) & _M32 for s in seeds],
                        dtype=torch.int64, device=words.device)
    seed = seed.reshape((len(seeds),) + (1,) * lengths.dim())
    init = (seed + lengths) & _M32
    a = b = c = out = init     # length 0: hashlittle returns c == init
    last = (lengths + 11) // 12 - 1      # each key's tail block
    for t in range(T // 3):
        a0 = (a + words[..., 3 * t]) & _M32
        b0 = (b + words[..., 3 * t + 1]) & _M32
        c0 = (c + words[..., 3 * t + 2]) & _M32
        am, bm, cm = _tmix(a0, b0, c0)
        if t < first_tail:
            a, b, c = am, bm, cm
            continue
        is_full = last > t            # another block follows → mix
        a = torch.where(is_full, am, a)
        b = torch.where(is_full, bm, b)
        c = torch.where(is_full, cm, c)
        out = torch.where(last == t, _tfinal(a0, b0, c0)[2], out)
    return out


def hashlittle_masked(words: torch.Tensor, lengths: torch.Tensor,
                      initval: int = 0) -> torch.Tensor:
    """hashlittle over variable-length keys (see
    :func:`_hashlittle_masked_seeds`) → u32 hashes [...]."""
    return _hashlittle_masked_seeds(words, lengths, (initval,))[0]


def hash_bytes64_masked(words: torch.Tensor, lengths: torch.Tensor,
                        seed_hi: int = 0,
                        seed_lo: int = 0xDEADBEEF) -> torch.Tensor:
    """u64 intern id (int64 bit pattern) from two seeded masked-hashlittle
    passes, computed together.  Default seeds: bit-identical to
    :func:`hash_bytes64`; other seeds give an independent id family."""
    hi, lo = _hashlittle_masked_seeds(words, lengths, (seed_hi, seed_lo))
    return (hi << 32) | lo


def hash_u64(keys: torch.Tensor, initval: int = 0) -> torch.Tensor:
    """u64 keys (int64 bit patterns) → u32 hashes matching hashlittle on
    their 8-byte little-endian encodings."""
    keys = keys.to(torch.int64)
    lo = keys & _M32
    hi = (keys >> 32) & _M32
    return hash_words32(torch.stack([lo, hi], dim=-1), initval)


# ---------------------------------------------------------------------------
# interning packed byte rows
# ---------------------------------------------------------------------------

ALT_SEEDS = (0x9E3779B9, 0x85EBCA6B)    # the collision check's id family
_WINDOW_BYTES = 1 << 26      # window bytes gathered per chunk of rows
_CHUNK_ROWS = 1 << 22


def _length_buckets(nblocks: torch.Tensor) -> torch.Tensor:
    """Bucket of each row by its count of 12-byte blocks: 0 for at most
    one block, else ceil(log2(blocks)) — a bucket's rows need at most
    twice the blocks of its shortest row."""
    lg = torch.ceil(torch.log2(nblocks.clamp(min=1).to(torch.float64)))
    return lg.to(torch.int64)


def _hash_window(buf: torch.Tensor, starts: torch.Tensor,
                 lengths: torch.Tensor, blocks: int, first_tail: int,
                 seed_hi: int, seed_lo: int) -> torch.Tensor:
    """hash_bytes64 of rows of at most ``blocks`` 12-byte blocks: each
    row's bytes gathered into a zero-padded window of little-endian u32
    words (lookup3 reads zeros past a key's end)."""
    width = 12 * max(blocks, 1)     # an all-empty bucket reads zeros
    idt = torch.int32 if buf.numel() < (1 << 31) else torch.int64
    lane = torch.arange(width, dtype=idt, device=buf.device)
    pos = starts.to(idt)[:, None] + lane
    pos.clamp_(min=0, max=max(buf.numel() - 1, 0))
    if buf.numel():
        win = buf.index_select(0, pos.reshape(-1)).reshape(-1, width)
    else:
        win = torch.zeros(pos.shape, dtype=torch.uint8, device=buf.device)
    del pos
    win.masked_fill_(lane[None, :] >= lengths.to(idt)[:, None], 0)
    hi, lo = _hashlittle_masked_seeds(win.view(torch.int32), lengths,
                                      (seed_hi, seed_lo), first_tail)
    return (hi << 32) | lo


def hash_rows(buf: torch.Tensor, starts: torch.Tensor,
              lengths: torch.Tensor, seed_hi: int = 0,
              seed_lo: int = 0xDEADBEEF) -> torch.Tensor:
    """hash_bytes64 of the rows ``buf[starts[i]:starts[i]+lengths[i]]``
    (int64 bits), on the buffer's device.  Rows are bucketed by length,
    so a bucket's lookup3 loop runs only as many blocks as its longest
    row (never thirty million short rows at the length of one long one),
    and each bucket is hashed in chunks of bounded window size."""
    n = lengths.numel()
    out = torch.empty(n, dtype=torch.int64, device=buf.device)
    if n == 0:
        return out
    nblocks = (lengths + 11) // 12
    bucket = _length_buckets(nblocks)
    for b in torch.unique(bucket).tolist():
        rows = torch.nonzero(bucket == b).squeeze(1)
        nb = nblocks[rows]
        blocks, first_tail = int(nb.max()), int(nb.min()) - 1
        step = max(1, min(_CHUNK_ROWS, _WINDOW_BYTES // max(12 * blocks, 1)))
        for lo in range(0, rows.numel(), step):
            r = rows[lo:lo + step]
            out[r] = _hash_window(buf, starts[r], lengths[r], blocks,
                                  first_tail, seed_hi, seed_lo)
    return out


def _row_bytes(buf: torch.Tensor, offsets: torch.Tensor, i: int) -> bytes:
    return buf[int(offsets[i]):int(offsets[i + 1])].cpu().numpy().tobytes()


def intern_packed(buf: torch.Tensor, offsets: torch.Tensor):
    """Intern the rows of a packed byte column on its device → (ids [n],
    unique ids [u] in unsigned order, first-occurrence row of each
    [u]); ids are int64 bit patterns of ``hash_bytes64``.  One stable
    sort of the ids gives the unique ids and first rows; when an id
    repeats, the rows of repeated ids hash again in the alternate family
    (:data:`ALT_SEEDS`), and two rows with one id but different alternate
    ids are a real 64-bit collision (``ValueError``)."""
    from .bits import unsigned_order_key
    starts = offsets[:-1]
    lengths = offsets[1:] - starts
    ids = hash_rows(buf, starts, lengths)
    n = ids.numel()
    order = torch.sort(unsigned_order_key(ids), stable=True).indices
    si = ids[order]
    head = torch.ones(n, dtype=torch.bool, device=ids.device)
    head[1:] = si[1:] != si[:-1]
    if n and not bool(head.all()):
        # the rows of repeated ids, in sorted order: a repeat and the
        # row before it are neighbours here too
        member = ~head
        member[:-1] |= ~head[1:]
        rows = order[member]
        sa = hash_rows(buf, starts[rows], lengths[rows], *ALT_SEEDS)
        hd = head[member]
        bad = ~hd[1:] & (sa[1:] != sa[:-1])
        del sa
        if bool(bad.any()):
            i = int(torch.nonzero(bad)[0, 0])
            raise ValueError(
                "64-bit intern collision between %r and %r"
                % (_row_bytes(buf, offsets, int(rows[i])),
                   _row_bytes(buf, offsets, int(rows[i + 1]))))
    return ids, si[head], order[head]


# ---------------------------------------------------------------------------
# the shuffle's destination hash
# ---------------------------------------------------------------------------

def keys_to_words32(keys: torch.Tensor, dtype=None) -> torch.Tensor:
    """Fixed-width keys [n] or [n, w] of logical numpy ``dtype`` (default:
    the tensor's own) → their little-endian u32 words [n, W] (int64
    lanes), so the device hash sees the bytes the host hash would: an
    8-byte key is 2 words (low first), a 4-byte key one, and a sub-4-byte
    key widens to one u32 as numpy's ``astype(uint32)`` does (the JAX
    package's ``keys_to_words32``, parallel/shuffle.py:51-63)."""
    if keys.dim() == 1:
        keys = keys[:, None]
    n = keys.shape[0]
    if keys.dtype.is_floating_point:
        keys = keys.view(torch.int64 if keys.element_size() == 8
                         else torch.int32)
    if keys.element_size() == 8:
        k = keys.to(torch.int64)
        words = torch.stack([k & _M32, (k >> 32) & _M32], dim=-1)
        return words.reshape(n, 2 * keys.shape[1])
    from .bits import widen64
    wide = widen64(keys, dtype) if dtype is not None \
        else keys.to(torch.int64)
    return (wide & _M32).reshape(n, keys.shape[1])


def default_hash(keys: torch.Tensor, dtype=None) -> torch.Tensor:
    """lookup3 over each key's bytes → u32 hashes (int64 lanes): the
    device twin of ``hashlittle(key, keybytes, nprocs)``
    (src/mapreduce.cpp:472), bit-equal to the JAX package's
    ``default_hash``."""
    return hash_words32(keys_to_words32(keys, dtype))
