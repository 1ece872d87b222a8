"""Device bodies of the OINK graph callbacks, and the helpers they share.

The one-device counterpart of ``gpu_mapreduce_tpu/parallel/devkernels.py``.
A callback of the composed graph engines maps or reduces a device frame
with one torch body: it receives the frame's padded tensors and its valid
counts and returns ``(key_rows, value_rows, valid)``;
:func:`skv_map`/:func:`skmv_map` pack the valid rows to the front, in
order, into a new frame on the same device.  The only host traffic is the
packed row count, one read an op (the scalar the reference Allreduces
after every op, ``src/mapreduce.cpp:557-558``).  A body returns
``valid=None`` when every row it returns is valid (a map whose valid
rows are the first ``count`` takes just those): the rows are then taken
as they are, with no compaction.

There is no jit: a body runs eagerly, and where the JAX package needs a
static cap (tri's angle expansion) the caller computes the exact size.
u64 ids travel as int64 bit patterns (``ops/bits.py``): every min, max
and compare of a u64 column goes through ``order_key``, and
:data:`U64MAX` (2^64 - 1, the identity of an unsigned min) is -1 here.
A body's int64 output columns are u64 unless the caller names another
logical dtype.

On a mesh frame (:class:`~.sharded.MeshKV`/``MeshKMV``) the body runs
once per shard on that shard's device, and the packed row counts come
back in one pull for the op; every shard's output block has one cap.
For a KV body that is the JAX package's static output length: the body's
rows per input row (the same on every non-empty shard, as for every
row-wise body here) times the input cap, so ``edge_to_vertices`` doubles
the cap and ``edge_upper`` keeps it; a body whose output is not
row-wise, and every KMV body, takes the power of two over the largest
shard's rows.  :func:`clone_sharded` clones shard by shard, and
``concat_sharded`` of mesh frames concatenates shard by shard with the
domains aligned (``parallel/backend.concat_mesh``).

A frame whose keys or values are interned text (``key_decode`` /
``value_decode``) is refused by :func:`skv_map`/:func:`skmv_map`: a
numeric body over hash ids is meaningless, unless the caller passes
``preserve_decodes=True`` to assert that its body keeps the ids opaque.
Concatenation aligns intern domains (:func:`_align_domains`): a
bytes-kind table hashes raw bytes, an object-kind one pickles, so the
bytes side re-interns through the pickle domain and one logical key keeps
one id.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ..core.column import InternTable
from ..core.frame import KMVFrame, KVFrame
from ..core.runtime import bump_dispatch
from ..ops.bits import from_order_key, order_key, to_torch
from ..ops.segment import segment_reduce
from .group import _local_segment_ids
from .sharded import (MeshKMV, MeshKV, ShardedKMV, ShardedKV, SyncStats,
                      pad_rows, round_cap, shard_frame)

U64MAX = -1          # 2^64 - 1 as the int64 that holds its bits
_U64 = np.dtype(np.uint64)


# ---------------------------------------------------------------------------
# unsigned compares of u64 columns held as int64
# ---------------------------------------------------------------------------

def u64_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit integers."""
    return order_key(a, _U64) < order_key(b, _U64)


def u64_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return from_order_key(torch.minimum(order_key(a, _U64),
                                        order_key(b, _U64)), _U64, a.dtype)


def u64_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return from_order_key(torch.maximum(order_key(a, _U64),
                                        order_key(b, _U64)), _U64, a.dtype)


def f64_to_u64(x: torch.Tensor) -> torch.Tensor:
    """Float64 values → u64 bit patterns in int64, as XLA's
    ``astype(uint64)`` converts them: truncated toward zero, NaN and
    values below 0 to 0, values from 2^64 up to 2^64 - 1."""
    x = torch.nan_to_num(x, nan=0.0).clamp(min=0.0)
    top, big = x >= 2.0 ** 64, x >= 2.0 ** 63
    low = torch.where(big, x - 2.0 ** 63, x).masked_fill(top, 0.0)
    low = low.to(torch.int64)
    out = torch.where(big, low + torch.iinfo(torch.int64).min, low)
    return out.masked_fill(top, U64MAX)


# ---------------------------------------------------------------------------
# frames in, frames out
# ---------------------------------------------------------------------------

def place_kv(fr, device) -> ShardedKV:
    """A host KVFrame → the same pairs on ``device``; a device frame as
    it is."""
    return shard_frame(fr, device) if isinstance(fr, KVFrame) else fr


def place_kmv(fr, device) -> ShardedKMV:
    """A host KMVFrame → the same groups on ``device`` (each group's run
    at its offset); a device frame as it is."""
    if not isinstance(fr, KMVFrame):
        return fr
    g, n = len(fr), len(fr.values)
    gcap, vcap = round_cap(g), round_cap(n)
    key, vals = fr.key.data, fr.values.data
    nv = np.zeros(gcap, np.int32)
    vo = np.full(gcap, vcap, np.int32)
    nv[:g] = fr.nvalues
    vo[:g] = fr.offsets[:-1]
    return ShardedKMV(pad_rows(to_torch(key, device), gcap),
                      to_torch(nv, device), to_torch(vo, device),
                      pad_rows(to_torch(vals, device), vcap),
                      np.array([g], np.int32), np.array([n], np.int32),
                      key.dtype, vals.dtype)


def _logical(t: torch.Tensor, dtype) -> np.dtype:
    if dtype is not None:
        return np.dtype(dtype)
    if t.dtype == torch.int64:
        return _U64
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _pack(ok, ov, valid, key_dtype=None, value_dtype=None,
          decodes=(None, None)) -> ShardedKV:
    """The valid rows of a body's output, in order, as a frame padded to
    a power-of-two cap (one device→host read: their count)."""
    if valid is not None:
        idx = torch.nonzero(valid).squeeze(1)
        ok, ov = ok[idx], ov[idx]
        del idx
    ok, ov = ok.contiguous(), ov.contiguous()
    n = ok.shape[0]
    cap = round_cap(n)
    kd, vd = decodes
    return ShardedKV(pad_rows(ok, cap), pad_rows(ov, cap),
                     np.array([n], np.int32),
                     _logical(ok, np.uint64 if kd is not None
                              else key_dtype),
                     _logical(ov, np.uint64 if vd is not None
                              else value_dtype), kd, vd)


def _check_decodes(fr, preserve_decodes: bool, what: str):
    """The decode tables the output keeps: both with
    ``preserve_decodes``; else a frame with any raises, since its ids
    look like plain numbers to a body."""
    if preserve_decodes:
        return fr.key_decode, fr.value_decode
    if fr.key_decode is not None or fr.value_decode is not None:
        which = [n for n, t in (("key", fr.key_decode),
                                ("value", fr.value_decode)) if t is not None]
        raise ValueError(
            f"{what}: {'/'.join(which)} entries are interned byte/object "
            f"ids — a numeric kernel over them is meaningless; decode to "
            f"host first, or pass preserve_decodes=True if the kernel "
            f"treats them as opaque ids")
    return None, None


def _scatter_pack(t, valid, cap: int):
    """The rows of ``t`` where ``valid``, in order, at the front of a
    ``cap``-row block (a prefix sum and one scatter; the dropped rows go
    to one spare row past ``cap``)."""
    if valid is None:
        return pad_rows(t.contiguous(), cap)
    pos = torch.cumsum(valid.to(torch.int64), 0) - 1
    tgt = torch.where(valid, pos, torch.full_like(pos, cap))
    out = t.new_zeros((cap + 1,) + tuple(t.shape[1:]))
    out[tgt] = t
    return out[:cap]


def _pack_mesh(mesh, results, row_cap=None, key_dtype=None,
               value_dtype=None, decodes=(None, None), cap=None) -> MeshKV:
    """Each shard's body output ``(okey, ovalue, valid)`` packed into one
    mesh frame: the valid counts in one pull, then every shard's rows
    at the front of a block of one cap.  ``row_cap`` is ``(input cap,
    input counts)`` for a KV body: the cap is then the body's rows per
    input row times the input cap when that ratio is one integer over
    the non-empty shards (the JAX static shape).  For a KMV body
    (``row_cap`` None) it is the bodies' output length when every shard's
    is the same (a body over one gcap and vcap: the JAX ``skmv_map``
    shape), or ``cap`` when given.  Else it is the power of two over the
    largest count."""
    lens = [ok.shape[0] for ok, _, _ in results]
    counts = list(lens)
    masked = [i for i, (_, _, v) in enumerate(results) if v is not None]
    if masked:
        dev0 = mesh.devices[0]
        SyncStats.bump()      # the op's one pull: the packed counts
        got = torch.stack([results[i][2].sum().to(dev0, non_blocking=True)
                           for i in masked]).cpu().tolist()
        for i, c in zip(masked, got):
            counts[i] = int(c)
    static = cap
    cap = round_cap(max(counts))
    if static is not None:
        cap = max(cap, static)
    elif row_cap is None and len(set(lens)) == 1:
        cap = max(cap, lens[0])
    elif row_cap is not None:
        cap_in, counts_in = row_cap
        ratios = {L // c if c and L % c == 0 else None
                  for L, c in zip(lens, counts_in) if c}
        if len(ratios) == 1 and None not in ratios:
            cap = max(cap, ratios.pop() * cap_in)
    kd, vd = decodes
    shards = []
    for (ok, ov, valid), n in zip(results, counts):
        shards.append(ShardedKV(
            _scatter_pack(ok, valid, cap), _scatter_pack(ov, valid, cap),
            np.array([n], np.int32),
            _logical(ok, np.uint64 if kd is not None else key_dtype),
            _logical(ov, np.uint64 if vd is not None else value_dtype),
            kd, vd))
    return MeshKV(mesh, shards)


def skv_map(fr, fn, extra=(), key_dtype=None, value_dtype=None,
            device=None, preserve_decodes: bool = False):
    """Run a KV body ``fn(key, value, count, *extra) → (okey, ovalue,
    valid)`` over a frame (a host frame is placed on ``device`` first; a
    mesh frame runs it shard by shard) and pack its valid rows into a new
    frame.  Interned frames are refused unless ``preserve_decodes``
    (:func:`_check_decodes`)."""
    if isinstance(fr, MeshKV):
        decodes = _check_decodes(fr, preserve_decodes, "skv_map")
        bump_dispatch()
        results = [fn(s.key, s.value, int(s.counts[0]), *extra)
                   for s in fr.shards]
        return _pack_mesh(fr.mesh, results, (fr.cap, fr.counts.tolist()),
                          key_dtype, value_dtype, decodes)
    fr = place_kv(fr, device)
    decodes = _check_decodes(fr, preserve_decodes, "skv_map")
    bump_dispatch()
    ok, ov, valid = fn(fr.key, fr.value, int(fr.counts[0]), *extra)
    return _pack(ok, ov, valid, key_dtype, value_dtype, decodes)


def skmv_map(kmv, fn, extra=(), key_dtype=None, value_dtype=None,
             device=None, preserve_decodes: bool = False,
             per_value: bool = False):
    """Run a KMV body ``fn(ukey, nvalues, voffsets, values, gcount,
    vcount, *extra) → (okey, ovalue, valid)`` (a vectorised reduce) over
    a grouped frame (a mesh frame shard by shard) and pack its valid rows
    into a new frame; the decode guard as in :func:`skv_map`.  A body
    that compacts its own rows, one at most a value, says so with
    ``per_value``: on a mesh frame its output cap is then the vcap (the
    JAX body's static length)."""
    if isinstance(kmv, MeshKMV):
        decodes = _check_decodes(kmv, preserve_decodes, "skmv_map")
        bump_dispatch()
        results = [fn(s.ukey, s.nvalues, s.voffsets, s.values,
                      int(s.gcounts[0]), int(s.vcounts[0]), *extra)
                   for s in kmv.shards]
        return _pack_mesh(kmv.mesh, results, None, key_dtype, value_dtype,
                          decodes, kmv.vcap if per_value else None)
    kmv = place_kmv(kmv, device)
    decodes = _check_decodes(kmv, preserve_decodes, "skmv_map")
    bump_dispatch()
    ok, ov, valid = fn(kmv.ukey, kmv.nvalues, kmv.voffsets, kmv.values,
                       int(kmv.gcounts[0]), int(kmv.vcounts[0]), *extra)
    return _pack(ok, ov, valid, key_dtype, value_dtype, decodes)


# ---------------------------------------------------------------------------
# intern domains (MapReduce.add, one_frame)
# ---------------------------------------------------------------------------

def _merge_decode(tables, what: str):
    """Union of id → row tables of one domain (None: plain ids; mixing
    plain with interned would merge two incompatible spaces)."""
    if all(t is None for t in tables):
        return None
    if any(t is None for t in tables):
        raise ValueError(
            f"cannot add an interned byte/object-{what}ed mesh dataset "
            f"to a plain one: the merge would span two {what} spaces")
    if len(tables) == 1:
        return tables[0]
    kind = "object" if any(t.kind == "object" for t in tables) \
        else "bytes"
    out = InternTable(kind=kind)
    for t in tables:
        out.update(t)
    return out


def _reintern_pickle_domain(col: torch.Tensor, table: InternTable):
    """A bytes-kind id column and its table → the same rows in the
    PICKLE id domain (the object tier's): every row of the table
    re-interns over its pickle, and the column remaps old → new id by one
    sorted lookup on its device; ids absent from the table (padding rows)
    pass through.  Returns (new column, object-kind table)."""
    from ..core.column import pack_rows
    from ..ops.hash import intern_packed
    if not table:
        return col, InternTable(kind="object")
    old_ids = np.fromiter(table.keys(), np.uint64, len(table))
    rows = list(table.values())
    buf, off = pack_rows([pickle.dumps(r, protocol=4) for r in rows])
    new_ids, uniq, first = intern_packed(
        torch.from_numpy(buf).to(col.device),
        torch.from_numpy(off).to(col.device))
    newt = InternTable(zip(new_ids[first].cpu().numpy().view(np.uint64)
                           .tolist(), [rows[i] for i in first.tolist()]),
                       kind="object")
    old = order_key(to_torch(old_ids, col.device), _U64)
    old, order = torch.sort(old)
    new_by_old = new_ids[order]
    key = order_key(col, _U64)
    pos = torch.searchsorted(old, key).clamp(max=old.numel() - 1)
    hit = old[pos] == key
    return torch.where(hit, new_by_old[pos], col), newt


def _align_domains(frames, which: str):
    """(columns, merged table) of several frames' ``which`` side: when
    bytes-kind and object-kind tables meet, each bytes-kind side
    re-interns through the pickle domain first, so equal logical rows
    carry one id and group together after the concat."""
    cols = [f.key if which == "key" else f.value for f in frames]
    tables = [f.key_decode if which == "key" else f.value_decode
              for f in frames]
    kinds = {t.kind for t in tables if t is not None}
    if kinds == {"bytes", "object"}:
        for i, t in enumerate(tables):
            if t is not None and t.kind == "bytes":
                cols[i], tables[i] = _reintern_pickle_domain(cols[i], t)
    return cols, _merge_decode(tables, which)


def clone_sharded(skv: ShardedKV) -> ShardedKMV:
    """KV → KMV with every row its own one-value group (the device path
    of ``MapReduce::clone``, src/mapreduce.cpp:631-652); a mesh frame
    shard by shard (row i of a shard is its group i)."""
    if isinstance(skv, MeshKV):
        return MeshKMV(skv.mesh, [clone_sharded(s) for s in skv.shards])
    r = torch.arange(skv.cap, dtype=torch.int32, device=skv.device)
    nv = (r < int(skv.counts[0])).to(torch.int32)
    return ShardedKMV(skv.key, nv, r, skv.value, skv.counts.copy(),
                      skv.counts.copy(), skv.key_dtype, skv.value_dtype,
                      skv.key_decode, skv.value_decode)


# ---------------------------------------------------------------------------
# segment helpers shared by the KMV bodies
# ---------------------------------------------------------------------------

def kmv_row_state(nv, vo, vals, gc: int, vc: int):
    """The common prologue: (segment id of each value row [vcap], row
    valid [vcap], group valid [gcap])."""
    vcap = vals.shape[0]
    # the first gc groups hold every value row; the padding groups past
    # them would all add to one counter
    seg = _local_segment_ids(vo[:gc], nv[:gc], vcap)
    rows_valid = (torch.arange(vcap, device=seg.device) < vc) & (seg >= 0)
    groups_valid = torch.arange(nv.shape[0], device=seg.device) < gc
    return seg, rows_valid, groups_valid


_SPARE = 1024        # slots past gcap that the dropped rows spread over


def _ids(seg, valid, gcap: int):
    """Segment ids with every dropped row sent to one of the ``_SPARE``
    slots past ``gcap`` by its row index: one slot for all of them would
    serialise their atomic updates on one address."""
    spare = torch.arange(seg.shape[0], device=seg.device)
    spare.bitwise_and_(_SPARE - 1).add_(gcap)
    return torch.where(valid, seg, spare)


def seg_min_u64(x, seg, valid, gcap: int):
    """Unsigned min of the valid rows of each segment; U64MAX where a
    segment has none."""
    return segment_reduce(x, _ids(seg, valid, gcap), gcap + _SPARE, "min",
                          _U64)[:gcap]


def seg_max_u64(x, seg, valid, gcap: int):
    """Unsigned max of the valid rows of each segment; 0 where a segment
    has none."""
    return segment_reduce(x, _ids(seg, valid, gcap), gcap + _SPARE, "max",
                          _U64)[:gcap]


def seg_any(cond, seg, valid, gcap: int):
    """Whether any valid row of each segment meets ``cond``."""
    return seg_max_u64(cond.to(torch.int64), seg, valid, gcap) > 0


def seg_min_with(x, seg, valid, gcap: int, identity):
    """Segment min with an explicit identity (float64 paths use +inf)."""
    out = torch.full((gcap + _SPARE,), identity, dtype=x.dtype,
                     device=x.device)
    out.scatter_reduce_(0, _ids(seg, valid, gcap), x, "amin",
                        include_self=True)
    return out[:gcap]


def seg_lex_min2(a, b, seg, valid, gcap: int, ident_a, ident_b):
    """Per-segment lexicographic min of (a, b) rows: (amin, bmin) with
    amin the least a and bmin the least b among the rows attaining amin
    (an exact float64 compare) — sssp's best (dist, pred) per vertex."""
    amin = seg_min_with(a, seg, valid, gcap, ident_a)
    att = valid & (a == amin[seg.clamp(min=0)])
    return amin, seg_min_with(b, seg, att, gcap, ident_b)


# ---------------------------------------------------------------------------
# edge/vertex bodies (the device halves of oink/kernels.py's edge maps)
# ---------------------------------------------------------------------------

def _null_like(k):
    return torch.zeros(k.shape[0], dtype=torch.uint8, device=k.device)


def edge_to_vertices_dev(k, v, c):
    okey = torch.cat([k[:c, 0], k[:c, 1]])
    return okey, _null_like(okey), None


def edge_to_vertex_dev(k, v, c):
    return k[:c, 0], _null_like(k[:c]), None


def edge_to_vertex_pair_dev(k, v, c):
    return k[:c, 0], k[:c, 1], None


def edge_both_directions_dev(k, v, c):
    k = k[:c]
    return (torch.cat([k[:, 0], k[:, 1]]), torch.cat([k[:, 1], k[:, 0]]),
            None)


def edge_upper_dev(k, v, c, key_dtype=_U64):
    k = k[:c]
    valid = k[:, 0] != k[:, 1]
    a, b = order_key(k[:, 0], key_dtype), order_key(k[:, 1], key_dtype)
    lo = from_order_key(torch.minimum(a, b), key_dtype, k.dtype)
    hi = from_order_key(torch.maximum(a, b), key_dtype, k.dtype)
    return torch.stack([lo, hi], 1), _null_like(k), valid


def invert_dev(k, v, c):
    return v[:c], k[:c], None


def add_weight_dev(k, v, c):
    return k[:c], torch.ones(c, dtype=torch.float64, device=k.device), None
