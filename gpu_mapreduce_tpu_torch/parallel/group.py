"""Convert / segment-reduce on device: the local half of collate.

The one-device counterpart of ``gpu_mapreduce_tpu/parallel/group.py``.
Convert sorts the frame's rows (valid rows first, then by key in the key
column's logical order), marks group boundaries and lays the groups out;
reduce computes one output row per group.  :func:`fused_group_body` is
convert(+reduce) in one call for the plan fuser, with the group table
(``ops/cuda/group.py``) as its second engine.  :func:`sort_sharded`
sorts a frame by key or value; :func:`sort_interned_sharded` sorts an
interned byte/object column by the rows' bytes (their ids are hashes, not
lexicographic order); :func:`sort_multivalues_sharded` sorts the values
inside each group.  Intern tables ride along on every output.

On a mesh frame (:class:`~.sharded.MeshKV`/``MeshKMV``) each op runs its
one-device body shard by shard.  Convert sizes every shard's group block
by the mesh-wide ``gcap`` (the largest shard's group count, rounded; JAX
group.py:132-153), pulling the P group counts in one transfer, so the
layouts are the JAX mesh's; the interned sort is global, as the JAX
package's: the valid rows come out in byte order packed into the first
shards.  :func:`fused_group_shards` runs the fused body on every shard
at one mesh-wide gcap, for the fuser's exchange and local groups.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.runtime import bump_dispatch
from ..ops.bits import order_key, to_torch
from ..ops.segment import segment_ids_from_boundary, segment_reduce
from ..ops.sort import lexsort
from .sharded import (MeshKMV, MeshKV, ShardedKMV, ShardedKV, SyncStats,
                      round_cap)


def _key_columns(key, key_dtype) -> list:
    """Order keys for ``ops/sort.lexsort``: a 1-D key, or the columns of a
    [n, k] key last to first (column 0 primary)."""
    cols = [key] if key.dim() == 1 else \
        [key[:, j] for j in range(key.shape[1] - 1, -1, -1)]
    return [order_key(c, key_dtype) for c in cols]


def _local_sort(key, value, count: int, key_dtype):
    """Rows ordered by (invalid last, key ascending, a [n, k] key
    lexicographically by column); ties keep their row order.  The valid
    rows are the first ``count``, so only they are sorted and the
    padding keeps its place after them."""
    cap = key.shape[0]
    order = lexsort(_key_columns(key[:count], key_dtype))
    if count < cap:
        order = torch.cat([order, torch.arange(count, cap,
                                               device=key.device)])
    sk, sv = key[order], value[order]
    del order
    return sk, sv, torch.arange(cap, device=key.device) < count


def _boundary(skey, valid):
    """First row of each group among the valid sorted rows (a [n, k] key
    starts a group where any column differs)."""
    diff = torch.ones_like(valid)
    ne = skey[1:] != skey[:-1]
    diff[1:] = ne if ne.dim() == 1 else ne.any(dim=1)
    return valid & diff


def grouped_layout(sk, mask, nrows: int, gcap: int):
    """Group layout of SORTED rows → (ukey [gcap], sizes [gcap] int32,
    voff [gcap] int32, seg [cap], g).  Slots past the group count hold
    key 0, size 0 and offset ``cap``, as in the JAX layout; groups past
    ``gcap`` are dropped (``g`` still counts them)."""
    cap = sk.shape[0]
    seg = segment_ids_from_boundary(mask)
    first = torch.nonzero(mask, as_tuple=True)[0]      # ascending
    g = int(first.numel())
    ends = torch.cat([first[1:], torch.tensor([nrows], device=sk.device)])
    first, ends = first[:gcap], ends[:gcap]
    gk = int(first.numel())
    ukey = torch.zeros((gcap,) + tuple(sk.shape[1:]), dtype=sk.dtype,
                       device=sk.device)
    ukey[:gk] = sk[first]
    voff = torch.full((gcap,), cap, dtype=torch.int32, device=sk.device)
    voff[:gk] = first.to(torch.int32)
    sizes = torch.zeros(gcap, dtype=torch.int32, device=sk.device)
    sizes[:gk] = (ends - first).to(torch.int32)
    return ukey, sizes, voff, seg, g


def segment_reduce_rows(x, seg, valid, gcap: int, op: str, dtype):
    """One output row per segment (sum/max/min); invalid rows and
    segments past ``gcap`` drop."""
    ids = torch.where(valid & (seg < gcap), seg, torch.full_like(seg, gcap))
    return segment_reduce(x, ids, gcap, op, dtype)


def convert_sharded(skv: ShardedKV) -> ShardedKMV:
    """Sort + boundary detection → grouped frame; one device→host read
    (the group count, which sizes ``gcap``)."""
    if isinstance(skv, MeshKV):
        return _convert_mesh(skv)
    count = int(skv.counts[0])
    bump_dispatch()
    sk, sv, valid = _local_sort(skv.key, skv.value, count, skv.key_dtype)
    mask = _boundary(sk, valid)
    g = int(mask.sum())
    gcap = round_cap(g) if g else 8
    ukey, sizes, voff, _seg, _g = grouped_layout(sk, mask, count, gcap)
    return ShardedKMV(ukey, sizes, voff, sv, np.array([g], np.int32),
                      skv.counts.copy(), skv.key_dtype, skv.value_dtype,
                      skv.key_decode, skv.value_decode)


def _local_segment_ids(voff, nval, vcap: int):
    """Value row → group id."""
    starts = torch.zeros(vcap + 1, dtype=torch.int64, device=voff.device)
    keep = voff <= vcap
    starts.index_add_(0, voff[keep].to(torch.int64),
                      (nval[keep] > 0).to(torch.int64))
    return torch.cumsum(starts[:vcap], 0) - 1


def reduce_sharded(kmv: ShardedKMV, op: str = "sum") -> ShardedKV:
    """One output pair per group: count, sum, max or min of its values
    (only the count of interned values: arithmetic on ids is refused)."""
    if isinstance(kmv, MeshKMV):
        return _per_shard_kv(kmv, lambda s: reduce_sharded(s, op))
    if kmv.value_decode is not None and op != "count":
        raise ValueError(
            f"reduce_sharded({op!r}): values are interned byte/object "
            f"ids — arithmetic on them is meaningless; decode to host "
            f"first (only 'count' is value-agnostic)")
    bump_dispatch()
    if op == "count":
        return ShardedKV(kmv.ukey, kmv.nvalues.to(torch.int64),
                         kmv.gcounts.copy(), kmv.key_dtype,
                         np.dtype(np.int64), kmv.key_decode)
    vcap = kmv.vcap
    seg = _local_segment_ids(kmv.voffsets, kmv.nvalues, vcap)
    valid = torch.arange(vcap, device=seg.device) < int(kmv.vcounts[0])
    out = segment_reduce_rows(kmv.values, seg, valid, kmv.gcap, op,
                              kmv.value_dtype)
    return ShardedKV(kmv.ukey, out, kmv.gcounts.copy(), kmv.key_dtype,
                     kmv.value_dtype, kmv.key_decode)


def fused_group_body(key, value, nrecv: int, gcap: int, out_kind: str,
                     reduce_op, key_dtype, value_dtype, table_cfg=None):
    """Convert(+reduce) of the first ``nrecv`` rows in one call, for the
    plan fuser.  Two engines with the same output:

    * sort path (default): sort by key, mark boundaries, then the grouped
      layout (``out_kind='kmv'``) or one pair per group (``'kv'``) by
      the same bodies the eager ops run;
    * table path (``table_cfg`` set, kv with count/sum only): the group
      table (``ops/cuda/group.segment_group_reduce``) accumulates per key
      with no row sort, then orders only its occupied slots.

    Returns ``(..., meta)`` with meta = (g, nrecv, overflow) as host ints;
    ``overflow`` (always 0 on the sort path) counts rows the table had no
    slot for."""
    if table_cfg is not None and out_kind == "kv" \
            and reduce_op in ("count", "sum"):
        from ..ops.cuda.group import segment_group_reduce
        ukey, uval, g, overflow = segment_group_reduce(
            key, value, nrecv, gcap, reduce_op, table_cfg, key_dtype,
            value_dtype)
        return ukey, uval, (g, nrecv, overflow)
    sk, sv, valid = _local_sort(key, value, nrecv, key_dtype)
    mask = _boundary(sk, valid)
    ukey, sizes, voff, seg, g = grouped_layout(sk, mask, nrecv, gcap)
    meta = (g, nrecv, 0)
    if out_kind == "kmv":
        return ukey, sizes, voff, sv, meta
    if reduce_op == "count":
        return ukey, sizes.to(torch.int64), meta
    if reduce_op == "first":
        gk = min(g, gcap)
        uval = torch.zeros((gcap,) + tuple(sv.shape[1:]), dtype=sv.dtype,
                           device=sv.device)
        uval[:gk] = sv[voff[:gk].to(torch.int64)]
        return ukey, uval, meta
    return ukey, segment_reduce_rows(sv, seg, valid, gcap, reduce_op,
                                     value_dtype), meta


def fused_group_shards(blocks, nrecvs, gcap: int, out_kind: str,
                       reduce_op, key_dtype, value_dtype, table_cfg=None):
    """:func:`fused_group_body` once per shard, every shard at the one
    mesh-wide ``gcap`` (each on its block's device; the table engine
    launches once a shard).  ``blocks`` holds each shard's ``(key,
    value)`` rows, ``nrecvs`` its valid count.  Returns ``(outs,
    gcounts, overflow)``: each shard's outputs without the meta, the
    group counts as one host array (one pull on a mesh) and the rows the
    tables had no slot for, over every shard."""
    outs, gcounts, overflow = [], [], 0
    for (key, value), n in zip(blocks, nrecvs):
        *out, (g, _n, over) = fused_group_body(key, value, int(n), gcap,
                                               out_kind, reduce_op,
                                               key_dtype, value_dtype,
                                               table_cfg)
        outs.append(out)
        gcounts.append(g)
        overflow += over
    if len(blocks) > 1:
        SyncStats.bump()      # the group's one pull: the group counts
    return outs, np.array(gcounts, np.int32), overflow


def first_sharded(kmv: ShardedKMV) -> ShardedKV:
    """One output pair per group with the group's first value (dedupe,
    the cull reduce)."""
    if isinstance(kmv, MeshKMV):
        return _per_shard_kv(kmv, first_sharded)
    bump_dispatch()
    idx = kmv.voffsets.to(torch.int64).clamp(max=kmv.vcap - 1)
    return ShardedKV(kmv.ukey, kmv.values[idx], kmv.gcounts.copy(),
                     kmv.key_dtype, kmv.value_dtype, kmv.key_decode,
                     kmv.value_decode)


def sort_sharded(skv: ShardedKV, by: str = "key",
                 descending: bool = False) -> ShardedKV:
    """The frame's rows sorted by key or value in the column's logical
    order, valid rows first; ties keep their row order.  Descending
    reverses the valid prefix of the ascending order (so ties come out in
    reverse row order, as the JAX package orders them)."""
    if isinstance(skv, MeshKV):
        return _per_shard_kv(skv, lambda s: sort_sharded(s, by, descending))
    bump_dispatch()
    col, dt = (skv.key, skv.key_dtype) if by == "key" \
        else (skv.value, skv.value_dtype)
    order = lexsort(_key_columns(col, dt)
                    + [~(torch.arange(skv.cap, device=col.device)
                         < int(skv.counts[0]))])
    if descending:
        order = _reverse_valid(order, int(skv.counts[0]))
    return _take_rows(skv, order)


def _reverse_valid(order: torch.Tensor, c: int) -> torch.Tensor:
    """``order`` with its first ``c`` entries (the valid rows) reversed."""
    r = torch.arange(order.numel(), device=order.device)
    pos = torch.where(r < c, c - 1 - r, r)
    inv = torch.empty_like(order)
    inv[pos] = r
    return order[inv]


def _take_rows(skv: ShardedKV, order: torch.Tensor) -> ShardedKV:
    return ShardedKV(skv.key[order], skv.value[order], skv.counts.copy(),
                     skv.key_dtype, skv.value_dtype, skv.key_decode,
                     skv.value_decode)


def _rank_lookup(table, device):
    """(ids in unsigned order as order keys, rank of each) for an intern
    table: rank = the row's place in byte order (pickle order for
    objects).  Built once on the host from the table and memoised on it
    (rebuilt only when the table grows)."""
    from ..ops.sort import argsort_column
    from .sharded import _decode_col
    cached = getattr(table, "_rank_cache", None)
    if cached is None or cached[0] != len(table):
        ids = np.fromiter(table.keys(), np.uint64, len(table))
        rank = np.empty(len(ids), np.int64)
        rank[argsort_column(_decode_col(table, ids))] = np.arange(len(ids))
        by_id = np.argsort(ids, kind="stable")
        cached = (len(table), ids[by_id], rank[by_id])
        table._rank_cache = cached
    _, ids, rank = cached
    return (order_key(to_torch(ids, device), np.uint64),
            to_torch(rank, device))


def sort_interned_sharded(skv: ShardedKV, by: str = "key",
                          descending: bool = False,
                          stable_descending: bool = False) -> ShardedKV:
    """The frame's rows sorted by an interned byte/object column in the
    rows' byte order (pickle order for objects), valid rows first: an id
    → rank surrogate from the decode table, then one device sort.
    Descending reverses the valid prefix of the ascending order (the
    JAX package's device order: equal rows in reverse row order); with
    ``stable_descending`` equal rows keep their row order (its host
    order, Python's ``sorted(reverse=True)``)."""
    if isinstance(skv, MeshKV):
        return _sort_interned_mesh(skv, by, descending)
    table = skv.key_decode if by == "key" else skv.value_decode
    col = skv.key if by == "key" else skv.value
    c, cap = int(skv.counts[0]), skv.cap
    bump_dispatch()
    ids, rank_of = _rank_lookup(table, col.device)
    key = order_key(col, np.uint64)
    pos = torch.searchsorted(ids, key).clamp(max=max(ids.numel() - 1, 0))
    rank = rank_of[pos] if ids.numel() else torch.zeros_like(key)
    if descending and stable_descending:
        rank = -rank
    invalid = ~(torch.arange(cap, device=col.device) < c)
    order = lexsort([rank, invalid])
    if descending and not stable_descending:
        order = _reverse_valid(order, c)
    return _take_rows(skv, order)


def sort_multivalues_sharded(kmv: ShardedKMV,
                             descending: bool = False) -> ShardedKMV:
    """Sort the values inside each group (reference
    src/mapreduce.cpp:2210-2352): one stable sort by (valid, group,
    value) keeps every group in its own run, so sizes and offsets stay.
    A [n, w] value sorts by its first column, as in the JAX package;
    descending orders by the complement (unsigned) or the negation."""
    if isinstance(kmv, MeshKMV):
        return MeshKMV(kmv.mesh, [sort_multivalues_sharded(s, descending)
                                  for s in kmv.shards])
    bump_dispatch()
    vcap = kmv.vcap
    seg = _local_segment_ids(kmv.voffsets, kmv.nvalues, vcap)
    valid = torch.arange(vcap, device=seg.device) < int(kmv.vcounts[0])
    v = kmv.values if kmv.values.dim() == 1 else kmv.values[:, 0]
    dt = np.dtype(kmv.value_dtype)
    if dt.kind == "u":
        keyv = order_key(v, dt)
        keyv = ~keyv if descending else keyv
    else:
        keyv = -v if descending else v
    order = lexsort([keyv, seg, ~valid])
    return ShardedKMV(kmv.ukey, kmv.nvalues, kmv.voffsets,
                      kmv.values[order], kmv.gcounts.copy(),
                      kmv.vcounts.copy(), kmv.key_dtype, kmv.value_dtype,
                      kmv.key_decode, kmv.value_decode)


# ---------------------------------------------------------------------------
# mesh frames: the one-device bodies shard by shard
# ---------------------------------------------------------------------------

def _per_shard_kv(frame, fn) -> MeshKV:
    """``fn`` over each shard of a mesh frame → a mesh KV frame."""
    return MeshKV(frame.mesh, [fn(s) for s in frame.shards])


def _layout(sk, mask, nrows: int, gcap: int, g: int):
    """:func:`grouped_layout` for a shard whose group count ``g`` the
    host already holds, with no further host read (JAX
    group.py:101-129): each group's first row scatters to its slot, the
    other rows to spare slots past ``gcap`` spread by row index (never
    one hot address), and sizes are the distances between group starts.
    Slots past ``g`` keep key 0, size 0 and offset ``cap``."""
    from .devkernels import _SPARE, _ids
    cap = sk.shape[0]
    dev = sk.device
    seg = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = _ids(seg, mask, gcap)
    n = gcap + _SPARE
    ukey = torch.zeros((n,) + tuple(sk.shape[1:]), dtype=sk.dtype,
                       device=dev)
    ukey[tgt] = sk
    voff = torch.full((n,), cap, dtype=torch.int32, device=dev)
    voff[tgt] = torch.arange(cap, dtype=torch.int32, device=dev)
    voff = voff[:gcap]
    sizes = torch.zeros(gcap, dtype=torch.int32, device=dev)
    if g:
        ends = torch.cat([voff[1:g], voff.new_full((1,), nrows)])
        sizes[:g] = ends - voff[:g]
    return ukey[:gcap], sizes, voff


def _convert_mesh(mkv: MeshKV) -> MeshKMV:
    """Per-shard sort and boundaries, the P group counts pulled in one
    transfer, then every shard's layout at the mesh-wide gcap."""
    bump_dispatch()
    parts = []
    for s in mkv.shards:
        c = int(s.counts[0])
        sk, sv, valid = _local_sort(s.key, s.value, c, s.key_dtype)
        parts.append((sk, sv, _boundary(sk, valid), c))
    dev0 = mkv.mesh.devices[0]
    SyncStats.bump()          # the op's one pull: the group counts
    g = torch.stack([m.sum().to(dev0, non_blocking=True)
                     for _, _, m, _ in parts]).cpu().numpy()
    gcap = round_cap(int(g.max())) if g.max() else 8
    shards = []
    for (sk, sv, mask, c), s, gp in zip(parts, mkv.shards, g):
        ukey, sizes, voff = _layout(sk, mask, c, gcap, int(gp))
        shards.append(ShardedKMV(ukey, sizes, voff, sv,
                                 np.array([gp], np.int32), s.counts.copy(),
                                 s.key_dtype, s.value_dtype, s.key_decode,
                                 s.value_decode))
    return MeshKMV(mkv.mesh, shards)


def _sort_interned_mesh(mkv: MeshKV, by: str, descending: bool) -> MeshKV:
    """The global interned sort of a mesh frame (JAX group.py:412-458):
    every shard's valid rows in shard order, one sort by the id → rank
    surrogate on the first shard's device (descending reverses the valid
    prefix, ties in reverse row order), then the sorted rows packed into
    the first shards at the frame's cap."""
    table = mkv.key_decode if by == "key" else mkv.value_decode
    dev0 = mkv.mesh.devices[0]
    bump_dispatch()
    ns = [int(c) for c in mkv.counts]
    key = torch.cat([s.key[:n].to(dev0) for s, n in zip(mkv.shards, ns)])
    value = torch.cat([s.value[:n].to(dev0)
                       for s, n in zip(mkv.shards, ns)])
    col = key if by == "key" else value
    ids, rank_of = _rank_lookup(table, dev0)
    k = order_key(col, np.uint64)
    pos = torch.searchsorted(ids, k).clamp(max=max(ids.numel() - 1, 0))
    rank = rank_of[pos] if ids.numel() else torch.zeros_like(k)
    order = lexsort([rank])
    if descending:
        order = order.flip(0)
    key, value = key[order], value[order]
    total, cap = key.shape[0], mkv.cap
    counts = np.clip(total - np.arange(mkv.nprocs) * cap, 0, cap)
    offs = np.concatenate([[0], np.cumsum(counts)])
    from .sharded import mesh_kv
    return mesh_kv(mkv.mesh,
                   [key[offs[p]:offs[p + 1]].to(dev)
                    for p, dev in enumerate(mkv.mesh.devices)],
                   [value[offs[p]:offs[p + 1]].to(dev)
                    for p, dev in enumerate(mkv.mesh.devices)],
                   counts, mkv.key_dtype, mkv.value_dtype, mkv.key_decode,
                   mkv.value_decode, cap=cap)
