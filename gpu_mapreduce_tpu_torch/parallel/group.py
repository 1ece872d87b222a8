"""Convert / segment-reduce on device: the local half of collate.

The one-device counterpart of ``gpu_mapreduce_tpu/parallel/group.py``.
Convert sorts the frame's rows (valid rows first, then by key in the key
column's logical order), marks group boundaries and lays the groups out;
reduce computes one output row per group.  :func:`fused_group_body` is
convert(+reduce) in one call for the plan fuser, with the group table
(``ops/cuda/group.py``) as its second engine.  :func:`sort_sharded`
sorts a frame by key or value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.runtime import bump_dispatch
from ..ops.bits import order_key
from ..ops.segment import segment_ids_from_boundary, segment_reduce
from ..ops.sort import lexsort
from .sharded import ShardedKMV, ShardedKV, round_cap


def _local_sort(key, value, count: int, key_dtype):
    """Rows ordered by (invalid last, key ascending); ties keep their
    row order."""
    valid = torch.arange(key.shape[0], device=key.device) < count
    order = lexsort((order_key(key, key_dtype), ~valid))
    return key[order], value[order], valid


def _boundary(skey, valid):
    """First row of each group among the valid sorted rows."""
    diff = torch.ones_like(valid)
    diff[1:] = skey[1:] != skey[:-1]
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
    count = int(skv.counts[0])
    bump_dispatch()
    sk, sv, valid = _local_sort(skv.key, skv.value, count, skv.key_dtype)
    mask = _boundary(sk, valid)
    g = int(mask.sum())
    gcap = round_cap(g) if g else 8
    ukey, sizes, voff, _seg, _g = grouped_layout(sk, mask, count, gcap)
    return ShardedKMV(ukey, sizes, voff, sv, np.array([g], np.int32),
                      skv.counts.copy(), skv.key_dtype, skv.value_dtype)


def _local_segment_ids(voff, nval, vcap: int):
    """Value row → group id."""
    starts = torch.zeros(vcap + 1, dtype=torch.int64, device=voff.device)
    keep = voff <= vcap
    starts.index_add_(0, voff[keep].to(torch.int64),
                      (nval[keep] > 0).to(torch.int64))
    return torch.cumsum(starts[:vcap], 0) - 1


def reduce_sharded(kmv: ShardedKMV, op: str = "sum") -> ShardedKV:
    """One output pair per group: count, sum, max or min of its values."""
    bump_dispatch()
    if op == "count":
        return ShardedKV(kmv.ukey, kmv.nvalues.to(torch.int64),
                         kmv.gcounts.copy(), kmv.key_dtype,
                         np.dtype(np.int64))
    vcap = kmv.vcap
    seg = _local_segment_ids(kmv.voffsets, kmv.nvalues, vcap)
    valid = torch.arange(vcap, device=seg.device) < int(kmv.vcounts[0])
    out = segment_reduce_rows(kmv.values, seg, valid, kmv.gcap, op,
                              kmv.value_dtype)
    return ShardedKV(kmv.ukey, out, kmv.gcounts.copy(), kmv.key_dtype,
                     kmv.value_dtype)


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


def first_sharded(kmv: ShardedKMV) -> ShardedKV:
    """One output pair per group with the group's first value (dedupe,
    the cull reduce)."""
    bump_dispatch()
    idx = kmv.voffsets.to(torch.int64).clamp(max=kmv.vcap - 1)
    return ShardedKV(kmv.ukey, kmv.values[idx], kmv.gcounts.copy(),
                     kmv.key_dtype, kmv.value_dtype)


def sort_sharded(skv: ShardedKV, by: str = "key",
                 descending: bool = False) -> ShardedKV:
    """The frame's rows sorted by key or value in the column's logical
    order, valid rows first; ties keep their row order.  Descending
    reverses the valid prefix of the ascending order (so ties come out in
    reverse row order, as the JAX package orders them)."""
    bump_dispatch()
    col, dt = (skv.key, skv.key_dtype) if by == "key" \
        else (skv.value, skv.value_dtype)
    c, cap = int(skv.counts[0]), skv.cap
    r = torch.arange(cap, device=col.device)
    cols = [col] if col.dim() == 1 else \
        [col[:, j] for j in range(col.shape[1] - 1, -1, -1)]
    order = lexsort([order_key(x, dt) for x in cols] + [~(r < c)])
    if descending:
        pos = torch.where(r < c, c - 1 - r, r)
        inv = torch.empty_like(order)
        inv[pos] = r
        order = order[inv]
    return ShardedKV(skv.key[order], skv.value[order], skv.counts.copy(),
                     skv.key_dtype, skv.value_dtype)
