"""Convert / segment-reduce on device: the local half of collate.

The one-device counterpart of ``gpu_mapreduce_tpu/parallel/group.py:26-260``.
Convert sorts the frame's rows (valid rows first, then by key in the key
column's logical order), marks group boundaries and lays the groups out;
reduce computes one output row per group.
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
    key 0, size 0 and offset ``cap``, as in the JAX layout."""
    cap = sk.shape[0]
    seg = segment_ids_from_boundary(mask)
    first = torch.nonzero(mask, as_tuple=True)[0]      # ascending
    g = int(first.numel())
    ukey = torch.zeros((gcap,) + tuple(sk.shape[1:]), dtype=sk.dtype,
                       device=sk.device)
    ukey[:g] = sk[first]
    voff = torch.full((gcap,), cap, dtype=torch.int32, device=sk.device)
    voff[:g] = first.to(torch.int32)
    ends = torch.cat([first[1:], torch.tensor([nrows], device=sk.device)])
    sizes = torch.zeros(gcap, dtype=torch.int32, device=sk.device)
    sizes[:g] = (ends - first).to(torch.int32)
    return ukey, sizes, voff, seg, g


def segment_reduce_rows(x, seg, valid, gcap: int, op: str, dtype):
    """One output row per segment (sum/max/min); invalid rows drop."""
    ids = torch.where(valid, seg, torch.full_like(seg, gcap))
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
