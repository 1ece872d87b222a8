"""Segment ids and segment reductions over sorted rows, and the group
table's epilogue.

One code path serves sum, max and min: max and min reduce in the order-key
domain of the column's logical dtype (``bits.order_key``), so u32 and u64
values held as signed bit patterns reduce in unsigned order, and empty
segments hold the dtype's fill value (its minimum for max, its maximum for
min), as ``jax.ops.segment_max``/``segment_min`` leave them.  Sums wrap
mod 2^width, bit-identical to the unsigned sum.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import from_order_key, narrow64, order_key
from .sort import argsort_slots


def segment_ids_from_boundary(mask: torch.Tensor) -> torch.Tensor:
    """Row → segment id for rows whose segment starts where ``mask`` is
    set (rows before the first start get -1)."""
    return torch.cumsum(mask.to(torch.int64), 0) - 1


def _fill(x: torch.Tensor, dtype, op: str) -> torch.Tensor:
    """The logical dtype's minimum (for max) or maximum (for min), as a
    bit pattern in ``x``'s storage dtype."""
    dt = np.dtype(dtype)
    if dt.kind == "u":
        v = 0 if op == "max" else -1      # all ones: the unsigned maximum
    else:
        info = np.finfo(dt) if dt.kind == "f" else np.iinfo(dt)
        v = info.min if op == "max" else info.max
    return torch.tensor(v, dtype=x.dtype)


def segment_reduce(x: torch.Tensor, ids: torch.Tensor, nseg: int, op: str,
                   dtype) -> torch.Tensor:
    """Reduce rows of ``x`` (logical ``dtype``) into ``nseg`` segments by
    ``ids``; an id equal to ``nseg`` drops its row."""
    if op == "sum":
        out = torch.zeros(nseg + 1, dtype=x.dtype, device=x.device)
        return out.index_add_(0, ids, x)[:nseg]
    if op not in ("max", "min"):
        raise ValueError(op)
    k = order_key(x, dtype)
    fill = order_key(_fill(x, dtype, op), dtype).item()
    out = torch.full((nseg + 1,), fill, dtype=k.dtype, device=x.device)
    out.scatter_reduce_(0, ids, k, "amax" if op == "max" else "amin",
                        include_self=True)
    return from_order_key(out[:nseg], dtype, x.dtype)


def table_to_groups(table, T: int, gcap: int, reduce_op: str, key_dtype,
                    value_dtype):
    """Group-table slots → ``(ukey [gcap], uval [gcap], g, overflow)``,
    the layout the sort path emits: ascending unique keys in the key's
    logical order, zero-filled past the group count ``g``.

    ``table`` is ``(tkey, occ, cnt, tsum)`` from
    ``ops/cuda/group.segment_table``: slots [0, T) are live (keys and
    sums as 64-bit widened bit patterns, ``tsum`` None for ``count``) and
    ``cnt[T]`` counts the rows that found no slot.  Counts come out as
    int64; sums narrow to the value dtype's width, the same wrap as the
    sort path's segment sum.  ``g`` and ``overflow`` are host ints (one
    device read each)."""
    tkey, occ, cnt, tsum = table
    key = narrow64(tkey[:T], key_dtype)
    order = argsort_slots(order_key(key, key_dtype), occ[:T] == 1)
    g = int(order.numel())
    top = order[:gcap]
    ukey = torch.zeros(gcap, dtype=key.dtype, device=key.device)
    ukey[:top.numel()] = key[top]
    if reduce_op == "count":
        uval = torch.zeros(gcap, dtype=torch.int64, device=key.device)
        uval[:top.numel()] = cnt[top].to(torch.int64)
    else:
        sums = narrow64(tsum[top], value_dtype)
        uval = torch.zeros(gcap, dtype=sums.dtype, device=key.device)
        uval[:top.numel()] = sums
    return ukey, uval, g, int(cnt[T])
