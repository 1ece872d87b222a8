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
    """Reduce rows of ``x`` (logical ``dtype``; a ``[n, w]`` column
    lane by lane) into ``nseg`` segments by ``ids``; an id equal to
    ``nseg`` drops its row."""
    shape = (nseg + 1,) + tuple(x.shape[1:])
    if op == "sum":
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        return out.index_add_(0, ids, x)[:nseg]
    if op not in ("max", "min"):
        raise ValueError(op)
    k = order_key(x, dtype)
    fill = order_key(_fill(x, dtype, op), dtype).item()
    out = torch.full(shape, fill, dtype=k.dtype, device=x.device)
    if k.dim() > 1:              # a [n, w] column reduces each lane
        ids = ids.reshape((-1,) + (1,) * (k.dim() - 1)).expand_as(k)
    out.scatter_reduce_(0, ids, k, "amax" if op == "max" else "amin",
                        include_self=True)
    return from_order_key(out[:nseg], dtype, x.dtype)


def _narrow_order(ok: torch.Tensor):
    """An int64 order key whose values span less than 2^32 → ``(int32
    key of the same order, base)`` (value - base), which sorts in half
    the radix passes; any other key → ``(ok, None)``.  One device read."""
    if ok.dtype != torch.int64 or ok.numel() == 0:
        return ok, None
    lo, hi = torch.stack(torch.aminmax(ok)).tolist()
    if hi - lo >= 1 << 32:
        return ok, None
    base = lo + (1 << 31)
    if base >= 1 << 63:          # then hi - lo < 2^31: hi is a base too
        base = hi
    return (ok - base).to(torch.int32), base


def table_to_groups(table, T: int, gcap: int, reduce_op: str, key_dtype,
                    value_dtype):
    """Group table → ``(ukey [gcap], uval [gcap], g, overflow)``, the
    layout the sort path emits: ascending unique keys in the key's
    logical order, zero-filled past the group count ``g``.

    ``table`` is the ``GroupTable`` of ``ops/cuda/group.segment_table``
    over T main slots (keys and sums as 64-bit widened bit patterns).
    Only its g claimed groups are read: their keys from the claimed list,
    one sort of their order keys (distinct, so it need not be stable; in
    32 bits when they span less than 2^32), then one gather of their
    counts or sums from the slots.  Counts come out as int64; sums narrow
    to the value dtype's width, the same wrap as the sort path's segment
    sum.  ``g`` and ``overflow`` are host ints (one device read of the
    meta slot)."""
    slots, sums, claimed, claimed_keys = table
    _lo, _hi, overflow, g = slots[T + 1].tolist()
    key = narrow64(claimed_keys[:g], key_dtype)
    store, dev = key.dtype, key.device
    ok, base = _narrow_order(order_key(key, key_dtype))
    sorted_ok, perm = torch.sort(ok)
    del key, ok
    k = min(g, gcap)
    sorted_ok = sorted_ok[:k]
    if base is not None:
        sorted_ok = sorted_ok.to(torch.int64).add_(base)
    ukey = torch.empty(gcap, dtype=store, device=dev)
    ukey[k:] = 0
    ukey[:k] = from_order_key(sorted_ok, key_dtype, store)
    src = claimed[perm[:k]]
    if reduce_op == "count":
        uval = torch.empty(gcap, dtype=torch.int64, device=dev)
        uval[:k] = slots[:, 2][src]
    else:
        vals = narrow64(sums[src], value_dtype)
        uval = torch.empty(gcap, dtype=vals.dtype, device=dev)
        uval[:k] = vals
    uval[k:] = 0
    return ukey, uval, g, overflow
