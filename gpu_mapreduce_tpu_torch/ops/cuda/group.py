"""The group table: count / exact sum per distinct key without a row sort.

The counterpart of ``gpu_mapreduce_tpu/ops/pallas/group.py``.
:func:`segment_table` launches the hand-written kernel
``csrc/seg_table.cu`` on a CUDA tensor; on a CPU tensor it runs
:func:`segment_table_ref`, a vectorised PyTorch build of the same table.
:func:`segment_group_reduce` puts the table and its epilogue
(``ops/segment.table_to_groups``) together into the fused group body's
table engine.

One launch covers any row count, so the TPU kernel's paging
(``page_rows_for``, ``MAX_PAGES``) is not carried over; the engine config
is ``("tbl", T)``.  The table's layout is :class:`GroupTable`.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...core.runtime import MRError
from ...utils.env import env_flag, env_str
from ..bits import M32, narrow64, widen64
from . import library, note_kernel_launch

# multiplicative-hash constants of the slot hash (csrc/seg_table.cu)
_GOLD1 = 0x9E3779B1
_GOLD2 = 0x85EBCA6B


def table_group_enabled(device: torch.device) -> bool:
    """``MRTPU_PALLAS_GROUP``, the JAX package's switch, read at call
    time: ``auto`` (default) takes the table engine where its kernel runs
    (a CUDA device) and the sort path on the CPU; ``1`` forces the table
    (on the CPU through the plain version); ``0`` selects the sort
    path.  ``auto`` matches the JAX package's choice, and on an H100 the
    table group is the faster one at both IntCount shapes, all keys
    distinct and zipf (PERF.md, the kernel findings)."""
    if env_str("MRTPU_PALLAS_GROUP", "auto") == "auto":
        return device.type == "cuda"
    return env_flag("MRTPU_PALLAS_GROUP", False)


def group_supported(skv, out_kind: str, reduce_op) -> Tuple[bool, str]:
    """(ok, reason): which fused group chains the table covers.  The
    reason feeds the warn-once fallback; unsupported chains keep the sort
    path, still fused."""
    if out_kind != "kv":
        return False, ("grouped KMV layout needs the full row "
                       "permutation (values stay with their groups)")
    if reduce_op not in ("count", "sum"):
        return False, (f"reduce op {reduce_op!r} is not "
                       f"table-accumulable (only count/sum)")
    kd, vd = np.dtype(skv.key_dtype), np.dtype(skv.value_dtype)
    if skv.key.dim() != 1 or kd.kind not in "iu" or kd.itemsize > 8:
        return False, "keys are not a 1-D <=8-byte integer column"
    if reduce_op == "sum" and (skv.value.dim() != 1 or vd.kind not in "iu"
                               or vd.itemsize > 8):
        return False, ("sum needs a 1-D integer value column — float "
                       "sums are order-sensitive and would drift from "
                       "the sorted segment_sum")
    return True, ""


_WARNED: set = set()


def warn_fallback(reason: str) -> None:
    """One warning per distinct fallback reason per process; the sort
    path runs instead."""
    if reason in _WARNED:
        return
    _WARNED.add(reason)
    warnings.warn(f"MRTPU_PALLAS_GROUP: group kernels falling back to the "
                  f"sort path ({reason})", stacklevel=3)


def table_slots(gcap: int) -> int:
    """Table size for an expected group capacity: the next power of two
    at ≤50% load, so probe chains stay short and a ~2× group-count miss
    still fits (overflow is detected, not undefined)."""
    g = max(int(gcap), 8)
    t = 1
    while t < g:
        t <<= 1
    return 2 * t


def split_limbs(col: torch.Tensor, dtype) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Integer column of logical ``dtype`` → (hi, lo) u32 limbs of its
    64-bit widening, as int64 lanes in [0, 2^32)."""
    w = widen64(col, dtype)
    return (w >> 32) & M32, w & M32


def join_limbs(hi: torch.Tensor, lo: torch.Tensor, dtype) -> torch.Tensor:
    """(hi, lo) u32 limbs → values of ``dtype`` in its storage type (the
    exact inverse of :func:`split_limbs`; wider values wrap)."""
    return narrow64((hi << 32) | (lo & M32), dtype)


def slot_hash(hi: torch.Tensor, lo: torch.Tensor, T: int) -> torch.Tensor:
    """The kernel's first probe slot for keys given as u32 limbs."""
    h = ((lo ^ ((hi * _GOLD1) & M32)) * _GOLD2) & M32
    return h & (T - 1)


EMPTY = -1          # the empty slot's key, 2^64-1 as an int64 bit pattern


class GroupTable(NamedTuple):
    """The table of ``csrc/seg_table.cu`` over T main slots.

    ``slots`` int32 [T+2, 4]: per 16-byte slot the key's (lo, hi) limbs
    (one int64 through :func:`slot_keys`), the int32 row count and a spare
    word.  Slots [0, T) hold keys by linear probing (``EMPTY`` when free);
    slot T is the side slot of key 2^64-1, which never probes; slot T+1 is
    the meta slot: its count is the rows that found no slot (overflow,
    read only as ``> 0``), its spare the number of ``claimed`` entries.
    ``sums`` int64 [T+2] beside them (None for a count).  ``claimed``
    int32 [min(n, T) + 1] lists the slots that hold a group, in no order,
    and ``claimed_keys`` int64 their keys."""
    slots: torch.Tensor
    sums: Optional[torch.Tensor]
    claimed: torch.Tensor
    claimed_keys: torch.Tensor


def slot_keys(slots: torch.Tensor) -> torch.Tensor:
    """The int64 key of every slot of ``GroupTable.slots``."""
    return slots.view(torch.int64)[:, 0]


def _table(T: int, n: int, with_sum: bool, device, fill) -> GroupTable:
    room = min(n, T) + 1
    return GroupTable(
        fill((T + 2, 4), dtype=torch.int32, device=device),
        fill(T + 2, dtype=torch.int64, device=device) if with_sum else None,
        fill(room, dtype=torch.int32, device=device),
        fill(room, dtype=torch.int64, device=device))


def segment_table_ref(keys: torch.Tensor, values: Optional[torch.Tensor],
                      T: int) -> GroupTable:
    """Plain PyTorch version of the kernel, with no per-row loop.

    Key 2^64-1 goes to the side slot.  The other distinct keys claim
    slots in rounds of linear probing: each round every unplaced key
    proposes its next slot, and of the keys that propose one empty slot
    the one whose first row comes first wins (``scatter_reduce`` amin).
    The losers and the keys that met an occupied slot step on; a key that
    has probed all T slots overflows.  Then ``index_add_`` sends every
    row to its key's slot."""
    n = keys.numel()
    dev = keys.device
    table = _table(T, n, values is not None, dev, torch.zeros)
    slot_keys(table.slots)[:] = EMPTY
    if n == 0:
        return table
    uniq, inv = torch.unique(keys, return_inverse=True)
    nu = uniq.numel()
    first_row = torch.full((nu,), n, dtype=torch.int64, device=dev)
    first_row.scatter_reduce_(0, inv, torch.arange(n, device=dev), "amin")
    hi, lo = split_limbs(uniq, np.int64)
    slot0 = slot_hash(hi, lo, T)
    step = torch.zeros(nu, dtype=torch.int64, device=dev)
    side = uniq == EMPTY
    slot_of = torch.where(side, T, T + 1)        # side slot, else overflow
    taken = torch.zeros(T, dtype=torch.bool, device=dev)
    best = torch.full((T,), n, dtype=torch.int64, device=dev)
    pending = torch.nonzero(~side, as_tuple=True)[0]
    placed = 0
    while pending.numel() and placed < T:
        s = (slot0[pending] + step[pending]) & (T - 1)
        free = torch.nonzero(~taken[s], as_tuple=True)[0]
        cand, cs = pending[free], s[free]
        best.scatter_reduce_(0, cs, first_row[cand], "amin")
        won = first_row[cand] == best[cs]
        best[cs] = n
        winners, ws = cand[won], cs[won]
        taken[ws] = True
        slot_of[winners] = ws
        placed += int(winners.numel())
        keep = torch.ones(pending.numel(), dtype=torch.bool, device=dev)
        keep[free[won]] = False
        pending = pending[keep]
        step[pending] += 1
        pending = pending[step[pending] < T]
    placed = slot_of <= T
    groups = slot_of[placed]
    slot_keys(table.slots)[groups] = uniq[placed]
    table.claimed[:groups.numel()] = groups.to(torch.int32)
    table.claimed_keys[:groups.numel()] = uniq[placed]
    row_slot = slot_of[inv]
    count = torch.zeros(T + 2, dtype=torch.int32, device=dev)
    count.index_add_(0, row_slot, torch.ones(n, dtype=torch.int32,
                                             device=dev))
    table.slots[:, 2] = count
    table.slots[T + 1, 3] = groups.numel()
    if values is not None:
        ok = row_slot <= T
        table.sums.index_add_(0, row_slot[ok], values[ok])
    return table


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.seg_table_launch.argtypes = [p, p, ctypes.c_int64, ctypes.c_int64,
                                     p, p, p, p, ctypes.c_int, p]
    lib.seg_table_launch.restype = ctypes.c_int


def _check(keys: torch.Tensor, values: Optional[torch.Tensor],
           T: int) -> None:
    for t in (keys,) if values is None else (keys, values):
        if not isinstance(t, torch.Tensor) or t.dim() != 1 \
                or t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError("segment_table takes contiguous 1-D int64 "
                             "tensors")
    if values is not None and (values.shape != keys.shape
                               or values.device != keys.device):
        raise ValueError("segment_table: keys and values differ in shape "
                         "or device")
    if T < 1 or T & (T - 1) or T > (1 << 31):
        raise ValueError(f"segment_table: T={T} is not a power of two "
                         f"in [1, 2^31]")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_table: unsupported device {keys.device}")


def segment_table(keys: torch.Tensor, values: Optional[torch.Tensor],
                  T: int) -> GroupTable:
    """The group table over ``keys`` [n] (int64, 64-bit widened bit
    patterns) with, for a sum, ``values`` [n] (int64 likewise), T main
    slots.  A CUDA tensor launches ``csrc/seg_table.cu`` on the current
    stream; a CPU tensor runs :func:`segment_table_ref`.  Anything else
    raises."""
    _check(keys, values, T)
    if keys.device.type == "cpu":
        return segment_table_ref(keys, values, T)
    table = _table(T, keys.numel(), values is not None, keys.device,
                   torch.empty)
    lib = library("seg_table", _bind)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = lib.seg_table_launch(
        keys.data_ptr(), None if values is None else values.data_ptr(),
        keys.numel(), T, table.slots.data_ptr(),
        None if table.sums is None else table.sums.data_ptr(),
        table.claimed.data_ptr(), table.claimed_keys.data_ptr(),
        keys.device.index or 0, stream)
    if rc != 0:
        raise MRError(f"seg_table kernel launch failed (CUDA error {rc})")
    note_kernel_launch(segment_table)
    return table


segment_table.launches = 0


def segment_group_reduce(key: torch.Tensor, value: torch.Tensor,
                         nrecv: int, gcap: int, reduce_op: str, cfg: tuple,
                         key_dtype, value_dtype):
    """The table engine of the fused group body over the first ``nrecv``
    rows → ``(ukey, uval, g, overflow)`` in the sort path's layout
    (``ops/segment.table_to_groups``).  ``cfg`` is ``("tbl", T)``."""
    from ..segment import table_to_groups
    _tag, T = cfg
    if T < gcap:
        raise ValueError(f"table T={T} smaller than group cap {gcap}")
    keys = widen64(key[:nrecv], key_dtype).contiguous()
    vals = None
    if reduce_op == "sum":
        vals = widen64(value[:nrecv], value_dtype).contiguous()
    table = segment_table(keys, vals, T)
    return table_to_groups(table, T, gcap, reduce_op, key_dtype,
                           value_dtype)
