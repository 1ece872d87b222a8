"""Unsigned integers carried as signed bit patterns.

PyTorch has no arithmetic, shifts, sorts or ``searchsorted`` on uint32 /
uint64 tensors that work on every device, so the port carries a u32 value
as int32 (or as an int64 lane masked to 32 bits, where arithmetic wraps)
and a u64 value as int64 with the same bits.  The logical numpy dtype
travels beside the tensor (``ShardedKV.key_dtype``) and is restored on the
way to the host.

Two traps the helpers here close:

* ``>>`` on a negative signed tensor is arithmetic; lookup3 needs logical
  shifts.  Values in 32-bit lanes of an int64 (``to_u32_lanes``, and
  arithmetic wrapped with ``& M32``) are never negative, so ``>>`` there
  is logical.
* A signed sort misorders u64 ids with the top bit set (about half of all
  lookup3 ids).  ``order_key`` maps a logical dtype to a signed key with
  the same order.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_SIGN64 = -(1 << 63)


def to_u32_lanes(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor holding u32 bit patterns → int64 lanes in
    [0, 2^32)."""
    return x.to(torch.int64) & M32


def unsigned_order_key(x: torch.Tensor) -> torch.Tensor:
    """u64 bit patterns in int64 → int64 keys whose signed order is the
    unsigned order of the u64 values."""
    return x ^ _SIGN64


def order_key(x: torch.Tensor, dtype) -> torch.Tensor:
    """A tensor holding values of logical numpy ``dtype`` → a tensor whose
    native (signed or float) order is the logical order."""
    dt = np.dtype(dtype)
    if dt.kind == "u":
        if dt.itemsize == 8:
            return unsigned_order_key(x)
        return x.to(torch.int64) & ((1 << (8 * dt.itemsize)) - 1)
    return x


def from_order_key(k: torch.Tensor, dtype, like: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`order_key`, back to the storage dtype ``like``."""
    dt = np.dtype(dtype)
    if dt.kind == "u" and dt.itemsize == 8:
        return unsigned_order_key(k)
    return k.to(like)


_STORAGE = {np.dtype(np.uint16): np.dtype(np.int16),
            np.dtype(np.uint32): np.dtype(np.int32),
            np.dtype(np.uint64): np.dtype(np.int64)}


def storage_dtype(dtype) -> torch.dtype:
    """The torch dtype that holds values of logical numpy ``dtype``."""
    dt = np.dtype(dtype)
    return torch.from_numpy(np.zeros(0, _STORAGE.get(dt, dt))).dtype


def widen64(x: torch.Tensor, dtype) -> torch.Tensor:
    """Integer values of logical ``dtype`` → int64 holding the bits of
    their 64-bit widening: unsigned zero-extends, signed sign-extends.
    (A plain ``.to(torch.int64)`` would sign-extend a u32 held as
    int32.)"""
    dt = np.dtype(dtype)
    if dt.itemsize == 8:
        return x
    w = x.to(torch.int64)
    if dt.kind == "u":
        w = w & ((1 << (8 * dt.itemsize)) - 1)
    return w


def narrow64(w: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`widen64`: the low bits in ``dtype``'s storage
    type (a wrap mod 2^width, as the narrowing cast of a sum)."""
    store = storage_dtype(dtype)
    return w if store == torch.int64 else w.to(store)


def to_torch(arr: np.ndarray, device) -> torch.Tensor:
    """Host array of any numeric dtype → tensor on ``device`` with the same
    bits (unsigned widths above 8 travel as the signed type of their
    width)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:       # torch tensors must own writable memory
        arr = arr.copy()
    store = _STORAGE.get(arr.dtype)
    if store is not None:
        arr = arr.view(store)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    """Tensor → host array reinterpreted as logical numpy ``dtype``."""
    return t.detach().cpu().numpy().view(np.dtype(dtype))
