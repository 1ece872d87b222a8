"""Device-resident frames on one device: padded row blocks + valid counts.

The one-device counterpart of ``gpu_mapreduce_tpu/parallel/sharded.py``
(``nprocs == 1``; the multi-GPU mesh comes with a later slice).  Each
frame holds torch tensors on its device and a host ``counts[1]`` saying
how many leading rows are valid; the rest is padding.  Caps are powers of
two (min 8).

Torch has no u64 arithmetic, so a u64 key column is held as int64 with
the same bits; ``key_dtype``/``value_dtype`` name the logical numpy dtype
and the host copies (``to_host``) are reinterpreted as it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from ..core.frame import KMVFrame, KVFrame
from ..ops.bits import to_numpy, to_torch


def round_cap(n: int) -> int:
    """Round a capacity up to a power of two (min 8)."""
    cap = 8
    while cap < n:
        cap <<= 1
    return cap


@dataclass
class ShardedKV:
    """KV frame on one device: ``key``/``value`` [cap] + ``counts`` [1]."""

    key: torch.Tensor
    value: torch.Tensor
    counts: np.ndarray
    key_dtype: np.dtype = np.dtype(np.uint64)
    value_dtype: np.dtype = np.dtype(np.uint64)

    nprocs = 1

    @property
    def device(self) -> torch.device:
        return self.key.device

    @property
    def cap(self) -> int:
        return self.key.shape[0]

    def __len__(self) -> int:
        return int(self.counts.sum())

    def to_host(self) -> KVFrame:
        """Exact host KVFrame of the valid rows, in logical dtypes."""
        n = len(self)
        return KVFrame(to_numpy(self.key[:n], self.key_dtype),
                       to_numpy(self.value[:n], self.value_dtype))

    def shard_to_host(self, p: int) -> KVFrame:
        if p != 0:
            raise IndexError(f"shard {p} of a one-device frame")
        return self.to_host()

    def head(self, n: int) -> KVFrame:
        """The first ``n`` valid pairs on the host (one small copy)."""
        n = min(n, len(self))
        return KVFrame(to_numpy(self.key[:n], self.key_dtype),
                       to_numpy(self.value[:n], self.value_dtype))

    def pairs(self) -> Iterator[Tuple[object, object]]:
        yield from self.to_host().pairs()

    def __repr__(self):
        return (f"ShardedKV(cap={self.cap}, counts={self.counts.tolist()}, "
                f"device={self.device})")


@dataclass
class ShardedKMV:
    """KMV frame on one device: groups ``ukey[:gcounts[0]]`` with value
    runs in ``values`` located by ``voffsets``/``nvalues``."""

    ukey: torch.Tensor        # [gcap]
    nvalues: torch.Tensor     # [gcap] int32
    voffsets: torch.Tensor    # [gcap] int32
    values: torch.Tensor      # [vcap]
    gcounts: np.ndarray       # host [1]
    vcounts: np.ndarray       # host [1]
    key_dtype: np.dtype = np.dtype(np.uint64)
    value_dtype: np.dtype = np.dtype(np.uint64)

    nprocs = 1

    @property
    def device(self) -> torch.device:
        return self.ukey.device

    @property
    def gcap(self) -> int:
        return self.ukey.shape[0]

    @property
    def vcap(self) -> int:
        return self.values.shape[0]

    def __len__(self) -> int:
        return int(self.gcounts.sum())

    @property
    def nvalues_total(self) -> int:
        return int(self.vcounts.sum())

    def to_host(self) -> KMVFrame:
        """Exact host KMVFrame: one ragged gather of each group's run."""
        g = len(self)
        key = to_numpy(self.ukey[:g], self.key_dtype)
        nv = self.nvalues[:g].cpu().numpy().astype(np.int64)
        vo = self.voffsets[:g].cpu().numpy().astype(np.int64)
        vals = to_numpy(self.values[:self.nvalues_total], self.value_dtype)
        offsets = np.concatenate([[0], np.cumsum(nv)]).astype(np.int64)
        idx = (np.repeat(vo - offsets[:-1], nv)
               + np.arange(int(offsets[-1]), dtype=np.int64))
        return KMVFrame(key, nv, offsets, vals[idx])

    def shard_to_host(self, p: int) -> KMVFrame:
        if p != 0:
            raise IndexError(f"shard {p} of a one-device frame")
        return self.to_host()

    def groups(self):
        yield from self.to_host().groups()

    def group_values(self, i: int):
        return self.to_host().group_values(i)

    def __repr__(self):
        return (f"ShardedKMV(gcap={self.gcap}, g={len(self)}, "
                f"n={self.nvalues_total}, device={self.device})")


def _pad(t: torch.Tensor, cap: int) -> torch.Tensor:
    if t.shape[0] == cap:
        return t
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:t.shape[0]] = t
    return out


def shard_frame(frame: KVFrame, device) -> ShardedKV:
    """Place a host KVFrame on ``device`` (padded to a power-of-two cap)."""
    n = len(frame)
    cap = round_cap(n)
    k, v = frame.key.data, frame.value.data
    return ShardedKV(_pad(to_torch(k, device), cap),
                     _pad(to_torch(v, device), cap),
                     np.array([n], np.int32), k.dtype, v.dtype)


def _logical_dtype(t: torch.Tensor, dtype) -> np.dtype:
    if dtype is not None:
        return np.dtype(dtype)
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def tensor_frame(key: torch.Tensor, value: torch.Tensor, key_dtype=None,
                 value_dtype=None) -> ShardedKV:
    """Key/value tensors (all rows valid) as a frame on their device,
    padded to a power-of-two cap; a ``None`` logical dtype is the
    tensor's own."""
    if key.shape[0] != value.shape[0]:
        from ..core.runtime import MRError
        raise MRError(f"key/value lengths differ: {key.shape[0]} vs "
                      f"{value.shape[0]}")
    n = key.shape[0]
    cap = round_cap(n)
    return ShardedKV(_pad(key, cap), _pad(value, cap),
                     np.array([n], np.int32),
                     _logical_dtype(key, key_dtype),
                     _logical_dtype(value, value_dtype))


def concat_sharded(frames: Sequence[ShardedKV]) -> ShardedKV:
    """Valid rows of several device frames, in order, as one frame."""
    first = frames[0]
    n = sum(len(f) for f in frames)
    cap = round_cap(n)
    key = _pad(torch.cat([f.key[:len(f)] for f in frames]), cap)
    value = _pad(torch.cat([f.value[:len(f)] for f in frames]), cap)
    return ShardedKV(key, value, np.array([n], np.int32), first.key_dtype,
                     first.value_dtype)
