"""Key/value state carried between the JAX package and the port.

This system has no weights; what stands in for them is its key/value
state.  These helpers turn frames pulled out of the JAX package as numpy
arrays into the port's device frames or host pages and back, bit for bit:
a u64 column is reinterpreted as int64 without changing a bit, and its
logical dtype travels with the frame.  A JAX mesh frame of P shards
crosses as per-shard blocks ``[P, cap, ...]`` plus ``counts [P]`` (the
JAX arrays' rows ``[p*cap, (p+1)*cap)`` are block p) and becomes a port
mesh frame, shard p on the mesh's device p, and back.  A frame of a JAX
two-axis mesh (``make_mesh2(S, C)``) crosses the same way, or as blocks
``[S, C, cap, ...]`` with counts ``[S, C]`` (the arrays reshaped by
axis), into the port's ``make_mesh2(S, C)`` frame: the flat shard id is
row-major ``s·C + c`` in both packages.  The second carrier of state across
the packages is a checkpoint directory (``core/checkpoint.py``), which
either package loads.
"""

from __future__ import annotations

import numpy as np

from .ops.bits import to_numpy as _tensor_to_numpy
from .ops.bits import to_torch
from .parallel.sharded import MeshKMV, MeshKV, ShardedKMV, ShardedKV


def kv_from_numpy(key: np.ndarray, value: np.ndarray, counts,
                  device) -> ShardedKV:
    """A one-device KV frame from padded host columns [cap] and the valid
    row count ``counts`` [1]."""
    return ShardedKV(to_torch(key, device), to_torch(value, device),
                     np.asarray(counts, np.int32).reshape(1),
                     key.dtype, value.dtype)


def kmv_from_numpy(ukey: np.ndarray, nvalues: np.ndarray,
                   voffsets: np.ndarray, values: np.ndarray, gcounts,
                   vcounts, device) -> ShardedKMV:
    """A one-device KMV frame from its padded host arrays."""
    return ShardedKMV(to_torch(ukey, device),
                      to_torch(nvalues.astype(np.int32), device),
                      to_torch(voffsets.astype(np.int32), device),
                      to_torch(values, device),
                      np.asarray(gcounts, np.int32).reshape(1),
                      np.asarray(vcounts, np.int32).reshape(1),
                      ukey.dtype, values.dtype)


def _flat_blocks(counts, mesh, *arrays):
    """Per-axis blocks ``[S, C, ...]`` with counts ``[S, C]`` (a two-axis
    mesh) → the flat ``[P, ...]`` blocks and counts ``[P]``."""
    counts = np.asarray(counts, np.int32)
    if counts.ndim == 1:
        return (counts,) + arrays
    if counts.shape != tuple(mesh.shape.values()):
        raise ValueError(f"blocks of axes {counts.shape} for a mesh of "
                         f"{mesh.shape}")
    n = counts.size
    return (counts.reshape(n),) + tuple(
        a.reshape((n,) + a.shape[counts.ndim:]) for a in arrays)


def mesh_kv_from_numpy(key: np.ndarray, value: np.ndarray, counts,
                       mesh) -> MeshKV:
    """A mesh KV frame from per-shard padded blocks ``[P, cap, ...]``
    and the valid counts ``[P]`` (or, on a two-axis mesh, ``[S, C, cap,
    ...]`` and ``[S, C]``)."""
    counts, key, value = _flat_blocks(counts, mesh, key, value)
    return MeshKV(mesh, [kv_from_numpy(key[p], value[p], counts[p], dev)
                         for p, dev in enumerate(mesh.devices)])


def mesh_kmv_from_numpy(ukey: np.ndarray, nvalues: np.ndarray,
                        voffsets: np.ndarray, values: np.ndarray, gcounts,
                        vcounts, mesh) -> MeshKMV:
    """A mesh KMV frame from per-shard padded blocks (``[P, gcap]`` group
    arrays, ``[P, vcap, ...]`` values, shard-local offsets)."""
    gcounts = np.asarray(gcounts, np.int32)
    vcounts = np.asarray(vcounts, np.int32)
    return MeshKMV(mesh, [
        kmv_from_numpy(ukey[p], nvalues[p], voffsets[p], values[p],
                       gcounts[p], vcounts[p], dev)
        for p, dev in enumerate(mesh.devices)])


def to_numpy(frame) -> dict:
    """A port frame's padded arrays as host numpy, in logical dtypes; a
    mesh frame's as per-shard blocks ``[P, cap, ...]`` with its counts
    ``[P]``."""
    if isinstance(frame, (MeshKV, MeshKMV)):
        parts = [to_numpy(s) for s in frame.shards]
        return {k: (np.concatenate([q[k] for q in parts])
                    if k.endswith("counts")
                    else np.stack([q[k] for q in parts]))
                for k in parts[0]}
    if isinstance(frame, ShardedKV):
        return {"key": _tensor_to_numpy(frame.key, frame.key_dtype),
                "value": _tensor_to_numpy(frame.value, frame.value_dtype),
                "counts": frame.counts.copy()}
    return {"ukey": _tensor_to_numpy(frame.ukey, frame.key_dtype),
            "nvalues": frame.nvalues.cpu().numpy(),
            "voffsets": frame.voffsets.cpu().numpy(),
            "values": _tensor_to_numpy(frame.values, frame.value_dtype),
            "gcounts": frame.gcounts.copy(), "vcounts": frame.vcounts.copy()}


def mapreduce_from_numpy(key: np.ndarray, value: np.ndarray, device=None,
                         host: bool = False, **settings):
    """A port MapReduce whose KV holds these host pairs (for example a JAX
    MapReduce's edge KV pulled out as numpy: ``[n, 2]`` u64 keys and
    their values): one frame on ``device``, or with ``host`` host pages
    of at most ``memsize`` MB (spilled past ``maxpage`` under
    ``outofcore=1``).  Register it by name in an
    ``oink.objects.ObjectManager`` with ``name_mr``."""
    from .core.frame import KVFrame
    from .core.mapreduce import MapReduce
    from .parallel.sharded import shard_frame
    mr = MapReduce(device=device, **settings)
    frame = KVFrame(key, value)
    if not host:
        frame = shard_frame(frame, mr.device)
    mr.map(1, lambda itask, kv, ptr: kv.add_frame(frame))
    return mr


def mapreduce_to_numpy(mr) -> tuple:
    """A port MapReduce's KV as host ``(key, value)`` arrays in logical
    dtypes, frames in order (spilled pages read back one at a time)."""
    frames = [fr.to_host() for fr in mr.kv.frames()]
    if not frames:
        raise ValueError("the MapReduce holds no KV pairs")
    return (np.concatenate([f.key.data for f in frames]),
            np.concatenate([f.value.data for f in frames]))
