"""Key/value state carried between the JAX package and the port.

This system has no weights; what stands in for them is its key/value
state.  These helpers turn frames pulled out of the JAX package as numpy
arrays into the port's device frames and back, bit for bit: a u64 column
is reinterpreted as int64 without changing a bit, and its logical dtype
travels with the frame.
"""

from __future__ import annotations

import numpy as np

from .ops.bits import to_numpy as _tensor_to_numpy
from .ops.bits import to_torch
from .parallel.sharded import ShardedKMV, ShardedKV


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


def to_numpy(frame) -> dict:
    """A port frame's padded arrays as host numpy, in logical dtypes."""
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
                         **settings):
    """A port MapReduce whose KV holds these host pairs (for example a JAX
    MapReduce's edge KV pulled out as numpy: ``[n, 2]`` u64 keys and
    their values) as one frame on ``device``; register it by name in an
    ``oink.objects.ObjectManager`` with ``name_mr``."""
    from .core.frame import KVFrame
    from .core.mapreduce import MapReduce
    from .parallel.sharded import shard_frame
    mr = MapReduce(device=device, **settings)
    frame = shard_frame(KVFrame(key, value), mr.device)
    mr.map(1, lambda itask, kv, ptr: kv.add_frame(frame))
    return mr


def mapreduce_to_numpy(mr) -> tuple:
    """A port MapReduce's KV as host ``(key, value)`` arrays in logical
    dtypes, frames in order."""
    frames = [fr.to_host() for fr in mr.kv.frames()]
    if not frames:
        raise ValueError("the MapReduce holds no KV pairs")
    return (np.concatenate([f.key.data for f in frames]),
            np.concatenate([f.value.data for f in frames]))
