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
