"""Registered kernel reduces: batch callbacks for ``mr.reduce(fn,
batch=True)``.

The counterpart of ``gpu_mapreduce_tpu/ops/reduces.py`` (the reference's
``oink/reduce_count.cpp``, ``oink/reduce_cull.cpp``).  Each dispatches on
the frame kind: a device ``ShardedKMV`` reduces on its device, a host
``KMVFrame`` with numpy.  The plan fuser recognises these functions
(``plan/fuser._kernel_op``) and fuses them with the convert before them.
"""

from __future__ import annotations

import numpy as np

from ..core.frame import KMVFrame

_HOST_REDUCE = {"sum": np.add, "max": np.maximum, "min": np.minimum}


def count(frame, kv, ptr=None):
    """(key, [v...]) → (key, nvalues) — oink reduce_count."""
    if isinstance(frame, KMVFrame):
        kv.add_batch(frame.key, frame.nvalues)
    else:
        from ..parallel.group import reduce_sharded
        kv.add_frame(reduce_sharded(frame, "count"))


def cull(frame, kv, ptr=None):
    """(key, [v...]) → (key, first value) — dedupe, oink reduce_cull."""
    if isinstance(frame, KMVFrame):
        kv.add_batch(frame.key, frame.values.data[frame.offsets[:-1]])
    else:
        from ..parallel.group import first_sharded
        kv.add_frame(first_sharded(frame))


def _segment_op(op):
    def fn(frame, kv, ptr=None):
        if isinstance(frame, KMVFrame):
            vals = frame.values.data
            out = _HOST_REDUCE[op].reduceat(vals, frame.offsets[:-1]) \
                if len(frame) else vals[:0]
            kv.add_batch(frame.key, out)
        else:
            from ..parallel.group import reduce_sharded
            kv.add_frame(reduce_sharded(frame, op))
    fn.__name__ = f"reduce_{op}"
    fn.__doc__ = f"(key, [v...]) → (key, {op}(values)), columnar."
    return fn


sum_values = _segment_op("sum")
max_values = _segment_op("max")
min_values = _segment_op("min")
