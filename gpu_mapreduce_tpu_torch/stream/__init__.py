"""stream/ — the standing-query micro-batch engine (the counterpart of
``gpu_mapreduce_tpu/stream/``).

Two surfaces over one engine:

* programmatic — ``mr.stream(sources, dir=...)`` (core/mapreduce.py)
  or :func:`open_stream` here;
* OINK — the ``stream`` command family (oink/commands/stream.py).

The model: tail append-only sources with offset cursors, cut
micro-batches by rows/bytes/time, run the recorded map/reduce chain on
each delta, merge into the resident dataset with the reduce's
accumulator kernel.  Exactly-once via the ft/ journal — cursors commit
atomically with each batch's merge record.
"""

from .engine import ACCUMULATORS, PARSERS, Stream
from .scheduler import BatchCutter
from .tailer import Tailer

__all__ = ["Stream", "Tailer", "BatchCutter", "PARSERS",
           "ACCUMULATORS", "open_stream"]


def open_stream(dir, sources, **kw) -> Stream:
    """Open (or resume) a standing query — see :class:`Stream`."""
    return Stream(dir, sources, **kw)
