"""Source tailers: follow append-only files/dirs with offset cursors
(the port's copy of ``gpu_mapreduce_tpu/stream/tailer.py``).

One :class:`Tailer` owns the cursor map of a stream — ``{abspath:
byte_offset}`` — and each :meth:`poll` asks the exec/ prefetch layer's
tail mode (:func:`..exec.prefetch.tail_chunks`) what every source grew
since its cursor.  Directory sources re-scan for NEW files on every
poll (a log-rotation layout: the producer opens ``dir/part-0001`` and
keeps appending), so a file that appears after the stream opened is
picked up at offset 0.

The cursor map is the stream's exactly-once anchor: the engine commits
it atomically with the batch that consumed the bytes (one journal
record carries both — stream/engine.py), so a kill -9 between a read
and its commit re-reads the same bytes from the same cursors on
resume, and a kill after the commit never re-reads them.

Watermark evidence rides each poll: the max source mtime of the data
actually consumed, feeding ``Stream.status()['watermark']`` and the
lag gauges.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple


class Tailer:
    """Cursor-tracking follower of a fixed set of file/dir sources."""

    def __init__(self, sources: List[str],
                 cursors: Optional[Dict[str, int]] = None):
        self.sources = [os.path.abspath(s) for s in sources]
        self.cursors: Dict[str, int] = dict(cursors or {})

    # -- discovery ---------------------------------------------------------
    def files(self) -> List[str]:
        """Every tailed file right now (sorted: deterministic batch
        assembly order).  A directory source contributes its current
        regular files; a missing source is simply not born yet."""
        out = set()
        for src in self.sources:
            if os.path.isdir(src):
                try:
                    names = sorted(os.listdir(src))
                except OSError:
                    continue
                for n in names:
                    p = os.path.join(src, n)
                    if os.path.isfile(p):
                        out.add(p)
            elif os.path.isfile(src):
                out.add(src)
        return sorted(out)

    # -- polling -----------------------------------------------------------
    def poll(self, max_bytes: Optional[int] = None,
             final: bool = False) -> Tuple[List[bytes], float]:
        """One follow pass over every source: ``(chunks, watermark)``
        where watermark is the max mtime among files that produced
        data (0.0 when nothing moved).  Advances ``self.cursors`` —
        the caller owns committing them."""
        from ..exec.prefetch import tail_chunks
        chunks: List[bytes] = []
        watermark = 0.0
        budget = max_bytes
        for path in self.files():
            if budget is not None and budget <= 0:
                break
            off = self.cursors.get(path, 0)
            got, new_off = tail_chunks(path, off, max_bytes=budget,
                                       final=final)
            if new_off == off:
                continue
            self.cursors[path] = new_off
            chunks.extend(got)
            if budget is not None:
                budget -= sum(len(c) for c in got)
            try:
                watermark = max(watermark, os.path.getmtime(path))
            except OSError:
                pass
        return chunks, watermark

    def pending_bytes(self) -> int:
        """Bytes appended past the committed cursors but not yet
        consumed — the ingest half of the stream's lag."""
        n = 0
        for path in self.files():
            try:
                n += max(0, os.path.getsize(path)
                         - self.cursors.get(path, 0))
            except OSError:
                continue
        return n
