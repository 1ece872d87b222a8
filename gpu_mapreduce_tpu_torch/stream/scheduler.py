"""Micro-batch cut policy: rows / bytes / time (the port's copy of
``gpu_mapreduce_tpu/stream/scheduler.py``).

One :class:`BatchCutter` decides when the pending delta is worth a
micro-batch.  Three triggers, any of which cuts:

* ``rows``  — pending newline-terminated records ≥ ``MRTPU_STREAM_ROWS``
* ``bytes`` — pending bytes ≥ ``MRTPU_STREAM_BYTES``
* ``time``  — ANY pending data older than ``MRTPU_STREAM_WAIT_MS``
  (latency floor: a trickle must not wait forever for a full batch)

The cutter never cuts an EMPTY batch: an idle stream writes no
journal records, takes no checkpoints, and recompiles nothing.
"""

from __future__ import annotations

import time
from typing import Optional

from ..utils.env import env_knob


def cut_rows_default() -> int:
    return max(1, env_knob("MRTPU_STREAM_ROWS", int, 4096))


def cut_bytes_default() -> int:
    return max(1, env_knob("MRTPU_STREAM_BYTES", int, 1 << 20))


def cut_wait_default() -> float:
    return max(0.0, env_knob("MRTPU_STREAM_WAIT_MS", int, 200) / 1000.0)


class BatchCutter:
    """Accumulates pending-delta evidence and answers "cut now?"."""

    def __init__(self, rows: Optional[int] = None,
                 nbytes: Optional[int] = None,
                 wait_s: Optional[float] = None):
        self.rows = rows if rows is not None else cut_rows_default()
        self.nbytes = nbytes if nbytes is not None \
            else cut_bytes_default()
        self.wait_s = wait_s if wait_s is not None \
            else cut_wait_default()
        self._first_pending: Optional[float] = None

    def note_pending(self, nbytes: int, rows: int,
                     now: Optional[float] = None) -> None:
        """Record the current pending census (from the tailer)."""
        if nbytes <= 0 and rows <= 0:
            self._first_pending = None
            return
        if self._first_pending is None:
            self._first_pending = time.monotonic() if now is None \
                else now

    def should_cut(self, nbytes: int, rows: int,
                   now: Optional[float] = None) -> bool:
        """True when the pending delta crosses any trigger."""
        if nbytes <= 0 and rows <= 0:
            self._first_pending = None
            return False
        self.note_pending(nbytes, rows, now=now)
        if rows >= self.rows or nbytes >= self.nbytes:
            return True
        now = time.monotonic() if now is None else now
        return self._first_pending is not None and \
            now - self._first_pending >= self.wait_s

    def cut_done(self) -> None:
        self._first_pending = None
