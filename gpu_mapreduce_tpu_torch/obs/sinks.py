"""Span-event sinks and the Chrome trace-event export (the port's copy
of ``gpu_mapreduce_tpu/obs/sinks.py``; the same file formats).

Events arrive in Chrome trace-event form (``tracer.Span.event``), so a
JSONL trace is one event a line and :func:`chrome_trace` only wraps the
list for Perfetto / chrome://tracing.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Callable, List, Optional

from ..utils.env import env_knob


def _jsonable(x):
    """json.dumps default= hook: numpy scalars/arrays, bytes, anything
    else degrades to str — a trace line must never raise."""
    try:
        import numpy as np
        if isinstance(x, np.integer):
            return int(x)
        if isinstance(x, np.floating):
            return float(x)
        if isinstance(x, np.ndarray):
            return x.tolist()
    except Exception:
        pass
    if isinstance(x, bytes):
        return x.decode("utf-8", errors="replace")
    return str(x)


def dumps(ev: dict) -> str:
    return json.dumps(ev, default=_jsonable)


class RingSink:
    """Bounded in-memory buffer.  Locked: a snapshot (list()) taken
    while another thread appends would raise 'deque mutated during
    iteration' — concurrent ``-partition`` worlds emit while a reader
    calls ``mr.stats()``/``dump_trace``."""

    def __init__(self, maxlen: int = 65536):
        self.events: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def emit(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def snapshot(self) -> list:
        with self._lock:
            return list(self.events)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()


class JsonlSink:
    """One JSON event per line, flushed per event so a killed run still
    leaves a readable trace.

    Bounded by size-based rotation so a multi-hour soak cannot fill the
    disk: past ``max_bytes`` (``MRTPU_TRACE_MAX_MB``; 0/unset =
    unbounded) the file rotates to ``path.1`` .. ``path.<keep>``
    (``MRTPU_TRACE_KEEP``, default 3, oldest dropped) and a fresh
    ``path`` opens.  Each rotation bumps the
    ``mrtpu_trace_rotated_total`` metrics counter."""

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 keep: Optional[int] = None):
        self.path = path
        if max_bytes is None:
            # env_knob: a typo'd knob warns and falls back — it must
            # not crash the run the trace was meant to observe
            mb = env_knob("MRTPU_TRACE_MAX_MB", float, 0.0)
            max_bytes = int(mb * (1 << 20)) if mb > 0 else 0
        self.max_bytes = max_bytes
        if keep is None:
            keep = env_knob("MRTPU_TRACE_KEEP", int, 3)
        self.keep = max(1, int(keep))
        self.rotations = 0
        self._f = open(path, "w")
        self._lock = threading.Lock()

    def emit(self, ev: dict) -> None:
        line = dumps(ev)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            if self.max_bytes and self._f.tell() >= self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        """Shift path.(i) → path.(i+1), current → path.1, reopen fresh
        (caller holds the lock).  A rotation failure (permissions, a
        vanished directory) keeps writing to the current file — a trace
        must degrade, not raise into the traced op — and DISABLES
        further rotation: retrying on every emit would pay a close/open
        per span and inflate the rotation counter while rotating
        nothing."""
        try:
            self._f.close()
            for i in range(self.keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        except OSError:
            self.max_bytes = 0            # broken: back to unbounded
            self._reopen()
            return
        self._reopen()                    # fresh file (rename moved it)
        self.rotations += 1
        from .metrics import note_trace_rotated
        note_trace_rotated()

    def _reopen(self) -> None:
        """Reopen the live file after a rotation attempt.  If even that
        fails (directory vanished, ENOSPC at create), the sink goes
        inert on /dev/null rather than raising out of emit() — a
        raising sink gets dropped by the tracer and the rest of a
        multi-hour run would leave no trace at all."""
        try:
            self._f = open(self.path, "a")
        except OSError:
            self.max_bytes = 0
            self._f = open(os.devnull, "w")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class CallbackSink:
    """Adapter: any ``fn(event_dict)`` as a sink."""

    def __init__(self, fn: Callable[[dict], None]):
        self.fn = fn

    def emit(self, ev: dict) -> None:
        self.fn(ev)


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

def chrome_trace(events: List[dict]) -> dict:
    """Wrap span events as a Chrome trace-event JSON object (the
    Perfetto-loadable envelope).  Events already carry ph/ts/dur/pid/tid;
    non-serializable args are scrubbed here."""
    return {"traceEvents": json.loads(json.dumps(list(events),
                                                 default=_jsonable)),
            "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events: List[dict]) -> int:
    """Write the Chrome trace JSON; returns the event count."""
    doc = chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


def read_jsonl(path: str) -> List[dict]:
    """Load a JSONL trace file (skipping any truncated final line from a
    killed run)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
