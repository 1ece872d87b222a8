"""Overlapped host work: ingest prefetch and background spill writes (the
port's copy of ``gpu_mapreduce_tpu/exec/``).

* :mod:`.prefetch` — a bounded producer thread reads chunk N+1 while
  chunk N's callback runs (``MapReduce._map_chunks``); depth knob
  ``MRTPU_PREFETCH`` (default 1, 0 = off).
* :mod:`.spill` — ``core/external.py``'s run writes go to a writer
  thread with a durability barrier before the merge reads a run;
  ``MRTPU_SPILL_BG`` (default 1).

Each path's busy and wait seconds accumulate here (:func:`note_overlap`)
and ``mr.stats()["exec"]`` reports them (:func:`exec_stats`): the
overlap ratio of a path is ``(busy - wait) / busy``, the share of its
background work the foreground never waited for.
"""

from __future__ import annotations

import threading

from ..utils.env import env_knob


def prefetch_depth() -> int:
    """Ingest prefetch depth (``MRTPU_PREFETCH``): 0 off, 1 (default)
    double-buffers, N keeps up to N chunks in flight."""
    return max(0, env_knob("MRTPU_PREFETCH", int, 1))


def spill_bg_enabled() -> bool:
    """Background spill writer (``MRTPU_SPILL_BG``, default on)."""
    return env_knob("MRTPU_SPILL_BG", int, 1) != 0


_LOCK = threading.Lock()
_OVERLAP: dict = {}     # path → {"busy_s", "wait_s", "items"}


def note_overlap(path: str, busy_s: float = 0.0, wait_s: float = 0.0,
                 items: int = 0) -> None:
    """Accumulate one path's background busy seconds, foreground wait
    seconds and item count, and refresh its ``mrtpu_overlap_ratio{path}``
    gauge when the metrics are armed (never raises)."""
    with _LOCK:
        rec = _OVERLAP.setdefault(
            path, {"busy_s": 0.0, "wait_s": 0.0, "items": 0})
        rec["busy_s"] += max(0.0, busy_s)
        rec["wait_s"] += max(0.0, wait_s)
        rec["items"] += items
        ratio = _ratio(rec)
    try:
        from ..obs import metrics as _metrics
        if _metrics.enabled():
            _metrics.get_registry().gauge(
                "mrtpu_overlap_ratio",
                "fraction of background work hidden behind foreground "
                "work, per overlap path (1 = fully overlapped)",
                ("path",)).set(ratio, path=path)
    except Exception:
        pass


def _ratio(rec: dict) -> float:
    busy = rec["busy_s"]
    if busy <= 0.0:
        return 0.0
    return round(max(0.0, min(1.0, (busy - rec["wait_s"]) / busy)), 6)


def exec_stats() -> dict:
    """The ``mr.stats()["exec"]`` section: per-path overlap and the
    active knob values."""
    with _LOCK:
        paths = {p: {**rec, "busy_s": round(rec["busy_s"], 6),
                     "wait_s": round(rec["wait_s"], 6),
                     "overlap_ratio": _ratio(rec)}
                 for p, rec in _OVERLAP.items()}
    return {"overlap": paths,
            "knobs": {"prefetch": prefetch_depth(),
                      "spill_bg": spill_bg_enabled()}}


def reset_stats() -> None:
    """Drop the accumulated overlap records."""
    with _LOCK:
        _OVERLAP.clear()


from .prefetch import prefetch_iter                        # noqa: E402
from .spill import SpillWriter                             # noqa: E402

__all__ = ["prefetch_depth", "spill_bg_enabled", "note_overlap",
           "exec_stats", "reset_stats", "prefetch_iter", "SpillWriter"]
