"""The plan cache and the plan history (the in-memory subset of
``gpu_mapreduce_tpu/plan/cache.py``).

:func:`plan_cache` (an :class:`LRUCache`) maps (stage-chain fingerprint, frame signature,
device) to the ``fuser.CompiledPlan`` that carries one run's group
capacities into the next.  :func:`plan_history` keeps the last 64
executed plans with their groups and modes.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class LRUCache:
    """Thread-safe LRU: a hit moves to the back, ``put`` evicts from the
    front past ``maxsize``."""

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key not in self._d:
                return None
            self._d.move_to_end(key)
            return self._d[key]

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


_PLAN_CACHE_SIZE = 32
_PLAN_CACHE = LRUCache(_PLAN_CACHE_SIZE)


def plan_cache() -> LRUCache:
    """The process's plan cache (the last 32 plans)."""
    return _PLAN_CACHE


_HISTORY: list = []
_HISTORY_LOCK = threading.Lock()
_HISTORY_CAP = 64


def record_history(desc: dict) -> None:
    with _HISTORY_LOCK:
        _HISTORY.append(desc)
        del _HISTORY[:-_HISTORY_CAP]


def plan_history() -> list:
    with _HISTORY_LOCK:
        return list(_HISTORY)


def clear_history() -> None:
    with _HISTORY_LOCK:
        _HISTORY.clear()
