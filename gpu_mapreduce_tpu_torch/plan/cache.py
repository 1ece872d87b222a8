"""The plan cache and the plan history (the in-memory subset of
``gpu_mapreduce_tpu/plan/cache.py``).

:func:`plan_cache` (an :class:`LRUCache`) maps (stage-chain
fingerprint, frame signature, device or mesh, ``all2all``, ``outofcore``)
to the ``fuser.CompiledPlan`` that carries one run's exchange plans
(``caps``) and group capacities (``mega``) into the next.  :func:`plan_history` keeps the last 64
executed plans with their groups and modes.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class LRUCache:
    """Thread-safe LRU: a hit moves to the back, ``put`` evicts from the
    front past ``maxsize``; hits, misses and evictions are counted."""

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = self.misses = self.evictions = 0

    def get(self, key):
        with self._lock:
            if key not in self._d:
                self.misses += 1
                return None
            self.hits += 1
            self._d.move_to_end(key)
            return self._d[key]

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._d), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


_PLAN_CACHE_SIZE = 32
_PLAN_CACHE = LRUCache(_PLAN_CACHE_SIZE)


def plan_cache() -> LRUCache:
    """The process's plan cache (the last 32 plans)."""
    return _PLAN_CACHE


def cache_stats() -> dict:
    """The ``plan`` section of ``MapReduce.stats()``: the plan cache's
    size and hit/miss/eviction counts."""
    return {"plan": plan_cache().stats()}


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
