"""The plan cache and the plan history (the in-memory subset of
``gpu_mapreduce_tpu/plan/cache.py``).

:func:`plan_cache` (an :class:`LRUCache`) maps (stage-chain
fingerprint, frame signature, device or mesh, ``all2all``, ``outofcore``)
to the ``fuser.CompiledPlan`` that carries one run's exchange plans
(``caps``) and group capacities (``mega``) into the next.
:func:`plan_history` keeps the last 64 executed plans with their groups
and modes, and :func:`note_fusion` the fused groups' counts (the
``fusion`` section of ``mr.stats()["plan"]``).  Each hit or miss and each
group also goes to the active request account (``obs/context.py``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class LRUCache:
    """Thread-safe LRU: a hit moves to the back, ``put`` evicts from the
    front past ``maxsize``; hits, misses and evictions are counted."""

    def __init__(self, maxsize: int, name: str = "cache"):
        self.name = name
        self.maxsize = max(1, int(maxsize))
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = self.misses = self.evictions = 0

    def get(self, key):
        with self._lock:
            if key in self._d:
                self.hits += 1
                self._d.move_to_end(key)
                hit = self._d[key]
            else:
                self.misses += 1
                hit = None
        # the same hit or miss on the active request account
        try:
            from ..obs.context import note_plan
            note_plan(self.name, hit is not None)
        except Exception:
            pass
        return hit

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
_PLAN_CACHE = LRUCache(_PLAN_CACHE_SIZE, name="plan")


def plan_cache() -> LRUCache:
    """The process's plan cache (the last 32 plans)."""
    return _PLAN_CACHE


def cache_stats() -> dict:
    """The ``plan`` section of ``MapReduce.stats()``: the plan cache's
    size and hit/miss/eviction counts, the fused groups' counts
    (``fusion``), and the persistent plan tier's, which is not ported and
    reads as the JAX package's disarmed tier (zeros)."""
    return {"plan": plan_cache().stats(), "fusion": fusion_stats(),
            "persistent": {"enabled": 0, "entries": 0, "bytes": 0,
                           "hits": 0, "misses": 0, "evictions": 0}}


_FUSION_LOCK = threading.Lock()
_FUSION = {"groups": 0, "fused_groups": 0, "eager_groups": 0,
           "mega_groups": 0, "pallas_groups": 0, "dispatches": 0,
           "eager_dispatch_estimate": 0, "dispatches_saved": 0}


def note_fusion(kind: str, mode: str, dispatches: int, eager_est: int,
                table: bool = False) -> None:
    """One executed plan group (JAX ``plan/cache.note_fusion``): its kind
    ("exchange", "local" or "eager"), its mode (the warm "exchange1" and
    "local1" count as the JAX package's megafused groups), the launches
    it made, the eager ops' launches for the same stages, and whether
    the group table ran (the JAX package's ``pallas_groups``)."""
    fused = kind != "eager"
    mega = fused and mode in ("exchange1", "local1")
    saved = max(0, int(eager_est) - int(dispatches)) if fused else 0
    with _FUSION_LOCK:
        _FUSION["groups"] += 1
        if not fused:
            _FUSION["eager_groups"] += 1
        else:
            _FUSION["fused_groups"] += 1
            if mega:
                _FUSION["mega_groups"] += 1
            if table:
                _FUSION["pallas_groups"] += 1
        _FUSION["dispatches"] += int(dispatches)
        _FUSION["eager_dispatch_estimate"] += int(eager_est)
        _FUSION["dispatches_saved"] += saved
    try:
        from ..obs.context import note_fusion as _ctx_note
        _ctx_note(fused, mega, int(dispatches), saved, table)
    except Exception:
        pass


def fusion_stats() -> dict:
    with _FUSION_LOCK:
        return dict(_FUSION)


def reset_fusion_stats() -> None:
    with _FUSION_LOCK:
        for k in _FUSION:
            _FUSION[k] = 0


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
