"""The plan cache, its persistent tier and the plan history (the
counterpart of ``gpu_mapreduce_tpu/plan/cache.py``).

:func:`plan_cache` (an :class:`LRUCache`) maps (stage-chain
fingerprint, frame signature, device or mesh, ``all2all``, ``outofcore``,
``MRTPU_WIRE``) to the ``fuser.CompiledPlan`` that carries one run's
exchange plans (``caps``) and group capacities (``mega``) into the next.
:func:`persistent_cache` is the on-disk tier under ``<cas>/plan/``
(armed by ``MRTPU_CAS_DIR``, ``utils/cas.py``): the same speculation
state, keyed by :func:`stable_plan_digest` of the in-memory key, so a
fresh process's first run of a known plan goes warm.  The entries are
the JAX package's (``{"c": stamp, "payload": ...}``, JSON with sorted
keys), so either package reads what the other wrote.
:func:`plan_history` keeps the last 64 executed plans with their groups
and modes, and :func:`note_fusion` the fused groups' counts (the
``fusion`` section of ``mr.stats()["plan"]``).  Each hit or miss and each
group also goes to the active request account (``obs/context.py``).

The JAX package's ``enable_executable_cache`` (XLA's executables under
``<cas>/xla/``) has no counterpart: the port compiles nothing per shape;
its kernels are built once from ``csrc/`` into ``_build/``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Optional

from ..utils.env import env_flag, env_knob


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


_PLAN_CACHE: Optional[LRUCache] = None
_PLAN_LOCK = threading.Lock()


def plan_cache() -> LRUCache:
    """The process's plan cache: the last ``MRTPU_PLAN_CACHE`` plans (32
    by default), sized when it is first made, as the JAX package's."""
    global _PLAN_CACHE
    if _PLAN_CACHE is None:
        with _PLAN_LOCK:
            if _PLAN_CACHE is None:
                _PLAN_CACHE = LRUCache(
                    env_knob("MRTPU_PLAN_CACHE", int, 32), name="plan")
    return _PLAN_CACHE


def cache_stats() -> dict:
    """The ``plan`` section of ``MapReduce.stats()``: the plan cache's
    size and hit/miss/eviction counts, the fused groups' counts
    (``fusion``), and the persistent tier's entries, bytes, hits, misses
    and evictions (zeros when it is disarmed)."""
    pp = persistent_cache()
    return {"plan": plan_cache().stats(), "fusion": fusion_stats(),
            "persistent": pp.stats() if pp is not None else {
                "enabled": 0, "entries": 0, "bytes": 0,
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


# ---------------------------------------------------------------------------
# the persistent plan tier: speculation state (exchange plans and group
# capacities) under <cas>/plan/, keyed by a stable digest of the
# in-memory key.  A digest collision is safe: the payload is checked
# against the fresh count matrices on every run (plan_holds, the gcap
# and overflow checks), so at worst one miss and a cold re-run.
# ---------------------------------------------------------------------------


def _mesh_stable(mesh) -> str:
    """Axis names and sizes, and the devices' types (``cuda``, ``cpu``):
    a plan learned on the card never replays on the CPU, and equal
    meshes in another process share state.  No device index, id or
    pointer enters it."""
    shape = dict(getattr(mesh, "shape", None) or {})
    kinds = sorted({_device_type(d) for d in getattr(mesh, "devices", ())})
    return f"{sorted(shape.items())}|{','.join(kinds)}"


def _device_type(dev) -> str:
    """A device's type (``cuda:3`` → ``cuda``)."""
    return getattr(dev, "type", None) or str(dev).split(":")[0]


def _stable_part(x) -> str:
    if isinstance(x, (int, float, str, bytes, bool, type(None))):
        return repr(x)
    if isinstance(x, tuple):
        if len(x) == 2 and x[0] == "fn" and callable(x[1]):
            f = x[1]
            return (f"fn:{getattr(f, '__module__', '?')}."
                    f"{getattr(f, '__qualname__', None) or getattr(f, '__name__', '?')}")
        if len(x) == 2 and x[0] == "mesh" and not isinstance(x[1], str):
            return f"mesh:{_mesh_stable(x[1])}"
        if len(x) == 2 and x[0] == "device" and isinstance(x[1], str):
            return f"device:{_device_type(x[1])}"
        return "(" + ",".join(_stable_part(e) for e in x) + ")"
    raise TypeError(f"no stable rendering for {type(x).__name__}")


def stable_plan_digest(key) -> Optional[str]:
    """Stable cross-process digest of an in-memory plan-cache key, or
    None when some component has no stable rendering (that plan stays
    process-local)."""
    try:
        text = _stable_part(key)
    except TypeError:
        return None
    return hashlib.sha256(text.encode()).hexdigest()


def to_jsonable(x):
    """Plan payloads → JSON-safe (tuples → lists, numpy scalars →
    Python); TypeError on anything else, so an unserializable plan stays
    process-local instead of storing garbage."""
    if isinstance(x, (list, tuple)):
        return [to_jsonable(e) for e in x]
    if isinstance(x, dict):
        return {str(k): to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (str, bool, type(None), int, float)):
        return x
    import numpy as np
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.dtype):
        return str(x)
    raise TypeError(f"not plan-serializable: {type(x).__name__}")


def from_jsonable(x):
    """Inverse of :func:`to_jsonable`: lists become tuples again (wire
    plans are compared and used as keys, so tuple-ness matters)."""
    if isinstance(x, list):
        return tuple(from_jsonable(e) for e in x)
    if isinstance(x, dict):
        return {k: from_jsonable(v) for k, v in x.items()}
    return x


class PersistentPlanCache:
    """One stamped JSON file a stable key digest under ``<root>/plan/``,
    verified on read: a corrupt entry counts
    ``mrtpu_integrity_failures_total{artifact="cas"}``, is removed and
    reads as a miss (a cold run, never wrong state).  Bounded by
    ``MRTPU_PLAN_PERSIST_CAP`` entries (512), oldest mtime evicted."""

    def __init__(self, root: str):
        self.dir = os.path.join(root, "plan")
        self.cap = max(1, env_knob("MRTPU_PLAN_PERSIST_CAP", int, 512))
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _path(self, digest: str) -> str:
        return os.path.join(self.dir, digest + ".json")

    def _note(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
        try:
            from ..obs.context import note_plan
            note_plan("persistent", hit)
        except Exception:
            pass

    def load(self, digest: str) -> Optional[dict]:
        from ..utils.integrity import (digest_bytes,
                                       record_integrity_failure,
                                       verify_enabled)
        path = self._path(digest)
        try:
            with open(path) as f:
                rec = json.load(f)
            payload = rec["payload"]
            body = json.dumps(payload, sort_keys=True).encode()
            if verify_enabled() and rec.get("c") != digest_bytes(body):
                raise ValueError("stamp mismatch")
        except OSError:
            self._note(False)
            return None
        except (ValueError, KeyError, TypeError):
            # a flipped or torn entry: removed, and a cold run instead
            record_integrity_failure("cas")
            try:
                os.remove(path)
            except OSError:
                pass
            self._note(False)
            return None
        self._note(True)
        return payload

    def store(self, digest: str, payload: dict) -> bool:
        """Write (or refresh) one entry through a tmp file, fsync and
        rename; a no-op when the stored bytes already match."""
        from ..utils.integrity import digest_bytes
        body = json.dumps(payload, sort_keys=True)
        rec = json.dumps({"c": digest_bytes(body.encode()),
                          "payload": payload}, sort_keys=True)
        path = self._path(digest)
        try:
            with open(path) as f:
                if f.read() == rec:
                    return False
        except OSError:
            pass
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                f.write(rec)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            return False
        self._evict()
        return True

    def _evict(self) -> None:
        try:
            names = [n for n in os.listdir(self.dir)
                     if n.endswith(".json")]
        except OSError:
            return
        excess = len(names) - self.cap
        if excess <= 0:
            return
        aged = []
        for n in names:
            try:
                aged.append((os.path.getmtime(
                    os.path.join(self.dir, n)), n))
            except OSError:
                continue
        for _mt, n in sorted(aged)[:excess]:
            try:
                os.remove(os.path.join(self.dir, n))
                with self._lock:
                    self.evictions += 1
            except OSError:
                pass

    def stats(self) -> dict:
        entries = 0
        nbytes = 0
        try:
            for n in os.listdir(self.dir):
                if not n.endswith(".json"):
                    continue
                try:
                    nbytes += os.path.getsize(os.path.join(self.dir, n))
                except OSError:
                    continue
                entries += 1
        except OSError:
            pass
        with self._lock:
            return {"enabled": 1, "entries": entries, "bytes": nbytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


_PERSIST: Optional[PersistentPlanCache] = None
_PERSIST_ROOT: Optional[str] = None
_PERSIST_LOCK = threading.Lock()


def persistent_cache() -> Optional[PersistentPlanCache]:
    """The on-disk tier (re-rooted when the environment changes); None
    when no CAS root is armed or ``MRTPU_PLAN_PERSIST=0``."""
    global _PERSIST, _PERSIST_ROOT
    from ..utils.cas import cas_enabled, cas_root
    if not cas_enabled() or not env_flag("MRTPU_PLAN_PERSIST", True):
        return None
    root = cas_root()
    with _PERSIST_LOCK:
        if _PERSIST is None or _PERSIST_ROOT != root:
            _PERSIST = PersistentPlanCache(root)
            _PERSIST_ROOT = root
        return _PERSIST


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
