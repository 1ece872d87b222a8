"""The MapReduce object: the subset of ops that InvertedIndex.run calls.

The counterpart of ``gpu_mapreduce_tpu/core/mapreduce.py``: ``map``,
``aggregate``, ``convert``, ``reduce`` (per-group host form and
``batch=True``), ``scan_kv`` and the ``kv``/``kmv`` datasets, with the
reference's callback arities: ``map`` calls ``func(itask, kv, ptr)``,
``reduce`` calls ``func(key, values, kv, ptr)`` per group or
``func(frame, kv, ptr)`` per frame with ``batch=True``.

Datasets live on one device (``device=None`` → the card, ``MRError``
when there is none; ``device="cpu"`` runs the plain path).  Map tasks run
in task order under every ``mapstyle``.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..parallel.backend import DeviceBackend
from .dataset import KeyMultiValue, KeyValue
from .runtime import MRError, Settings, resolve_device


class MapReduce:
    """One MapReduce object owns at most one KV and/or one KMV."""

    def __init__(self, device=None, **settings):
        self.settings = Settings(**settings)
        self.settings.validate()
        self.device = resolve_device(device)
        self.backend = DeviceBackend(self.device)
        self.kv: Optional[KeyValue] = None
        self.kmv: Optional[KeyMultiValue] = None

    def _new_kv(self) -> KeyValue:
        return KeyValue()

    def _require_kv(self, op: str) -> KeyValue:
        if self.kv is None or not self.kv.complete_done:
            raise MRError(f"Cannot {op} without completed KeyValue")
        return self.kv

    def _require_kmv(self, op: str) -> KeyMultiValue:
        if self.kmv is None:
            raise MRError(f"Cannot {op} without KeyMultiValue")
        return self.kmv

    def map(self, nmap: int, func: Callable, ptr=None) -> int:
        """Task map: ``func(itask, kv, ptr)`` for each of ``nmap`` tasks;
        returns the pair count."""
        if self.kmv is not None:
            self.kmv.free()
            self.kmv = None
        if self.kv is not None:
            self.kv.free()
        self.kv = self._new_kv()
        for itask in range(nmap):
            func(itask, self.kv, ptr)
        return self.kv.complete()

    def aggregate(self) -> int:
        """The shuffle; on one device, the nprocs == 1 early-out."""
        kv = self._require_kv("aggregate")
        self.backend.aggregate(self)
        return kv.nkv

    def convert(self) -> int:
        """KV → KMV grouping (sort + segment on the device)."""
        from ..parallel.group import convert_sharded
        kv = self._require_kv("convert")
        self.kmv = KeyMultiValue()
        self.kmv.push(convert_sharded(self.backend.place(kv.one_frame())))
        kv.free()
        self.kv = None
        return self.kmv.complete()

    def reduce(self, func: Callable, ptr=None, batch: bool = False) -> int:
        """Callback per KMV group (or per frame with ``batch=True``) →
        a new KV."""
        kmv = self._require_kmv("reduce")
        kv = self._new_kv()
        for fr in kmv.frames():
            if batch:
                func(fr, kv, ptr)
            else:
                for k, vals in fr.groups():
                    func(k, vals, kv, ptr)
        kmv.free()
        self.kmv = None
        self.kv = kv
        return kv.complete()

    def scan_kv(self, func: Callable, ptr=None, batch: bool = False) -> int:
        """Read-only iteration over KV pairs: ``func(key, value, ptr)``, or
        ``func(frame, ptr)`` with ``batch=True``."""
        kv = self._require_kv("scan")
        for fr in kv.frames():
            if batch:
                func(fr, ptr)
            else:
                for k, v in fr.pairs():
                    func(k, v, ptr)
        return kv.nkv
