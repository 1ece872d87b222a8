"""The MapReduce object: the subset of ops the ported paths call.

The counterpart of ``gpu_mapreduce_tpu/core/mapreduce.py``: ``map``
(with ``addflag``), ``map_files``, ``map_mr``, ``aggregate``,
``convert``, ``collate``, ``reduce`` (per-group host form and
``batch=True``), ``gather``, ``add``, ``sort_keys``/``sort_values`` (int
flags), ``scan_kv``, ``kv_stats`` and the ``kv``/``kmv`` datasets, with
the reference's callback arities: ``map`` calls ``func(itask, kv, ptr)``,
``map_files`` ``func(itask, filename, kv, ptr)``, ``map_mr``
``func(itask, key, value, kv, ptr)`` per pair or ``func(frame, kv,
ptr)`` per frame with ``batch=True``, ``reduce`` ``func(key, values, kv,
ptr)`` per group or ``func(frame, kv, ptr)`` per frame with
``batch=True``.

Datasets live on one device (``device=None`` → the card, ``MRError``
when there is none; ``device="cpu"`` runs the plain path).  Map tasks run
in task order under every ``mapstyle``.

Fusion (``plan/``): under ``fuse=1`` (``MRTPU_FUSE``) or inside ``with
mr.pipeline():`` aggregate, convert, int-flag sorts and registered-kernel
reduces are recorded instead of run and return a lazy ``PendingCount``;
every other op, and any read of ``mr.kv``/``mr.kmv``, is a barrier that
runs the recorded chain first.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Sequence, Union

from ..parallel.backend import DeviceBackend
from ..utils.io import findfiles
from .dataset import KeyMultiValue, KeyValue
from .runtime import MRError, Settings, resolve_device


def _fusible(fn):
    """Defer this op into the plan recorder when one is active (an
    explicit ``mr.pipeline()`` block or the ``fuse=1`` setting).  The
    fuser replays a non-fused stage through the undeferred method;
    ``_plan_replaying`` guards that re-entry."""
    op = fn.__name__

    @functools.wraps(fn)
    def wrapper(self, *args, **kw):
        if not self._plan_replaying:
            if not _defer_ok(op, args, kw):
                # a user callback may have side effects the caller reads
                # right after the call: a barrier, never a stage
                self._flush_plan()
                return fn(self, *args, **kw)
            rec = self._plan
            if rec is None and self.settings.fuse:
                from ..plan.recorder import PlanRecorder
                rec = self._plan = PlanRecorder(self, auto=True)
            if rec is not None:
                return rec.record(op, args, kw)
        return fn(self, *args, **kw)
    return wrapper


def _defer_ok(op: str, args: tuple, kw: dict) -> bool:
    """Only ops that could fuse are deferred: aggregate, convert, int-flag
    sorts and registered-kernel reduces without a ``ptr``."""
    if op in ("sort_keys", "sort_values"):
        arg = args[0] if args else kw.get("flag", 1)
        return not callable(arg)
    if op != "reduce":
        return True          # aggregate / convert
    if kw.get("ptr") is not None or (len(args) > 1 and args[1] is not None):
        return False
    fn = args[0] if args else kw.get("func")
    from ..plan.fuser import _kernel_op
    return fn is not None and _kernel_op(fn) is not None


class MapReduce:
    """One MapReduce object owns at most one KV and/or one KMV."""

    def __init__(self, device=None, **settings):
        self.settings = Settings(**settings)
        self.settings.validate()
        self.device = resolve_device(device)
        self.backend = DeviceBackend(self.device)
        self._kv_data: Optional[KeyValue] = None
        self._kmv_data: Optional[KeyMultiValue] = None
        self._plan = None              # active plan recorder (plan/)
        self._plan_replaying = False   # the fuser is replaying a stage

    # reading or writing a dataset is a plan barrier: pending deferred
    # ops run first, so a reader never sees stale state under fuse=1
    @property
    def kv(self) -> Optional[KeyValue]:
        self._flush_pending()
        return self._kv_data

    @kv.setter
    def kv(self, value: Optional[KeyValue]) -> None:
        self._flush_pending()
        self._kv_data = value

    @property
    def kmv(self) -> Optional[KeyMultiValue]:
        self._flush_pending()
        return self._kmv_data

    @kmv.setter
    def kmv(self, value: Optional[KeyMultiValue]) -> None:
        self._flush_pending()
        self._kmv_data = value

    def _flush_pending(self) -> None:
        rec = self._plan
        if rec is not None and rec.stages:
            self._flush_plan()

    def pipeline(self):
        """Record the ops issued inside the block and run them fused at
        its exit (or at any barrier inside it)::

            with mr.pipeline():
                mr.aggregate(); mr.convert(); mr.reduce(count, batch=True)
        """
        @contextlib.contextmanager
        def _ctx():
            from ..plan.recorder import PlanRecorder
            prev = self._plan
            rec = self._plan = PlanRecorder(self)
            if prev is not None:
                # adopt an auto recorder's pending stages so they run in
                # issue order, and may fuse with ours
                rec.stages, prev.stages = prev.stages, []
                if prev.auto:
                    prev = None
            try:
                yield rec
            except BaseException:
                # abort: the unflushed tail is discarded, not run
                rec.stages.clear()
                raise
            finally:
                if self._plan is rec:
                    self._plan = prev
                rec.flush()
        return _ctx()

    def _flush_plan(self) -> None:
        """Run any pending recorded plan (the barrier hook).  An auto
        recorder (fuse=1) uninstalls; an explicit ``pipeline()`` recorder
        stays and keeps recording."""
        rec = self._plan
        if rec is None:
            return
        if rec.auto:
            self._plan = None
        rec.flush()

    def discard_plan(self) -> None:
        """Drop the pending recorded stages without running them; their
        PendingCounts raise if ever read."""
        rec = self._plan
        if rec is not None:
            self._plan = None
            rec.stages.clear()

    def _new_kv(self) -> KeyValue:
        return KeyValue()

    def _require_kv(self, op: str) -> KeyValue:
        kv = self.kv
        if kv is None or not kv.complete_done:
            raise MRError(f"Cannot {op} without completed KeyValue")
        return kv

    def _require_kmv(self, op: str) -> KeyMultiValue:
        kmv = self.kmv
        if kmv is None:
            raise MRError(f"Cannot {op} without KeyMultiValue")
        return kmv

    def _start_map(self, addflag: int = 0) -> KeyValue:
        """The KV a map writes: a new one, or with ``addflag`` the
        existing one reopened so the new pairs append."""
        if self.kmv is not None:
            self.kmv.free()
            self.kmv = None
        if addflag and self.kv is not None:
            self.kv.append()
            return self.kv
        if self.kv is not None:
            self.kv.free()
        self.kv = self._new_kv()
        return self.kv

    def map(self, nmap: int, func: Callable, ptr=None,
            addflag: int = 0) -> int:
        """Task map: ``func(itask, kv, ptr)`` for each of ``nmap`` tasks;
        returns the pair count (with ``addflag``, of the whole KV the new
        pairs were appended to)."""
        kv = self._start_map(addflag)
        for itask in range(nmap):
            func(itask, kv, ptr)
        return kv.complete()

    def map_mr(self, mr: "MapReduce", func: Callable, ptr=None,
               addflag: int = 0, batch: bool = False) -> int:
        """Map over an MR's KV pairs, ``mr`` may be this one (its frames
        are taken before the map starts): ``func(itask, key, value, kv,
        ptr)`` per pair, or ``func(frame, kv, ptr)`` per frame with
        ``batch=True`` (a device frame stays on its device)."""
        src_frames = list(mr._require_kv("map over").frames())
        kv = self._start_map(addflag)
        itask = 0
        for fr in src_frames:
            if batch:
                func(fr, kv, ptr)
                continue
            for k, v in fr.pairs():
                func(itask, k, v, kv, ptr)
                itask += 1
        return kv.complete()

    def map_files(self, files: Union[str, Sequence[str]], func: Callable,
                  ptr=None) -> int:
        """File map: ``func(itask, filename, kv, ptr)`` per file, files in
        order (globs and directories expanded by ``findfiles``)."""
        if isinstance(files, str):
            files = [files]
        names = findfiles(list(files))
        kv = self._start_map()
        for itask, name in enumerate(names):
            func(itask, name, kv, ptr)
        return kv.complete()

    @_fusible
    def aggregate(self, hash_fn: Optional[Callable] = None) -> int:
        """The shuffle; on one device, the nprocs == 1 early-out (no
        exchange, so ``hash_fn`` is not called)."""
        kv = self._require_kv("aggregate")
        self.backend.aggregate(self)
        return kv.nkv

    def gather(self, nprocs: int) -> int:
        """Funnel the KV onto the first ``nprocs`` procs: a no-op on one
        device, and a plan barrier."""
        kv = self._require_kv("gather")
        if nprocs <= 0:
            raise MRError("Cannot gather to fewer than 1 processor")
        return kv.nkv

    @_fusible
    def convert(self) -> int:
        """KV → KMV grouping (sort + segment on the device)."""
        from ..parallel.group import convert_sharded
        kv = self._require_kv("convert")
        kmv = KeyMultiValue()
        kmv.push(convert_sharded(self.backend.place(kv.one_frame())))
        kv.free()
        self.kv = None
        self.kmv = kmv
        return kmv.complete()

    def collate(self, hash_fn: Optional[Callable] = None) -> int:
        """aggregate + convert; returns the group count."""
        self.aggregate(hash_fn)
        return self.convert()

    @_fusible
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

    @_fusible
    def sort_keys(self, flag: int = 1) -> int:
        """Sort the KV by key: ascending for ``flag > 0``, descending for
        ``flag < 0`` (|flag| picks the reference's comparator family,
        moot for typed columns)."""
        return self._sort_kv("key", flag)

    @_fusible
    def sort_values(self, flag: int = 1) -> int:
        """Sort the KV by value (see :meth:`sort_keys`)."""
        return self._sort_kv("value", flag)

    def _sort_kv(self, by: str, flag: int) -> int:
        from ..parallel.group import sort_sharded
        if callable(flag):
            raise MRError("comparator sorts are not ported yet; pass an "
                          "int flag")
        kv = self._require_kv(f"sort_{by}s")
        out = sort_sharded(self.backend.place(kv.one_frame()), by,
                           descending=flag < 0)
        kv.free()
        kv.add_frame(out)
        return kv.complete()

    def add(self, mr: "MapReduce") -> int:
        """Append ``mr``'s KV pairs to this KV (frames are shared, not
        copied: no op changes a frame in place)."""
        src = list(mr._require_kv("add from").frames())
        kv = self.kv
        if kv is None:
            kv = self.kv = self._new_kv()
        else:
            kv.append()
        for fr in src:
            kv.add_frame(fr)
        return kv.complete()

    def kv_stats(self, level: int = 0) -> tuple:
        """(pairs, bytes) of the KV, (0, 0) without one; ``level >= 1``
        also prints them."""
        kv = self.kv
        if kv is None:
            return (0, 0)
        n, nb = kv.nkv, kv.nbytes()
        if level:
            print(f"{n} pairs, {nb / (1 << 20):.3g} Mb of KV data")
        return (n, nb)

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
