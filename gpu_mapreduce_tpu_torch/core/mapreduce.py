"""The MapReduce object: the op algebra of the reference
(``src/mapreduce.h:59-131``) on one torch device or a mesh of them.

The counterpart of ``gpu_mapreduce_tpu/core/mapreduce.py``: ``map``
(with ``addflag``), ``map_files``, ``map_file_char``, ``map_file_str``,
``map_mr``, ``aggregate``, ``broadcast``, ``gather``, ``scrunch``,
``convert``, ``collate``, ``clone``, ``collapse``, ``reduce`` (per-group
host form, ``batch=True``, and ``block_rows`` for large groups),
``compress``, ``add``, ``copy``, ``open``/``close``, ``set``,
``sort_keys``/``sort_values`` (int flags, or a comparator ``cmp(a, b)`` on
the host), ``sort_multivalues``, ``print``, ``scan_kv``, ``scan_kmv``,
``kv_stats``, ``kmv_stats``, ``save``/``load``, ``reshard``, ``stats`` and
``cummulative_stats``, with the reference's callback arities: ``map``
calls ``func(itask, kv, ptr)``, ``map_files`` ``func(itask, filename, kv,
ptr)``, the chunk maps ``func(itask, chunk_bytes, kv, ptr)``, ``map_mr``
``func(itask, key, value, kv, ptr)`` per pair or ``func(frame, kv, ptr)``
per frame with ``batch=True``, ``reduce`` ``func(key, values, kv, ptr)``
per group or ``func(frame, kv, ptr)`` per frame with ``batch=True``.

Datasets live on one device (``device=None`` → the card, ``MRError``
when there is none; ``device="cpu"`` runs the plain path), or with
``comm=mesh`` (``parallel/mesh.make_mesh``) over a mesh of P shards
driven by this process: ``map_files`` and the chunk maps ingest per
shard (``parallel/ingest.py``), ``aggregate``/``gather``/``broadcast``
run the exchange (``parallel/shuffle.py``, ``parallel/collectives.py``),
and convert, reduce, clone and the sorts run shard by shard; every
other op and setting runs there as on one device (``map_mr`` walks a
mesh frame's pairs in shard order, ``collapse`` builds one host group
from every shard's rows, ``save`` writes the shards' rows with their
counts and digests).  Map tasks run
in task order under mapstyle 0 and 1; mapstyle 2 runs them on a thread
pool and replays each task's adds in task order, so the KV is the same.
Keys and values may be numbers, bytes/str or arbitrary Python objects:
text columns intern to u64 ids when they move to the device
(``core/column.py``), and sorts of an interned column order by the rows'
bytes, never by their ids.

The host tier (``core/dataset.py``): host pages of at most ``memsize``
MB; under ``outofcore=1`` pages past ``maxpage`` spill to ``fpath``, a
multi-page host KV converts and sorts through the external merge
(``core/external.py``), and a device KV larger than ``maxpage ×
memsize`` MB first streams to host pages (``_demote_mesh_kv``; on a
mesh the budget is per shard, and the shard blocks stream in shard
order).

Fusion (``plan/``): under ``fuse=1`` (``MRTPU_FUSE``) or inside ``with
mr.pipeline():`` aggregate, convert, int-flag sorts and registered-kernel
reduces are recorded instead of run and return a lazy ``PendingCount``;
every other op, and any read of ``mr.kv``/``mr.kmv``, is a barrier that
runs the recorded chain first.  The fuser never fuses across a spill
boundary.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
from typing import Callable, Optional, Sequence, Union

import numpy as np

from ..parallel.backend import DeviceBackend, MeshBackend
from ..utils.io import file_chunks, findfiles
from .column import BytesColumn, DenseColumn, concat
from .dataset import KeyMultiValue, KeyValue
from .frame import BlockedMultivalue, KMVFrame, KVFrame
from .runtime import (MRError, Settings, Timer, global_counters,
                      resolve_device, write_histo)


class _TaskSink:
    """Per-task KV stand-in for mapstyle-2 worker threads: records the
    callback's adds, replayed into the real KeyValue in task order once
    the task is done (a KeyValue's append buffers are not thread-safe,
    and the replay keeps the output order that of mapstyle 0)."""

    __slots__ = ("_calls", "device")

    def __init__(self, device=None):
        self._calls: list = []
        self.device = device

    def add(self, key, value):
        self._calls.append(("add", (key, value), {}))

    def add_batch(self, keys, values, **kw):
        self._calls.append(("add_batch", (keys, values), kw))

    def add_frame(self, frame):
        self._calls.append(("add_frame", (frame,), {}))

    def add_kv(self, other):
        self._calls.append(("add_kv", (other,), {}))

    def replay(self, kv: KeyValue):
        for name, args, kw in self._calls:
            getattr(kv, name)(*args, **kw)
        self._calls.clear()


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
    sorts and registered-kernel reduces without a ``ptr`` or
    ``block_rows``."""
    if op in ("sort_keys", "sort_values"):
        arg = args[0] if args else kw.get("flag", 1)
        return not callable(arg)
    if op != "reduce":
        return True          # aggregate / convert
    if kw.get("ptr") is not None or (len(args) > 1 and args[1] is not None):
        return False
    if kw.get("block_rows") is not None or \
            (len(args) > 3 and args[3] is not None):
        return False
    fn = args[0] if args else kw.get("func")
    from ..plan.fuser import _kernel_op
    return fn is not None and _kernel_op(fn) is not None


class MapReduce:
    """One MapReduce object owns at most one KV and/or one KMV."""

    def __init__(self, device=None, comm=None, **settings):
        self.settings = Settings(**settings)
        self.settings.validate()
        # ft/: apply MRTPU_FAULTS / MRTPU_RETRY / MRTPU_JOURNAL when they
        # changed (a getenv and a compare each when they did not)
        from ..ft import configure_from_env
        configure_from_env()
        from ..parallel.mesh import Mesh
        if isinstance(comm, Mesh):
            # one shard is the one-device backend on that shard's device
            self.device = comm.devices[0]
            self.backend = DeviceBackend(self.device) if comm.size == 1 \
                else MeshBackend(comm)
        elif comm is None or comm == 1:
            self.device = resolve_device(device)
            self.backend = DeviceBackend(self.device)
        else:
            raise MRError(f"comm must be None, 1 or a Mesh, not {comm!r}")
        self.comm = comm
        self.last_exchange = None        # the last exchange's telemetry
        self.last_reshard = None         # the last reshard's from/to/n/s
        self.last_ingest: dict = {"mode": None}
        self.counters = global_counters()
        self._kv_data: Optional[KeyValue] = None
        self._kmv_data: Optional[KeyMultiValue] = None
        self._plan = None              # active plan recorder (plan/)
        self._plan_replaying = False   # the fuser is replaying a stage
        self._open = False             # between open() and close()
        self._op_snap = None           # counters at the op's start
        self._pool = None              # the mapstyle-2 thread pool

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

    @property
    def nprocs(self) -> int:
        """The shard count P (1 on one device)."""
        return self.backend.nprocs

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

    # ------------------------------------------------------------------
    # internal helpers
    # ------------------------------------------------------------------
    def _new_kv(self, name: str = "kv") -> KeyValue:
        return KeyValue(self.settings, self.counters, name, self.device)

    def _new_kmv(self) -> KeyMultiValue:
        return KeyMultiValue(self.settings, self.counters)

    def _finish_kv(self, op: str) -> int:
        """Complete the KV an op wrote and return its pair count; while
        the MR is open, its KV stays open for other MRs' adds and the
        count is of the pairs so far."""
        if self._open:
            return self.kv.nkv
        n = self.kv.complete()
        self._op_stats(op, nkv=n)
        return n

    def _begin_op(self) -> Timer:
        """An op's start: its timer, and the I/O counters for the
        ``verbosity`` 2 deltas."""
        c = self.counters
        self._op_snap = (c.wsize, c.rsize, c.cssize)
        return Timer()

    def _op_stats(self, op: str, **kw) -> None:
        """``verbosity`` ≥ 1: the KV totals after the op; ≥ 2: the
        spill and shuffle bytes it moved (reference file_stats,
        src/mapreduce.cpp:3112-3226).  An armed journal (ft/) gets the
        op's record."""
        from ..ft.journal import note_op
        note_op(self, op, kw.get("nkv", kw.get("nkmv")))
        if self.settings.verbosity:
            self.kv_stats(self.settings.verbosity, _op=op)
            if self.settings.verbosity >= 2 and self._op_snap is not None:
                c = self.counters
                w0, r0, s0 = self._op_snap
                dw, dr, ds = c.wsize - w0, c.rsize - r0, c.cssize - s0
                if dw or dr or ds:
                    print(f"  {op} I/O: {dw / (1 << 20):.3g} Mb spilled, "
                          f"{dr / (1 << 20):.3g} Mb re-read, "
                          f"{ds / (1 << 20):.3g} Mb shuffled")
        self._op_snap = None

    def _time(self, op: str, t: Timer, comm: bool = False) -> None:
        """``timer`` ≥ 1: the op's seconds; ≥ 2: the per-shard row
        histogram (reference src/mapreduce.cpp:3112-3128)."""
        dt = t.elapsed()
        if comm:
            self.counters.add(commtime=dt)
        if self.settings.timer:
            print(f"{op} time (secs) = {dt:.6g}")
            if self.settings.timer >= 2:
                which = "kv" if self.kv is not None else "kmv"
                write_histo(f"{op} rows", self._shard_counts(which))

    def _shard_counts(self, which: str = "kv") -> list:
        """Rows per frame (the one device's 'procs'): a device frame its
        valid count, a host or spilled page its rows."""
        ds = self.kv if which == "kv" else self.kmv
        if ds is None:
            return []
        out = []
        for f in ds._frames:
            counts = getattr(f, "gcounts" if which == "kmv" else "counts",
                             None)
            if counts is not None:
                out.extend(int(x) for x in counts)
            else:
                out.append(f.n if hasattr(f, "n") else len(f))
        return out

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

    # ------------------------------------------------------------------
    # map family (reference src/mapreduce.cpp:1044-1642)
    # ------------------------------------------------------------------
    def _task_pool(self):
        """The MR's thread pool for mapstyle 2 (min(cpus, 16) workers),
        made on first use and shut down when the MR is collected."""
        if self._pool is None:
            import os
            import weakref
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=max(1, min(os.cpu_count() or 4, 16)),
                thread_name_prefix="mrtpu-ingest")
            weakref.finalize(self, self._pool.shutdown, False)
        return self._pool

    def _run_tasks(self, kv: KeyValue, tasks, call: Callable) -> int:
        """``call(itask, payload, sink)`` over the task payloads under the
        mapstyle (reference map_tasks scheduling,
        src/mapreduce.cpp:1136-1213); returns the task count.  0 and 1
        run every task here in order.  2 hands tasks to a thread pool
        that pulls the next when free; each task writes a private sink,
        replayed into ``kv`` in task order, and at most 4 × workers tasks
        are in flight, so payloads and buffered output stay bounded.

        Every task runs under the ft/ ingest policy
        (``ft.retry.ingest_task``): its fault points, retries into a fresh
        sink an attempt (published only on success, so a retried task
        keeps its place and adds nothing twice), ``MRError`` naming a
        file task's file, and quarantine under ``onfault="skip"``."""
        from ..ft.retry import ingest_active, ingest_task
        onfault = self.settings.onfault
        active = ingest_active(onfault)
        if self.settings.mapstyle != 2:
            n = 0
            for itask, payload in enumerate(tasks):
                ingest_task(call, itask, payload, kv, onfault=onfault,
                            private_sink=False, active=active)
                n += 1
            return n
        from collections import deque
        pool = self._task_pool()
        window = 4 * pool._max_workers
        inflight: deque = deque()      # (future, sink) in task order
        n = 0

        def drain_one():
            fut, sink = inflight.popleft()
            fut.result()               # a callback's exception surfaces
            sink.replay(kv)

        try:
            for itask, payload in enumerate(tasks):
                if len(inflight) >= window:
                    drain_one()
                sink = _TaskSink(kv.device)
                inflight.append((pool.submit(ingest_task, call, itask,
                                             payload, sink, onfault=onfault,
                                             active=active), sink))
                n += 1
            while inflight:
                drain_one()
        except BaseException:
            for fut, _ in inflight:
                fut.cancel()
            raise
        return n

    def map(self, nmap: int, func: Callable, ptr=None,
            addflag: int = 0) -> int:
        """Task map: ``func(itask, kv, ptr)`` for each of ``nmap`` tasks;
        returns the pair count (with ``addflag``, of the whole KV the new
        pairs were appended to)."""
        t = self._begin_op()
        kv = self._start_map(addflag)
        self._run_tasks(kv, range(nmap),
                        lambda itask, _task, sink: func(itask, sink, ptr))
        n = self._finish_kv("map")
        self._time("map", t)
        return n

    def map_mr(self, mr: "MapReduce", func: Callable, ptr=None,
               addflag: int = 0, batch: bool = False) -> int:
        """Map over an MR's KV pairs, ``mr`` may be this one (its frames
        are taken before the map starts): ``func(itask, key, value, kv,
        ptr)`` per pair (a mesh frame's in shard order), or ``func(frame,
        kv, ptr)`` per frame with ``batch=True`` (a device or mesh frame
        stays where it is; no op changes a frame in place, so a callback
        may add the frame itself)."""
        t = self._begin_op()
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
        n = self._finish_kv("map_mr")
        self._time("map_mr", t)
        return n

    def map_files(self, files: Union[str, Sequence[str]], func: Callable,
                  ptr=None, addflag: int = 0) -> int:
        """File map: ``func(itask, filename, kv, ptr)`` per file, files in
        order (globs and directories expanded by ``findfiles``); with
        ``addflag`` the pairs append to the existing KV."""
        t = self._begin_op()
        if isinstance(files, str):
            files = [files]
        names = self._find_inputs(files, 0, 0)
        kv = self._start_map(addflag)
        call = lambda itask, fname, sink: func(itask, fname, sink, ptr)
        if self._mesh_ingest_ok(addflag):
            from ..parallel.ingest import mesh_map_files
            self.last_ingest = mesh_map_files(self, kv, names, call)
        else:
            self._run_tasks(kv, names, call)
            self.last_ingest = {"mode": "host"}
        n = self._finish_kv("map_files")
        self._time("map_files", t)
        return n

    def _find_inputs(self, files, recurse, readflag) -> list:
        """``findfiles`` under the ft/ discovery policy: a failing path
        is an ``MRError`` naming it, or under ``onfault="skip"`` a
        quarantined and dropped path, as at task time."""
        from ..ft.retry import input_unreadable, quarantine_or_raise
        if self.settings.onfault != "skip":
            try:
                return findfiles(list(files), bool(recurse), bool(readflag))
            except OSError as e:
                raise input_unreadable(e) from e
        names: list = []
        for p in files:
            try:
                names.extend(findfiles([p], bool(recurse), bool(readflag)))
            except OSError as e:
                quarantine_or_raise(e, p, "skip")
        return names

    def _mesh_ingest_ok(self, addflag: int) -> bool:
        """Per-shard file ingest: a mesh of P > 1, a fresh KV (with
        ``addflag`` the pairs append to the existing dataset) and in
        core (out of core the host pages and their budget hold the
        pairs)."""
        return (self.backend.nprocs > 1 and not addflag
                and self.settings.outofcore != 1)

    def map_file_char(self, nmap: int, files, recurse: int, readflag: int,
                      sepchar: Union[str, bytes], delta: int,
                      func: Callable, ptr=None, addflag: int = 0) -> int:
        """Chunk map with a one-byte separator (reference
        src/mapreduce.cpp:1232-1301): each file splits into about
        ``nmap / nfiles`` chunks ending on ``sepchar``, and
        ``func(itask, chunk_bytes, kv, ptr)`` runs per chunk."""
        return self._map_chunks(nmap, files, recurse, readflag,
                                _to_bytes(sepchar), delta, func, ptr,
                                addflag)

    def map_file_str(self, nmap: int, files, recurse: int, readflag: int,
                     sepstr: Union[str, bytes], delta: int,
                     func: Callable, ptr=None, addflag: int = 0) -> int:
        """Chunk map with a separator string (the reference's sepstr
        variant)."""
        return self._map_chunks(nmap, files, recurse, readflag,
                                _to_bytes(sepstr), delta, func, ptr,
                                addflag)

    def _map_chunks(self, nmap, files, recurse, readflag, sep, delta,
                    func, ptr, addflag) -> int:
        from ..exec import prefetch_iter
        t = self._begin_op()
        if isinstance(files, str):
            files = [files]
        names = self._find_inputs(files, recurse, readflag)
        if not names:
            raise MRError("No files found for chunked map")
        per_file = max(1, nmap // max(1, len(names)))
        kv = self._start_map(addflag)
        call = lambda itask, chunk, sink: func(itask, chunk, sink, ptr)
        if self._mesh_ingest_ok(addflag):
            from ..parallel.ingest import mesh_map_chunks
            self.last_ingest = mesh_map_chunks(self, kv, names, per_file,
                                               sep, delta, call)
            n = self._finish_kv("map_chunks")
            self._time("map_chunks", t)
            return n

        from ..ft.retry import ingest_active, ingest_read, input_unreadable
        onfault = self.settings.onfault

        def chunk_stream():
            # each file reads under the ft/ ingest.read policy; disarmed,
            # its chunks stay lazy (a retry needs the file's chunks whole)
            for fname in names:
                if not ingest_active(onfault):
                    try:
                        yield from file_chunks(fname, per_file, sep, delta)
                    except OSError as e:
                        raise input_unreadable(e, fname) from e
                    continue
                chunks = ingest_read(
                    lambda f=fname: list(file_chunks(f, per_file, sep,
                                                     delta)),
                    file=fname, onfault=onfault)
                if chunks is not None:
                    yield from chunks

        # the next chunk is read while this one's callback runs
        self._run_tasks(kv, prefetch_iter(chunk_stream(),
                                          path="ingest.serial"), call)
        self.last_ingest = {"mode": "host"}
        n = self._finish_kv("map_chunks")
        self._time("map_chunks", t)
        return n

    # ------------------------------------------------------------------
    # distribution ops (one device: local)
    # ------------------------------------------------------------------
    @_fusible
    def aggregate(self, hash_fn: Optional[Callable] = None) -> int:
        """The shuffle: each key to one shard, by ``hash_fn(keys) % P``
        (a device hash over the key tensor; with a ``host_hash``
        attribute, a host hash over each key's bytes) or lookup3 of the
        key bytes (reference src/mapreduce.cpp:385-563).  On one device,
        the nprocs == 1 early-out (no exchange, so ``hash_fn`` is not
        called)."""
        t = self._begin_op()
        kv = self._require_kv("aggregate")
        self.backend.aggregate(self, hash_fn)
        self._op_stats("aggregate", nkv=kv.nkv)
        self._time("aggregate", t, comm=True)
        return kv.nkv

    def broadcast(self, root: int = 0) -> int:
        """Replicate root's KV on every proc (reference
        src/mapreduce.cpp:569-623): a barrier on one device; on a mesh
        every shard then holds root's rows, and the count is over all
        the replicas."""
        kv = self._require_kv("broadcast")
        self.backend.broadcast(self, root)
        return kv.nkv

    def gather(self, nprocs: int) -> int:
        """Funnel the KV onto the first ``nprocs`` procs: a no-op on one
        device, and a plan barrier."""
        kv = self._require_kv("gather")
        if nprocs <= 0:
            raise MRError("Cannot gather to fewer than 1 processor")
        self.backend.gather(self, nprocs)
        return kv.nkv

    def scrunch(self, nprocs: int, key) -> int:
        """gather + collapse (reference src/mapreduce.cpp:2075-2095); on a
        mesh the collapse takes the gathered rows in shard order."""
        self.gather(nprocs)
        return self.collapse(key)

    # ------------------------------------------------------------------
    # the page budget (out-of-core)
    # ------------------------------------------------------------------
    def _use_external(self, kv: KeyValue) -> bool:
        """An out-of-core multi-page host dataset streams through the
        external sort and merge instead of consolidating in core."""
        return (self.settings.outofcore == 1 and kv.nframes > 1
                and kv.is_host_dataset())

    def _hbm_budget_bytes(self) -> Optional[int]:
        """The device budget: ``maxpage × memsize`` MB under
        ``outofcore=1`` (the reference runs every op in a few fixed
        pages, doc/Interface_c++.txt:39-59); None = unlimited."""
        s = self.settings
        if s.outofcore != 1 or s.maxpage == 0:
            return None
        return s.memsize * (1 << 20) * s.maxpage

    def _mesh_over_budget(self, kv: KeyValue) -> bool:
        """Whether the device-resident bytes of kv exceed the budget: per
        shard, a frame's bytes over its shard count."""
        budget = self._hbm_budget_bytes()
        if budget is None or kv.is_host_dataset():
            return False
        from ..parallel.sharded import MeshKV, ShardedKV
        per_shard = sum(f.nbytes() // max(f.nprocs, 1) for f in kv._frames
                        if isinstance(f, (ShardedKV, MeshKV)))
        return per_shard > budget

    def _demote_mesh_kv(self) -> None:
        """Stream every device frame to host pages under the page budget
        (spilling past ``maxpage``), so convert and sort can take the
        external path: a mesh frame shard block by shard block, in shard
        order, one block on the host at a time.  The device frames are
        freed only after the last page is pushed."""
        from ..parallel.sharded import MeshKV, ShardedKV
        from .dataset import _split_to_budget
        kv = self.kv
        newkv = self._new_kv()
        for fr in kv.frames():
            if isinstance(fr, (ShardedKV, MeshKV)):
                host = (fr.shard_to_host(p) for p in range(fr.nprocs)
                        if int(fr.counts[p]))
            else:
                host = [fr]
            for h in host:
                for piece in _split_to_budget(h, self.settings):
                    newkv._push_frame(piece)
        kv.free()
        newkv.nkv = sum(newkv._frame_n(f) for f in newkv._frames)
        newkv.complete_done = True
        self.kv = newkv

    # ------------------------------------------------------------------
    # grouping ops
    # ------------------------------------------------------------------
    @_fusible
    def convert(self) -> int:
        """KV → KMV grouping: sort + segment on the device; a multi-page
        out-of-core dataset (or a device KV over the budget, demoted
        first) streams through sorted runs, a k-way merge and
        group-boundary cuts in about one page of memory (the Spool
        cascade's job, src/mapreduce.cpp:2359-2633)."""
        from ..parallel.group import convert_sharded
        t = self._begin_op()
        kv = self._require_kv("convert")
        kmv = self._new_kmv()
        if self._mesh_over_budget(kv):
            self._demote_mesh_kv()
            kv = self.kv
        if self._use_external(kv):
            from .external import external_sorted_chunks, group_stream
            chunks = external_sorted_chunks(kv.frames(), "key",
                                            self.settings, self.counters,
                                            self.device)
            for kmv_frame in group_stream(chunks):
                kmv.push(kmv_frame)
        else:
            kmv.push(convert_sharded(self.backend.place_kv(kv)))
        kv.free()
        self.kv = None
        self.kmv = kmv
        n = kmv.complete()
        self._op_stats("convert", nkmv=n)
        self._time("convert", t)
        return n

    def collate(self, hash_fn: Optional[Callable] = None) -> int:
        """aggregate + convert; returns the group count."""
        self.aggregate(hash_fn)
        return self.convert()

    def clone(self) -> int:
        """KV → KMV with every pair its own one-value group (reference
        src/mapreduce.cpp:631-652), on the device; a mesh dataset shard
        by shard."""
        from ..parallel.devkernels import clone_sharded
        kv = self._require_kv("clone")
        kmv = self._new_kmv()
        kmv.push(clone_sharded(self.backend.place_kv(kv)))
        kv.free()
        self.kv = None
        self.kmv = kmv
        return kmv.complete()

    def collapse(self, key) -> int:
        """KV → one KMV group ``key`` whose multivalue is
        ``[k1, v1, k2, v2, ...]`` (reference src/mapreduce.cpp:681-702).
        Keys and values must share a type (all bytes, or all numbers of
        one shape); spilled pages stream one at a time.  On a mesh the
        one group is a host group over every shard's rows, in shard
        order (as the JAX package builds it)."""
        kv = self._require_kv("collapse")
        parts = []
        for fr in kv.frames():
            fr = fr.to_host()
            if len(fr):
                parts.append(_interleave_frame(fr))
        values = concat(parts) if parts \
            else DenseColumn(np.zeros(0, np.int64))
        n = len(values)
        kmv = self._new_kmv()
        kmv.push(KMVFrame(_rows_to_column([key]), np.asarray([n]),
                          np.asarray([0, n]), values))
        kv.free()
        self.kv = None
        self.kmv = kmv
        return kmv.complete()

    # ------------------------------------------------------------------
    # reduce family
    # ------------------------------------------------------------------
    @_fusible
    def reduce(self, func: Callable, ptr=None, batch: bool = False,
               block_rows: Optional[int] = None) -> int:
        """Callback per KMV group (or per frame with ``batch=True``) →
        a new KV.  With ``block_rows``, a group of more values receives a
        :class:`~.frame.BlockedMultivalue` instead of a list (the
        reference's multi-page KMV, src/mapreduce.cpp:1874-1925; read it
        with ``iter_blocks``)."""
        self._begin_op()
        kmv = self._require_kmv("reduce")
        kv = self._new_kv()
        loud = self.settings.verbosity >= 2
        for fr in kmv.frames():
            if batch:
                if loud:        # a fall to the host tier is worth seeing
                    tier = "host per-row" if isinstance(fr, KMVFrame) \
                        else "device batch"
                    print(f"  reduce(batch): {tier} tier ({len(fr)} rows)")
                func(fr, kv, ptr)
            elif block_rows is not None:
                self._reduce_blocked(fr, func, kv, ptr, block_rows)
            else:
                if loud:
                    print(f"  reduce: host per-group tier ({len(fr)} "
                          f"groups)")
                for k, vals in fr.groups():
                    func(k, vals, kv, ptr)
        kmv.free()
        self.kmv = None
        self.kv = kv
        return self._finish_kv("reduce")

    @staticmethod
    def _reduce_blocked(fr, func, kv, ptr, block_rows: int) -> None:
        if not isinstance(fr, KMVFrame):
            fr = fr.to_host()
        for i, k in enumerate(fr.key.tolist()):
            if int(fr.nvalues[i]) > block_rows:
                func(k, BlockedMultivalue(fr, i, block_rows), kv, ptr)
            else:
                func(k, fr.group_values(i).tolist(), kv, ptr)

    def compress(self, func: Callable, ptr=None, batch: bool = False,
                 block_rows: Optional[int] = None) -> int:
        """Local convert + reduce, KV → KV: the combiner (reference
        src/mapreduce.cpp:749-851); ``block_rows`` as in :meth:`reduce`.
        Under fusion a kernel reduce runs with the convert as one local
        group."""
        self.convert()
        return self.reduce(func, ptr, batch=batch, block_rows=block_rows)

    # ------------------------------------------------------------------
    # sorting (reference src/mapreduce.cpp:2102-2352)
    # ------------------------------------------------------------------
    @_fusible
    def sort_keys(self, flag=1) -> int:
        """Sort the KV by key: ascending for ``flag > 0``, descending for
        ``flag < 0`` (|flag| picks the reference's comparator family,
        moot for typed columns), or by a comparator ``flag(a, b) →
        -1/0/1``."""
        return self._sort_kv("key", flag)

    @_fusible
    def sort_values(self, flag=1) -> int:
        """Sort the KV by value (see :meth:`sort_keys`)."""
        return self._sort_kv("value", flag)

    def _sort_kv(self, by: str, flag) -> int:
        """Dense columns sort on the device; an interned column sorts by
        its rows' byte order (``sort_interned_sharded``); a comparator
        sorts on the host.  Out of core, a multi-page host KV (or a
        device KV over the budget, demoted first) sorts through the
        external merge."""
        from ..parallel.group import sort_interned_sharded, sort_sharded
        t = self._begin_op()
        kv = self._require_kv(f"sort_{by}s")
        if self._mesh_over_budget(kv):
            self._demote_mesh_kv()
            kv = self.kv
        if not callable(flag) and self._use_external(kv):
            return self._sort_kv_external(kv, by, flag < 0, t)
        on_host = callable(flag)
        if not on_host and not kv.is_host_dataset():
            fr = kv.one_frame()
            budget = self._hbm_budget_bytes()
            if getattr(fr, f"{by}_decode") is not None and \
                    budget is not None and fr.nbytes() > budget:
                # past the budget an interned sort streams to host pages
                # first (JAX: the global device sort would gather it)
                self._demote_mesh_kv()
                kv = self.kv
                if self._use_external(kv):
                    return self._sort_kv_external(kv, by, flag < 0, t)
                on_host = True
        if on_host:
            fr = kv.one_frame().to_host()
            col = fr.key if by == "key" else fr.value
            from ..ops.sort import argsort_column
            order = argsort_column(col, cmp=flag) if callable(flag) \
                else argsort_column(col, descending=flag < 0)
            fr = fr.take(order)
            kv.free()
            kv.add_batch(fr.key, fr.value)
        else:
            host = kv.is_host_dataset()
            skv = self.backend.place_kv(kv)
            decode = skv.key_decode if by == "key" else skv.value_decode
            if decode is None:
                out = sort_sharded(skv, by, descending=flag < 0)
            else:
                # a host text column sorts as Python's sorted() does:
                # equal rows keep their order when descending
                out = sort_interned_sharded(skv, by, descending=flag < 0,
                                            stable_descending=host)
            kv.free()
            kv.add_frame(out)
        n = kv.complete()
        self._op_stats(f"sort_{by}s", nkv=n)
        self._time("sort", t)
        return n

    def _sort_kv_external(self, kv: KeyValue, by: str, descending: bool,
                          t: Timer) -> int:
        """Out-of-core sort: external runs + k-way merge into a fresh
        spilling dataset; descending flips each ascending chunk and
        reverses the page order."""
        from .external import external_sorted_chunks
        newkv = self._new_kv()
        for ch in external_sorted_chunks(kv.frames(), by, self.settings,
                                         self.counters, self.device):
            if descending:
                ch = ch.take(np.arange(len(ch) - 1, -1, -1))
            newkv._push_frame(ch)
        if descending:
            newkv._frames.reverse()
        newkv.nkv = sum(newkv._frame_n(f) for f in newkv._frames)
        newkv.complete_done = True
        kv.free()
        self.kv = newkv
        self._op_stats(f"sort_{by}s", nkv=newkv.nkv)
        self._time("sort", t)
        return newkv.nkv

    def sort_multivalues(self, flag=1) -> int:
        """Sort the values inside each group (reference
        src/mapreduce.cpp:2210-2352): dense values on the device; a
        comparator, or interned values (ids are hashes, not byte order),
        on the host."""
        from ..parallel.group import sort_multivalues_sharded
        t = self._begin_op()
        kmv = self._require_kmv("sort_multivalues")
        new = self._new_kmv()
        for fr in kmv.frames():
            if not isinstance(fr, KMVFrame):
                if callable(flag) or fr.value_decode is not None:
                    fr = fr.to_host()
                else:
                    new.push(sort_multivalues_sharded(fr,
                                                      descending=flag < 0))
                    continue
            new.push(KMVFrame(fr.key, fr.nvalues, fr.offsets,
                              _sort_groups(fr, flag)))
        kmv.free()
        self.kmv = new
        self._time("sort", t)
        return new.complete()

    # ------------------------------------------------------------------
    # read-only ops
    # ------------------------------------------------------------------
    def print(self, nstride: int = 1, kflag: int = -1, vflag: int = -1,
              file=None, fflag: int = 0) -> int:
        """Formatted dump of the KV pairs or KMV groups, one a line
        (reference src/mapreduce.cpp:1671-1761): every ``nstride``-th
        pair, to stdout or to ``file`` (appended with ``fflag``).  Columns
        know their types, so ``kflag``/``vflag`` only force float
        formatting (3, 4)."""
        self._flush_plan()
        if self.kv is None and self.kmv is None:
            raise MRError("Cannot print without KeyValue or KeyMultiValue")
        out = sys.stdout if file is None else \
            open(file, "a" if fflag else "w")
        try:
            if self.kv is not None:
                count = 0
                for fr in self.kv.frames():
                    for k, v in fr.pairs():
                        if count % nstride == 0:
                            out.write(f"{_fmt(k, kflag)} {_fmt(v, vflag)}\n")
                        count += 1
                return self.kv.nkv
            for fr in self.kmv.frames():
                for k, vals in fr.groups():
                    out.write(f"{_fmt(k, kflag)} "
                              + " ".join(_fmt(v, vflag) for v in vals)
                              + "\n")
            return self.kmv.nkmv
        finally:
            if file is not None:
                out.close()

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

    def scan_kmv(self, func: Callable, ptr=None, batch: bool = False,
                 block_rows: Optional[int] = None) -> int:
        """Read-only iteration over KMV groups: ``func(key, values, ptr)``
        per group, or ``func(frame, ptr)`` with ``batch=True``;
        ``block_rows`` as in :meth:`reduce`."""
        kmv = self._require_kmv("scan")
        for fr in kmv.frames():
            if batch:
                func(fr, ptr)
            elif block_rows is not None:
                self._reduce_blocked(
                    fr, lambda k, mv, _kv, p: func(k, mv, p), None, ptr,
                    block_rows)
            else:
                for k, vals in fr.groups():
                    func(k, vals, ptr)
        return kmv.nkmv

    # ------------------------------------------------------------------
    # whole-object ops
    # ------------------------------------------------------------------
    def add(self, mr: "MapReduce") -> int:
        """Append ``mr``'s KV pairs to this KV (frames are shared, not
        copied: no op changes a frame in place)."""
        self._flush_plan()
        src = mr._require_kv("add from")
        kv = self.kv
        if kv is None:
            kv = self.kv = self._new_kv()
        else:
            kv.append()
        kv.add_kv(src)
        return self._finish_kv("add")

    def copy(self) -> "MapReduce":
        """A new MR on the same device with a copy of the settings and the
        same KV and KMV frames (shared, not copied: no op changes a frame
        in place)."""
        self._flush_plan()
        mr = MapReduce(device=self.device, comm=self.comm,
                       **dataclasses.asdict(self.settings))
        if self.kv is not None:
            mr.kv = mr._new_kv()
            mr.kv.add_kv(self.kv)
            mr.kv.complete()
        if self.kmv is not None:
            mr.kmv = mr._new_kmv()
            for fr in self.kmv.frames():
                mr.kmv.push(fr)
            mr.kmv.complete()
        return mr

    def open(self, addflag: int = 0) -> KeyValue:
        """Begin cross-MR adds: until :meth:`close`, other MRs' callbacks
        add pairs to this KV (reference src/mapreduce.cpp:1648-1664); with
        ``addflag`` the existing pairs stay.  On a mesh the adds are host
        pages until the next aggregate routes them to the shards."""
        self._start_map(addflag)
        self._open = True
        return self.kv

    def close(self) -> int:
        """End cross-MR adds and return the KV's pair count (reference
        src/mapreduce.cpp:658-672)."""
        if not self._open:
            raise MRError("Cannot close without open")
        self._open = False
        return self._finish_kv("close")

    def set(self, **settings) -> "MapReduce":
        """Change settings (the script's ``mr`` builtin and ``set``
        method)."""
        fields = {f.name for f in dataclasses.fields(Settings)}
        for key in settings:
            if key not in fields:
                raise MRError(f"unknown setting {key!r}")
        candidate = dataclasses.replace(self.settings, **settings)
        candidate.validate()
        # turning fusion off is a barrier for a fuse=1 auto recorder
        if not candidate.fuse and self._plan is not None and self._plan.auto:
            self._flush_plan()
        self.settings = candidate
        return self

    # ------------------------------------------------------------------
    # checkpoint / restore (core/checkpoint.py)
    # ------------------------------------------------------------------
    def save(self, path: str) -> int:
        """Checkpoint the KV or KMV to directory ``path``; returns the
        number of frames written.  Mesh frames are written as their host
        rows with the writer's per-shard counts and digests.  The save
        runs under the ft/ ``checkpoint.save`` retry policy (the directory
        swap is atomic, so a retried save never mixes generations)."""
        self._flush_plan()
        from ..ft.retry import retry_call
        from .checkpoint import save as _save
        return retry_call("checkpoint.save", lambda: _save(self, path),
                          detail=path)

    def load(self, path: str) -> int:
        """Replace the dataset with a checkpoint written at any width;
        returns the pair or group count.  The frames load as host pages,
        which the next aggregate routes to this MR's shards."""
        self._flush_plan()
        from .checkpoint import load as _load
        return _load(self, path)

    # ------------------------------------------------------------------
    # topology (parallel/reshard.py)
    # ------------------------------------------------------------------
    def reshard(self, comm) -> int:
        """Move the resident dataset onto a new topology and swap the
        backend (JAX ``core/mapreduce.py:1304-1374``).  ``comm``: a
        :class:`~..parallel.mesh.Mesh` of any width — device frames move
        N → M through the range exchange, the global row and group order
        kept exactly (a one-device frame moves as a mesh of one) — or
        ``None``/an int for one device, where device frames compact to the
        host.  Host frames are left as they are: they go onto the shards
        at the next aggregate, like fresh data.  Returns the global pair
        or group count."""
        self._flush_plan()
        from ..parallel.mesh import Mesh
        from ..parallel.reshard import reshard_kmv, reshard_kv
        from ..parallel.sharded import MeshKMV, MeshKV, ShardedKMV, ShardedKV
        t = Timer()
        if comm is None or isinstance(comm, int):
            mesh = None
            backend = DeviceBackend(self.device)
        elif isinstance(comm, Mesh):
            mesh = comm
            self.device = comm.devices[0]
            backend = DeviceBackend(self.device) if comm.size == 1 \
                else MeshBackend(comm)
        else:
            raise MRError(f"reshard: comm must be None, an int or a Mesh, "
                          f"not {comm!r}")
        nfrom = self.backend.nprocs

        def move(fr):
            if not isinstance(fr, (MeshKV, MeshKMV, ShardedKV, ShardedKMV)):
                return fr
            if mesh is None:
                return fr.to_host()
            if isinstance(fr, (ShardedKV, ShardedKMV)):
                one = MeshKV if isinstance(fr, ShardedKV) else MeshKMV
                fr = one(Mesh((fr.device,)), [fr])
            if fr.mesh != mesh:
                fr = reshard_kv(fr, mesh, self.settings.all2all,
                                self.counters) \
                    if isinstance(fr, MeshKV) else \
                    reshard_kmv(fr, mesh, self.settings.all2all,
                                self.counters)
            return fr.shards[0] if mesh.size == 1 else fr

        n = 0
        for ds in (self._kv_data, self._kmv_data):
            if ds is None:
                continue
            out = []
            for fr in ds._frames:
                new = move(fr)
                if new is not fr:
                    self.counters.mem(new.nbytes() - fr.nbytes())
                out.append(new)
            ds._frames = out
        self.backend = backend
        self.comm = comm
        if self._kv_data is not None:
            self._kv_data.nkv = sum(self._kv_data._frame_n(f)
                                    for f in self._kv_data._frames)
            n = self._kv_data.nkv
        if self._kmv_data is not None:
            n = self._kmv_data.complete()
        self.counters.add(commtime=t.elapsed())
        self.last_reshard = {"from": nfrom, "to": self.backend.nprocs,
                             "wall_s": round(t.elapsed(), 6), "n": n}
        self._op_stats("reshard", nkv=n)
        return n

    # ------------------------------------------------------------------
    # stats (reference src/mapreduce.cpp:2937-3066)
    # ------------------------------------------------------------------
    def kv_stats(self, level: int = 0, _op: str = "") -> tuple:
        """(pairs, bytes) of the KV, (0, 0) without one; ``level >= 1``
        also prints them, ``level >= 2`` the per-shard histogram."""
        kv = self.kv
        if kv is None:
            return (0, 0)
        n, nb = kv.nkv, kv.nbytes()
        if level:
            print(f"{n} pairs, {nb / (1 << 20):.3g} Mb of KV data "
                  f"{('after ' + _op) if _op else ''}".rstrip())
            if level >= 2:
                write_histo("KV pairs", self._shard_counts("kv"))
        return (n, nb)

    def kmv_stats(self, level: int = 0) -> tuple:
        """(groups, values, bytes) of the KMV, (0, 0, 0) without one;
        ``level >= 1`` also prints them."""
        kmv = self.kmv
        if kmv is None:
            return (0, 0, 0)
        g, n, nb = kmv.nkmv, kmv.nvalues(), kmv.nbytes()
        if level:
            print(f"{g} pairs, {n} values, {nb / (1 << 20):.3g} Mb of KMV "
                  f"data")
            if level >= 2:
                write_histo("KMV groups", self._shard_counts("kmv"))
        return (g, n, nb)

    def stats(self) -> dict:
        """What ``cummulative_stats`` prints, as a dict: every counter by
        name, the plan cache's counts (``plan``), the overlap records of
        exec/ (``exec``) and the fault-tolerance section of ft/ (``ft``:
        retries per site, faults injected, quarantines, budgets, the
        journal's progress)."""
        self._flush_plan()
        from ..exec import exec_stats
        from ..ft import ft_stats
        from ..plan.cache import cache_stats
        out = self.counters.snapshot()
        out["plan"] = cache_stats()
        out["exec"] = exec_stats()
        out["ft"] = ft_stats()
        return out

    def cummulative_stats(self, level: int = 1, reset: int = 0):
        """Print the cumulative counters (reference
        src/mapreduce.cpp:3007-3066); ``reset`` zeroes them."""
        s = self.stats()
        if level:
            print(f"Cummulative hi-water mem = "
                  f"{s['msizemax'] / (1 << 20):.3g} Mb")
            print(f"Cummulative spill I/O = {s['rsize'] / (1 << 20):.3g} "
                  f"Mb read, {s['wsize'] / (1 << 20):.3g} Mb written")
            print(f"Cummulative comm = {s['cssize'] / (1 << 20):.3g} Mb "
                  f"sent, {s['crsize'] / (1 << 20):.3g} Mb received, "
                  f"{s['cspad'] / (1 << 20):.3g} Mb padding, "
                  f"{s['commtime']:.3g} secs")
        if reset:
            self.counters.reset()
        return self.counters


def _to_bytes(s) -> bytes:
    return s.encode() if isinstance(s, str) else bytes(s)


def _rows_to_column(rows: list):
    """A list of rows → a byte column (bytes/str) or a dense one."""
    first = rows[0] if rows else 0
    if isinstance(first, (bytes, str)):
        return BytesColumn(rows)
    from .dataset import rows_to_array
    return DenseColumn(rows_to_array(rows))


def _interleave_frame(fr: KVFrame):
    """One host frame's collapse rows ``[k1, v1, k2, v2, ...]``: byte
    rows as bytes, dense columns of one dtype and shape by a strided
    write; anything else row by row (so u64 and int64 never meet in a
    float64 promotion)."""
    k, v = fr.key, fr.value
    n = len(fr)
    if isinstance(k, BytesColumn) and isinstance(v, BytesColumn):
        out: list = [None] * (2 * n)
        out[0::2] = k.tolist()
        out[1::2] = v.tolist()
        return BytesColumn(out)
    if isinstance(k, DenseColumn) and isinstance(v, DenseColumn):
        ka, va = k.data, v.data
        if ka.shape[1:] == va.shape[1:] and ka.dtype == va.dtype:
            arr = np.empty((2 * n,) + ka.shape[1:], ka.dtype)
            arr[0::2] = ka
            arr[1::2] = va
            return DenseColumn(arr)
    rows: list = [None] * (2 * n)
    rows[0::2] = k.tolist()
    rows[1::2] = v.tolist()
    return _interleave_rows(rows)


def _interleave_rows(rows: list):
    """The collapse multivalue column of ``rows``, refusing mixed
    types."""
    if not rows:
        return DenseColumn(np.zeros(0, np.int64))
    if all(isinstance(r, (bytes, str)) for r in rows):
        return BytesColumn(rows)
    if any(isinstance(r, (bytes, str)) for r in rows):
        raise MRError("collapse requires keys and values of a common type "
                      "(all bytes or all numeric)")
    from .dataset import rows_to_array
    arr = rows_to_array(rows)
    if arr.dtype == object:
        raise MRError("collapse requires keys and values of a common shape")
    return DenseColumn(arr)


def _sort_groups(fr, flag):
    """The values of a host KMVFrame sorted inside every group.  Dense
    scalar values sort in one stable lexsort over (group, value); a
    comparator and text or [n, w] values sort group by group."""
    from ..ops.sort import argsort_column
    if not callable(flag) and isinstance(fr.values, DenseColumn) \
            and fr.values.data.ndim == 1:
        vals = fr.values.data
        seg = np.repeat(np.arange(len(fr), dtype=np.int64), fr.nvalues)
        order = np.lexsort((vals, seg))
        if flag < 0:
            # reverse each group's slice of the ascending order
            off = fr.offsets
            pos = np.arange(len(vals), dtype=np.int64)
            order = order[off[seg] + off[seg + 1] - 1 - pos]
        return DenseColumn(vals[order])
    pieces = []
    for i in range(len(fr)):
        col = fr.group_values(i)
        order = argsort_column(col, cmp=flag) if callable(flag) \
            else argsort_column(col, descending=flag < 0)
        pieces.append(col.take(order))
    return concat(pieces) if pieces else fr.values


def _fmt(x, flag: int) -> str:
    """One printed field (reference keyvalue.cpp:773-835)."""
    if isinstance(x, bytes):
        try:
            return x.decode()
        except UnicodeDecodeError:
            return repr(x)
    if isinstance(x, tuple):
        return " ".join(_fmt(e, flag) for e in x)
    if isinstance(x, float) or flag in (3, 4):
        return f"{x:g}"
    return str(x)
