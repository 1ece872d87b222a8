"""The standing-query micro-batch engine (the counterpart of
``gpu_mapreduce_tpu/stream/engine.py``).

One :class:`Stream` turns the batch MapReduce chain into a standing
query: a tailer (``stream/tailer.py``) follows append-only sources
through the exec/ prefetch producer, a :class:`~.scheduler.BatchCutter`
cuts micro-batches by rows, bytes or time, and each batch runs the same
registered map/reduce chain a one-shot job would, on the delta only,
then merges into the resident dataset with the accumulator kernel of
the recorded reduce (count partials merge with ``sum``: the resident
already holds counts).  The delta and the resident live on the stream's
device or mesh (the card unless ``device=`` or ``comm=`` says
otherwise); the parsed words are interned there.

Exactly-once is one journal record: the batch's source cursors commit
with its merge (``stream_batch`` carries both, appended only after the
post-merge checkpoint is renamed into place).  A kill -9 anywhere
resumes from the last committed record, so the recovered stream
re-reads exactly the bytes whose merge never committed.  The journal
records and ``stream.json`` are the JAX package's.

Sliding windows are bucketed retire-and-merge: ``window=N`` keeps the
last N batch deltas as reduced buckets; the resident view is their
merge, rebuilt from the survivors when a bucket retires.

Every batch replays one recorded chain over its delta.  A plan's key
carries the delta's exact row count, so under ``fuse=1`` only deltas of
equal row count repeat a key: such warm micro-batches take the cached
plan (no new plan misses) and the group table on the card, while a delta
of a new length misses once.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.runtime import MRError
from ..utils.env import env_knob
from .scheduler import BatchCutter
from .tailer import Tailer

# delta-reduce kernel → the accumulator that merges its partials into
# the resident dataset.  count's partials are already counts — merging
# them with count would count KV records, not occurrences.
ACCUMULATORS = {"count": "sum", "sum": "sum", "min": "min",
                "max": "max"}

_OPEN, _CLOSED, _FAILED = "open", "closed", "failed"


def _parse_words(chunk: bytes, kv) -> int:
    words = chunk.split()
    if words:
        kv.add_batch(words, np.ones(len(words), np.int64))
    return len(words)


def _parse_lines(chunk: bytes, kv) -> int:
    lines = chunk.splitlines()
    if lines:
        kv.add_batch(lines, np.ones(len(lines), np.int64))
    return len(lines)


def _parse_kv(chunk: bytes, kv) -> int:
    keys: List[bytes] = []
    vals: List[int] = []
    for line in chunk.splitlines():
        parts = line.split()
        if len(parts) >= 2:
            try:
                vals.append(int(parts[1]))
            except ValueError:
                continue
            keys.append(parts[0])
    if keys:
        kv.add_batch(keys, np.asarray(vals, np.int64))
    return len(keys)


PARSERS: Dict[str, Callable] = {"words": _parse_words,
                                "lines": _parse_lines,
                                "kv": _parse_kv}


def ckpt_keep_default() -> int:
    return max(1, env_knob("MRTPU_STREAM_KEEP", int, 2))


class Stream:
    """One standing query over append-only sources.

    ``dir`` is the stream's durable home (its ft/ journal + committed
    checkpoints); ``sources`` are files or directories to tail;
    ``parser``/``reduce`` name the recorded chain (PARSERS and the
    oink/ REDUCE_KERNELS registry); ``window`` > 0 keeps only the last
    N micro-batches resident (bucketed retire-and-merge).  ``device``
    and ``comm`` place the datasets as ``MapReduce`` does (the card by
    default; ``MRError`` without one).  ``resident`` optionally binds
    the resident dataset to a caller-owned MapReduce (the
    ``mr.stream()`` surface) — merges land in that object.

    Construction RESUMES when the directory already holds committed
    batches: cursors, seq, and the resident dataset restore from the
    last committed record (integrity-verified; an unloadable generation
    falls back to the previous one, ft/ discipline)."""

    def __init__(self, dir: str, sources: List[str],
                 parser: str = "words", reduce: str = "count",
                 window: int = 0, comm=None,
                 settings: Optional[dict] = None,
                 rows: Optional[int] = None,
                 nbytes: Optional[int] = None,
                 wait_s: Optional[float] = None,
                 name: Optional[str] = None,
                 resident=None, keep: Optional[int] = None,
                 device=None):
        from ..oink.kernels import REDUCE_KERNELS
        if parser not in PARSERS:
            raise MRError(f"unknown stream parser {parser!r} "
                          f"(have {sorted(PARSERS)})")
        if reduce not in ACCUMULATORS:
            raise MRError(f"unknown stream reduce {reduce!r} "
                          f"(have {sorted(ACCUMULATORS)})")
        self.dir = os.path.abspath(dir)
        self.name = name or os.path.basename(self.dir.rstrip("/")) \
            or "stream"
        self.parser = parser
        self.reduce = reduce
        self.window = max(0, int(window))
        self.comm = comm
        self.device = device
        self.settings = dict(settings or {})
        self.keep = keep if keep is not None else ckpt_keep_default()
        self._parse = PARSERS[parser]
        self._reduce_fn = REDUCE_KERNELS[reduce]
        self._accum_fn = REDUCE_KERNELS[ACCUMULATORS[reduce]]
        self.tailer = Tailer(sources)
        self.cutter = BatchCutter(rows=rows, nbytes=nbytes,
                                  wait_s=wait_s)
        self.state = _OPEN
        self.error: Optional[str] = None
        self.seq = 0                    # committed batches
        self.rows_total = 0
        self.bytes_total = 0
        self.watermark = 0.0            # max source mtime committed
        self.resumes = 0
        self._lock = threading.Lock()
        self._external = resident is not None
        self.resident = resident if resident is not None \
            else self._new_mr()
        self._buckets: List = []        # window mode: last N deltas
        os.makedirs(self.dir, exist_ok=True)
        self._restore()
        from ..ft.journal import Journal
        self._journal = Journal(self.dir, script_mode=True)
        if self.seq == 0:
            self._journal.append({
                "kind": "stream_open", "name": self.name,
                "parser": parser, "reduce": reduce,
                "window": self.window,
                "sources": list(self.tailer.sources)})

    # -- construction helpers ----------------------------------------------
    def _new_mr(self):
        from ..core.mapreduce import MapReduce
        return MapReduce(self.device, comm=self.comm, **self.settings)

    def _ckpt_dir(self, tag: str) -> str:
        return os.path.join(self.dir, "ckpt", tag)

    def _restore(self) -> None:
        """Resume from the last committed ``stream_batch`` record whose
        checkpoint still loads (generation fallback: a torn or
        bit-flipped newest checkpoint falls back to the one before it —
        its record's cursors come along, so the re-read covers exactly
        the gap)."""
        from ..ft.journal import read_journal
        try:
            recs = read_journal(self.dir)
        except MRError:
            return
        batches = [r for r in recs if r.get("kind") == "stream_batch"]
        # a ``stream_rehome`` record marks a directory move (the JAX
        # package's fleet takeover writes one): the
        # journaled cursors still name paths under the OLD home, so
        # every restored cursor key gets the prefix maps applied in
        # record order.  Without this the moved feed file reads from
        # offset 0 and every committed batch double-counts
        remaps = [r.get("map") or {} for r in recs
                  if r.get("kind") == "stream_rehome"]

        def rehome(path: str) -> str:
            for m in remaps:
                for old, new in m.items():
                    if path == old or path.startswith(
                            old.rstrip(os.sep) + os.sep):
                        path = new + path[len(old):]
                        break
            return path
        if any(r.get("kind") == "stream_close" for r in recs):
            # a cleanly closed stream re-opens for MORE data; its
            # committed state still restores below
            pass
        from ..core import checkpoint as ckpt_mod
        from ..ft.retry import device_error
        for rec in reversed(batches):
            tag = rec.get("ckpt", "")
            path = os.path.join(self._ckpt_dir(tag), "resident")
            try:
                resident = self._new_mr()
                ckpt_mod.load(resident, path)
                buckets = []
                for i in range(int(rec.get("buckets", 0))):
                    b = self._new_mr()
                    ckpt_mod.load(b, os.path.join(
                        self._ckpt_dir(tag), f"b{i}"))
                    buckets.append(b)
            except Exception as e:
                if device_error(e):
                    raise                # a card failure is fatal
                continue                 # fall back a generation
            self._set_resident(resident)
            self._buckets = buckets
            self.tailer.cursors = {
                rehome(str(k)): int(v)
                for k, v in (rec.get("cursors") or {}).items()}
            with self._lock:
                self.seq = int(rec.get("seq", 0))
                self.rows_total = int(rec.get("rows_cum", 0))
                self.bytes_total = int(rec.get("bytes_cum", 0))
                self.watermark = float(rec.get("wm", 0.0))
                self.resumes = 1
            self._metric("mrtpu_stream_resumes_total",
                         "streams resumed from a committed journal "
                         "record", 1)
            return

    def _set_resident(self, mr) -> None:
        """Install ``mr`` as the resident dataset.  An external
        resident (``mr.stream()``) keeps the CALLER's object identity:
        its dataset is replaced in place through public ops (a fresh
        0-task map resets the KV, then one add pulls the new state
        in)."""
        if not self._external:
            self.resident = mr
            return
        if mr is self.resident:
            return
        self.resident.map(0, lambda i, kv, p: None)
        self.resident.add(mr)

    # -- ingest ------------------------------------------------------------
    def _collect(self, max_bytes: Optional[int],
                 final: bool) -> tuple:
        """Pull pending chunks through the exec/ prefetch producer —
        the reads overlap the batch's compute, and the stream's lag
        attribution metrics (``mrtpu_prefetch_*{path="stream/<name>"}``)
        are fed here."""
        from ..exec.prefetch import prefetch_iter
        state = {"wm": 0.0}

        def tail_iter():
            chunks, wm = self.tailer.poll(max_bytes=max_bytes,
                                          final=final)
            state["wm"] = wm
            for c in chunks:
                yield c

        out = list(prefetch_iter(tail_iter(),
                                 path=f"stream/{self.name}"))
        return out, state["wm"]

    # -- the micro-batch ---------------------------------------------------
    def poll_once(self, force: bool = False,
                  final: bool = False) -> int:
        """One scheduler pass: cut and process at most one micro-batch;
        returns rows processed (0 = nothing cut).  ``force`` cuts any
        pending data regardless of thresholds (drain / close);
        ``final`` also consumes an unterminated trailing line."""
        if self.state != _OPEN:
            return 0
        pending = self.tailer.pending_bytes()
        if pending <= 0 and not final:
            self._update_gauges(0)
            return 0
        if not (force or final):
            # rows trigger rides the observed bytes/row of committed
            # batches (no pre-read row count exists for free)
            est_rows = 0
            if self.rows_total and self.bytes_total:
                est_rows = int(pending * self.rows_total
                               / self.bytes_total)
            if not self.cutter.should_cut(pending, est_rows):
                self._update_gauges(pending)
                return 0
        cursors_before = dict(self.tailer.cursors)
        try:
            chunks, wm = self._collect(
                None if final else max(pending, self.cutter.nbytes),
                final)
            if not chunks:
                self._update_gauges(self.tailer.pending_bytes())
                return 0
            rows = self._process(chunks, wm)
        except Exception:
            # the cursors advanced but the batch never committed:
            # rewind so a retry (or the resumed stream) re-reads the
            # exact same bytes — exactly-once, not at-most-once
            self.tailer.cursors = cursors_before
            raise
        self.cutter.cut_done()
        self._update_gauges(self.tailer.pending_bytes())
        return rows

    def drain(self, final: bool = False) -> int:
        """Process everything pending right now (deterministic tests,
        OINK ``stream poll``, close).  Returns total rows."""
        total = 0
        while True:
            n = self.poll_once(force=True, final=final)
            if n <= 0 and self.tailer.pending_bytes() <= 0:
                return total
            if n <= 0:
                return total            # torn tail only (not final)
            total += n

    def _process(self, chunks: List[bytes], wm: float) -> int:
        """The incremental chain + atomic commit for one batch."""
        from ..obs import get_tracer
        nbytes = sum(len(c) for c in chunks)
        with get_tracer().span("stream.batch", cat="stream",
                               stream=self.name, seq=self.seq + 1,
                               bytes=nbytes) as sp:
            delta = self._new_mr()

            def mapper(itask, kv, ptr):
                self._parse(ptr[itask], kv)

            delta.map(len(chunks), mapper, ptr=chunks)
            delta.collate()
            delta.reduce(self._reduce_fn, batch=True)
            rows = sum(c.count(b"\n") for c in chunks)
            if chunks and not chunks[-1].endswith(b"\n"):
                rows += 1               # final-drain unterminated tail
            if self.window > 0:
                self._buckets.append(delta)
                while len(self._buckets) > self.window:
                    self._buckets.pop(0)    # retire the aged bucket
                view = self._new_mr()
                for b in self._buckets:
                    view.add(b)
                view.collate()
                view.reduce(self._accum_fn, batch=True)
                self._set_resident(view)
            else:
                self.resident.add(delta)
                self.resident.collate()
                self.resident.reduce(self._accum_fn, batch=True)
            self._commit(rows, nbytes, wm)
            sp.set(rows=rows, seq=self.seq)
        return rows

    def _commit(self, rows: int, nbytes: int, wm: float) -> None:
        """Checkpoint, THEN the record — the exactly-once edge.  Every
        save is atomic (tmp sibling + rename, core/checkpoint.py), and
        the ``stream_batch`` record carrying the advanced cursors is
        appended only after all of them: a kill -9 before the append
        leaves the PREVIOUS record authoritative, and its cursors
        re-read exactly the bytes whose merge was lost."""
        from ..core import checkpoint as ckpt_mod
        from ..obs import get_tracer
        seq = self.seq + 1
        tag = f"g{seq:06d}"
        with get_tracer().span("stream.checkpoint", cat="stream",
                               stream=self.name, seq=seq):
            ckpt_mod.save(self.resident,
                          os.path.join(self._ckpt_dir(tag), "resident"))
            for i, b in enumerate(self._buckets):
                ckpt_mod.save(b, os.path.join(self._ckpt_dir(tag),
                                              f"b{i}"))
        with self._lock:
            self.seq = seq
            self.rows_total += rows
            self.bytes_total += nbytes
            if wm > 0:
                self.watermark = max(self.watermark, wm)
            cursors = dict(self.tailer.cursors)
        self._journal.append({
            "kind": "stream_batch", "seq": seq, "ckpt": tag,
            "cursors": cursors, "rows": rows, "bytes": nbytes,
            "rows_cum": self.rows_total, "bytes_cum": self.bytes_total,
            "buckets": len(self._buckets), "wm": self.watermark})
        self._gc_ckpts(seq)
        self._metric("mrtpu_stream_batches_total",
                     "micro-batches committed per stream", 1)
        self._metric("mrtpu_stream_rows_total",
                     "records committed per stream", rows)

    def _gc_ckpts(self, seq: int) -> None:
        """Drop committed checkpoint generations past ``keep`` (the
        newest is always load-bearing; older ones are the generation
        fallback)."""
        root = os.path.join(self.dir, "ckpt")
        try:
            tags = sorted(n for n in os.listdir(root)
                          if n.startswith("g") and ".tmp" not in n)
        except OSError:
            return
        live = {f"g{s:06d}" for s in
                range(max(1, seq - self.keep + 1), seq + 1)}
        for t in tags:
            if t not in live and t <= f"g{seq:06d}":
                shutil.rmtree(os.path.join(root, t),
                              ignore_errors=True)

    # -- observation -------------------------------------------------------
    def _metric(self, name: str, help: str, amount) -> None:
        try:
            from ..obs.metrics import get_registry
            get_registry().counter(name, help, ("stream",)).inc(
                amount, stream=self.name)
        except Exception:
            pass

    def _update_gauges(self, pending: int) -> None:
        try:
            from ..obs.metrics import get_registry
            reg = get_registry()
            reg.gauge("mrtpu_stream_pending_bytes",
                      "bytes appended past the committed cursors but "
                      "not yet consumed", ("stream",)).set(
                          pending, stream=self.name)
            reg.gauge("mrtpu_stream_lag_seconds",
                      "event-time lag of the stream (0 when caught "
                      "up)", ("stream",)).set(self.lag_s(pending),
                                              stream=self.name)
        except Exception:
            pass

    def lag_s(self, pending: Optional[int] = None) -> float:
        """Event-time lag: 0 when caught up, else now minus the
        watermark (the newest source mtime already committed — the
        uncommitted tail is AT LEAST that old)."""
        if pending is None:
            pending = self.tailer.pending_bytes()
        if pending <= 0 or self.watermark <= 0:
            return 0.0
        return max(0.0, time.time() - self.watermark)

    def _ingest_stats(self) -> dict:
        """The lag-attribution half: what the exec/ prefetch producer
        reports for THIS stream's path label — wait says ingest-bound,
        depth says the producer is ahead (compute-bound)."""
        out = {"prefetch_depth": 0, "prefetch_wait_s": 0.0}
        try:
            from ..obs.metrics import get_registry
            reg = get_registry()
            label = f"stream/{self.name}"
            d = reg.gauge(
                "mrtpu_prefetch_depth",
                "items the prefetch producer holds ahead of the "
                "consumer", ("path",)).value(path=label)
            w = reg.counter(
                "mrtpu_prefetch_wait_seconds_total",
                "seconds the consumer spent blocked on the prefetch "
                "producer (ingest-bound time)",
                ("path",)).value(path=label)
            out["prefetch_depth"] = int(d or 0)
            out["prefetch_wait_s"] = round(float(w or 0.0), 6)
        except Exception:
            pass
        return out

    def status(self) -> dict:
        pending = self.tailer.pending_bytes()
        with self._lock:
            out = {
                "name": self.name, "state": self.state,
                "error": self.error,
                "parser": self.parser, "reduce": self.reduce,
                "window": self.window,
                "buckets": len(self._buckets),
                "batches": self.seq, "rows": self.rows_total,
                "bytes": self.bytes_total,
                "pending_bytes": pending,
                "watermark": round(self.watermark, 6),
                "lag_s": round(self.lag_s(pending), 6),
                "resumed": bool(self.resumes),
                "cursors": dict(self.tailer.cursors),
            }
        out["ingest"] = self._ingest_stats()
        return out

    def snapshot(self) -> str:
        """Canonical text of the resident dataset — gathered, key-
        sorted, one ``key value`` line per pair.  THE byte-identity
        surface: incremental-vs-batch and kill-9-resume goldens
        compare exactly this string."""
        mr = self.resident.copy()
        mr.gather(1)
        mr.sort_keys(1)
        lines: List[str] = []

        def emit(k, v, _ptr):
            key = k.decode("utf-8", "replace") if isinstance(
                k, (bytes, bytearray)) else str(k)
            lines.append(f"{key} {int(v)}\n")

        mr.scan_kv(emit)
        return "".join(lines)

    # -- lifecycle ---------------------------------------------------------
    def suspend(self) -> None:
        """Release this HANDLE without closing the QUERY: the journal
        handle closes, no ``stream_close`` record lands — a later
        ``Stream(dir, ...)`` over the same directory resumes from the
        last committed batch.  The OINK command surface (one process
        per invocation) and daemon shutdown both detach this way."""
        if self.state == _OPEN:
            self.state = "suspended"
        try:
            self._journal.close()
        except Exception:
            pass

    def close(self, drain: bool = True) -> dict:
        """Final drain (unterminated tail included), the
        ``stream_close`` record, and the journal handle.  Returns the
        final status.  Idempotent."""
        if self.state == _OPEN:
            if drain:
                try:
                    self.drain(final=True)
                except Exception as e:
                    self.error = f"{type(e).__name__}: {e}"
                    self.state = _FAILED
            if self.state == _OPEN:
                self.state = _CLOSED
            try:
                self._journal.append({"kind": "stream_close",
                                      "state": self.state})
            except (ValueError, OSError):
                pass
        try:
            self._journal.close()
        except Exception:
            pass
        return self.status()
