"""Thread-safe tracer with nested spans (the port's copy of
``gpu_mapreduce_tpu/obs/tracer.py``).

A span records host wall time, deltas of the cumulative
``core.runtime.Counters`` (bytes shuffled, padded and spilled, program
launches, the resident hi-water), and op attributes.  Nesting is per
thread (a thread-local stack), so ``collate`` parents ``aggregate`` and
``convert``, which parent the exchange's ``shuffle.exchange``, and the
``-partition`` worlds' interpreter threads each get their own stack.
Events go to the sinks already in Chrome trace-event form (``ph: "X"``,
``ts``/``dur`` in µs).

On the card a span is also a profiler range: it opens
``torch.profiler.record_function(name)`` and, when CUDA is available
(decided once, from ``torch.cuda.is_available()``, when a span first
asks: a process that records no span, as the fleet router, never calls
into CUDA), an NVTX range
(``torch.cuda.nvtx.range_push``/``range_pop`` on the span's own thread),
so ``torch.profiler`` and Nsight Systems show each span over the card's
kernels.  ``MRTPU_TRACE_JAX`` (default on, the JAX package's knob for its
profiler annotations) turns both off.  A span never synchronises the
device: its time is the host's wall time around the work it enqueued.

Counter deltas are process-global: when concurrent ``-partition`` worlds
overlap, a span may count another world's bytes.  Disabled tracing
costs one attribute check: ``span()`` returns the shared
:data:`NULL_SPAN`.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import torch

from ..utils.env import env_flag, env_knob, env_str
from .context import current_trace_id as _ctx_trace_id
from .context import note_span as _ctx_note_span

# Counters fields snapshotted at span entry; the exit delta lands in the
# span's args under the mapped name (only when nonzero, to keep traces
# small).  msizemax is a hi-water, not a flow — reported as the absolute
# hi-water at span exit when it moved during the span.
_DELTA_FIELDS = (
    ("cssize", "shuffle_sent_bytes"),
    ("cspad", "shuffle_pad_bytes"),
    ("wsize", "spill_write_bytes"),
    ("rsize", "spill_read_bytes"),
    ("commtime", "comm_secs"),
    ("ndispatch", "dispatches"),
)


class _NullSpan:
    """Shared no-op stand-in when tracing is disabled (or for the
    ``annotate`` of a thread with no open span)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One timed region.  Use as a context manager::

        with tracer.span("collate", shards=P) as sp:
            ...
            sp.set(nkv=n)
    """

    __slots__ = ("tracer", "name", "cat", "attrs", "span_id", "parent_id",
                 "t0", "t1", "_snap", "_mem0", "_prof", "trace_id")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.span_id = 0
        self.parent_id = 0
        self.t0 = self.t1 = 0.0
        self._snap = None
        self._mem0 = 0
        self._prof = None
        self.trace_id = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.span_id = tr._next_id()
        stack = tr._stack()
        self.parent_id = stack[-1].span_id if stack else 0
        stack.append(self)
        # request-scoped trace context (obs/context.py): the id rides
        # the event so one request's spans are filterable out of any
        # sink — including spans emitted from worker threads that
        # re-installed the submitting request's context
        self.trace_id = _ctx_trace_id()
        c = tr.counters
        self._snap = tuple(getattr(c, f) for f, _ in _DELTA_FIELDS)
        self._mem0 = c.msizemax
        if tr.annotations:
            # the profiler's range (torch.profiler shows the span's
            # kernels under it) and, with a card, an NVTX range on this
            # thread (Nsight Systems); neither synchronises the device
            self._prof = torch.profiler.record_function(self.name)
            self._prof.__enter__()
            if tr.nvtx:
                torch.cuda.nvtx.range_push(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter()
        tr = self.tracer
        if self._prof is not None:
            if tr.nvtx:
                torch.cuda.nvtx.range_pop()
            self._prof.__exit__(exc_type, exc, tb)
            self._prof = None
        stack = tr._stack()
        # pop self even if an inner span leaked (exception unwinding)
        while stack and stack.pop() is not self:
            pass
        c = tr.counters
        for (field, label), before in zip(_DELTA_FIELDS, self._snap):
            d = getattr(c, field) - before
            if d:
                self.attrs[label] = d
        if c.msizemax != self._mem0:
            self.attrs["hbm_hiwater_bytes"] = c.msizemax
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        # per-request stage profile (obs/context.py): the finished
        # span's wall + counter deltas land on the active account too —
        # same numbers, scoped to the request instead of the process
        _ctx_note_span(self.name, self.cat, self.t1 - self.t0, self.attrs)
        tr._emit(self)
        return False

    def event(self) -> dict:
        """This finished span as a Chrome trace-event dict."""
        tr = self.tracer
        ev = {
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": round((self.t0 - tr.epoch) * 1e6, 1),
            "dur": round((self.t1 - self.t0) * 1e6, 1),
            "pid": tr.pid, "tid": threading.get_ident() & 0x7FFFFFFF,
            "id": self.span_id, "parent": self.parent_id,
            "wall": round(tr.wall_epoch + self.t0, 6),
            "args": self.attrs,
        }
        if self.trace_id is not None:
            ev["trace"] = self.trace_id
        return ev


class Tracer:
    """Span factory + sink fan-out.  One per process normally
    (:func:`get_tracer`); tests may build private instances."""

    def __init__(self, counters=None):
        if counters is None:
            from ..core.runtime import global_counters
            counters = global_counters()
        self.enabled = False
        self.counters = counters
        # process-wide attrs merged into EVERY span (parallel/dist.py
        # stamps rank= here so one multi-rank trace merge stays
        # attributable without threading rank through call signatures)
        self.proc_attrs: dict = {}
        # the profiler ranges (MRTPU_TRACE_JAX, the JAX package's knob
        # for its profiler annotations); NVTX only where CUDA is
        # available, decided once at the first span that asks
        self.annotations = env_flag("MRTPU_TRACE_JAX", True)
        self._nvtx: Optional[bool] = None
        self.epoch = time.perf_counter()
        # wall-clock origin of the perf_counter timeline: lets a
        # cross-process merge (fleetobs.read_trace_dir) rebase
        # each process's private ts epoch onto one shared clock
        self.wall_epoch = time.time() - time.perf_counter()
        self.pid = os.getpid()
        self._sinks: List[object] = []
        self._ring: Optional["RingSink"] = None
        self._jsonl: Dict[str, object] = {}   # path → JsonlSink (dedupe)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._id = 0

    # -- span construction --------------------------------------------------
    def span(self, name: str, cat: str = "op", **attrs):
        """A new child span of this thread's current span — or the no-op
        singleton when disabled (the zero-cost fast path)."""
        if not self.enabled:
            return NULL_SPAN
        if self.proc_attrs:
            attrs = {**self.proc_attrs, **attrs}
        return Span(self, name, cat, attrs)

    def annotate(self, **attrs) -> None:
        """Attach attrs to this thread's innermost open span (no-op when
        disabled or no span is open) — how deep layers report tier/shape
        facts without threading span objects through call signatures."""
        if not self.enabled:
            return
        stack = self._stack()
        if stack:
            stack[-1].attrs.update(attrs)

    def current(self):
        stack = self._stack() if self.enabled else None
        return stack[-1] if stack else None

    def set_proc_attrs(self, **attrs) -> None:
        """Merge process-wide span attrs (e.g. ``rank=3``) — stamped on
        every span this tracer creates from now on."""
        self.proc_attrs.update(attrs)

    @property
    def nvtx(self) -> bool:
        if self._nvtx is None:
            self._nvtx = self.annotations and torch.cuda.is_available()
        return self._nvtx

    @nvtx.setter
    def nvtx(self, on: bool) -> None:
        self._nvtx = bool(on)

    # -- configuration ------------------------------------------------------
    def enable(self, jsonl: Optional[str] = None, ring: Optional[int] = None):
        """Turn tracing on.  ``jsonl``: also stream events to this path
        (idempotent per path).  ``ring``: in-memory buffer capacity (a
        ring is always attached; default from MRTPU_TRACE_RING or 65536).
        Returns self for chaining."""
        from .sinks import JsonlSink, RingSink
        with self._lock:
            if self._ring is None:
                cap = ring or env_knob("MRTPU_TRACE_RING", int, 65536)
                self._ring = RingSink(cap)
                self._sinks.append(self._ring)
            if jsonl and jsonl not in self._jsonl:
                sink = JsonlSink(jsonl)
                self._jsonl[jsonl] = sink
                self._sinks.append(sink)
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def subscribe(self, fn) -> None:
        """Register ``fn(event_dict)`` as a sink and enable tracing —
        the external-consumer hook.  Goes through enable() so the ring
        (and hence events()/stats()/dump_trace) works too."""
        from .sinks import CallbackSink
        self.enable()
        with self._lock:
            self._sinks.append(CallbackSink(fn))

    def subscribe_once(self, fn) -> None:
        """subscribe() unless ``fn`` already is — check and append under
        ONE lock hold, so concurrent enables (two threads constructing
        MapReduce(metrics_port=...)) cannot double-subscribe the metrics
        bridge / flight ring and double-count every span; long-lived
        consumers also re-arm safely after a reset().  Membership is by
        ``==``, not ``is``: a bound method (the flight recorder's
        ``rec.emit``) is a fresh object per access but compares equal."""
        from .sinks import CallbackSink
        self.enable()
        with self._lock:
            if not any(isinstance(s, CallbackSink) and s.fn == fn
                       for s in self._sinks):
                self._sinks.append(CallbackSink(fn))

    def unsubscribe(self, fn) -> None:
        """Detach a callback sink subscribed via subscribe[_once] (by
        ``==``, matching subscribe_once's membership rule).  A consumer
        with a bounded lifetime (a per-session event feed) must detach on shutdown or every emission keeps paying
        for a dead listener."""
        from .sinks import CallbackSink
        with self._lock:
            self._sinks = [s for s in self._sinks
                           if not (isinstance(s, CallbackSink)
                                   and s.fn == fn)]

    def reset(self) -> None:
        """Drop sinks/events and disable (test isolation)."""
        self.enabled = False
        with self._lock:
            for s in self._sinks:
                close = getattr(s, "close", None)
                if close:
                    try:
                        close()
                    except Exception:
                        pass
            self._sinks = []
            self._ring = None
            self._jsonl = {}

    # -- event access -------------------------------------------------------
    def events(self) -> list:
        """Snapshot of the in-memory ring (empty when never enabled)."""
        return self._ring.snapshot() if self._ring is not None else []

    def clear(self) -> None:
        """Drop buffered ring events (sinks stay attached) — e.g. to
        separate a warmup run from the timed run."""
        if self._ring is not None:
            # mrlint: disable=lock-unguarded-mutation — RingSink.clear
            # takes the sink's OWN lock; self._lock only guards the
            # _ring/_jsonl attachment maps, not ring contents
            self._ring.clear()

    def stats(self) -> dict:
        """Per-op aggregate over the ring (see report.aggregate_ops)."""
        from .report import aggregate_ops
        return aggregate_ops(self.events())

    # -- internals ----------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _emit(self, span: Span) -> None:
        ev = span.event()
        with self._lock:
            sinks = list(self._sinks)
        for s in sinks:
            try:
                s.emit(ev)
            except Exception:
                # a broken sink (full disk, closed file) must never fail
                # the traced op; drop it fully — including its jsonl
                # dedup entry, so a later enable(jsonl=path) can attach
                # a fresh sink instead of silently no-opping
                with self._lock:
                    if s in self._sinks:
                        self._sinks.remove(s)
                    for path, sink in list(self._jsonl.items()):
                        if sink is s:
                            del self._jsonl[path]
                close = getattr(s, "close", None)
                if close:
                    try:
                        close()
                    except Exception:
                        pass


def configure_from_env(tracer: Tracer) -> Tracer:
    """Apply MRTPU_TRACE (JSONL path, or '1' for ring-only) if set."""
    path = env_str("MRTPU_TRACE", None)
    if path:
        tracer.enable(jsonl=None if path == "1" else path)
    return tracer


_GLOBAL: Optional[Tracer] = None
_GLOBAL_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer (created on first use; MRTPU_TRACE in
    the environment auto-enables it)."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = configure_from_env(Tracer())
    return _GLOBAL
