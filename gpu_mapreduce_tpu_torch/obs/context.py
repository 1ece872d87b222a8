"""Request-scoped trace context and exact per-request cost attribution
(the port's copy of ``gpu_mapreduce_tpu/obs/context.py``).

Every request (a top-level OINK script, a ``request_scope`` block, or
the process's own programmatic run) gets a trace context:

* a ``trace_id`` that every span opened under the context carries, as
  do the ft/ journal's records and quarantine records and the flight
  recorder's dump;
* a :class:`RequestAccount` charged from the funnels the work already
  goes through: ``Counters.add``/``Counters.mem`` (``core/runtime.py``,
  through ``_REQUEST_FEED``), the retry outcomes (``ft/retry.py``), the
  plan cache's hits and misses and the fused groups (``plan/cache.py``),
  the exchange telemetry (``obs/metrics.record_exchange``), finished
  spans (``obs/tracer.py``) and sync points (``obs/fleetobs.py``), so
  two concurrent requests never charge each other.

Propagation is ``contextvars``-based; the worker threads of exec/ (the
prefetch producer, the spill writer) and the ingest pool re-install the
submitting request's context through :func:`capture`, :func:`use` and
:func:`bind`.  With no explicit scope, :func:`active_account` falls back
to a lazily made process context (one trace id for the whole run);
``MRTPU_PROFILE=0`` turns that fallback and the implicit per-script
scopes off.  :func:`barrier_check` is the cooperative cancellation hook
at the op barriers.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Dict, Optional

# the active request account for THIS thread/context.  Deliberately a
# ContextVar and not a threading.local: a context can be captured and
# re-installed in worker threads, and nested scopes restore via tokens.
_CTXVAR: contextvars.ContextVar[Optional["RequestAccount"]] = \
    contextvars.ContextVar("mrtpu-request", default=None)

_PROCESS: Optional["RequestAccount"] = None
_PROC_LOCK = threading.Lock()

# distinct stage names kept per account; the tail aggregates into one
# "(other)" row so a pathological span-name cardinality (a bug, or a
# hostile script) cannot grow a session's account without bound
_STAGE_CAP = 64


def profiling_enabled() -> bool:
    """The implicit-context knob (``MRTPU_PROFILE``, default on).
    Explicit scopes (:func:`request_scope`) always work regardless."""
    from ..utils.env import env_flag
    return env_flag("MRTPU_PROFILE", True)


def new_trace_id() -> str:
    """16 hex chars of OS entropy — unique across daemon restarts
    without any coordination (a counter would collide after replay)."""
    return os.urandom(8).hex()


class RequestAccount:
    """Exact cost attribution for one request.

    Fed from the single funnels the work already goes through —
    ``Counters.add``/``Counters.mem`` (core/runtime.py), the retry
    engine's outcome counter (ft/retry.py), the LRU compile caches
    (plan/cache.py), the exchange per-call stats (obs/metrics.py) and
    finished spans (obs/tracer.py) — so there is no second measurement
    path to drift from the process-global truth: the account receives
    the same deltas, scoped to whichever context was active."""

    __slots__ = ("trace_id", "tenant", "label", "t0", "_lock",
                 "dispatches", "comm_s",
                 "exchange_count", "exchange_sent", "exchange_pad",
                 "exchange_rows", "exchange_rounds", "exchange_wire",
                 "exchange_wire_logical",
                 "spill_write", "spill_read",
                 "mem_in_use", "mem_hi_water",
                 "retries", "plan", "fusion", "stages", "sync_sites",
                 "cancel_reason", "deadline", "last_barrier", "barriers",
                 "cancel_closed", "kernels")

    def __init__(self, trace_id: Optional[str] = None,
                 tenant: str = "", label: str = ""):
        self.trace_id = trace_id or new_trace_id()
        self.tenant = tenant
        self.label = label
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()
        # cooperative cancellation: a reason string arms the flag; barrier_check() trips it at the
        # next op barrier.  Plain attribute writes — str/float
        # assignment is atomic under the GIL and the checker tolerates
        # one-barrier staleness, so no lock is needed on this path.
        self.cancel_reason: Optional[str] = None
        self.deadline: Optional[float] = None    # time.monotonic()
        self.last_barrier = time.monotonic()     # stall-watchdog clock
        self.barriers = 0                        # barrier-progress count
        self.cancel_closed = False               # disarm is PERMANENT
        self.dispatches = 0
        self.comm_s = 0.0
        self.exchange_count = 0
        self.exchange_sent = 0
        self.exchange_pad = 0
        self.exchange_rows = 0
        self.exchange_rounds = 0
        self.exchange_wire = 0
        self.exchange_wire_logical = 0
        self.spill_write = 0
        self.spill_read = 0
        self.mem_in_use = 0
        self.mem_hi_water = 0
        self.retries: Dict[str, int] = {}
        self.plan: Dict[str, Dict[str, int]] = {}
        self.fusion: Dict[str, int] = {
            "groups": 0, "fused_groups": 0, "mega_groups": 0,
            "pallas_groups": 0, "dispatches": 0,
            "dispatches_saved": 0}
        self.stages: Dict[str, dict] = {}
        # per-sync-site straggler evidence (parallel/dist guarded
        # collectives, fed via obs/fleetobs.SyncObserver): worst spread,
        # the rank most often last, attributed cause counts
        self.sync_sites: Dict[str, dict] = {}
        # launches of the port's hand-written CUDA kernels (ops/cuda),
        # by wrapper name: a serve result's ``meta.kernels``; not part
        # of profile(), whose keys are the JAX package's.  Charged on
        # the threads that carry this context: the request's own and
        # the workers that re-install it (capture/use, bind); a thread
        # started without it charges no request
        self.kernels: Dict[str, int] = {}

    # -- feeds (each must never raise into the work it observes) ----------
    def note_counters(self, deltas: dict) -> None:
        """One ``Counters.add`` call's deltas (the byte/dispatch funnel:
        exchange volume, spill traffic, collective seconds, compiled-
        program launches)."""
        with self._lock:
            self.dispatches += deltas.get("ndispatch", 0)
            self.exchange_sent += deltas.get("cssize", 0)
            self.exchange_pad += deltas.get("cspad", 0)
            self.spill_write += deltas.get("wsize", 0)
            self.spill_read += deltas.get("rsize", 0)
            self.comm_s += deltas.get("commtime", 0.0)

    def note_kernel(self, name: str) -> None:
        with self._lock:
            self.kernels[name] = self.kernels.get(name, 0) + 1

    def charge_mem(self, delta: int) -> None:
        """One ``Counters.mem`` charge: per-request HBM residency and
        hi-water (the PageAccount mechanism, scoped to a request)."""
        with self._lock:
            self.mem_in_use = max(0, self.mem_in_use + int(delta))
            if self.mem_in_use > self.mem_hi_water:
                self.mem_hi_water = self.mem_in_use

    def note_exchange(self, stats) -> None:
        """Per-call shuffle telemetry (rows/rounds/calls + the wire
        codec's actual interconnect bytes; the logical byte volume
        arrives via :meth:`note_counters` — one source each, never
        double-counted)."""
        with self._lock:
            self.exchange_count += 1
            self.exchange_rows += int(getattr(stats, "rows", 0))
            self.exchange_rounds += int(getattr(stats, "nrounds", 0))
            wire = int(getattr(stats, "wire_bytes", 0))
            self.exchange_wire += wire
            if wire:
                # the ratio's numerator counts ONLY codec-compressed
                # exchanges — raw-bypass logical bytes in the request
                # must not inflate the reported compression
                self.exchange_wire_logical += (
                    int(getattr(stats, "sent_bytes", 0))
                    + int(getattr(stats, "pad_bytes", 0)))

    def note_retry(self, site: str, outcome: str) -> None:
        with self._lock:
            key = f"{site}:{outcome}"
            self.retries[key] = self.retries.get(key, 0) + 1

    def note_plan(self, cache: str, hit: bool) -> None:
        with self._lock:
            c = self.plan.get(cache)
            if c is None:
                c = self.plan[cache] = {"hits": 0, "misses": 0}
            c["hits" if hit else "misses"] += 1

    def note_fusion(self, fused: bool, mega: bool, dispatches: int,
                    saved: int, pallas: bool) -> None:
        """One executed plan group charged to this request: fusion
        effectiveness (plan/cache.note_fusion's per-request twin —
        which classifies the kind/mode strings ONCE and hands the
        derived booleans here)."""
        with self._lock:
            self.fusion["groups"] += 1
            if fused:
                self.fusion["fused_groups"] += 1
                if mega:
                    self.fusion["mega_groups"] += 1
                if pallas:
                    self.fusion["pallas_groups"] += 1
            self.fusion["dispatches"] += int(dispatches)
            self.fusion["dispatches_saved"] += int(saved)

    def note_span(self, name: str, cat: str, dur_s: float,
                  attrs: dict) -> None:
        """One finished span under this context → a stage row.  Rows
        aggregate per span name (bounded), like report.aggregate_ops;
        nested spans each get their own row, so rows overlap in wall
        time — the table reads like a profile, not a partition."""
        with self._lock:
            row = self.stages.get(name)
            if row is None:
                if len(self.stages) >= _STAGE_CAP:
                    name = "(other)"
                    row = self.stages.get(name)
                if row is None:
                    row = self.stages[name] = {
                        "cat": cat, "count": 0, "total_s": 0.0,
                        "max_s": 0.0, "dispatches": 0}
            row["count"] += 1
            row["total_s"] += dur_s
            if dur_s > row["max_s"]:
                row["max_s"] = dur_s
            row["dispatches"] += int(attrs.get("dispatches", 0) or 0)
            for k in ("shuffle_sent_bytes", "shuffle_pad_bytes",
                      "spill_write_bytes", "spill_read_bytes"):
                v = attrs.get(k)
                if v:
                    row[k] = row.get(k, 0) + int(v)

    def note_sync_point(self, site: str, spread_s: float, slowest: int,
                        cause: str, ranks_seen: int) -> None:
        """One guarded collective sync's arrival evidence charged to
        this request (the ``straggler`` profile section)."""
        with self._lock:
            row = self.sync_sites.get(site)
            if row is None:
                row = self.sync_sites[site] = {
                    "count": 0, "spread_s_sum": 0.0, "max_spread_s": 0.0,
                    "slowest_rank": -1, "causes": {}}
            row["count"] += 1
            row["spread_s_sum"] += spread_s
            if spread_s >= row["max_spread_s"]:
                row["max_spread_s"] = spread_s
                row["slowest_rank"] = int(slowest)
                row["worst_cause"] = cause
            row["causes"][cause] = row["causes"].get(cause, 0) + 1
            row["ranks_seen"] = int(ranks_seen)

    # -- cooperative cancellation ------------------------------------------
    def cancel(self, reason: str = "client") -> None:
        """Arm the cancellation flag: the request raises
        :class:`~...core.runtime.CancelledError` at its next op barrier.
        Idempotent; the FIRST reason wins (a deadline firing after a
        client cancel must not rewrite the story).  A no-op once the
        owner disarmed — the release path must stay uncancellable even
        against a DELETE racing the request's last lines."""
        with self._lock:
            if self.cancel_reason is None and not self.cancel_closed:
                self.cancel_reason = reason

    def set_deadline(self, seconds_from_now: float) -> None:
        with self._lock:      # pairs with disarm_cancel's clear
            self.deadline = time.monotonic() + max(0.0, seconds_from_now)

    def check_cancel(self) -> None:
        """Raise if cancelled or past deadline (the barrier-site hook —
        attribute reads only on the un-armed fast path; the deadline
        trip takes the same lock as cancel/disarm so a concurrent
        disarm can never be overwritten)."""
        reason = self.cancel_reason
        if reason is None:
            dl = self.deadline
            if dl is None or time.monotonic() <= dl:
                return
            with self._lock:
                if self.cancel_reason is None and \
                        not self.cancel_closed:
                    self.cancel_reason = "deadline"
                reason = self.cancel_reason
            if reason is None:
                return      # disarmed concurrently: nothing to stop
        from ..core.runtime import CancelledError
        raise CancelledError(reason)

    def disarm_cancel(self) -> None:
        """Drop the armed flag + deadline, PERMANENTLY: the owner is
        past the point of stopping (releasing resources, writing the
        terminal record) — a cancel arriving after this is the
        cancel-vs-complete race and loses.  The lock makes close-vs-
        cancel atomic: without it a cancel() preempted between its
        check and its store could re-arm the flag AFTER the disarm and
        cancel the release path anyway."""
        with self._lock:
            self.cancel_closed = True
            self.cancel_reason = None
            self.deadline = None

    # -- read-out ----------------------------------------------------------
    def profile(self) -> dict:
        """The per-request cost profile (the JAX package's keys)."""
        with self._lock:
            stages = {}
            for name, row in self.stages.items():
                r = dict(row)
                r["total_s"] = round(r["total_s"], 6)
                r["max_s"] = round(r["max_s"], 6)
                stages[name] = r
            straggler = {}
            for site, row in self.sync_sites.items():
                straggler[site] = {
                    "count": row["count"],
                    "avg_spread_s": round(
                        row["spread_s_sum"] / max(1, row["count"]), 6),
                    "max_spread_s": round(row["max_spread_s"], 6),
                    "slowest_rank": row["slowest_rank"],
                    "worst_cause": row.get("worst_cause", ""),
                    "causes": dict(row["causes"]),
                    "ranks_seen": row.get("ranks_seen", 0)}
            return {
                "trace_id": self.trace_id,
                "tenant": self.tenant,
                "label": self.label,
                "wall_s": round(time.perf_counter() - self.t0, 4),
                "dispatches": self.dispatches,
                "comm_s": round(self.comm_s, 6),
                "exchange": {"count": self.exchange_count,
                             "sent_bytes": self.exchange_sent,
                             "pad_bytes": self.exchange_pad,
                             "rows": self.exchange_rows,
                             "rounds": self.exchange_rounds,
                             "wire_bytes": self.exchange_wire,
                             # logical/wire ratio over the request's
                             # codec-compressed exchanges ONLY (raw-
                             # bypass traffic excluded; 0 = none ran)
                             "compression_ratio": round(
                                 self.exchange_wire_logical
                                 / self.exchange_wire, 4)
                             if self.exchange_wire else 0.0},
                "spill": {"write_bytes": self.spill_write,
                          "read_bytes": self.spill_read},
                "hbm": {"hi_water_bytes": self.mem_hi_water},
                "retries": dict(sorted(self.retries.items())),
                "plan_cache": {c: dict(v)
                               for c, v in sorted(self.plan.items())},
                # fusion v2 effectiveness: how many of this request's
                # plan groups fused / megafused / took the Pallas group
                # kernels, and the dispatches that saved vs eager
                "fusion": dict(self.fusion),
                # which collective sync sites this request waited at,
                # who was last, and whether the data or the host was
                # at fault (doc/distributed.md "a rank is slow, not
                # dead")
                "straggler": dict(sorted(straggler.items())),
                "stages": dict(sorted(
                    stages.items(),
                    key=lambda kv: -kv[1]["total_s"])),
            }


# ---------------------------------------------------------------------------
# scope management
# ---------------------------------------------------------------------------

def _process_account() -> Optional[RequestAccount]:
    """The lazy process-default context (the "top-level programmatic
    run").  None when profiling is disabled."""
    global _PROCESS
    if _PROCESS is not None:
        # an explicitly-installed account (set_process_trace_id — the
        # dist trace stitch) outranks the MRTPU_PROFILE gate
        return _PROCESS
    if not profiling_enabled():
        return None
    with _PROC_LOCK:
        if _PROCESS is None:
            _PROCESS = RequestAccount(label="process")
    return _PROCESS


def active_account() -> Optional[RequestAccount]:
    """The account charged by the feeds: the innermost explicit scope,
    else the process default (else None under MRTPU_PROFILE=0)."""
    acct = _CTXVAR.get()
    if acct is not None:
        return acct
    return _process_account()


def current_trace_id() -> Optional[str]:
    acct = active_account()
    return acct.trace_id if acct is not None else None


@contextlib.contextmanager
def request_scope(trace_id: Optional[str] = None, tenant: str = "",
                  label: str = "", account: Optional[RequestAccount]
                  = None):
    """``with request_scope() as acct:`` — install a fresh (or given)
    account as THIS context's attribution target.  Always works, even
    under MRTPU_PROFILE=0 (the knob only gates the implicit scopes)."""
    acct = account if account is not None else RequestAccount(
        trace_id=trace_id, tenant=tenant, label=label)
    token = _CTXVAR.set(acct)
    try:
        yield acct
    finally:
        _CTXVAR.reset(token)


@contextlib.contextmanager
def ensure_scope(label: str = "", tenant: str = ""):
    """A scope for top-level runners (OinkScript): reuse the already-
    installed context when one exists (an enclosing request wrapping
    the script must stay ONE request), otherwise open a fresh one — unless
    profiling is disabled, in which case this is a no-op."""
    if _CTXVAR.get() is not None or not profiling_enabled():
        yield _CTXVAR.get()
        return
    with request_scope(label=label, tenant=tenant) as acct:
        yield acct


def capture() -> Optional[RequestAccount]:
    """The effective context to hand to a worker thread (explicit scope
    or the process default) — pair with :func:`use` on the other side."""
    return active_account()


@contextlib.contextmanager
def use(acct: Optional[RequestAccount]):
    """Install a captured context in the current thread (no-op on
    None).  The worker-thread half of cross-thread propagation."""
    if acct is None:
        yield None
        return
    token = _CTXVAR.set(acct)
    try:
        yield acct
    finally:
        _CTXVAR.reset(token)


def bind(fn):
    """Wrap ``fn`` so it runs under the CURRENT context wherever it is
    later called (thread-pool submission sites: the shared ingest pool,
    mapstyle-2 task queues).  Identity when no context is active."""
    acct = active_account()
    if acct is None:
        return fn

    def wrapper(*a, **kw):
        token = _CTXVAR.set(acct)
        try:
            return fn(*a, **kw)
        finally:
            _CTXVAR.reset(token)
    return wrapper


# ---------------------------------------------------------------------------
# the runtime feed (installed into core/runtime at import — runtime
# cannot import obs/ at module level without a cycle)
# ---------------------------------------------------------------------------

def _counters_feed(kind: str, payload) -> None:
    """``Counters.add``/``mem`` hook.  Must never raise into the
    counter bump it observes."""
    try:
        acct = _CTXVAR.get()
        if acct is None:
            acct = _process_account()
            if acct is None:
                return
        if kind == "add":
            acct.note_counters(payload)
        else:
            acct.charge_mem(payload)
    except Exception:
        pass


def note_kernel(name: str) -> None:
    """One hand-written kernel launch, charged to the current request
    (outside a request it is only the wrapper's own counter)."""
    try:
        acct = _CTXVAR.get()
        if acct is not None:
            acct.note_kernel(name)
    except Exception:
        pass


def note_exchange(stats) -> None:
    """Feed point for parallel/shuffle + plan/fuser per-call exchange
    stats (via obs/metrics.record_exchange)."""
    acct = active_account()
    if acct is not None:
        acct.note_exchange(stats)


def note_retry(site: str, outcome: str) -> None:
    """Feed point for ft/retry's outcome counter."""
    acct = active_account()
    if acct is not None:
        acct.note_retry(site, outcome)


def note_plan(cache: str, hit: bool) -> None:
    """Feed point for plan/cache.LRUCache hit/miss telemetry."""
    acct = active_account()
    if acct is not None:
        acct.note_plan(cache, hit)


def note_fusion(fused: bool, mega: bool, dispatches: int, saved: int,
                pallas: bool) -> None:
    """Feed point for plan/cache.note_fusion — per-request fusion
    effectiveness (``profile()["fusion"]``)."""
    acct = active_account()
    if acct is not None:
        acct.note_fusion(fused, mega, dispatches, saved, pallas)


def note_span(name: str, cat: str, dur_s: float, attrs: dict) -> None:
    """Feed point for finished spans (obs/tracer.Span.__exit__)."""
    acct = active_account()
    if acct is not None:
        acct.note_span(name, cat, dur_s, attrs)


def note_sync(site: str, spread_s: float, slowest: int, cause: str,
              ranks_seen: int) -> None:
    """Feed point for collective sync straggler evidence
    (obs/fleetobs.SyncObserver → the profile's ``straggler`` section)."""
    acct = active_account()
    if acct is not None:
        acct.note_sync_point(site, spread_s, slowest, cause, ranks_seen)


def set_process_trace_id(trace_id: str) -> None:
    """Pin the process-default context to a GIVEN trace id — the
    cross-process stitch: mrlaunch mints one id, ships it via
    ``MRTPU_DIST_TRACE_ID``, and every rank installs it here so all
    ranks' spans/journals/flight dumps carry the launch's single id.
    Creates the process account if needed (even under MRTPU_PROFILE=0 —
    an explicit launch-provided id outranks the implicit-context knob)."""
    global _PROCESS
    with _PROC_LOCK:
        if _PROCESS is None:
            _PROCESS = RequestAccount(trace_id=trace_id, label="dist")
        else:
            _PROCESS.trace_id = trace_id


def barrier_check() -> None:
    """The op-barrier hook (core/mapreduce op start + plan barrier,
    parallel/shuffle count sync, oink command/checkpoint round): note
    barrier progress for the stall watchdog, then raise
    :class:`~..core.runtime.CancelledError` when the active request was
    cancelled or ran past its deadline.  Cooperative by design — a
    running program is never interrupted mid-dispatch; it stops at the
    next barrier with its datasets in a consistent, resumable state.
    No-op (a ContextVar read)
    when no request context is active."""
    acct = _CTXVAR.get()
    if acct is None:
        return
    acct.last_barrier = time.monotonic()
    acct.barriers += 1
    if acct.cancel_reason is not None or acct.deadline is not None:
        acct.check_cancel()


def reset() -> None:
    """Test isolation: drop the process-default context (explicit
    scopes are stack-managed and need no reset)."""
    global _PROCESS
    with _PROC_LOCK:
        _PROCESS = None


from ..core import runtime as _runtime  # noqa: E402

_runtime._REQUEST_FEED = _counters_feed
