"""Thread-safe metrics registry: counters, gauges and histograms with
labels (the port's copy of ``gpu_mapreduce_tpu/obs/metrics.py``; the
same metric names, ``doc/observability.md``'s catalog, and the same
Prometheus text byte for byte).

One registry, three exposures: ``mr.stats()["metrics"]``, the
Prometheus endpoint (``obs/httpd.py``, ``MRTPU_METRICS_PORT`` or
``MapReduce(metrics_port=...)``) and periodic JSONL snapshots
(``MRTPU_METRICS_SNAP``, every ``MRTPU_METRICS_SNAP_SECS``).
:func:`enable_metrics` wires the feeds: a span bridge on the process
tracer (``mrtpu_op_latency_seconds{op,cat}``, the spill byte counters),
:func:`record_exchange` from the exchanges, and collectors run at each
read that copy ``core.runtime.Counters`` (``mrtpu_hbm_hiwater_bytes`` is
the hi-water of bytes resident on the card here), the plan cache, ft/
and exec/ into the registry.  Everything here is crash-proof: a metrics
fault never fails the op that reported it.

The SLO collector ticks the tenant SLO engine (``obs/slo.py``) at each
scrape, refreshing ``mrtpu_slo_burn_ratio{tenant,window}``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_INF = float("inf")

# op latencies span ~µs host ops to multi-minute compiles
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0, _INF)


def _fmt_value(v) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and abs(v) < 1e15):
        return str(int(v))
    if v == _INF:
        return "+Inf"
    return repr(float(v))


def _escape_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


class _Metric:
    """One metric family: a name, fixed label names, and one child per
    label-value combination.  A single lock guards the children dict AND
    child mutation, so concurrent inc/observe from worker threads land
    exactly (the registry hammer test's contract)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple, object] = OrderedDict()
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> Tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _labels_dict(self, key: Tuple) -> dict:
        return dict(zip(self.labelnames, key))


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount=1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + amount

    def value(self, **labels):
        with self._lock:
            return self._children.get(self._key(labels), 0)

    def samples(self) -> List[dict]:
        with self._lock:
            return [{"labels": self._labels_dict(k), "value": v}
                    for k, v in self._children.items()]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = value

    def inc(self, amount=1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + amount

    def value(self, **labels):
        with self._lock:
            return self._children.get(self._key(labels), 0)

    samples = Counter.samples


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, buckets=None):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(buckets or DEFAULT_BUCKETS))
        if b[-1] != _INF:
            b = b + (_INF,)
        self.buckets = b

    def observe(self, value, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = \
                    {"counts": [0] * len(self.buckets), "sum": 0.0,
                     "count": 0}
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    child["counts"][i] += 1
                    break
            child["sum"] += value
            child["count"] += 1

    def samples(self) -> List[dict]:
        with self._lock:
            out = []
            for k, ch in self._children.items():
                cum, buckets = 0, OrderedDict()
                for ub, c in zip(self.buckets, ch["counts"]):
                    cum += c
                    buckets["+Inf" if ub == _INF else _fmt_value(ub)] = cum
                out.append({"labels": self._labels_dict(k),
                            "count": ch["count"],
                            "sum": ch["sum"], "buckets": buckets})
            return out


class MetricsRegistry:
    """Metric factory + snapshot/export.  ``counter``/``gauge``/
    ``histogram`` are get-or-create (idempotent per name), so feed sites
    can look their metric up on every call without holding references.
    ``collect()`` first runs the registered collectors — pull-style
    refreshers that copy cumulative sources (Counters, plan caches)
    into gauges at read time."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = OrderedDict()
        self._collectors: List[Callable] = []
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} re-declared as {cls.kind}"
                f"{tuple(labelnames)} (was {m.kind}{m.labelnames})")
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        h = self._get_or_create(Histogram, name, help, labelnames,
                                buckets=buckets)
        if buckets is not None:
            b = tuple(sorted(buckets))
            if b[-1] != _INF:
                b = b + (_INF,)
            if h.buckets != b:
                # same loud contract as kind/labelnames conflicts —
                # observations silently landing in buckets the caller
                # never declared would be unfindable
                raise ValueError(
                    f"metric {name!r} re-declared with buckets {b} "
                    f"(was {h.buckets})")
        return h

    def register_collector(self, fn: Callable) -> None:
        """``fn(registry)`` runs before every collect()/prometheus_text()
        — refresh gauges from a cumulative source.  Registered at most
        once per function identity (enable_metrics re-runs are no-ops)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:
                pass  # a broken collector must not break the scrape

    def collect(self) -> Dict[str, dict]:
        """{name: {type, help, labelnames, samples}} snapshot."""
        self._run_collectors()
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"type": m.kind, "help": m.help,
                         "labelnames": list(m.labelnames),
                         "samples": m.samples()}
                for m in metrics}

    def prometheus_text(self) -> str:
        """The Prometheus exposition format (text/plain version 0.0.4)."""
        self._run_collectors()
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for s in m.samples():
                lab = s["labels"]

                def render(extra=None):
                    items = list(lab.items()) + (extra or [])
                    if not items:
                        return ""
                    return "{" + ",".join(
                        f'{k}="{_escape_label(v)}"' for k, v in items) + "}"

                if m.kind == "histogram":
                    for ub, cum in s["buckets"].items():
                        lines.append(f"{m.name}_bucket"
                                     f"{render([('le', ub)])} {cum}")
                    lines.append(
                        f"{m.name}_sum{render()} {_fmt_value(s['sum'])}")
                    lines.append(f"{m.name}_count{render()} {s['count']}")
                else:
                    lines.append(
                        f"{m.name}{render()} {_fmt_value(s['value'])}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every metric and collector (test isolation)."""
        with self._lock:
            self._metrics = OrderedDict()
            self._collectors = []


# ---------------------------------------------------------------------------
# process-global registry + the automatic feeds
# ---------------------------------------------------------------------------

_REGISTRY: Optional[MetricsRegistry] = None
_REG_LOCK = threading.Lock()
_ENABLED = False


def get_registry() -> MetricsRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        with _REG_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def enabled() -> bool:
    return _ENABLED


# last cumulative wsize/rsize the bridge has accounted: top-level span
# ARGS deltas are per-span snapshots of the shared global Counters, so
# two overlapping top-level spans (mapstyle-2 threads, two MapReduce
# objects) would both include the same bump — delta-tracking the
# cumulative source here counts every spilled byte exactly once
_SPILL_LOCK = threading.Lock()
_SPILL_SEEN = {"wsize": 0, "rsize": 0}


def _bridge_emit(ev: dict) -> None:
    """Tracer sink: every finished span becomes metric updates.  Must
    never raise (the tracer drops a raising sink)."""
    try:
        reg = get_registry()
        reg.histogram(
            "mrtpu_op_latency_seconds",
            "wall time of traced spans by op name and category",
            ("op", "cat")).observe(
                float(ev.get("dur", 0.0)) / 1e6,
                op=ev.get("name", "?"), cat=ev.get("cat", "?"))
        if not ev.get("parent"):
            from ..core.runtime import global_counters
            snap = global_counters().snapshot()
            with _SPILL_LOCK:
                dw = snap["wsize"] - _SPILL_SEEN["wsize"]
                dr = snap["rsize"] - _SPILL_SEEN["rsize"]
                _SPILL_SEEN["wsize"] = snap["wsize"]
                _SPILL_SEEN["rsize"] = snap["rsize"]
            spill = reg.counter(
                "mrtpu_spill_bytes_total",
                "bytes spilled to / re-read from fpath files", ("dir",))
            if dw > 0:
                spill.inc(dw, dir="write")
            if dr > 0:
                spill.inc(dr, dir="read")
    except Exception:
        pass


def _collect_counters(reg: MetricsRegistry) -> None:
    """Refresh gauges from the cumulative cross-instance Counters."""
    from ..core.runtime import global_counters
    snap = global_counters().snapshot()
    cum = reg.gauge("mrtpu_cum",
                    "cumulative runtime.Counters fields (bytes/seconds "
                    "/launches; the cummulative_stats snapshot)",
                    ("field",))
    for k, v in snap.items():
        cum.set(v, field=k)
    reg.gauge("mrtpu_hbm_hiwater_bytes",
              "hi-water of bytes resident in HBM frames (msizemax)"
              ).set(snap["msizemax"])      # on the card, in the port
    reg.gauge("mrtpu_dispatch_total",
              "compiled-program launches (Counters.ndispatch)"
              ).set(snap["ndispatch"])


def _collect_plan(reg: MetricsRegistry) -> None:
    """Refresh plan/jit compile-cache telemetry (plan/cache.py)."""
    from ..plan.cache import cache_stats
    st = cache_stats()
    g = reg.gauge("mrtpu_plan_cache",
                  "compile-cache telemetry per cache and stat",
                  ("cache", "stat"))
    ratio = reg.gauge("mrtpu_plan_cache_hit_ratio",
                      "hits / (hits + misses) per compile cache",
                      ("cache",))
    for cname, s in st.items():
        for k, v in s.items():
            g.set(v, cache=cname, stat=k)
        tot = s.get("hits", 0) + s.get("misses", 0)
        ratio.set(round(s.get("hits", 0) / tot, 6) if tot else 0.0,
                  cache=cname)


_FT_LOCK = threading.Lock()
# last ft/ counter values already synced into the registry: the ft
# counters are process-cumulative and may predate enable_metrics, so
# the collector delta-syncs at scrape time (exact regardless of when
# the registry armed; the lock keeps concurrent scrapes from double-
# counting a delta)
_FT_SEEN: Dict[str, dict] = {"retries": {}, "faults": {},
                             "quarantined": {}}


def _collect_ft(reg: MetricsRegistry) -> None:
    """Refresh the fault-tolerance counters from ft/'s cumulative
    sources: mrtpu_retries_total{site,outcome},
    mrtpu_faults_injected_total{site}, mrtpu_quarantined_total{site}."""
    from ..ft import counters_snapshot
    snap = counters_snapshot()
    specs = (("retries", "mrtpu_retries_total",
              "ft/ retry engine outcomes per site "
              "(retry/recovered/exhausted/fatal)", ("site", "outcome")),
             ("faults", "mrtpu_faults_injected_total",
              "faults injected by the ft/ chaos schedule", ("site",)),
             ("quarantined", "mrtpu_quarantined_total",
              "poisoned map inputs skipped under onfault=skip",
              ("site",)))
    with _FT_LOCK:
        for field, name, help, labels in specs:
            c = reg.counter(name, help, labels)
            seen = _FT_SEEN[field]
            for key, n in snap[field].items():
                d = n - seen.get(key, 0)
                if d < 0:
                    # the source went backwards — only ft.reset() does
                    # that, so everything now counted is NEW since the
                    # reset: inc the full n (staying monotonic) rather
                    # than silently dropping post-reset events until
                    # counts exceed their pre-reset values
                    d = n
                if d > 0:
                    lab = dict(zip(labels, key if isinstance(key, tuple)
                                   else (key,)))
                    c.inc(d, **lab)
                seen[key] = n


def _collect_exec(reg: MetricsRegistry) -> None:
    """Refresh the async-overlap gauges (exec/) at scrape time, so a
    registry armed after an ingest still reads the cumulative ratios."""
    from ..exec import exec_stats
    g = reg.gauge("mrtpu_overlap_ratio",
                  "fraction of background work hidden behind foreground "
                  "work, per overlap path (1 = fully overlapped)",
                  ("path",))
    for path, rec in exec_stats()["overlap"].items():
        g.set(rec["overlap_ratio"], path=path)


def _collect_slo(reg: MetricsRegistry) -> None:
    """Tick the tenant SLO engine (obs/slo.py) at scrape time: windowed
    burn rates over the serve session counters this registry holds,
    refreshing ``mrtpu_slo_burn_ratio{tenant,window}``.  A no-op when no
    objective is configured (``MRTPU_SLO`` unset)."""
    from . import slo as _slo
    eng = _slo.get_engine()
    if eng is not None:
        eng.tick(reg=reg)


def enable_metrics(flight: Optional[bool] = None) -> MetricsRegistry:
    """Wire the automatic feeds (idempotent): subscribe the span bridge
    to the process tracer (this enables tracing), register the Counters,
    plan-cache, exec/ and ft/ collectors, and — unless ``flight=False``
    or ``MRTPU_FLIGHT=0`` — arm the flight recorder (obs/flight.py).
    The SLO collector ticks ``MRTPU_SLO``'s objectives at scrape time."""
    global _ENABLED
    reg = get_registry()
    reg.register_collector(_collect_counters)
    reg.register_collector(_collect_plan)
    reg.register_collector(_collect_exec)
    reg.register_collector(_collect_ft)
    reg.register_collector(_collect_slo)
    from .tracer import get_tracer
    get_tracer().subscribe_once(_bridge_emit)
    _ENABLED = True
    if flight is None:
        from ..utils.env import env_str
        # MRTPU_FLIGHT is a path-or-flag: any value but "0" arms it
        flight = env_str("MRTPU_FLIGHT", "") != "0"
    if flight:
        try:
            from . import flight as _flight
            _flight.enable()
        except Exception:
            pass
    return reg


def snapshot() -> Dict[str, dict]:
    return get_registry().collect()


def prometheus_text() -> str:
    return get_registry().prometheus_text()


def reset() -> None:
    """Test isolation: drop metrics/collectors and the enabled flag.
    (The bridge sink, if subscribed, is cleared by ``tracer.reset()``.)"""
    global _ENABLED
    _ENABLED = False
    get_registry().reset()
    with _FT_LOCK:
        for d in _FT_SEEN.values():
            d.clear()


# -- feed points ------------------------------------------------------------

def record_exchange(stats) -> None:
    """Per-call shuffle telemetry (parallel/shuffle.exchange): useful vs
    padding bytes, flow-control rounds, routed rows."""
    # the request account's exchange feed runs BEFORE the registry
    # gate: per-request attribution (obs/context.py) must stay exact
    # whether or not live metrics are armed
    try:
        from .context import note_exchange
        note_exchange(stats)
    except Exception:
        pass
    if not _ENABLED:
        return
    try:
        reg = get_registry()
        reg.counter("mrtpu_exchanges_total",
                    "shuffle exchange() calls").inc()
        b = reg.counter("mrtpu_exchange_bytes_total",
                        "bytes moved by exchanges: useful (sent) vs "
                        "static-shape padding slack (pad) at logical "
                        "row width, and actual interconnect bytes "
                        "after the MRTPU_WIRE codec (wire)", ("kind",))
        b.inc(int(stats.sent_bytes), kind="sent")
        b.inc(int(stats.pad_bytes), kind="pad")
        b.inc(int(getattr(stats, "wire_bytes", 0)), kind="wire")
        reg.counter("mrtpu_exchange_rounds_total",
                    "flow-control rounds across exchanges"
                    ).inc(int(stats.nrounds))
        reg.counter("mrtpu_exchange_rows_total",
                    "rows routed across exchanges").inc(int(stats.rows))
    except Exception:
        pass


def note_trace_rotated() -> None:
    """The trace sink rotated a JSONL file (sinks.JsonlSink under
    MRTPU_TRACE_MAX_MB).  Counts even before enable_metrics — rotation
    evidence must not depend on the bridge being armed."""
    try:
        get_registry().counter(
            "mrtpu_trace_rotated_total",
            "JSONL trace-file rotations (MRTPU_TRACE_MAX_MB)").inc()
    except Exception:
        pass


# ---------------------------------------------------------------------------
# periodic JSONL snapshots
# ---------------------------------------------------------------------------

class Snapshotter(threading.Thread):
    """Daemon thread appending one ``{"utc", "metrics"}`` JSON line to
    ``path`` every ``every_s`` seconds — the long-window exposure: a
    multi-hour soak leaves a time series even when nothing ever scrapes
    the HTTP endpoint."""

    def __init__(self, path: str, every_s: float = 60.0):
        super().__init__(daemon=True, name="mrtpu-metrics-snap")
        self.path = path
        self.every_s = max(1.0, float(every_s))
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.wait(self.every_s):
            self.write_once()

    def write_once(self) -> None:
        try:
            line = json.dumps(
                {"utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                 "metrics": snapshot()}, default=str)
            with open(self.path, "a") as f:
                f.write(line + "\n")
        except Exception:
            pass  # a full disk must not kill the run

    def stop(self) -> None:
        self._stop.set()


_SNAPSHOTTER: Optional[Snapshotter] = None
_SNAP_LOCK = threading.Lock()   # NOT _REG_LOCK: enable_metrics() below
#                                 reaches get_registry(), which takes it


def start_snapshotter(path: str, every_s: float = 60.0) -> Snapshotter:
    """Start (or return the already-running) periodic snapshot writer."""
    global _SNAPSHOTTER
    enable_metrics()
    with _SNAP_LOCK:
        if _SNAPSHOTTER is None or not _SNAPSHOTTER.is_alive():
            _SNAPSHOTTER = Snapshotter(path, every_s)
            _SNAPSHOTTER.start()
    return _SNAPSHOTTER


def configure_from_env() -> None:
    """Apply MRTPU_METRICS_PORT / MRTPU_METRICS_SNAP[_SECS] /
    MRTPU_FLIGHT if set (called once at obs import).  Never raises,
    and each knob is independent — a bad port value must not silently
    disarm the snapshotter or the flight recorder set via their own
    valid env vars."""
    import sys

    def _warn(knob: str, e: Exception) -> None:
        # one stderr line, not silence: a typo'd port on a multi-hour
        # capture window must not quietly run with no live export
        print(f"{knob} ignored: {e!r}", file=sys.stderr)

    from ..utils.env import env_knob, env_str
    try:
        port = env_knob("MRTPU_METRICS_PORT", int, None)
        if port is not None:
            enable_metrics()
            from .httpd import ensure_server
            ensure_server(port)
    except Exception as e:
        _warn("MRTPU_METRICS_PORT", e)
    try:
        snap = env_str("MRTPU_METRICS_SNAP", None)
        if snap:
            start_snapshotter(
                snap, env_knob("MRTPU_METRICS_SNAP_SECS", float, 60.0))
    except Exception as e:
        _warn("MRTPU_METRICS_SNAP", e)
    try:
        fl = env_str("MRTPU_FLIGHT", None)
        if fl and fl != "0":
            from . import flight as _flight
            _flight.enable()
    except Exception as e:
        _warn("MRTPU_FLIGHT", e)
