"""Observability: structured tracing and live metrics for every layer
(the port's copy of ``gpu_mapreduce_tpu/obs/``; the same event,
snapshot, artifact and file formats, and the same metric names).

* **tracing**: a thread-safe tracer with nested spans that the layers
  report into (the MapReduce ops in ``core/mapreduce.py``, the exchange
  in ``parallel/shuffle.py``, ingest in ``parallel/ingest.py``, the
  fused plans in ``plan/fuser.py``, exec/ and ft/, the OINK commands in
  ``oink/script.py``), sinks (an in-memory ring, a size-rotated JSONL
  file, callbacks), the Chrome trace-event export and a per-op summary.
  On the card each span is also a ``torch.profiler.record_function``
  and an NVTX range (``tracer.py``).
* **metrics**: a registry of labeled counters, gauges and histograms fed
  from the tracer and the exchanges (``metrics.py``), read through
  ``mr.stats()["metrics"]``, a Prometheus endpoint (``httpd.py``,
  ``MRTPU_METRICS_PORT``) and periodic JSONL snapshots, with a flight
  recorder (``flight.py``) that dumps a forensic artifact on an
  unhandled exception or SIGUSR1.
* request context (``context.py``) and the launched runs' trace shards,
  sync observer and metrics dumps (``fleetobs.py``).

Enable tracing with ``MRTPU_TRACE=/path/trace.jsonl`` (``1``: the ring
only), ``MapReduce(trace=...)`` or ``get_tracer().enable()``.  Disabled,
``tracer.span()`` returns a shared no-op singleton.  The tenant SLO
engine (``slo.py``) turns the serve daemon's session metrics into
multi-window burn rates.
"""

import importlib

# each public name and its module, imported at first use: ``trace_view``
# (sinks, report, fleetobs) then starts without torch, which the tracer
# needs
_EXPORTS = {
    "Tracer": ".tracer", "Span": ".tracer", "NULL_SPAN": ".tracer",
    "get_tracer": ".tracer", "configure_from_env": ".tracer",
    "RingSink": ".sinks", "JsonlSink": ".sinks", "CallbackSink": ".sinks",
    "chrome_trace": ".sinks", "write_chrome_trace": ".sinks",
    "read_jsonl": ".sinks",
    "aggregate_ops": ".report", "per_op_table": ".report",
    "MetricsRegistry": ".metrics", "get_registry": ".metrics",
    "enable_metrics": ".metrics",
    "RequestAccount": ".context", "request_scope": ".context",
    "current_trace_id": ".context", "new_trace_id": ".context",
}

__all__ = [
    "Tracer", "Span", "NULL_SPAN", "get_tracer", "configure_from_env",
    "RingSink", "JsonlSink", "CallbackSink",
    "chrome_trace", "write_chrome_trace", "read_jsonl",
    "aggregate_ops", "per_op_table",
    "MetricsRegistry", "get_registry", "enable_metrics",
    "RequestAccount", "request_scope", "current_trace_id",
    "new_trace_id",
]


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


from .metrics import configure_from_env as _metrics_env   # noqa: E402
_metrics_env()
