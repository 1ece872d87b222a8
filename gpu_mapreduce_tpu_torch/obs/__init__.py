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

from .tracer import (NULL_SPAN, Span, Tracer, configure_from_env,
                     get_tracer)
from .sinks import (CallbackSink, JsonlSink, RingSink, chrome_trace,
                    read_jsonl, write_chrome_trace)
from .report import aggregate_ops, per_op_table
from .metrics import MetricsRegistry, enable_metrics, get_registry
from .context import (RequestAccount, current_trace_id, new_trace_id,
                      request_scope)

__all__ = [
    "Tracer", "Span", "NULL_SPAN", "get_tracer", "configure_from_env",
    "RingSink", "JsonlSink", "CallbackSink",
    "chrome_trace", "write_chrome_trace", "read_jsonl",
    "aggregate_ops", "per_op_table",
    "MetricsRegistry", "get_registry", "enable_metrics",
    "RequestAccount", "request_scope", "current_trace_id",
    "new_trace_id",
]

# apply MRTPU_METRICS_PORT / MRTPU_METRICS_SNAP / MRTPU_FLIGHT once, when
# the package is first imported; never raises
from .metrics import configure_from_env as _metrics_env   # noqa: E402
_metrics_env()
