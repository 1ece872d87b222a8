"""Flight recorder: a bounded ring of recent spans that dumps a
forensic JSON artifact when a run dies (the port's copy of
``gpu_mapreduce_tpu/obs/flight.py``; the same artifact).

The recorder subscribes to the process tracer and dumps
``mr_flight.<pid>.<seq>.json`` on an unhandled exception (``MRError``
and the card's ``DeviceError`` included), on ``SIGUSR1`` and on an
explicit :meth:`FlightRecorder.dump`: the reason, the last spans, the
cumulative ``Counters``, the plan cache's stats, the metrics snapshot
when the registry is armed, and the process group's lease table.

After a CUDA fault every CUDA call raises again, so a dump touches
nothing on the card: it reads only the ring and host state.

``MRTPU_FLIGHT=<dir>`` (or ``1`` for the working directory) arms it, as
does :func:`obs.metrics.enable_metrics`; ``MRTPU_FLIGHT=0`` keeps it
off; ``MRTPU_FLIGHT_RING`` bounds the ring (default 2048).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Optional


class FlightRecorder:
    """The ring + dumper.  ``emit`` is a tracer sink; every method is
    crash-proof — a recorder bug must never mask the original failure."""

    def __init__(self, dir: str = ".", capacity: Optional[int] = None):
        self.dir = dir
        from ..utils.env import env_knob
        cap = capacity or env_knob("MRTPU_FLIGHT_RING", int, 2048)
        self.events: deque = deque(maxlen=cap)
        self._lock = threading.Lock()
        self._seq = 0
        self.last_dump: Optional[str] = None

    # -- tracer sink --------------------------------------------------------
    def emit(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    # -- artifact -----------------------------------------------------------
    def snapshot(self, reason: str = "snapshot") -> dict:
        from ..core.runtime import global_counters
        from .context import current_trace_id
        with self._lock:
            spans = list(self.events)
        doc = {"reason": reason,
               "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
               "pid": os.getpid(),
               "argv": list(sys.argv),
               # the request the dumping thread was serving (None when
               # no context is active); every ringed span additionally
               # carries its OWN "trace" id, so a multi-tenant dump
               # still attributes each span to its request
               "trace_id": current_trace_id(),
               "counters": global_counters().snapshot(),
               "spans": spans}
        try:
            from ..plan.cache import cache_stats
            doc["plan"] = cache_stats()
        except Exception:
            pass
        try:
            from . import metrics as _metrics
            if _metrics.enabled():
                doc["metrics"] = _metrics.snapshot()
        except Exception:
            pass
        try:
            # multi-process data plane: the peer lease table (heartbeat
            # ages, fence state) — a PeerLostError dump must answer
            # "who died, and when" from the artifact alone.  Late
            # import; parallel/dist pulls in no obs/ at module level.
            from ..parallel import dist as _dist
            rt = _dist.active()
            if rt is not None:
                doc["dist"] = _dist.lease_table(rt)
        except Exception:
            pass
        return doc

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Write the artifact; returns its path (None when even the
        write fails — never raises)."""
        try:
            from .sinks import _jsonable
            with self._lock:
                self._seq += 1
                seq = self._seq
            if self.dir not in ("", "."):
                os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(
                self.dir, f"mr_flight.{os.getpid()}.{seq}.json")
            doc = self.snapshot(reason)
            with open(path, "w") as f:
                json.dump(doc, f, default=_jsonable)
            self.last_dump = path
            print(f"flight recorder: {reason} -> {path}", file=sys.stderr)
            return path
        except Exception:
            return None


_RECORDER: Optional[FlightRecorder] = None
_LOCK = threading.Lock()
_HOOKED = False


def get() -> Optional[FlightRecorder]:
    return _RECORDER


def enable(dir: Optional[str] = None,
           capacity: Optional[int] = None) -> FlightRecorder:
    """Arm the recorder (idempotent): subscribe its ring to the tracer
    (enables tracing), chain ``sys.excepthook``, install the SIGUSR1
    handler (main thread only — silently skipped elsewhere)."""
    global _RECORDER, _HOOKED
    with _LOCK:
        if _RECORDER is None:
            if dir is None:
                from ..utils.env import env_str
                env = env_str("MRTPU_FLIGHT", "")
                dir = env if env not in ("", "0", "1") else "."
            _RECORDER = FlightRecorder(dir=dir, capacity=capacity)
        elif dir is not None:
            _RECORDER.dir = dir
        rec = _RECORDER
    from .tracer import get_tracer
    get_tracer().subscribe_once(rec.emit)
    with _LOCK:
        if not _HOOKED:
            _HOOKED = True
            _install_hooks()
    return rec


def _install_hooks() -> None:
    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        rec = _RECORDER
        if rec is not None and not issubclass(
                exc_type, (SystemExit, KeyboardInterrupt)):
            rec.dump(f"unhandled:{exc_type.__name__}")
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook
    try:
        prev_sig = signal.getsignal(signal.SIGUSR1)

        def on_usr1(signum, frame):
            rec = _RECORDER
            if rec is not None:
                # dump on a SEPARATE thread: the handler runs on the
                # main thread at a bytecode boundary, possibly INSIDE a
                # ring/metrics lock section — dumping inline would
                # re-acquire those non-reentrant locks and deadlock the
                # run this signal was meant to merely poke.  The dump
                # thread just blocks until the handler returns and the
                # interrupted code releases its locks.
                threading.Thread(target=rec.dump, args=("SIGUSR1",),
                                 daemon=True,
                                 name="mrtpu-flight-dump").start()
            if callable(prev_sig):
                prev_sig(signum, frame)

        signal.signal(signal.SIGUSR1, on_usr1)
    except (ValueError, AttributeError, OSError):
        # not the main thread, or a platform without SIGUSR1 — the
        # excepthook path still works
        pass


def reset() -> None:
    """Drop the recorder (test isolation).  The installed hooks stay
    (they no-op with no recorder) — re-installing per test would build
    an unbounded excepthook chain."""
    global _RECORDER
    with _LOCK:
        _RECORDER = None
