"""Bounded admission with backpressure, priorities and tenant quotas.

The daemon's front door, three gates in order:

* **per-tenant rate limit** — a token bucket per tenant
  (``MRTPU_SERVE_RATE`` requests/sec, burst ``MRTPU_SERVE_BURST``;
  0 = off): a tenant past its refill rate gets 429 with a
  ``Retry-After`` computed from ITS OWN bucket deficit, so one noisy
  tenant's backpressure never shows up on its neighbors' clocks;
* **bounded queue** — submissions past ``MRTPU_SERVE_QUEUE`` pending
  sessions are REJECTED (429 + drain-time ``Retry-After``) instead of
  buffered without bound — under sustained overload the queue depth,
  not the daemon's memory, is the thing that saturates;
* **priority** — an accepted session carries a ``priority`` (higher
  first, FIFO within a priority): workers drain urgent tenants ahead
  of batch backfill without starving equal-priority arrivals.

Recovery replay uses ``force=True``: a session the journal says was
accepted must re-enter the queue (at its recorded priority) even when
the restart finds it already full.  Decisions count into
``mrtpu_serve_admission_total{outcome,tenant}``.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, Optional, Tuple


class TenantRateLimiter:
    """Token bucket per tenant.  ``rate`` requests/sec refill, ``burst``
    bucket size; rate 0 disables (every check passes).  Thread-safe."""

    def __init__(self, rate: float = 0.0, burst: Optional[float] = None):
        self.rate = max(0.0, float(rate))
        self.burst = float(burst) if burst is not None \
            else max(1.0, self.rate * 2)
        self._buckets: Dict[str, Tuple[float, float]] = {}  # (tokens, t)
        self._lock = threading.Lock()

    def check(self, tenant: str, now: Optional[float] = None
              ) -> Tuple[bool, float]:
        """(allowed, retry_after_seconds).  Consumes one token when
        allowed; the retry hint is the time until this tenant's bucket
        refills one token — per-tenant honesty, not a global constant."""
        if self.rate <= 0:
            return True, 0.0
        now = time.monotonic() if now is None else now
        with self._lock:
            if len(self._buckets) > 256:
                # tenant names come from the request body: prune
                # buckets that have refilled to full (reconstructible
                # from the default) so a client cycling unique names
                # cannot grow the daemon's memory without bound
                self._buckets = {
                    t: (tok, ts) for t, (tok, ts) in
                    self._buckets.items()
                    if tok + (now - ts) * self.rate < self.burst}
            tokens, t0 = self._buckets.get(tenant, (self.burst, now))
            tokens = min(self.burst, tokens + (now - t0) * self.rate)
            if tokens >= 1.0:
                self._buckets[tenant] = (tokens - 1.0, now)
                return True, 0.0
            self._buckets[tenant] = (tokens, now)
            return False, (1.0 - tokens) / self.rate

    def snapshot(self) -> dict:
        with self._lock:
            return {"rate": self.rate, "burst": self.burst,
                    "tenants": {t: round(b[0], 3)
                                for t, b in self._buckets.items()}}


class AdmissionQueue:
    """Thread-safe bounded priority queue (higher priority first, FIFO
    within).  ``offer`` never blocks — admission control means telling
    the client "not now", not making it wait on a server thread."""

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self._q: list = []        # heap of (-priority, seq, item)
        self._seq = 0
        self._cv = threading.Condition()
        self._closed = False
        self.rejects = 0          # cumulative admission rejections

    def offer(self, item, force: bool = False, priority: int = 0) -> bool:
        with self._cv:
            if self._closed:
                return False
            if len(self._q) >= self.cap and not force:
                self.rejects += 1
                return False
            self._seq += 1
            heapq.heappush(self._q, (-int(priority), self._seq, item))
            self._cv.notify()
            return True

    def take(self, timeout: Optional[float] = None):
        """Next session (highest priority, then admission order), or
        None on timeout / after close-and-drained.  A closed queue
        still hands out its remaining items — shutdown finishes
        accepted work unless the process dies first (the journal
        covers that case)."""
        with self._cv:
            if not self._q and not self._closed:
                self._cv.wait(timeout)
            if self._q:
                return heapq.heappop(self._q)[2]
            return None

    def reject(self) -> None:
        """Count an admission rejection made by a caller that checked
        capacity itself (the daemon holds its submit lock across the
        check + journal + offer, so it probes ``full()`` rather than
        letting ``offer`` race) — the counter mutation stays under the
        queue's own lock either way."""
        with self._cv:
            self.rejects += 1

    def depth(self) -> int:
        with self._cv:
            return len(self._q)

    def full(self) -> bool:
        with self._cv:
            return len(self._q) >= self.cap

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return {"depth": len(self._q), "cap": self.cap,
                    "rejects": self.rejects, "closed": self._closed}
