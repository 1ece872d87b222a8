"""Self-protection under overload: SLO-burn shedding + disk pressure.

Two gates the daemon consults on every submit, both built from
evidence it already collects:

* :class:`BurnShedder` — closes the loop from the tenant SLO burn
  engine (obs/slo.py) back into admission.  A tenant burning its
  error budget in EVERY window of its objective (the same multi-window
  AND that raises the burn alert) gets its NEW submits handled first,
  before the shared queue starts rejecting everyone: its
  expensive-profile jobs (per-tenant session-cost EWMA from the
  request accounts) are SHED with an honest per-tenant ``Retry-After``,
  its cheap ones are DEPRIORITIZED below every polite tenant.  The
  queue-full 429 remains the backstop — this gate just makes the
  *greedy* tenant absorb the backpressure instead of the polite ones
  (doc/serve.md#slo-burn-shedding).

* :class:`DiskMonitor` — resource-pressure degradation.  ENOSPC on a
  session path, or free space under ``MRTPU_SERVE_DISK_MIN`` MB on the
  state/result filesystems, flips the daemon to DEGRADED: new
  admissions shed with ``Retry-After``, running sessions keep their
  pages and finish (they own the space they already hold), and
  ``/healthz`` answers 503 ``{"status": "degraded"}`` so LBs and the
  fleet router re-route.  Degradation clears itself when space
  returns — no operator restart (doc/reliability.md#daemon-under-
  overload).

Shed decisions land in ``mrtpu_serve_shed_total{tenant,reason}`` (one
count per shed response) and, on the rising edge per (tenant, reason),
as a ``serve_shed`` journal record — forensics without journal spam.
"""

from __future__ import annotations

import errno
import os
import threading
import time
from typing import Dict, Optional, Tuple

from ..utils.env import env_flag, env_knob

# deprioritization floor: a burning-but-cheap tenant's submits sort
# below any default-priority work but keep FIFO among themselves
SHED_PRIORITY = -5


class CostProfiles:
    """Per-tenant EWMA of session cost — the *evidence* the shedder and
    the mesh autoscaler act on.  Fed by the daemon after every finished
    session from that session's own RequestAccount profile (exact under
    concurrency); thread-safe; bounded like the rate-limiter's
    bucket table (tenant names come from request bodies)."""

    _ALPHA = 0.3
    _CAP = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # tenant → (wall_s EWMA, exchange-bytes EWMA, sessions seen)
        self._rows: Dict[str, Tuple[float, float, int]] = {}
        self._global_wall = 0.0
        self._n = 0

    def record(self, tenant: str, wall_s: float,
               exchange_bytes: float) -> None:
        wall_s = max(0.0, float(wall_s or 0.0))
        exchange_bytes = max(0.0, float(exchange_bytes or 0.0))
        a = self._ALPHA
        with self._lock:
            if len(self._rows) >= self._CAP and tenant not in self._rows:
                # drop the least-seen row: a client cycling tenant
                # names cannot grow the table without bound
                victim = min(self._rows, key=lambda t: self._rows[t][2])
                del self._rows[victim]
            w, x, n = self._rows.get(tenant, (wall_s, exchange_bytes, 0))
            self._rows[tenant] = (w + a * (wall_s - w),
                                  x + a * (exchange_bytes - x), n + 1)
            self._global_wall += a * (wall_s - self._global_wall) \
                if self._n else wall_s - self._global_wall
            self._n += 1

    def wall(self, tenant: str) -> Optional[float]:
        with self._lock:
            row = self._rows.get(tenant)
            return row[0] if row else None

    def exchange_bytes(self, tenant: str) -> Optional[float]:
        with self._lock:
            row = self._rows.get(tenant)
            return row[1] if row else None

    def global_wall(self) -> float:
        with self._lock:
            return self._global_wall

    def snapshot(self) -> dict:
        with self._lock:
            return {t: {"wall_s": round(w, 4),
                        "exchange_bytes": int(x), "sessions": n}
                    for t, (w, x, n) in sorted(self._rows.items())}


class BurnShedder:
    """The admission-side half of the SLO loop.  ``decide(tenant,
    priority)`` → ``(action, priority, retry_after_s)`` with action one
    of ``"admit"`` / ``"deprioritize"`` / ``"shed"``."""

    def __init__(self, profiles: CostProfiles,
                 enabled: Optional[bool] = None):
        self.profiles = profiles
        self.enabled = enabled if enabled is not None \
            else env_flag("MRTPU_SERVE_SHED", True)
        self.shed_count = 0
        self.deprioritized = 0
        self._last_force = 0.0

    def decide(self, tenant: str, priority: int
               ) -> Tuple[str, int, float]:
        if not self.enabled:
            return "admit", priority, 0.0
        from ..obs import slo as _slo
        eng = _slo.get_engine()
        if eng is None:
            return "admit", priority, 0.0
        # the engine's own tick rate-limit (min_window/10, >=6 s) is a
        # scrape-storm guard; an ADMISSION decision reading that stale
        # a burn would admit a whole burst before noticing it.  Force a
        # re-evaluation at ~1/60th of the shortest window (>= 1 s) —
        # fresh enough to catch a burst, bounded enough that the
        # snapshot ring stays ~90 entries at any window size.
        now = time.monotonic()
        if now - self._last_force >= max(1.0, eng.min_window() / 60.0):
            self._last_force = now
            eng.tick(force=True)
        else:
            eng.tick()
        if not eng.burning(tenant):
            return "admit", priority, 0.0
        # the tenant is burning in every window.  Its own cost profile
        # decides HOW it absorbs backpressure: expensive sessions shed
        # outright (each admit would burn serious capacity), cheap ones
        # only lose priority (they still run, after everyone else).  An
        # unknown profile counts as expensive — a burning tenant with
        # no history gets no benefit of the doubt.
        wall = self.profiles.wall(tenant)
        baseline = self.profiles.global_wall()
        if wall is None or baseline <= 0 or wall >= baseline:
            self.shed_count += 1
            # honest horizon: the burn is a windowed rate, so it decays
            # over the shortest objective window — suggest a fraction
            # of it, bounded to something a client will actually honor
            ra = min(60.0, max(1.0, eng.min_window() / 4.0))
            return "shed", priority, ra
        self.deprioritized += 1
        return "deprioritize", min(priority, SHED_PRIORITY), 0.0

    def snapshot(self) -> dict:
        return {"enabled": self.enabled, "shed": self.shed_count,
                "deprioritized": self.deprioritized}


class DiskMonitor:
    """Free-space floor + ENOSPC latch over the daemon's durable paths.

    ``check()`` returns a reason string while degraded, else None —
    cached ~2 s so per-submit probing costs one lock + clock read.  An
    observed ENOSPC (``note_error``) degrades immediately and stays
    degraded for ``_ENOSPC_HOLD`` seconds past the last occurrence,
    then clears if the free-space probe passes — self-healing, no
    restart."""

    _CACHE_S = 2.0
    _ENOSPC_HOLD = 30.0

    def __init__(self, paths, floor_mb: Optional[int] = None):
        self.paths = [p for p in paths if p]
        self.floor_mb = floor_mb if floor_mb is not None \
            else env_knob("MRTPU_SERVE_DISK_MIN", int, 64)
        self._lock = threading.Lock()
        self._last_probe = 0.0
        self._reason: Optional[str] = None
        self._last_enospc = 0.0
        self.trips = 0

    # the out-of-space errno class: plain full disk AND quota
    # exhaustion (EDQUOT passes the free-byte probe, so the latch is
    # the ONLY way it ever degrades the daemon)
    _SPACE_ERRNOS = frozenset(
        {errno.ENOSPC} | ({errno.EDQUOT} if hasattr(errno, "EDQUOT")
                          else set()))

    def note_error(self, exc: BaseException) -> bool:
        """Latch ENOSPC/EDQUOT seen anywhere in a failure chain."""
        seen = set()
        e: Optional[BaseException] = exc
        while e is not None and id(e) not in seen:
            seen.add(id(e))
            if isinstance(e, OSError) and e.errno in self._SPACE_ERRNOS:
                with self._lock:
                    self._last_enospc = time.monotonic()
                    self._last_probe = 0.0      # re-evaluate now
                return True
            e = e.__cause__ or e.__context__
        return False

    def _probe(self) -> Optional[str]:
        if self.floor_mb <= 0:
            return None
        floor = self.floor_mb * (1 << 20)
        for path in self.paths:
            p = path
            while p and not os.path.isdir(p):
                p = os.path.dirname(p)
            try:
                st = os.statvfs(p or ".")
            except OSError:
                continue
            free = st.f_bavail * st.f_frsize
            if free < floor:
                return (f"low disk under {path!r}: "
                        f"{free // (1 << 20)} MB free < "
                        f"{self.floor_mb} MB floor")
        return None

    def check(self) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            if now - self._last_probe < self._CACHE_S:
                return self._reason
            self._last_probe = now
            held = now - self._last_enospc < self._ENOSPC_HOLD
        reason = self._probe()
        if reason is None and held:
            reason = "recent ENOSPC on a session path"
        with self._lock:
            if reason and not self._reason:
                self.trips += 1
            self._reason = reason
        return reason

    @property
    def degraded(self) -> bool:
        return self.check() is not None

    def snapshot(self) -> dict:
        return {"floor_mb": self.floor_mb, "reason": self.check(),
                "trips": self.trips}
