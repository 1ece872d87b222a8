"""Runtime state: errors, settings, counters, timers and device resolution.

The PyTorch counterpart of ``gpu_mapreduce_tpu/core/runtime.py``:
``MRError``, ``Settings`` (the reference's settings fields,
``src/mapreduce.h:28-41``, with the JAX package's defaults and env
knobs), ``Counters`` (the static cross-instance counters reported by
``cummulative_stats``, ``src/mapreduce.cpp:3007-3066``), ``Timer``,
``histogram`` and ``write_histo``.

Device resolution is the port's own: an entry point given ``device=None``
runs on the card, and raises ``MRError`` when there is none.  The CPU is
used only when the caller asks for it (the tests do).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.env import env_knob, env_str
from .errors import CancelledError, DeviceError, MRError  # noqa: F401


@dataclass
class Settings:
    mapstyle: int = 0       # 0 chunk, 1 stride, 2 master-slave work queue
    all2all: int = 1        # the exchange's schedule: 1 all-to-all, 0 ring
    verbosity: int = 0      # 0 silent, 1 totals, 2 + per-shard histograms
    timer: int = 0          # 0 off, 1 totals, 2 + per-shard histograms
    # MB per page (reference default 64); MRTPU_MEMSIZE / MRTPU_FPATH
    # are the JAX package's knobs for the reference's MRMPI_MEMSIZE /
    # MRMPI_FPATH build defaults
    memsize: int = field(default_factory=lambda: env_knob(
        "MRTPU_MEMSIZE", int, 64))
    minpage: int = 0
    maxpage: int = 0        # pages resident before a spill; 0 = unlimited
    freepage: int = 1
    outofcore: int = 0      # 1 = spill to fpath past the page budget
    zeropage: int = 0
    keyalign: int = 8       # accepted, ignored (columnar)
    valuealign: int = 8
    fpath: str = field(default_factory=lambda: env_str("MRTPU_FPATH", "."))
    # 1 = defer op chains into the plan/ recorder and run them fused
    fuse: int = field(default_factory=lambda: env_knob("MRTPU_FUSE", int,
                                                       0))
    # what a failed map input does after the ft/ retry budget is spent:
    # "fail" raises MRError, "retry" retries with a default budget even
    # when MRTPU_RETRY is unset, "skip" quarantines the input and goes on
    # (the records in mr.stats()["ft"])
    onfault: str = field(default_factory=lambda: env_str("MRTPU_ONFAULT",
                                                         "fail"))

    def validate(self) -> None:
        if self.memsize <= 0:
            raise MRError("Invalid memsize setting")
        if self.mapstyle not in (0, 1, 2):
            raise MRError("Invalid mapstyle setting")
        if self.all2all not in (0, 1):
            raise MRError("Invalid all2all setting")
        if self.fuse not in (0, 1):
            raise MRError("Invalid fuse setting")
        if self.onfault not in ("fail", "retry", "skip"):
            raise MRError("Invalid onfault setting (fail, retry, or skip)")
        for a in (self.keyalign, self.valuealign):
            if a <= 0 or (a & (a - 1)):
                raise MRError("Alignment setting must be power of 2")


@dataclass
class Counters:
    """Cumulative cross-instance stats, shared by every MapReduce.
    ``ndispatch`` counts device program launches (the convert/reduce
    programs, and the hand-written kernels through
    ``ops.cuda.note_kernel_launch``)."""
    msize: int = 0          # bytes resident in pages now
    msizemax: int = 0       # their hi-water mark
    rsize: int = 0          # bytes read back from spill files
    wsize: int = 0          # bytes written to spill files
    cssize: int = 0         # bytes sent in shuffles (0 on one device)
    crsize: int = 0         # bytes received in shuffles
    cspad: int = 0          # padding bytes sent in shuffles
    commtime: float = 0.0   # seconds in collectives
    ndispatch: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, **deltas) -> None:
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)
        if "wsize" in deltas or "rsize" in deltas:
            acct = getattr(_ACCOUNT_TLS, "acct", None)
            if acct is not None:
                acct.note_io(deltas.get("wsize", 0), deltas.get("rsize", 0))
        feed = _REQUEST_FEED
        if feed is not None:
            feed("add", deltas)

    def mem(self, delta: int) -> None:
        """Move the resident bytes by ``delta`` and keep the hi-water;
        the thread's tenant :class:`PageAccount`, if any, is charged too."""
        with self._lock:
            self.msize += delta
            if self.msize > self.msizemax:
                self.msizemax = self.msize
        acct = getattr(_ACCOUNT_TLS, "acct", None)
        if acct is not None:
            acct.charge(delta)
        feed = _REQUEST_FEED
        if feed is not None:
            feed("mem", delta)

    def snapshot(self) -> dict:
        with self._lock:
            return {"msize": self.msize, "msizemax": self.msizemax,
                    "rsize": self.rsize, "wsize": self.wsize,
                    "cssize": self.cssize, "crsize": self.crsize,
                    "cspad": self.cspad, "commtime": self.commtime,
                    "ndispatch": self.ndispatch}

    def reset(self) -> None:
        with self._lock:
            for name in ("msize", "msizemax", "rsize", "wsize", "cssize",
                         "crsize", "cspad", "ndispatch"):
                setattr(self, name, 0)
            self.commtime = 0.0


class PageAccount:
    """Per-tenant frame-residency accounting (``serve/budget.py``).

    A tenant's budget is enforced by the page machinery itself: a
    session's MRs get ``maxpage``/``memsize``/``outofcore`` from the
    tenant's allowance and spill like any memory-bound run.  This class
    attributes: bytes charged through :meth:`Counters.mem` while a tenant
    scope is installed land here (the ``mrtpu_tenant_pages{tenant}``
    gauge).  Attribution is thread-scoped (:func:`page_account_scope`):
    helper threads a session starts bill the global counters only.  The
    bytes are frame bytes, not the caching allocator's reserve."""

    __slots__ = ("tenant", "page_bytes", "limit_pages", "bytes_in_use",
                 "hi_water", "spilled_bytes", "reread_bytes", "_lock")

    def __init__(self, tenant: str, page_bytes: int, limit_pages: int = 0):
        self.tenant = tenant
        self.page_bytes = max(1, int(page_bytes))
        self.limit_pages = int(limit_pages)      # 0 = unlimited
        self.bytes_in_use = 0
        self.hi_water = 0
        self.spilled_bytes = 0       # disk traffic this tenant paid
        self.reread_bytes = 0
        self._lock = threading.Lock()

    def charge(self, delta: int) -> None:
        with self._lock:
            self.bytes_in_use = max(0, self.bytes_in_use + int(delta))
            if self.bytes_in_use > self.hi_water:
                self.hi_water = self.bytes_in_use

    def note_io(self, wsize: int, rsize: int) -> None:
        with self._lock:
            self.spilled_bytes += int(wsize)
            self.reread_bytes += int(rsize)

    def pages_in_use(self) -> float:
        with self._lock:
            return self.bytes_in_use / self.page_bytes

    def snapshot(self) -> dict:
        with self._lock:
            return {"tenant": self.tenant,
                    "bytes_in_use": self.bytes_in_use,
                    "hi_water": self.hi_water,
                    "spilled_bytes": self.spilled_bytes,
                    "reread_bytes": self.reread_bytes,
                    "page_bytes": self.page_bytes,
                    "pages_in_use": round(self.bytes_in_use
                                          / self.page_bytes, 4),
                    "limit_pages": self.limit_pages}


_ACCOUNT_TLS = threading.local()


def set_page_account(acct):
    """Install ``acct`` as THIS thread's tenant account; returns the
    previous one (callers restore it)."""
    prev = getattr(_ACCOUNT_TLS, "acct", None)
    _ACCOUNT_TLS.acct = acct
    return prev


def current_page_account():
    return getattr(_ACCOUNT_TLS, "acct", None)


@contextlib.contextmanager
def page_account_scope(acct):
    """``with page_account_scope(acct):`` installs and restores."""
    prev = set_page_account(acct)
    try:
        yield acct
    finally:
        set_page_account(prev)


# the request-context hook: obs/context.py installs its feed here when
# it is imported (``fn(kind, payload)``: "add" with the deltas dict,
# "mem" with the byte delta), so core/ never imports obs/ and the
# unarmed cost is one None check
_REQUEST_FEED = None

_GLOBAL_COUNTERS = Counters()
_DISPATCH_TLS = threading.local()


def global_counters() -> Counters:
    return _GLOBAL_COUNTERS


def bump_dispatch(n: int = 1) -> None:
    """Count one device program launch, process-wide and for this
    thread (:func:`thread_dispatches`)."""
    _GLOBAL_COUNTERS.add(ndispatch=n)
    _DISPATCH_TLS.n = getattr(_DISPATCH_TLS, "n", 0) + n


def thread_dispatches() -> int:
    """Launches counted by THIS thread so far: two reads around a region
    give its own count while other threads launch (the plan fuser's
    per-group meter)."""
    return getattr(_DISPATCH_TLS, "n", 0)


class Timer:
    __slots__ = ("t0",)

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0


def histogram(values, nbins: int = 10):
    """(min, avg, max, bins) over per-shard values (reference histogram,
    src/mapreduce.cpp:3267-3311): bins count the shards in each
    equal-width slice of [min, max]."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        return 0.0, 0.0, 0.0, [0] * nbins
    lo, hi = float(v.min()), float(v.max())
    if hi == lo:
        bins = [0] * nbins
        bins[0] = int(v.size)
        return lo, float(v.mean()), hi, bins
    idx = np.minimum(((v - lo) / (hi - lo) * nbins).astype(int), nbins - 1)
    bins = np.bincount(idx, minlength=nbins).astype(int).tolist()
    return lo, float(v.mean()), hi, bins


def write_histo(label: str, values, out=None) -> None:
    """Reference write_histo (src/mapreduce.cpp:3251-3263): min/avg/max
    across shards and the shard-count distribution."""
    lo, ave, hi, bins = histogram(values)
    out = out or sys.stdout
    out.write(f"  {label} (per shard): {ave:.4g} ave {hi:.4g} max "
              f"{lo:.4g} min\n")
    out.write("  histogram: " + " ".join(str(b) for b in bins) + "\n")


def resolve_device(device=None) -> torch.device:
    """``None`` → the card; raises ``MRError`` when no card is present.
    Any explicit device is taken as given (``"cpu"`` runs every kernel's
    plain PyTorch version)."""
    if device is None:
        if not torch.cuda.is_available():
            raise MRError("no CUDA device is available; pass device='cpu' "
                          "to run the plain PyTorch path on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MRError(f"device {dev} requested but CUDA is not available")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (host timers read real time)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
