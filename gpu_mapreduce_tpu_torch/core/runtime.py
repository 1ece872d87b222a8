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

import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.env import env_knob, env_str


class MRError(RuntimeError):
    """Raised for fatal conditions (the reference aborts; we raise)."""


class DeviceError(MRError):
    """The card or a kernel failed: a kernel that did not build, load or
    launch.  The retry layer never retries it, quarantines it or answers
    it with a plain version (``ft/retry.device_error``)."""


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

    def mem(self, delta: int) -> None:
        """Move the resident bytes by ``delta`` and keep the hi-water."""
        with self._lock:
            self.msize += delta
            if self.msize > self.msizemax:
                self.msizemax = self.msize

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


_GLOBAL_COUNTERS = Counters()


def global_counters() -> Counters:
    return _GLOBAL_COUNTERS


def bump_dispatch(n: int = 1) -> None:
    """Count one device program launch."""
    _GLOBAL_COUNTERS.add(ndispatch=n)


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
