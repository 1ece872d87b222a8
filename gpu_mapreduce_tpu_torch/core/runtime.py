"""Runtime state: errors, settings, counters and device resolution.

The PyTorch counterpart of ``gpu_mapreduce_tpu/core/runtime.py``, cut to
what the ported paths read: ``MRError``, a ``Settings`` subset
(memsize, mapstyle, verbosity, fuse) and ``Counters`` with
``bump_dispatch``.

Device resolution is the port's own: an entry point given ``device=None``
runs on the card, and raises ``MRError`` when there is none.  The CPU is
used only when the caller asks for it (the tests do).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
import torch

from ..utils.env import env_knob


class MRError(RuntimeError):
    """Raised for fatal conditions (the reference aborts; we raise)."""


@dataclass
class Settings:
    memsize: int = 64       # MB per frame (reference default 64)
    mapstyle: int = 0       # 0 chunk, 1 stride, 2 master-slave
    verbosity: int = 0
    # 1 = defer op chains into the plan/ recorder and run them fused;
    # MRTPU_FUSE flips the default, as in the JAX package
    fuse: int = field(default_factory=lambda: env_knob("MRTPU_FUSE", int,
                                                       0))

    def validate(self) -> None:
        if self.memsize <= 0:
            raise MRError("Invalid memsize setting")
        if self.mapstyle not in (0, 1, 2):
            raise MRError("Invalid mapstyle setting")
        if self.fuse not in (0, 1):
            raise MRError("Invalid fuse setting")


@dataclass
class Counters:
    """Cumulative cross-instance stats.  ``ndispatch`` counts device
    program launches (the convert/reduce programs, and the hand-written
    kernels through ``ops.cuda.note_kernel_launch``)."""
    ndispatch: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, **deltas) -> None:
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)


_GLOBAL_COUNTERS = Counters()


def global_counters() -> Counters:
    return _GLOBAL_COUNTERS


def bump_dispatch(n: int = 1) -> None:
    """Count one device program launch."""
    _GLOBAL_COUNTERS.add(ndispatch=n)


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
