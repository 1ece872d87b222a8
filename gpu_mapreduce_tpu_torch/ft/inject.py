"""Deterministic fault injection at named sites (the port's copy of
``gpu_mapreduce_tpu/ft/inject.py``).

A chaos run is reproducible bit for bit: each spec arms one or more
registered sites (:data:`SITES`) from a seeded schedule, and the k-th
probe of a site draws the same verdict in every process.

Arming:

* env — ``MRTPU_FAULTS="site=dist.exchange;kind=peer_kill;rank=2"``
  (several specs separated by ``|``; ``site=*`` hits every registered
  site, ``n=K`` caps a spec at K injected faults and ``after=K`` skips a
  site's first K probes — both PER SITE, so wildcard specs stay
  deterministic under thread interleaving; ``rank=R`` arms the spec only
  in the process whose ``MRTPU_DIST_RANK`` is R);
* code — :func:`schedule` with the same fields.

Each spec owns a ``random.Random`` seeded from ``(seed, site)`` (via
crc32, not the salted ``hash()``).  Disarmed, :func:`fault_point` is one
module-bool check.

The registry is the reference's ten sites: the retry layer's six
(``ingest.read``, ``ingest.tokenize``, ``spill.write``, ``spill.read``,
``shuffle.exchange``, ``checkpoint.save``; :mod:`.retry` decides what a
fault there costs) and the process group's four sync points, the
``dist.*`` sites of ``parallel/dist.DistRuntime.guard``.  A spec naming
any other site is refused.

Kinds: ``oserror``/``ioerror``, ``timeout``, ``runtime`` and ``fatal``
raise an exception carrying ``.ft_site`` and subclassing
:class:`InjectedFault`; the process kinds ``peer_kill`` (SIGKILL self),
``peer_hang`` (sleep ``MRTPU_DIST_HANG_S``, default 3600 s, on the sync
path while the heartbeat thread keeps beating) and ``delay`` (sleep
``MRTPU_DIST_DELAY_S``, default 2 s, then go on into the collective)
arm only at an explicit ``dist.*`` site.
"""

from __future__ import annotations

import os
import random
import signal
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional

from ..utils.env import env_knob, env_str

# the retry layer's sites, then the sync points of
# parallel/dist.DistRuntime.guard: the count matrix, the exchange, the
# range exchange of a launcher's finalize step and the checkpoint barrier
SITES = ("ingest.read", "ingest.tokenize", "spill.write", "spill.read",
         "shuffle.exchange", "checkpoint.save",
         "dist.count_sync", "dist.exchange", "dist.reshard",
         "dist.ckpt_barrier")


class InjectedFault:
    """Marker mixin: this exception was injected by ft/, not real."""


class InjectedOSError(InjectedFault, OSError):
    pass


class InjectedTimeout(InjectedFault, TimeoutError):
    pass


class InjectedRuntimeError(InjectedFault, RuntimeError):
    pass


class InjectedFatal(InjectedFault, RuntimeError):
    """kind=fatal: the non-retryable kill switch."""


_KINDS = {"oserror": InjectedOSError, "ioerror": InjectedOSError,
          "timeout": InjectedTimeout, "runtime": InjectedRuntimeError,
          "fatal": InjectedFatal}

# process-level kinds: the PROCESS is the fault, at a dist.* site only
_PROC_KINDS = ("peer_kill", "peer_hang", "delay")


class FaultSpec:
    """One armed schedule entry: which site(s), how often, what to do."""

    __slots__ = ("site", "rate", "kind", "seed", "max_faults", "after",
                 "rank", "_rngs", "injected", "_probes",
                 "_injected_by_site", "_from_env")

    def __init__(self, site: str = "*", rate: float = 1.0,
                 kind: str = "oserror", seed: int = 0,
                 max_faults: Optional[int] = None, after: int = 0,
                 rank: Optional[int] = None):
        if kind not in _KINDS and kind not in _PROC_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(one of {sorted(_KINDS) + list(_PROC_KINDS)})")
        if site != "*" and site not in SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(registered: {SITES})")
        if kind in _PROC_KINDS and not site.startswith("dist."):
            raise ValueError(f"kind={kind} only arms at an explicit "
                             f"dist.* site (got {site!r})")
        self.rank = None if rank is None else int(rank)
        self.site = site
        self.rate = float(rate)
        self.kind = kind
        self.seed = int(seed)
        self.max_faults = max_faults
        self.after = int(after)
        self._rngs: Dict[str, random.Random] = {}
        self.injected = 0
        # per-SITE probe and fault counts: `after` and `n` apply per site
        self._probes: Dict[str, int] = {}
        self._injected_by_site: Dict[str, int] = {}
        self._from_env = False   # an env respec replaces only env specs

    def matches(self, site: str) -> bool:
        if self.site not in ("*", site):
            return False
        return self.rank is None or self.rank == _self_rank()

    def draw(self, site: str) -> bool:
        """Deterministic verdict for the next probe of ``site``."""
        probes = self._probes.get(site, 0) + 1
        self._probes[site] = probes
        if probes <= self.after:
            return False
        if self.max_faults is not None and \
                self._injected_by_site.get(site, 0) >= self.max_faults:
            return False
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(
                (self.seed << 32) ^ zlib.crc32(site.encode()))
        if rng.random() < self.rate:
            self._injected_by_site[site] = \
                self._injected_by_site.get(site, 0) + 1
            return True
        return False


def _self_rank() -> int:
    """This process's rank in the process group (0 outside one), read
    once from the launcher's environment."""
    global _RANK
    if _RANK is None:
        _RANK = env_knob("MRTPU_DIST_RANK", int, 0)
    return _RANK


_RANK: Optional[int] = None

_LOCK = threading.Lock()
_SPECS: List[FaultSpec] = []
_ARMED = False                       # the fault_point fast-path check
_ENV_APPLIED: Optional[str] = None   # last MRTPU_FAULTS string applied
_COUNTS: Dict[str, int] = {}         # site → faults injected


def schedule(site: str = "*", rate: float = 1.0, kind: str = "oserror",
             seed: int = 0, max_faults: Optional[int] = None,
             after: int = 0, rank: Optional[int] = None) -> FaultSpec:
    """Arm one fault spec programmatically; returns it (its ``injected``
    count is live).  :func:`clear_faults` disarms everything."""
    global _ARMED
    spec = FaultSpec(site, rate, kind, seed, max_faults, after, rank)
    with _LOCK:
        _SPECS.append(spec)
        _ARMED = True
    return spec


def clear_faults() -> None:
    """Disarm every spec and drop the injection counts; the next
    :func:`configure_from_env` re-reads the environment."""
    global _ARMED, _ENV_APPLIED
    with _LOCK:
        _SPECS.clear()
        _COUNTS.clear()
        _ARMED = False
        _ENV_APPLIED = None


def armed() -> bool:
    return _ARMED


def armed_for(site: str) -> bool:
    """Whether any armed spec can hit ``site``."""
    if not _ARMED:
        return False
    with _LOCK:
        return any(s.matches(site) for s in _SPECS)


def parse_faults(text: str) -> List[FaultSpec]:
    """``"site=dist.exchange;kind=peer_kill;rank=2"`` → specs.  ``|``
    separates independent specs; ``site`` may list several sites
    comma-separated (one spec each, sharing the other fields)."""
    specs: List[FaultSpec] = []
    for part in text.split("|"):
        part = part.strip()
        if not part:
            continue
        fields = {}
        for kv in part.split(";"):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(f"malformed MRTPU_FAULTS field {kv!r}")
            k, v = kv.split("=", 1)
            fields[k.strip()] = v.strip()
        sites = fields.pop("site", "*").split(",")
        kw = {"rate": float(fields.pop("rate", 1.0)),
              "kind": fields.pop("kind", "oserror"),
              "seed": int(fields.pop("seed", 0)),
              "after": int(fields.pop("after", 0))}
        if "n" in fields:
            kw["max_faults"] = int(fields.pop("n"))
        if "rank" in fields:
            kw["rank"] = int(fields.pop("rank"))
        if fields:
            raise ValueError(f"unknown MRTPU_FAULTS fields "
                             f"{sorted(fields)}")
        for s in sites:
            specs.append(FaultSpec(site=s.strip(), **kw))
    return specs


def configure_from_env() -> None:
    """Apply ``MRTPU_FAULTS`` if it changed since the last look.  A
    malformed value warns on stderr and stays disarmed."""
    global _ARMED, _ENV_APPLIED
    raw = env_str("MRTPU_FAULTS", "")
    if raw == (_ENV_APPLIED or ""):
        return
    try:
        specs = parse_faults(raw) if raw else []
    except (ValueError, TypeError) as e:
        print(f"MRTPU_FAULTS ignored: {e!r}", file=sys.stderr)
        specs = []
    with _LOCK:
        _SPECS[:] = [s for s in _SPECS if not s._from_env]
        for s in specs:
            s._from_env = True
            _SPECS.append(s)
        _ARMED = bool(_SPECS)
        _ENV_APPLIED = raw


def fault_point(site: str, **detail) -> None:
    """Probe a registered site: raise the scheduled fault, run the
    scheduled process fault, or return."""
    if not _ARMED:
        return
    with _LOCK:
        for spec in _SPECS:
            if spec.matches(site) and spec.draw(site):
                spec.injected += 1
                _COUNTS[site] = _COUNTS.get(site, 0) + 1
                kind = spec.kind
                exc_cls = _KINDS.get(kind)
                break
        else:
            return
    if exc_cls is None:
        _proc_fault(kind, site)
        return
    exc = exc_cls(f"injected {kind} fault at {site}"
                  + (f" ({detail})" if detail else ""))
    exc.ft_site = site
    from ..obs import get_tracer
    with get_tracer().span("ft.inject", cat="ft", site=site, kind=kind):
        raise exc


def _proc_fault(kind: str, site: str) -> None:
    """A rank SIGKILLed, wedged, or slow exactly AT a sync point."""
    print(f"ft.inject: {kind} at {site} (rank {_self_rank()}, "
          f"pid {os.getpid()})", file=sys.stderr, flush=True)
    if kind == "peer_kill":
        os.kill(os.getpid(), signal.SIGKILL)
        return                      # unreachable
    if kind == "delay":
        time.sleep(env_knob("MRTPU_DIST_DELAY_S", float, 2.0))
        return
    # peer_hang: on the sync path, so this rank's heartbeat thread keeps
    # beating and survivors must trip on their sync deadline
    time.sleep(env_knob("MRTPU_DIST_HANG_S", float, 3600.0))


def counts() -> Dict[str, int]:
    """{site: faults injected so far} (process-cumulative)."""
    with _LOCK:
        return dict(_COUNTS)
