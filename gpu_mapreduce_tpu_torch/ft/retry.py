"""Retry and backoff policy for the registered fault sites (the port's
copy of ``gpu_mapreduce_tpu/ft/retry.py``).

Every site of the retry layer (:data:`..ft.inject.SITES`) gets a
bounded-retry policy:

* **budgets**: ``MRTPU_RETRY="ingest.read=3,spill.read=2"`` (or a bare
  ``MRTPU_RETRY=3`` for every site), or :func:`set_budget`.  Budget 0
  (the default) runs the call bare.  An env respec replaces only the
  budgets the env set.
* **classification** (:func:`classify`): transient (OS, timeout and
  connection errors, injected faults) or fatal (everything else:
  ``MRError``, ``FileNotFoundError``, ``kind=fatal`` injections, and
  every error of the card: :func:`device_error`).
* **backoff**: ``base * 2^k``, capped, times a seeded jitter in
  [0.5, 1.0) (``MRTPU_RETRY_BACKOFF`` base seconds,
  ``MRTPU_RETRY_BACKOFF_MAX`` cap; tests patch :data:`_sleep`).
* **exhaustion**: ``MRError`` naming the site, the attempts and the last
  error, chained to it.

:func:`ingest_task` adds the ``onfault`` setting: every attempt of a map
task writes a private ``_TaskSink`` that is published only on success,
so a retry never duplicates or reorders the pairs of a partial attempt;
a raw ``OSError`` from a file task becomes an ``MRError`` naming the
file, shard and task; ``onfault="skip"`` quarantines the input.

A failure of the card is never retried, never quarantined and never
answered by a plain version: a CUDA error, ``torch.cuda.OutOfMemoryError``
and a kernel that did not build, load or launch
(``core.runtime.DeviceError``) are fatal under every budget.

Counts: retries by ``(site, outcome)`` (``retry`` a re-attempt,
``recovered``, ``exhausted``, ``fatal``), quarantines by site with the
last :data:`_QUARANTINE_KEEP` records; ``mr.stats()["ft"]`` reads them.
"""

from __future__ import annotations

import random
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core.runtime import DeviceError, MRError
from . import inject

_sleep = time.sleep          # patched by the backoff tests

_LOCK = threading.Lock()
_BUDGETS: Dict[str, int] = {}        # site → max retries (not attempts)
_DEFAULT_BUDGET = 0                  # for sites not listed
_ENV_APPLIED: Optional[str] = None
_ENV_SITES: set = set()              # budget keys MRTPU_RETRY set
_ENV_DEFAULT = False
# (site, outcome) → count; outcomes: retry / recovered / exhausted / fatal
_RETRIES: Dict[tuple, int] = {}
_QUARANTINE: List[dict] = []         # the skipped inputs' records
_QUARANTINE_KEEP = 64                # records kept (the count is exact)
_NQUAR: Dict[str, int] = {}          # site → inputs quarantined
_JITTER = random.Random(0xF7A11)     # seeded: backoff is reproducible


def set_budget(site: str, retries: int) -> None:
    """Allow ``retries`` re-attempts at ``site`` (``"*"``: the default
    of every site); a later ``MRTPU_RETRY`` change leaves it."""
    global _DEFAULT_BUDGET, _ENV_DEFAULT
    if site != "*" and site not in inject.SITES:
        raise ValueError(f"unknown retry site {site!r} "
                         f"(registered: {inject.SITES})")
    with _LOCK:
        if site == "*":
            _DEFAULT_BUDGET = int(retries)
            _ENV_DEFAULT = False
        else:
            _BUDGETS[site] = int(retries)
            _ENV_SITES.discard(site)


def budget(site: str) -> int:
    with _LOCK:
        return _BUDGETS.get(site, _DEFAULT_BUDGET)


def parse_retry(text: str) -> Dict[str, int]:
    """``"ingest.read=3,spill.read=2"`` (or bare ``"3"``) → budgets; an
    unknown site raises."""
    out: Dict[str, int] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            site, n = part.split("=", 1)
            site = site.strip()
            if site != "*" and site not in inject.SITES:
                raise ValueError(f"unknown retry site {site!r} "
                                 f"(registered: {inject.SITES})")
            out[site] = int(n)
        else:
            out["*"] = int(part)
    return out


def configure_from_env() -> None:
    """Apply ``MRTPU_RETRY`` when it changed; a malformed value warns on
    stderr and disarms.  Only env-set budgets are replaced."""
    global _ENV_APPLIED, _DEFAULT_BUDGET, _ENV_DEFAULT
    from ..utils.env import env_str
    raw = env_str("MRTPU_RETRY", "")
    if raw == (_ENV_APPLIED or ""):
        return
    try:
        budgets = parse_retry(raw) if raw else {}
    except (ValueError, TypeError) as e:
        print(f"MRTPU_RETRY ignored: {e!r}", file=sys.stderr)
        budgets = {}
    with _LOCK:
        for site in _ENV_SITES:
            _BUDGETS.pop(site, None)
        _ENV_SITES.clear()
        if _ENV_DEFAULT:
            _DEFAULT_BUDGET = 0
            _ENV_DEFAULT = False
        if "*" in budgets:
            _DEFAULT_BUDGET = budgets.pop("*")
            _ENV_DEFAULT = True
        _BUDGETS.update(budgets)
        _ENV_SITES.update(budgets)
        _ENV_APPLIED = raw


def _backoff(attempt: int) -> float:
    """Delay before retry ``attempt`` (0-based): exponential, capped,
    jittered into [0.5, 1.0)×."""
    from ..utils.env import env_knob
    base = env_knob("MRTPU_RETRY_BACKOFF", float, 0.05)
    cap = env_knob("MRTPU_RETRY_BACKOFF_MAX", float, 2.0)
    return min(cap, base * (2.0 ** attempt)) * (0.5 + 0.5 * _JITTER.random())


def device_error(exc: BaseException) -> bool:
    """Whether ``exc`` is a failure of the card: a kernel that did not
    build, load or launch, an out-of-memory on the card, or a CUDA
    error torch raised."""
    if isinstance(exc, DeviceError):
        return True
    torch = sys.modules.get("torch")
    if torch is not None:
        for name in ("OutOfMemoryError", "CudaError"):
            cls = getattr(torch.cuda, name, None)
            if isinstance(cls, type) and isinstance(exc, cls):
                return True
        cls = getattr(torch, "AcceleratorError", None)
        if isinstance(cls, type) and isinstance(exc, cls):
            return True
    return isinstance(exc, RuntimeError) and \
        str(exc).startswith(("CUDA error", "CUDA out of memory",
                             "CUDA driver error"))


def classify(site: str, exc: BaseException) -> str:
    """``"transient"`` (a retry may help) or ``"fatal"`` (it will not)."""
    if device_error(exc):
        return "fatal"
    if isinstance(exc, inject.InjectedFatal):
        return "fatal"
    if isinstance(exc, inject.InjectedFault):
        return "transient"
    if isinstance(exc, MRError):
        return "fatal"
    if isinstance(exc, (FileNotFoundError, IsADirectoryError,
                        NotADirectoryError)):
        # a missing input stays missing: never burn the budget on it
        return "fatal"
    if isinstance(exc, (OSError, TimeoutError, ConnectionError)):
        return "transient"
    return "fatal"


def _count(site: str, outcome: str) -> None:
    with _LOCK:
        _RETRIES[(site, outcome)] = _RETRIES.get((site, outcome), 0) + 1
    # the same outcome on the active request account (obs/context.py)
    try:
        from ..obs.context import note_retry
        note_retry(site, outcome)
    except Exception:
        pass


def retry_call(site: str, fn: Callable, *, detail: str = "",
               retryable: Optional[Callable[[BaseException], bool]] = None,
               budget_override: Optional[int] = None):
    """Run ``fn()`` under ``site``'s retry policy.  Budget 0 calls
    straight through.  ``retryable``: a per-call veto (the input of an
    exchange must still be whole); ``budget_override``: a budget the
    caller computed (the ingest paths' ``onfault`` default)."""
    b = budget(site) if budget_override is None else budget_override
    if b <= 0:
        return fn()
    try:
        return fn()
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as first:
        return _retry_tail(site, fn, first, b, detail, retryable)


def _retry_tail(site: str, fn: Callable, first: BaseException, b: int,
                detail: str, retryable) -> object:
    """After a first failure: classify, then retry with backoff until a
    success, a fatal error or the budget's end, all under one
    ``ft.retry`` span (JAX :204-246)."""
    from ..obs import get_tracer
    with get_tracer().span("ft.retry", cat="ft", site=site,
                           detail=detail) as sp:
        e = first
        attempt = 0
        while True:
            s = getattr(e, "ft_site", site)   # an injected fault knows its site
            if classify(s, e) == "fatal" or \
                    (retryable is not None and not retryable(e)):
                _count(s, "fatal")
                sp.set(site=s, outcome="fatal", attempts=attempt)
                raise e
            if attempt >= b:
                _count(s, "exhausted")
                sp.set(site=s, outcome="exhausted", attempts=attempt,
                       last_error=type(e).__name__)
                err = MRError(
                    f"ft: {s} retry budget exhausted after "
                    f"{attempt + 1} attempts"
                    + (f" ({detail})" if detail else "")
                    + f": {e!r}")
                err.ft_site = s    # a quarantine downstream keeps the site
                raise err from e
            _sleep(_backoff(attempt))
            _count(s, "retry")
            attempt += 1
            try:
                out = fn()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e2:
                e = e2
                continue
            _count(s, "recovered")
            sp.set(site=s, outcome="recovered", attempts=attempt)
            return out


# ---------------------------------------------------------------------------
# the ingest task wrapper: onfault policy, MRError wrapping, quarantine
# ---------------------------------------------------------------------------

def quarantine(site: str, **record) -> None:
    """Record one skipped input (counted exactly; the last
    :data:`_QUARANTINE_KEEP` records kept), stamped with the active
    request's trace id (``obs/context.py``)."""
    try:
        from ..obs.context import current_trace_id
        tid = current_trace_id()
    except Exception:
        tid = None
    if tid is not None:
        record.setdefault("trace", tid)
    with _LOCK:
        _NQUAR[site] = _NQUAR.get(site, 0) + 1
        _QUARANTINE.append({"site": site, **record})
        del _QUARANTINE[:-_QUARANTINE_KEEP]
    from ..obs import get_tracer
    get_tracer().annotate(ft_quarantined=record.get("task"))


def ingest_active(onfault: str = "fail") -> bool:
    """Whether the ingest paths need the buffered attempts: injection
    armed at an ingest site, an ingest budget, or ``onfault`` other than
    ``fail``.  False is the unchanged fast path.  A map decides once for
    all its tasks (the ``active`` argument of :func:`ingest_task`)."""
    return (onfault != "fail"
            or (inject.armed() and (inject.armed_for("ingest.read")
                                    or inject.armed_for("ingest.tokenize")))
            or ((bool(_BUDGETS) or _DEFAULT_BUDGET > 0)
                and (budget("ingest.read") > 0
                     or budget("ingest.tokenize") > 0)))


def _ingest_budget(onfault: str) -> int:
    b = max(budget("ingest.read"), budget("ingest.tokenize"))
    if b == 0 and onfault == "retry":
        b = 2       # onfault=retry without a budget: 2 retries
    return b


def input_unreadable(e: OSError, file=None) -> MRError:
    """An ``OSError`` of input discovery as an ``MRError`` naming the
    file."""
    name = file if file is not None else getattr(e, "filename", None)
    if name is None and e.args and isinstance(e.args[0], str):
        name = e.args[0]      # findfiles raises FileNotFoundError(path)
    err = MRError(f"map input file {name!r} unreadable: {e!r}")
    err.ft_site = "ingest.read"
    return err


def quarantine_or_raise(e: OSError, file, onfault: str,
                        shard=None) -> bool:
    """A discovery-time failure gets the task-time disposition:
    quarantined under ``onfault="skip"`` (True: the caller drops the
    file), else the wrapping ``MRError``."""
    if onfault == "skip" and _skippable(e):
        quarantine("ingest.read", file=file, shard=shard,
                   error=repr(e)[:200])
        return True
    raise input_unreadable(e, file) from e


def _skippable(e: BaseException) -> bool:
    """What ``onfault="skip"`` may quarantine: per-input failures, never
    the injected kill switch, resource exhaustion or the card."""
    return not (isinstance(e, (inject.InjectedFatal, MemoryError))
                or device_error(e))


def _where(itask, fname, shard) -> str:
    out = f"task {itask}"
    if shard is not None:
        out += f", shard {shard}"
    if fname is not None:
        out += f", file {fname!r}"
    return out


def ingest_task(call: Callable, itask: int, payload, out, *,
                onfault: str = "fail", shard: Optional[int] = None,
                private_sink: bool = True, active: Optional[bool] = None):
    """Run one map task ``call(itask, payload, sink)`` under the ingest
    fault policy.  ``out`` is the task's own ``_TaskSink``
    (``private_sink=True``) or the live ``KeyValue``; each attempt writes
    a fresh sink on ``out``'s device, published only on success.
    ``active``: :func:`ingest_active`, as the caller found it for the
    whole map (None: look now)."""
    fname = payload if isinstance(payload, str) else None
    if not (ingest_active(onfault) if active is None else active):
        try:
            return call(itask, payload, out)
        except OSError as e:
            if fname is None:
                raise   # not a file task: the callback's own OSError
            raise MRError(f"map input {_where(itask, fname, shard)} "
                          f"failed: {e}") from e
    from ..core.mapreduce import _TaskSink
    where = _where(itask, fname, shard)
    device = getattr(out, "device", None)

    def attempt():
        inject.fault_point("ingest.read", task=itask)
        tmp = _TaskSink(device)
        call(itask, payload, tmp)
        inject.fault_point("ingest.tokenize", task=itask)
        return tmp

    b = _ingest_budget(onfault)
    try:
        try:
            tmp = attempt()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as first:
            if b <= 0:
                raise   # no policy: the error as it was, never "exhausted"
            tmp = _retry_tail("ingest.read", attempt, first, b, where, None)
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as e:
        if onfault == "skip" and _skippable(e):
            quarantine(getattr(e, "ft_site", "ingest.read"), task=itask,
                       shard=shard, file=fname, error=repr(e)[:200])
            return None
        if isinstance(e, OSError) and fname is not None:
            raise MRError(f"map input {where} failed: {e}") from e
        raise
    if private_sink:
        out._calls[:] = tmp._calls
    else:
        tmp.replay(out)
    return None


def ingest_read(fn: Callable, *, file: Optional[str] = None,
                onfault: str = "fail", shard: Optional[int] = None):
    """A host read outside a task callback (the chunk maps' file reads)
    under the :func:`ingest_task` policy; None when the file was
    quarantined."""
    def attempt():
        inject.fault_point("ingest.read", file=file)
        return fn()

    try:
        b = _ingest_budget(onfault) if ingest_active(onfault) else 0
        if b <= 0:
            return attempt() if inject.armed_for("ingest.read") else fn()
        return retry_call("ingest.read", attempt,
                          detail=str(file or ""), budget_override=b)
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as e:
        if onfault == "skip" and _skippable(e):
            quarantine(getattr(e, "ft_site", "ingest.read"), shard=shard,
                       file=file, error=repr(e)[:200])
            return None
        if isinstance(e, OSError):
            raise input_unreadable(e, file) from e
        raise


# ---------------------------------------------------------------------------
# stats / isolation
# ---------------------------------------------------------------------------

def retries_snapshot() -> Dict[tuple, int]:
    with _LOCK:
        return dict(_RETRIES)


def quarantine_snapshot() -> dict:
    with _LOCK:
        return {"count": sum(_NQUAR.values()), "by_site": dict(_NQUAR),
                "records": list(_QUARANTINE)}


def reset() -> None:
    """Budgets, counters, quarantine and the env cache back to start."""
    global _DEFAULT_BUDGET, _ENV_APPLIED, _ENV_DEFAULT
    with _LOCK:
        _BUDGETS.clear()
        _RETRIES.clear()
        _QUARANTINE.clear()
        _NQUAR.clear()
        _ENV_SITES.clear()
        _DEFAULT_BUDGET = 0
        _ENV_APPLIED = None
        _ENV_DEFAULT = False
