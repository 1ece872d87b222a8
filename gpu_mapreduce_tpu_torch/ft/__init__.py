"""Fault tolerance (the port's ``gpu_mapreduce_tpu/ft``), in three parts:

* deterministic fault injection (:mod:`.inject`): named fault points at
  the real failure sites, armed by a seeded schedule (``MRTPU_FAULTS`` or
  :func:`schedule`), one bool check when disarmed;
* the retry policy (:mod:`.retry`): transient or fatal, bounded retries
  with seeded backoff (``MRTPU_RETRY``), the ``onfault`` setting
  (``fail`` | ``retry`` | ``skip`` with quarantine), ``MRError`` on
  exhaustion; a failure of the card is always fatal;
* the op journal (:mod:`.journal`): ``MRTPU_JOURNAL=dir``, checkpoints
  every ``MRTPU_CKPT_EVERY`` commands, and :func:`resume` / the OINK
  ``resume <dir>`` replaying a killed script from its last checkpoint.

A fault schedule the budgets absorb leaves the output byte for byte that
of the fault-free run.  The counters are process-wide (the worlds of a
``-partition`` run share them) and ``mr.stats()["ft"]`` reads them
(:func:`ft_stats`).
"""

from __future__ import annotations

from .inject import (SITES, FaultSpec, InjectedFault, InjectedFatal,
                     armed, armed_for, clear_faults,
                     counts as fault_counts, fault_point, parse_faults,
                     schedule)
from .journal import Journal, latest_checkpoint, read_journal, resume
from .retry import (budget, classify, device_error, ingest_task,
                    parse_retry, quarantine_snapshot, retries_snapshot,
                    retry_call, set_budget)

__all__ = [
    "SITES", "FaultSpec", "InjectedFault", "InjectedFatal",
    "armed", "armed_for", "schedule", "clear_faults", "fault_point",
    "parse_faults", "fault_counts",
    "retry_call", "set_budget", "budget", "classify", "device_error",
    "parse_retry", "ingest_task", "retries_snapshot",
    "quarantine_snapshot",
    "Journal", "resume", "read_journal", "latest_checkpoint",
    "configure_from_env", "ft_stats", "counters_snapshot", "reset",
]


def configure_from_env() -> None:
    """Apply ``MRTPU_FAULTS`` / ``MRTPU_RETRY`` / ``MRTPU_JOURNAL`` when
    they changed (every ``MapReduce()`` construction)."""
    from . import inject as _inject, journal as _journal, retry as _retry
    _inject.configure_from_env()
    _retry.configure_from_env()
    _journal.configure_from_env()


def counters_snapshot() -> dict:
    """The raw cumulative counters: retries by (site, outcome), faults
    and quarantines by site."""
    from . import inject as _inject, retry as _retry
    q = _retry.quarantine_snapshot()
    return {"retries": _retry.retries_snapshot(),
            "faults": _inject.counts(),
            "quarantined": q["by_site"]}


def ft_stats() -> dict:
    """The ``mr.stats()["ft"]`` section: retry outcomes per site, faults
    injected per site, quarantine accounting, budgets, journal
    progress."""
    from . import inject as _inject, journal as _journal, retry as _retry
    retries: dict = {}
    for (site, outcome), n in _retry.retries_snapshot().items():
        retries.setdefault(site, {})[outcome] = n
    j = _journal.active()
    return {"retries": retries,
            "faults_injected": _inject.counts(),
            "quarantined": _retry.quarantine_snapshot(),
            "budgets": {s: _retry.budget(s) for s in SITES
                        if _retry.budget(s)},
            "journal": j.stats() if j is not None else None}


def reset() -> None:
    """Disarm injection, drop budgets, counters and quarantine, close the
    active journal."""
    from . import inject as _inject, journal as _journal, retry as _retry
    _inject.clear_faults()
    _retry.reset()
    _journal.reset()
