"""Fault tolerance (the port's ``gpu_mapreduce_tpu/ft``): for now only the
deterministic fault injection of :mod:`.inject`, armed at the process
group's sync points (``dist.*``).  The retry policy, the journal and
``resume`` are not ported yet (ROADMAP.md, item 5)."""

from __future__ import annotations

from .inject import (SITES, FaultSpec, InjectedFault, InjectedFatal,
                     armed, armed_for, clear_faults, configure_from_env,
                     counts as fault_counts, fault_point, parse_faults,
                     schedule)

__all__ = ["SITES", "FaultSpec", "InjectedFault", "InjectedFatal",
           "armed", "armed_for", "clear_faults", "configure_from_env",
           "fault_counts", "fault_point", "parse_faults", "schedule"]
