"""The recorder: defer op calls into PlanStage nodes (the counterpart of
``gpu_mapreduce_tpu/plan/recorder.py``).

Entered two ways:

* explicitly — ``with mr.pipeline(): ...`` records every deferrable op
  in the block and fuses+executes at exit (or earlier, at any barrier);
* implicitly — ``Settings.fuse=1`` (or ``MRTPU_FUSE=1``): the first
  deferrable op auto-opens a recorder; any barrier (map, gather, scan,
  user-callback ops, direct ``mr.kv``/``mr.kmv`` reads, ...) flushes
  it.  Only side-effect-free ops defer at all —
  see ``core.mapreduce._defer_ok``.

Deferred ops can't return their real global pair counts (nothing ran
yet), so they return a :class:`PendingCount` — an int-like proxy that
flushes the plan the moment the number is actually *looked at* (int(),
comparison, arithmetic, str).  Code that ignores the return value — the
normal pipeline shape — pays nothing.
"""

from __future__ import annotations

from typing import List

from ..core.runtime import MRError
from .ir import Plan, PlanStage, snapshot_settings


class PendingCount:
    """Lazy stand-in for a deferred op's global pair/group count.
    Coercing it (int/float/index/comparison/arithmetic/str) flushes the
    owning plan and yields the real count."""

    __slots__ = ("_mr", "_stage")

    def __init__(self, mr, stage: PlanStage):
        self._mr = mr
        self._stage = stage

    def _resolve(self) -> int:
        self._mr._flush_plan()
        r = self._stage.result
        if r is None:
            # the stage never executed — its pipeline() block aborted
            # and discarded it; a silent 0 would look like a real count
            raise MRError(f"deferred {self._stage.op} was discarded before "
                          "executing (its pipeline aborted)")
        return int(r)

    def __int__(self):
        return self._resolve()

    __index__ = __int__

    def __float__(self):
        return float(self._resolve())

    def __bool__(self):
        return bool(self._resolve())

    def __eq__(self, other):
        return self._resolve() == other

    def __ne__(self, other):
        return self._resolve() != other

    def __lt__(self, other):
        return self._resolve() < other

    def __le__(self, other):
        return self._resolve() <= other

    def __gt__(self, other):
        return self._resolve() > other

    def __ge__(self, other):
        return self._resolve() >= other

    def __hash__(self):
        return hash(self._resolve())

    def __add__(self, other):
        return self._resolve() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self._resolve() - other

    def __rsub__(self, other):
        return other - self._resolve()

    def __mul__(self, other):
        return self._resolve() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._resolve() / other

    def __rtruediv__(self, other):
        return other / self._resolve()

    def __floordiv__(self, other):
        return self._resolve() // other

    def __rfloordiv__(self, other):
        return other // self._resolve()

    def __mod__(self, other):
        return self._resolve() % other

    def __rmod__(self, other):
        return other % self._resolve()

    def __divmod__(self, other):
        return divmod(self._resolve(), other)

    def __rdivmod__(self, other):
        return divmod(other, self._resolve())

    def __neg__(self):
        return -self._resolve()

    def __pos__(self):
        return self._resolve()

    def __abs__(self):
        return abs(self._resolve())

    def __str__(self):
        return str(self._resolve())

    def __repr__(self):
        return repr(self._resolve())

    def __format__(self, spec):
        return format(self._resolve(), spec)


class PlanRecorder:
    """Collects deferred stages for one MapReduce object.  ``auto``
    recorders (Settings.fuse) uninstall themselves at flush; explicit
    ``mr.pipeline()`` recorders stay installed so ops after a
    mid-pipeline barrier keep recording."""

    def __init__(self, mr, auto: bool = False):
        self.mr = mr
        self.auto = auto
        self.stages: List[PlanStage] = []

    def record(self, op: str, args: tuple, kw: dict) -> PendingCount:
        stage = PlanStage(op=op, args=tuple(args), kw=dict(kw),
                          settings=snapshot_settings(self.mr.settings))
        self.stages.append(stage)
        return PendingCount(self.mr, stage)

    def flush(self) -> None:
        """Fuse + execute everything recorded so far.  Re-entrant: the
        stage list is swapped out first, so replayed ops that hit a
        barrier (and call _flush_plan again) see an empty recorder."""
        stages, self.stages = self.stages, []
        if not stages:
            return
        from .fuser import execute_plan
        execute_plan(self.mr, Plan(stages))
