"""plan/ — the lazy pipeline planner.

The counterpart of ``gpu_mapreduce_tpu/plan/``.  Under ``fuse=1``
(``MRTPU_FUSE=1``) or inside ``with mr.pipeline():`` the side-effect-free
ops are recorded instead of run (:mod:`.recorder`, :mod:`.ir`); at a
barrier the fuser (:mod:`.fuser`) runs ``[convert, reduce(kernel)]`` (and
on a mesh ``[aggregate, convert(, reduce)]``) as one fused group and
replays everything else eagerly, and the plan cache (:mod:`.cache`)
carries what a run learned into the next one, and with a content store
(``MRTPU_CAS_DIR``) into the next process::

    with mr.pipeline():
        mr.aggregate()
        mr.convert()
        mr.reduce(count, batch=True)
"""

from .cache import LRUCache, clear_history, plan_cache, plan_history
from .ir import Plan, PlanStage
from .recorder import PendingCount, PlanRecorder

__all__ = ["Plan", "PlanStage", "PlanRecorder", "PendingCount", "LRUCache",
           "plan_cache", "plan_history", "clear_history"]
