"""The fuser: run a recorded stage chain with fused groups (the one-device
subset of ``gpu_mapreduce_tpu/plan/fuser.py``).

Walks the plan front to back against the live dataset.  On one device the
aggregate is the P=1 early-out and replays eagerly; ``[convert,
reduce(kernel, batch)]`` over a device frame runs as one local group,
``parallel/group.fused_group_body``:

* cold (no cached state): the sort path at full row capacity; the output
  is cut down to the group count's power of two when that shrinks it ≥4×,
  and the plan's cache entry is armed with that group capacity
  (``CompiledPlan.mega[gidx] = ("l", gcap)``);
* warm: the group runs at the cached gcap and, for a supported chain
  (``ops/cuda/group.group_supported``, ``MRTPU_PALLAS_GROUP``), on the
  group table with T = ``table_slots(gcap)``.  If the table overflowed or
  the groups outgrew gcap, the result is thrown away, the entry popped,
  and the group runs again cold.

A host frame reaching a group is placed on the device first, byte and
object columns interned (``_device_state``, as the eager aggregate does);
a group whose reduce would do arithmetic on interned values replays
eagerly so the eager refusal raises (``_reduce_value_ok``).  Intern tables
ride on the group's output.

Under ``outofcore=1`` nothing fuses (``_device_state``): the page
budget's spill and external paths are eager.  Every other stage replays
through the ordinary op.  Left out against the
JAX fuser: the exchange and megafused groups (P>1), the wire codec, the
persistent plan tier, buffer donation, the fault-retry wrapper and the
tracer spans.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .cache import plan_cache, record_history
from .ir import Plan, PlanStage, frame_signature


@dataclass
class CompiledPlan:
    """Cached state of one (fingerprint, frame, device) plan: per group,
    the capacity a warm run uses — gidx → ("l", gcap)."""
    mega: dict = field(default_factory=dict)


def _kernel_op(fn) -> Optional[str]:
    """Registered kernel reduce → segment-op name (None = host tier)."""
    from ..ops import reduces
    table = {reduces.count: "count", reduces.sum_values: "sum",
             reduces.max_values: "max", reduces.min_values: "min",
             reduces.cull: "first"}
    return table.get(fn)


def _reduce_stage_op(st: PlanStage) -> Optional[str]:
    """Fusible reduce stage → segment-op name, else None."""
    if st.op != "reduce" or not st.args:
        return None
    if not (st.kw.get("batch") or (len(st.args) > 2 and st.args[2])):
        return None
    return _kernel_op(st.args[0])


def _device_state(mr):
    """The live frame a fused group would consume, placed on mr's device
    (byte and object columns interned) and installed as the KV's frame,
    as the eager aggregate places it; or None (eager).  The fuser never
    fuses across a spill boundary, so under ``outofcore=1`` (where pages
    spill and a device KV over the budget demotes) every stage runs
    eagerly."""
    kv = mr._kv_data
    if kv is None or not kv.complete_done or mr._open \
            or mr.settings.outofcore == 1 or not kv.nkv:
        return None
    from ..parallel.sharded import ShardedKV
    frames = kv._frames
    if len(frames) == 1 and isinstance(frames[0], ShardedKV):
        return frames[0]
    skv = mr.backend.place_kv(kv)
    kv.replace_frames(skv)
    return skv


def _reduce_value_ok(frame, rop: str) -> bool:
    """Arithmetic on interned value ids is meaningless: the eager
    reduce refuses it, so such a group replays eagerly and the same
    error surfaces from the same code path."""
    return rop in ("count", "first") or frame.value_decode is None


def _match_group(mr, stages, i):
    """(n_stages, reduce_op, frame) of the local group starting at stage
    i, or (1, None, None) → eager replay."""
    from ..parallel.sharded import ShardedKV
    if stages[i].op == "convert" and i + 1 < len(stages):
        rop = _reduce_stage_op(stages[i + 1])
        frame = _device_state(mr) if rop is not None else None
        if isinstance(frame, ShardedKV) and _reduce_value_ok(frame, rop):
            return 2, rop, frame
    return 1, None, None


def _table_cfg_for(skv, reduce_op, gcap: int):
    """``("tbl", T)`` for the group table, or None → sort path (the knob
    is off, or the chain is unsupported: warn once)."""
    from ..ops.cuda import group as tgroup
    if not tgroup.table_group_enabled(skv.device):
        return None
    ok, reason = tgroup.group_supported(skv, "kv", reduce_op)
    if not ok:
        tgroup.warn_fallback(reason)
        return None
    return ("tbl", tgroup.table_slots(gcap))


def _gcap_for(g: int, cap: int) -> int:
    """The group capacity a warm run uses: the power of two of the group
    count, at most the row capacity."""
    from ..parallel.sharded import round_cap
    return min(round_cap(max(g, 1)), cap)


def _maybe_compact(cap: int, g: int, *arrs):
    """Cut group-indexed outputs down to round_cap(g) when that shrinks
    them ≥4× (a copy, so the row-capacity buffers are freed)."""
    from ..parallel.sharded import round_cap
    n = round_cap(max(g, 1))
    if n * 4 > cap:
        return arrs
    return tuple(a[:n].clone() for a in arrs)


def _install_kv(mr, skv) -> None:
    """Replace mr's dataset with a fused group's output."""
    if mr._kmv_data is not None:
        mr._kmv_data.free()
        mr._kmv_data = None
    old = mr._kv_data
    newkv = mr._new_kv()
    newkv.add_frame(skv)
    newkv.complete()
    if old is not None:
        old.free()
    mr._kv_data = newkv


def _exec_local_group(mr, stages, reduce_op, compiled: CompiledPlan,
                      gidx: int, frame) -> tuple:
    """Run [convert, reduce(kernel)] on a device frame as one group.
    Returns ``(mode, table)``: mode "local" (cold) or "local1" (warm at
    the cached capacity), and whether the group table ran."""
    from ..core.runtime import bump_dispatch
    from ..parallel.group import fused_group_body
    from ..parallel.sharded import ShardedKV
    skv = frame
    cap, nrecv = skv.cap, int(skv.counts[0])
    entry = compiled.mega.get(gidx)
    gcap = entry[1] if entry is not None else None
    cfg = _table_cfg_for(skv, reduce_op, gcap) if gcap is not None \
        else None

    def run(gc, tcfg):
        bump_dispatch()
        return fused_group_body(skv.key, skv.value, nrecv, gc, "kv",
                                reduce_op, skv.key_dtype, skv.value_dtype,
                                tcfg)

    ukey, uval, (g, _n, overflow) = run(gcap or cap, cfg)
    if gcap is not None and (overflow or g > gcap):
        # the cached capacity no longer covers: discard, run cold
        compiled.mega.pop(gidx, None)
        gcap, cfg = None, None
        ukey, uval, (g, _n, overflow) = run(cap, None)
    if gcap is None:
        ukey, uval = _maybe_compact(cap, g, ukey, uval)
        compiled.mega[gidx] = ("l", _gcap_for(g, cap))
    vdt = np.dtype(np.int64) if reduce_op == "count" else skv.value_dtype
    _install_kv(mr, ShardedKV(ukey, uval, np.array([g], np.int32),
                              skv.key_dtype, vdt, skv.key_decode,
                              skv.value_decode if reduce_op == "first"
                              else None))
    stages[0].result = g
    stages[1].result = g
    return ("local" if gcap is None else "local1"), cfg is not None


def _replay(mr, stage: PlanStage) -> None:
    """Eager fallback: run one recorded stage through the ordinary op,
    under the settings snapshot taken at record time."""
    saved = mr.settings
    if stage.settings is not None:
        mr.settings = stage.settings
    mr._plan_replaying = True
    try:
        stage.result = getattr(mr, stage.op)(*stage.args, **stage.kw)
    finally:
        mr._plan_replaying = False
        mr.settings = saved


def execute_plan(mr, plan: Plan) -> None:
    """Fuse + run a recorded plan against mr's current dataset.  The
    cache key is (fingerprint, frame signature, ("device", device))."""
    kv = mr._kv_data
    frame = kv._frames[0] if kv is not None and kv.complete_done \
        and kv._frames else None
    try:
        key = (plan.fingerprint(), frame_signature(frame),
               ("device", str(mr.device)))
        compiled = plan_cache().get(key)
    except TypeError:       # an unhashable stage argument: run uncached
        key, compiled = None, None
    cache_hit = compiled is not None
    if compiled is None:
        compiled = CompiledPlan()
        if key is not None:
            plan_cache().put(key, compiled)
    groups_desc = []
    stages = list(plan.stages)
    i = gidx = 0
    while i < len(stages):
        n, rop, frame = _match_group(mr, stages, i)
        run = stages[i:i + n]
        mode, table = "eager", False
        if rop is None:
            _replay(mr, run[0])
        else:
            mode, table = _exec_local_group(mr, run, rop, compiled, gidx,
                                            frame)
        groups_desc.append({"stages": [s.describe() for s in run],
                            "fused": rop is not None, "reduce_op": rop,
                            "mode": mode, "table": table})
        i += n
        gidx += 1
    record_history({"stages": plan.describe(), "groups": groups_desc,
                    "cache_hit": cache_hit})
