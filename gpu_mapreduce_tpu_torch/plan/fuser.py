"""The fuser: run a recorded stage chain with fused groups (the
counterpart of ``gpu_mapreduce_tpu/plan/fuser.py``).

Walks the plan front to back against the live dataset and runs each
fusible run of stages as one group:

* ``[aggregate, convert(, reduce(kernel, batch))]`` on a mesh of P > 1
  is an exchange group (``_exec_exchange_group``): phase 1 of the
  exchange and its count- and stats-matrix pull
  (``parallel/shuffle.phase1``), the one planning step the eager
  exchange takes (``wire.plan_from_pull``, under the wire codec unless
  ``MRTPU_WIRE=0``), then phase 2 (packed columns decoded at the
  destination under a wire plan) and the group body
  (``parallel/group.fused_group_shards``) on every shard.  Without a
  kernel reduce the group ends in a grouped KMV.
* ``[convert, reduce(kernel, batch)]`` on a device frame, of one device
  or a mesh, is a local group (``_exec_local_group``): the group body on
  every shard.

Both kinds run cold or warm:

* cold (no cached state): the sort path at full capacity (an exchange
  group at the plan's ``cap_out``, a local group at the frame's cap);
  group-indexed outputs are cut down to the power of two of the largest
  shard's group count when that shrinks them ≥4×, and the plan's cache
  entry is armed: ``CompiledPlan.caps[gidx]`` with the exchange plan,
  ``CompiledPlan.mega[gidx]`` with ``("x", plan, gcap)`` or
  ``("l", gcap)``;
* warm: the cached plan and the cached mesh-wide gcap, and for a
  supported chain (``ops/cuda/group.group_supported``,
  ``MRTPU_PALLAS_GROUP``) the group table with T = ``table_slots(gcap)``
  on every shard — the JAX package's megafused warm arithmetic, without
  its single dispatch.  The speculation check follows: a cached plan
  that no longer holds every row or whose pack widths no longer hold
  the bucket ranges (``wire.plan_holds``, checked before phase 2, which
  could not place them), a table overflow or a shard with more groups
  than gcap throws the result away, pops the entry and runs the group
  again cold.  A warm entry ≥4× too large, or whose plan's tag differs
  from the fresh one's, is right-sized for the next run.

A host frame reaching an exchange group is placed and split over the
mesh first, byte and object columns interned, as the eager aggregate
places it (``MeshBackend.mesh_frame``); one reaching a local group on one
device is placed there.  A group whose reduce would do arithmetic on
interned values runs without it, so the eager refusal raises from the
same code path (``_reduce_value_ok``).  Intern tables ride on the
group's output.  ``last_exchange``, the ``cssize``/``cspad`` counters and
``SyncStats`` read as after the eager exchange.

Fusion breaks where the JAX package breaks it (``_fusible_kv``): under
``outofcore=1`` (pages spill, a device KV over the budget demotes), on an
open MR and on an empty KV every stage replays through the ordinary op.

An exchange group runs under the ft/ ``shuffle.exchange`` retry policy
as the eager exchange does.  Telemetry (JAX :731, :880, :900): a
``plan.execute`` span over the whole plan and a ``plan.group`` span for
each fused group (its plan's bucket, rounds, caps, rows and groups,
whether it ran warm and whether the group table ran), the exchange's
numbers fed to ``obs/metrics.record_exchange``, and each group's
launches against the eager ops' (``plan/cache.note_fusion``).

The persistent tier (``plan/cache.persistent_cache``, JAX :861-875,
:936-945): an in-memory miss loads the key's on-disk entry and rebuilds
the ``CompiledPlan`` from it, so a fresh process's first run of a known
plan goes warm; after every run the plan's state is stored (a no-op when
unchanged).  A persisted plan or gcap is speculation only, checked on
every run as above.  Left out against the JAX fuser: the single-dispatch
megafusion and buffer donation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .cache import (note_fusion, persistent_cache, plan_cache,
                    record_history, stable_plan_digest)
from .ir import Plan, PlanStage, frame_signature

# the eager ops' launches, the baseline a fused group's launches are
# held against (JAX :82)
_EAGER_DISPATCHES = {"aggregate": 2, "convert": 2, "reduce": 1}


@dataclass
class CompiledPlan:
    """Cached state of one plan key: per group index, the exchange plan
    its last cold run took (``caps``: gidx → a ``parallel/wire.py`` plan
    tuple) and what a warm run uses (``mega``: gidx → ``("x", plan,
    gcap)`` for an exchange group, ``("l", gcap)`` for a local one)."""
    caps: dict = field(default_factory=dict)
    mega: dict = field(default_factory=dict)


def _plan_payload(compiled: CompiledPlan) -> Optional[dict]:
    """The speculation state as a JSON-safe payload (JAX :947-962), or
    None when a component has no serialization.  No run count: it would
    change every run and defeat the store's unchanged-bytes no-op."""
    from .cache import to_jsonable
    try:
        return {"caps": {str(k): to_jsonable(v)
                         for k, v in compiled.caps.items()},
                "mega": {str(k): to_jsonable(v)
                         for k, v in compiled.mega.items()}}
    except TypeError:
        return None


def _plan_from_payload(payload: dict) -> CompiledPlan:
    """Inverse of :func:`_plan_payload` (JAX :965-977): group indices
    back to ints, lists back to tuples (wire plans are compared and used
    as keys).  A malformed payload gives an empty (cold) plan."""
    from .cache import from_jsonable
    cp = CompiledPlan()
    try:
        cp.caps = {int(k): from_jsonable(v)
                   for k, v in dict(payload.get("caps") or {}).items()}
        cp.mega = {int(k): from_jsonable(v)
                   for k, v in dict(payload.get("mega") or {}).items()}
    except (TypeError, ValueError, AttributeError):
        return CompiledPlan()
    # an entry of another shape is dropped: that group runs cold
    cp.mega = {k: v for k, v in cp.mega.items()
               if isinstance(v, tuple) and len(v) == {"x": 3, "l": 2}.get(
                   v[0] if v else None)}
    return cp


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


def _fusible_kv(mr):
    """mr's KV when its state may fuse, else None: the fuser never fuses
    across a spill boundary (``outofcore=1``), into an open MR or over
    an empty KV."""
    kv = mr._kv_data
    if kv is None or not kv.complete_done or mr._open \
            or mr.settings.outofcore == 1 or not kv.nkv:
        return None
    return kv


def _local_frame(mr):
    """The device frame a local group consumes, or None (eager).  On one
    device a host dataset is placed there and installed as the KV's
    frame, as the eager aggregate places it; on a mesh only mesh frames
    qualify (the JAX local group takes a sharded frame only)."""
    from ..parallel.sharded import MeshKV, ShardedKV
    kv = _fusible_kv(mr)
    if kv is None:
        return None
    frames = kv._frames
    if len(frames) == 1 and isinstance(frames[0], (ShardedKV, MeshKV)):
        return frames[0]
    if mr.nprocs > 1 and not all(isinstance(f, MeshKV) for f in frames):
        return None
    skv = mr.backend.place_kv(kv)
    kv.replace_frames(skv)
    return skv


def _agg_hash(st: PlanStage):
    return st.args[0] if st.args else st.kw.get("hash_fn")


def _exchange_frame(mr, st: PlanStage):
    """The mesh frame an exchange group routes, or None (eager): a mesh
    of P > 1, a hash that runs on the device (a ``host_hash`` needs each
    key's bytes on the host) and a fusible KV, placed over the mesh as
    the eager aggregate places it."""
    if mr.nprocs == 1:
        return None
    fn = _agg_hash(st)
    if fn is not None and getattr(fn, "host_hash", False):
        return None
    kv = _fusible_kv(mr)
    return None if kv is None else mr.backend.mesh_frame(kv)


def _reduce_value_ok(frame, rop: str) -> bool:
    """Arithmetic on interned value ids is meaningless: the eager
    reduce refuses it, so such a reduce replays eagerly and the same
    error surfaces from the same code path."""
    return rop in ("count", "first") or frame.value_decode is None


def _match_group(mr, stages, i):
    """(n_stages, kind, reduce_op, frame) of the group starting at stage
    i, or (1, None, None, None) → eager replay."""
    n = len(stages)
    st = stages[i]
    if st.op == "aggregate" and i + 1 < n and stages[i + 1].op == "convert":
        frame = _exchange_frame(mr, st)
        if frame is not None:
            rop = _reduce_stage_op(stages[i + 2]) if i + 2 < n else None
            if rop is not None and not _reduce_value_ok(frame, rop):
                rop = None
            return (2 if rop is None else 3), "exchange", rop, frame
    if st.op == "convert" and i + 1 < n:
        rop = _reduce_stage_op(stages[i + 1])
        frame = _local_frame(mr) if rop is not None else None
        if frame is not None and _reduce_value_ok(frame, rop):
            return 2, "local", rop, frame
    return 1, None, None, None


def _table_cfg_for(shard, out_kind: str, reduce_op, gcap: int):
    """``("tbl", T)`` for the group table, or None → sort path (the knob
    is off, or the chain is unsupported: warn once)."""
    from ..ops.cuda import group as tgroup
    if not tgroup.table_group_enabled(shard.device):
        return None
    ok, reason = tgroup.group_supported(shard, out_kind, reduce_op)
    if not ok:
        tgroup.warn_fallback(reason)
        return None
    return ("tbl", tgroup.table_slots(gcap))


def _gcap_for(gmax: int, cap: int) -> int:
    """The group capacity a warm run uses: the power of two of the
    largest shard's group count, at most the row capacity."""
    from ..parallel.sharded import round_cap
    return min(round_cap(max(int(gmax), 1)), cap)


def _maybe_compact(cap: int, gmax: int, outs: list, ngroup: int) -> list:
    """Cut the first ``ngroup`` (group-indexed) outputs of every shard
    down to round_cap(gmax) when that shrinks them ≥4× (a copy, so the
    row-capacity buffers are freed); the mesh-wide rule of the JAX
    fuser, so every shard keeps one cap."""
    from ..parallel.sharded import round_cap
    n = round_cap(max(int(gmax), 1))
    if n * 4 > cap:
        return outs
    return [[a[:n].clone() if j < ngroup else a for j, a in enumerate(o)]
            for o in outs]


def _kv_out(mesh, outs, gcounts, skv, reduce_op):
    """The group outputs as a KV frame: one-device at P = 1, a mesh
    frame otherwise."""
    from ..parallel.sharded import MeshKV, ShardedKV
    vdt = np.dtype(np.int64) if reduce_op == "count" else skv.value_dtype
    vdec = skv.value_decode if reduce_op == "first" else None
    shards = [ShardedKV(ukey, uval, np.array([g], np.int32), skv.key_dtype,
                        vdt, skv.key_decode, vdec)
              for (ukey, uval), g in zip(outs, gcounts)]
    return shards[0] if mesh is None else MeshKV(mesh, shards)


def _kmv_out(mesh, outs, gcounts, nrecvs, skv):
    from ..parallel.sharded import MeshKMV, ShardedKMV
    return MeshKMV(mesh, [ShardedKMV(ukey, sizes, voff, sv,
                                     np.array([g], np.int32),
                                     np.array([n], np.int32),
                                     skv.key_dtype, skv.value_dtype,
                                     skv.key_decode, skv.value_decode)
                          for (ukey, sizes, voff, sv), g, n
                          in zip(outs, gcounts, nrecvs)])


def _install_kv(mr, frame) -> None:
    """Replace mr's dataset with a fused group's KV output."""
    if mr._kmv_data is not None:
        mr._kmv_data.free()
        mr._kmv_data = None
    old = mr._kv_data
    newkv = mr._new_kv()
    newkv.add_frame(frame)
    newkv.complete()
    if old is not None:
        old.free()
    mr._kv_data = newkv


def _install_kmv(mr, frame) -> None:
    """Replace mr's dataset with a fused group's grouped output."""
    if mr._kv_data is not None:
        mr._kv_data.free()
        mr._kv_data = None
    if mr._kmv_data is not None:
        mr._kmv_data.free()
    mr._kmv_data = mr._new_kmv()
    mr._kmv_data.push(frame)
    mr._kmv_data.complete()


def _exec_exchange_group(mr, stages, reduce_op, compiled: CompiledPlan,
                         gidx: int, skv, sp) -> tuple:
    """Run [aggregate, convert(, reduce(kernel))] over a mesh frame as
    one group.  Returns ``(mode, table)``: mode "exchange" (cold) or
    "exchange1" (warm at the cached plan and gcap), and whether the
    group table ran.  Runs under the ft/ ``shuffle.exchange`` fault site
    and retry policy as the eager exchange does (JAX
    ``plan/fuser.py:500-533``): the fault point comes before phase 1, so
    a faulted attempt launches nothing and leaves the cached plan, the
    counters and the dataset as they were."""
    from ..parallel.shuffle import _under_retry
    return _under_retry(
        skv, lambda: _exchange_group_once(mr, stages, reduce_op, compiled,
                                          gidx, skv, sp),
        f"P={skv.nprocs} fused")


def _exchange_group_once(mr, stages, reduce_op, compiled: CompiledPlan,
                         gidx: int, skv, sp) -> tuple:
    from ..core.runtime import Timer
    from ..parallel import shuffle as sh
    from ..parallel import wire
    from ..parallel.group import fused_group_shards
    t = Timer()
    out_kind = "kv" if reduce_op is not None else "kmv"
    ngroup = 2 if out_kind == "kv" else 3     # the group-indexed outputs
    ph = sh.phase1(skv, ("hash", _agg_hash(stages[0])))
    counts_mat, _ = ph.pull()
    fresh, kvrange, bmax, nmax, nrecvs = ph.plan()
    transport = mr.settings.all2all

    def run(plan, gcap, cfg):
        blocks = sh.phase2(skv, ph, plan, transport)
        return fused_group_shards(blocks, nrecvs, gcap, out_kind, reduce_op,
                                  skv.key_dtype, skv.value_dtype, cfg)

    mode, cfg, outs = "exchange", None, None
    entry = compiled.mega.get(gidx)
    if entry is not None and entry[0] == "x":
        _tag, plan, gcap = entry
        if wire.plan_holds(plan, bmax, nmax, kvrange):
            cfg = _table_cfg_for(skv.shards[0], out_kind, reduce_op, gcap)
            outs, gcounts, overflow = run(plan, gcap, cfg)
            gmax = int(gcounts.max())
            if overflow or gmax > gcap:
                outs = None
            elif (plan[0] != fresh[0]
                  or wire.plan_oversized(plan, bmax, nmax)
                  or gcap > 4 * _gcap_for(gmax, wire.plan_cap_out(plan))):
                # right-size the entry for the next run; this one is exact
                compiled.mega[gidx] = (
                    "x", fresh, _gcap_for(gmax, wire.plan_cap_out(fresh)))
        if outs is None:
            # the speculation failed: discard and run the group cold
            compiled.mega.pop(gidx, None)
            sp.set(mega_miss=True)
            cfg = None
        else:
            mode = "exchange1"
    if outs is None:
        cached = compiled.caps.get(gidx)
        if cached is not None and cached[0] == fresh[0] \
                and wire.plan_holds(cached, bmax, nmax, kvrange) \
                and not wire.plan_oversized(cached, bmax, nmax):
            plan = cached
        else:
            plan = compiled.caps[gidx] = fresh
        cap_out = wire.plan_cap_out(plan)
        outs, gcounts, _ = run(plan, cap_out, None)
        gmax = int(gcounts.max())
        outs = _maybe_compact(cap_out, gmax, outs, ngroup)
        compiled.mega[gidx] = ("x", plan, _gcap_for(gmax, cap_out))
    st = mr.last_exchange = sh.exchange_stats(
        skv, counts_mat, plan, mr.counters, speculative=mode == "exchange1")
    mr.counters.add(commtime=t.elapsed())
    ngroups = int(gcounts.sum())
    sp.set(bucket=st.bucket, nrounds=st.nrounds, cap_out=st.cap_out,
           rows=st.rows, groups=ngroups, wire_bytes=st.wire_bytes,
           wire_ratio=st.wire_ratio, mega=mode == "exchange1",
           pallas=cfg is not None)
    stages[0].result = int(counts_mat.sum())
    stages[1].result = ngroups
    if out_kind == "kv":
        _install_kv(mr, _kv_out(skv.mesh, outs, gcounts, skv, reduce_op))
        stages[2].result = ngroups
    else:
        _install_kmv(mr, _kmv_out(skv.mesh, outs, gcounts, nrecvs, skv))
    return mode, cfg is not None


def _exec_local_group(mr, stages, reduce_op, compiled: CompiledPlan,
                      gidx: int, frame, sp) -> tuple:
    """Run [convert, reduce(kernel)] on a device frame (one device or a
    mesh) as one group, every shard at one gcap.  Returns ``(mode,
    table)``: mode "local" (cold) or "local1" (warm at the cached
    capacity), and whether the group table ran."""
    from ..core.runtime import bump_dispatch
    from ..parallel.group import fused_group_shards
    from ..parallel.sharded import MeshKV
    mesh = frame.mesh if isinstance(frame, MeshKV) else None
    shards = frame.shards if mesh is not None else [frame]
    cap = frame.cap
    blocks = [(s.key, s.value) for s in shards]
    nrecvs = [int(s.counts[0]) for s in shards]
    entry = compiled.mega.get(gidx)
    gcap = entry[1] if entry is not None and entry[0] == "l" else None
    cfg = _table_cfg_for(shards[0], "kv", reduce_op, gcap) \
        if gcap is not None else None

    def run(gc, tcfg):
        bump_dispatch()
        return fused_group_shards(blocks, nrecvs, gc, "kv", reduce_op,
                                  frame.key_dtype, frame.value_dtype, tcfg)

    outs, gcounts, overflow = run(gcap or cap, cfg)
    if gcap is not None and (overflow or int(gcounts.max()) > gcap):
        # the cached capacity no longer covers: discard, run cold
        compiled.mega.pop(gidx, None)
        sp.set(mega_miss=True)
        gcap, cfg = None, None
        outs, gcounts, _ = run(cap, None)
    if gcap is None:
        gmax = int(gcounts.max())
        outs = _maybe_compact(cap, gmax, outs, 2)
        compiled.mega[gidx] = ("l", _gcap_for(gmax, cap))
    _install_kv(mr, _kv_out(mesh, outs, gcounts, frame, reduce_op))
    ngroups = int(gcounts.sum())
    sp.set(groups=ngroups, mega=gcap is not None, pallas=cfg is not None)
    stages[0].result = ngroups
    stages[1].result = ngroups
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


def _backend_signature(mr) -> tuple:
    """The third component of the plan-cache key: the device, or the
    mesh (its devices in shard order).  The persistent tier renders
    either by its devices' type (``plan/cache._stable_part``)."""
    mesh = mr.backend.mesh
    return ("device", str(mr.device)) if mesh is None else ("mesh", mesh)


def _key_brief(mr, key) -> Optional[str]:
    """The plan key as ``dump_plan`` prints it, in the JAX package's words
    (its ``_key_brief``): a mesh frame is that package's ``ShardedKV``, a
    host text column has its numpy dtype ``object``, and the backend is
    ``mesh`` for a MapReduce over a mesh, else ``serial``."""
    if key is None:
        return None
    from ..parallel.mesh import Mesh
    fp, frame_sig, _backend, transport, ooc, wire = key
    ops = "→".join(s[0] for s in fp)
    if frame_sig:
        kind = "ShardedKV" if frame_sig[0] == "MeshKV" else frame_sig[0]
        frame_sig = (kind,) + tuple(
            (c[0], c[1], "object") if c[2] == "bytes" else c
            for c in frame_sig[1:])
    backend = "mesh" if isinstance(mr.comm, Mesh) else "serial"
    return (f"ops[{ops}] frame{frame_sig!r} backend={backend} "
            f"all2all={transport} outofcore={ooc} wire={int(wire)}")


def execute_plan(mr, plan: Plan) -> None:
    """Fuse + run a recorded plan against mr's current dataset.  The
    cache key is (fingerprint, frame signature, device or mesh, all2all,
    outofcore, ``MRTPU_WIRE``), as the JAX package keys it."""
    from ..parallel.wire import wire_enabled
    kv = mr._kv_data
    frame = kv._frames[0] if kv is not None and kv.complete_done \
        and kv._frames else None
    try:
        key = (plan.fingerprint(), frame_signature(frame),
               _backend_signature(mr), mr.settings.all2all,
               mr.settings.outofcore, wire_enabled())
        compiled = plan_cache().get(key)
    except TypeError:       # an unhashable stage argument: run uncached
        key, compiled = None, None
    cache_hit = compiled is not None
    # the persistent tier: an in-memory miss reads the on-disk entry
    pkey = stable_plan_digest(key) if key is not None \
        and persistent_cache() is not None else None
    if compiled is None and pkey is not None:
        payload = persistent_cache().load(pkey)
        if payload is not None:
            compiled = _plan_from_payload(payload)
            plan_cache().put(key, compiled)
            cache_hit = True
    if compiled is None:
        compiled = CompiledPlan()
        if key is not None:
            plan_cache().put(key, compiled)
    from ..core.runtime import thread_dispatches
    from ..obs import get_tracer
    tracer = get_tracer()
    groups_desc = []
    stages = list(plan.stages)
    i = gidx = 0
    with tracer.span("plan.execute", cat="plan", nstages=len(stages),
                     cache_hit=cache_hit) as psp:
        while i < len(stages):
            n, kind, rop, frame = _match_group(mr, stages, i)
            run = stages[i:i + n]
            mode, table = "eager", False
            # this thread's launches: another thread's never count here
            d0 = thread_dispatches()
            if kind is None:
                _replay(mr, run[0])
            else:
                with tracer.span("plan.group", cat="plan", kind=kind,
                                 fused=True, nstages=n,
                                 reduce_op=rop or "") as sp:
                    group = _exec_exchange_group if kind == "exchange" \
                        else _exec_local_group
                    mode, table = group(mr, run, rop, compiled, gidx, frame,
                                        sp)
            note_fusion(kind or "eager", mode, thread_dispatches() - d0,
                        sum(_EAGER_DISPATCHES.get(s.op, 1) for s in run),
                        table=table)
            groups_desc.append({"stages": [s.describe() for s in run],
                                "fused": kind is not None,
                                "kind": kind or "eager", "reduce_op": rop,
                                "mode": mode, "table": table})
            i += n
            gidx += 1
        psp.set(ngroups=gidx,
                nfused=sum(1 for d in groups_desc if d["fused"]))
    if pkey is not None:
        # what this run learned, for the next process (no-op when
        # unchanged; an empty state still marks the digest as seen)
        payload = _plan_payload(compiled)
        pp = persistent_cache()
        if payload is not None and pp is not None:
            pp.store(pkey, payload)
    record_history({"stages": plan.describe(), "groups": groups_desc,
                    "cache_hit": cache_hit,
                    "cache_key": _key_brief(mr, key)})
