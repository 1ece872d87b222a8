"""The two-phase exchange: aggregate, gather and the data plane's shuffle.

The counterpart of ``gpu_mapreduce_tpu/parallel/shuffle.py`` (the
reference's ``MapReduce::aggregate`` over ``Irregular``,
src/mapreduce.cpp:385-563, src/irregular.cpp), over a mesh driven by one
process, with the JAX package's defaults: the wire codec
(``parallel/wire.py``) and the speculative plan cache.

phase 1, per shard (:class:`Phase1`, ``_phase1_core``, JAX :77-110): a
  destination for every valid row (the default lookup3 hash, a device
  hash function, a fixed shard or a range), a stable sort of the rows
  by destination, the rows per destination and, with the codec on, each
  bucket's key and value min/max (``wire.bucket_stats``); the ``[P,
  P]`` counts and the ``[P, P, 4]`` stats come to the host in one
  transfer — the op's one sync (:class:`~.sharded.SyncStats`).

the plan (``wire.plan_from_pull``, JAX :452-466 and wire.py): the count
  and stats matrices give a ``("wire", tiers, cap_out, kpack, vpack)``
  or ``("raw", B, nrounds, cap_out)`` plan; a cached plan is held
  against them by ``wire.plan_holds`` and ``wire.plan_oversized``.

phase 2, per destination (:func:`phase2`, JAX ``phase2_shard_body`` and
  ``phase2_wire_shard_body``): output shard d is zeros ``[cap_out]``;
  each source's dest-d slice lands at ``base[src]``, sources in
  ascending order, so shard d holds every source's rows for it,
  source-major and each in its original order.  Under a wire plan the
  slices travel as ``col - base[dest]`` at the pack's width and decode
  at the destination from the source's base (byte-identical to the raw
  path).  The copies follow ``_route``: on a flat mesh ``all2all=1``
  sources in ascending order for each destination, ``all2all=0`` the
  ring's shifts (JAX ``_ring_exchange``); on a two-level mesh
  (``mesh.make_mesh2``) every transport first gathers a slice's rows for
  a destination on the slice's shard with the destination's chip index,
  then moves them across slices in one copy (JAX ``_a2a_hier``).
  Between distinct cards the copies go device to device.

the speculative plan cache (``_SPEC_CACHE``, JAX :428-450, :664-752):
  keyed by (mesh, transport, destination, column shapes and dtypes,
  codec on), the plan of the last exchange of that key.  When the
  cached plan still holds the pulled matrices (``wire.plan_holds``),
  phase 2 runs at it, keeping its larger ``cap_out``, and the exchange
  is marked speculative; otherwise phase 2 runs at the fresh plan.  The
  cache is right-sized as JAX does, so caps and ``speculative`` equal
  JAX's over any sequence of exchanges.  The rank exchange keys its
  entries by the world, the local shards and the generation instead of
  a mesh, and runs at a cached plan only where every rank holds the
  same one (:func:`exchange_ranks`).  JAX also enqueues phase 2 before
  the pull; the port waits for the pull first, on a mesh and across
  ranks (an early dispatch measured slower on an H100, PERF.md §6).

The eager exchange (:func:`exchange`) and the fused exchange group of
``plan/fuser.py`` share these steps, so their layouts and telemetry are
one.  A rank frame of the process group (``parallel/dist.RankKV``)
takes the same phase 1 and plan on its blocks, the count and stats
matrices in one gather across ranks, and phase 2 as one
``all_to_all_single`` a chip index (:func:`exchange_ranks`); its blocks
equal the one-process mesh's shards.

Every exchange runs under the ft/ ``shuffle.exchange`` retry policy
(:func:`_under_retry`) and is a cancellation barrier
(``obs/context.barrier_check``); each attempt of an eager or rank
exchange is a ``shuffle.exchange`` span (the plan's bucket, rounds,
caps, rows, bytes and whether it was speculative) with a
``shuffle.count_sync`` child around the count pull, and every exchange's
telemetry feeds ``obs/metrics.record_exchange``.  The JAX exchange's
buffer donation is not ported (torch never consumes its inputs).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.frame import KVFrame
from ..core.runtime import MRError, bump_dispatch
from ..ops.hash import default_hash
from . import dist as _dist
from . import wire as _wire
from .dist import RankKV
from .sharded import (MeshKV, ShardedKV, SyncStats, shard_frame_with_counts)

# the speculative plan cache: spec key → the plan the last exchange of
# that key ran.  Entries are immutable tuples; the lock guards the dict
# accesses only, never an exchange.
_SPEC_CACHE: dict = {}
_SPEC_LOCK = threading.Lock()


@dataclass
class ExchangeCallStats:
    """Flow-control telemetry of one exchange (the JAX package's
    ``ExchangeCallStats``): the bucket B and round count of the plan's
    schedule (the largest tier and the tier count under a wire plan),
    the output cap, the rows routed, whether phase 2 ran at the cached
    (speculative) plan, the bytes that cross between shards at full width
    (``sent_bytes``, the diagonal excluded) and the padding its schedule
    would send (``pad_bytes``), the bytes a wire plan's schedule moves
    (``wire_bytes``) and ``(sent + pad) / wire`` (``wire_ratio``; both 0
    under a raw plan); beside them the count matrix's smallest and
    largest bucket."""

    nrounds: int
    bucket: int
    cap_out: int
    rows: int
    speculative: bool = False
    sent_bytes: int = 0
    pad_bytes: int = 0
    wire_bytes: int = 0
    wire_ratio: float = 0.0
    bucket_min: int = 0
    bucket_max: int = 0


def _dest_fn(dest, nprocs: int, key_dtype) -> Callable:
    """Destination spec → per-shard function ``(keys, shard) → dest``, or
    for a range a :class:`_RangeDest` (JAX ``_dest_fn``, :216-262):

    * ``("hash", None)`` — ``default_hash(keys) % P``;
    * ``("hash", fn)`` — ``fn(keys) % P``, ``fn`` a device hash over the
      key tensor (u64 keys as their int64 bits);
    * ``("fixed_mod", n)`` — every row of shard i to shard ``i % n``,
      the reference gather's sender → receiver map
      (src/mapreduce.cpp:919-928);
    * ``("range", offsets, ends)`` — topology resharding
      (``parallel/reshard.py``): row r of shard p has global index
      ``offsets[p] + r`` and goes to ``searchsorted(ends, g, right)``
      (:class:`_RangeDest`).
    """
    kind = dest[0]
    if kind == "hash":
        fn = dest[1]
        if fn is None:
            return lambda keys, p: default_hash(keys, key_dtype) % nprocs
        return lambda keys, p: fn(keys).to(torch.int64) % nprocs
    if kind == "fixed_mod":
        n = dest[1]
        return lambda keys, p: torch.full((keys.shape[0],), p % n,
                                          dtype=torch.int64,
                                          device=keys.device)
    if kind == "range":
        return _RangeDest(np.asarray(dest[1], np.int64),
                          np.asarray(dest[2], np.int64), nprocs)
    raise ValueError(f"unknown exchange destination {dest!r}")


@dataclass(frozen=True)
class _RangeDest:
    """The ``("range", offsets, ends)`` destination: global row
    ``g = offsets[p] + r`` goes to ``searchsorted(ends, g, right=True)``.
    It is monotone in the row, so a shard's rows are already in
    destination order (the stable sort is the identity and the output
    keeps the global row order), and the rows per destination follow
    from the shard's global range alone, on the host."""

    offsets: np.ndarray
    ends: np.ndarray
    nprocs: int

    def rows_per_dest(self, p: int, c: int) -> np.ndarray:
        """Rows of shard p's global range ``[offsets[p], offsets[p] + c)``
        inside each target's ``[ends[d-1], ends[d])``, as ``[nprocs]``."""
        lo, hi = int(self.offsets[p]), int(self.offsets[p]) + c
        starts = np.concatenate([[0], self.ends[:-1]])
        n = np.clip(np.minimum(self.ends, hi) - np.maximum(starts, lo),
                    0, None)
        out = np.zeros(self.nprocs, np.int64)
        out[:n.shape[0]] = n
        return out


def _phase1_core(nprocs: int, dest_of: Callable, shard: ShardedKV, p: int,
                 need_dest: bool = True):
    """One shard's valid rows stably sorted by destination, each row's
    destination (int64; for a range only with ``need_dest``, else None)
    and the rows per destination ``[P]`` (int64), all on the shard's
    device."""
    c = int(shard.counts[0])
    key, value = shard.key[:c], shard.value[:c]
    dev = key.device
    if isinstance(dest_of, _RangeDest):
        row = torch.from_numpy(dest_of.rows_per_dest(p, c)).to(
            dev, non_blocking=True)
        sd = torch.searchsorted(torch.cumsum(row, 0),
                                torch.arange(c, device=dev), right=True) \
            if need_dest else None
        return key, value, sd, row
    sd, order = torch.sort(dest_of(key, p), stable=True)
    # rows per destination from the sorted destinations: no atomics on
    # P hot counters
    bounds = torch.searchsorted(sd, torch.arange(nprocs + 1, device=dev))
    return key[order], value[order], sd, bounds[1:] - bounds[:-1]


class Phase1:
    """Phase 1 of an exchange over a mesh frame: every shard's valid rows
    sorted by destination (``rows[p] = (keys, values, dests, counts)``),
    the count row and (codec on) the ``[P, 4]`` stats of each shard,
    joined as one ``[P, P·(1+4)]`` matrix on the first device.
    :meth:`pull` is the op's one sync;
    :meth:`meta_on` gives the matrix on any device without the host.  A
    range destination's count matrix is the host's own schedule
    (``known``), before any pull."""

    def __init__(self, skv: MeshKV, dest, wire_on: bool):
        mesh = skv.mesh
        self.P = P = mesh.size
        self.key_dtype, self.value_dtype = skv.key_dtype, skv.value_dtype
        s0 = skv.shards[0]
        self.kspec = _wire.col_spec(s0.key, skv.key_dtype)
        self.vspec = _wire.col_spec(s0.value, skv.value_dtype)
        self.wire_on = wire_on
        self.elig = _wire.columns_eligible(self.kspec, self.vspec) \
            if wire_on else None
        dest_of = _dest_fn(dest, P, skv.key_dtype)
        self.counts_in = [int(s.counts[0]) for s in skv.shards]
        self.known = np.stack([dest_of.rows_per_dest(p, c) for p, c in
                               enumerate(self.counts_in)]) \
            if isinstance(dest_of, _RangeDest) else None
        bump_dispatch()
        self.rows, self.stats_local, metas = [], [], []
        for p, s in enumerate(skv.shards):
            k, v, sd, row = _phase1_core(P, dest_of, s, p, wire_on)
            self.rows.append((k, v, sd, row))
            meta = [row]
            if wire_on:
                st = _wire.bucket_stats(P, k, v, sd, row, self.key_dtype,
                                        self.value_dtype, self.elig)
                self.stats_local.append(st)
                meta.append(st.reshape(-1))
            metas.append(torch.cat(meta))
        dev0 = mesh.devices[0]
        self._meta = torch.stack([m.to(dev0, non_blocking=True)
                                  for m in metas])
        self._on = {dev0: self._meta}
        self.counts_mat = self.stats_mat = None

    def meta_on(self, device) -> tuple:
        """(counts ``[P, P]``, stats ``[P, P, 4]`` or None) on ``device``,
        copied there once, device to device."""
        m = self._on.get(device)
        if m is None:
            m = self._on[device] = self._meta.to(device, non_blocking=True)
        P = self.P
        stats = m[:, P:].reshape(P, P, 4) if self.wire_on else None
        return m[:, :P], stats

    def pull(self) -> tuple:
        """The count and stats matrices on the host (the op's one
        sync)."""
        if self.counts_mat is None:
            SyncStats.bump()
            m = self._meta.cpu().numpy()
            P = self.P
            self.counts_mat = m[:, :P]
            self.stats_mat = m[:, P:].reshape(P, P, 4) if self.wire_on \
                else None
        return self.counts_mat, self.stats_mat

    def plan(self) -> tuple:
        """``wire.plan_from_pull`` on the pulled matrices: ``(plan,
        kvrange, bmax_raw, nmax_out, new_counts)``."""
        counts_mat, stats_mat = self.pull()
        return _wire.plan_from_pull(self.kspec, self.vspec, counts_mat,
                                    stats_mat, self.wire_on, self.elig)

    def send_columns(self, plan) -> list:
        """Each shard's ``(keys, values)`` as they travel under ``plan``:
        the sorted rows, or their deltas at the pack width."""
        kpack, vpack = _packs(plan)
        out = []
        for p, (k, v, sd, _row) in enumerate(self.rows):
            if kpack:
                k = _wire.encode(k, self.key_dtype,
                                 self.stats_local[p][:, 0], sd, kpack)
            if vpack:
                v = _wire.encode(v, self.value_dtype,
                                 self.stats_local[p][:, 2], sd, vpack)
            out.append((k, v))
        return out


def phase1(skv: MeshKV, dest, wire_on: Optional[bool] = None) -> Phase1:
    """Phase 1 of an exchange (:class:`Phase1`); ``wire_on`` defaults to
    ``MRTPU_WIRE``.  The eager exchange and the fused exchange group
    (``plan/fuser.py``) share it."""
    if wire_on is None:
        wire_on = _wire.wire_enabled()
    return Phase1(skv, dest, wire_on)


def _packs(plan) -> tuple:
    return (plan[3], plan[4]) if plan[0] == "wire" else (None, None)


def _rowbytes(skv) -> int:
    s = skv.shards[0]
    k, v = s.key, s.value
    return (k.element_size() * (k.shape[1] if k.dim() > 1 else 1)
            + v.element_size() * (v.shape[1] if v.dim() > 1 else 1))


def exchange_volume(skv, counts_mat: np.ndarray, slots: int,
                    nprocs: int) -> tuple:
    """(moved, pad, rowbytes) of one exchange at full row width (JAX
    :509-528): the rows that leave their shard, and the empty slots of
    the plan's schedule (``slots`` per bucket), the diagonal excluded on
    both sides."""
    rowbytes = _rowbytes(skv)
    useful = int(counts_mat.sum() - np.trace(counts_mat))
    sent_slots = nprocs * (nprocs - 1) * slots
    return (useful * rowbytes, max(0, sent_slots - useful) * rowbytes,
            rowbytes)


# -- phase 2 ------------------------------------------------------------------

def _schedule(transport: int, nprocs: int):
    """The (src, dst) copies of a flat mesh in issue order: ``all2all=1``
    sources in ascending order for each destination; ``all2all=0`` the
    ring's shifts s = 0 (the self copy) .. P-1, destination d taking
    from (d-s) % P."""
    if transport == 1:
        return [(s, d) for d in range(nprocs) for s in range(nprocs)]
    return [((d - s) % nprocs, d) for s in range(nprocs)
            for d in range(nprocs)]


def _route(mesh, pieces, transport: int):
    """Blocks ``(d, srcs, tensors)`` for the destinations to place: each
    block holds the pieces of consecutive sources ``srcs`` for shard d,
    joined in source order.  ``pieces[s][d]`` is ``None`` (nothing to
    send) or a tuple of tensors on shard s's device.  A flat mesh sends
    each piece as it is, in ``_schedule`` order.  A two-level mesh
    first joins slice ss's pieces for d on shard ``(ss, chip of d)``
    (the hop within the slice), and that one block is what crosses to
    d's slice (JAX ``_a2a_hier``)."""
    P = mesh.size
    if len(mesh.axis_names) == 1:
        for s, d in _schedule(transport, P):
            if pieces[s][d] is not None:
                yield d, [s], pieces[s][d]
        return
    S, C = mesh.dims
    for d in range(P):
        dc = d % C
        for ss in range(S):
            srcs = [ss * C + sc for sc in range(C)
                    if pieces[ss * C + sc][d] is not None]
            if not srcs:
                continue
            hub = mesh.devices[ss * C + dc]
            parts = [pieces[s][d] for s in srcs]
            yield d, srcs, tuple(
                _join([p[j] for p in parts], hub)
                for j in range(len(parts[0])))


def _join(ts, device) -> torch.Tensor:
    """Tensors from any devices, joined on ``device`` by one copy each."""
    n = sum(t.shape[0] for t in ts)
    out = torch.empty((n,) + tuple(ts[0].shape[1:]), dtype=ts[0].dtype,
                      device=device)
    at = 0
    for t in ts:
        out[at:at + t.shape[0]].copy_(t, non_blocking=True)
        at += t.shape[0]
    return out


def _decode_block(k, v, counts, stats, key_dtype, value_dtype, plan):
    """The destination's side of a wire plan for one output block:
    ``base[src] + delta`` for every packed column, each row's source
    from the destination's column of the count matrix (``counts`` ``[P]``,
    P past the valid prefix) and its base from its ``stats`` ``[P, 4]``,
    both on the block's device."""
    kpack, vpack = _packs(plan)
    src = torch.searchsorted(torch.cumsum(counts, 0),
                             torch.arange(k.shape[0], device=k.device),
                             right=True, out_int32=True)
    if kpack:
        k = _wire.decode(k, key_dtype, _wire.with_zero(stats[:, 0]), src,
                         kpack)
    if vpack:
        v = _wire.decode(v, value_dtype, _wire.with_zero(stats[:, 2]), src,
                         vpack)
    return k, v


def _decode_blocks(skv: MeshKV, ph: Phase1, plan, blocks) -> list:
    """:func:`_decode_block` for every destination of a mesh, from the
    count and stats matrices on its device (the raw plan's blocks as
    they are)."""
    if plan[0] != "wire" or not any(_packs(plan)):
        return blocks
    out = []
    for d, ((k, v), dev) in enumerate(zip(blocks, skv.mesh.devices)):
        counts, stats = ph.meta_on(dev)
        out.append(_decode_block(k, v, counts[:, d], stats[:, d],
                                 ph.key_dtype, ph.value_dtype, plan))
    return out


def _out_blocks(skv: MeshKV, cols, n: int) -> tuple:
    """Zero ``[n]`` output blocks, one a destination, in the sent
    columns' dtypes."""
    k0, v0 = cols[0]
    return ([k0.new_zeros((n,) + tuple(k0.shape[1:]), device=dev)
             for dev in skv.mesh.devices],
            [v0.new_zeros((n,) + tuple(v0.shape[1:]), device=dev)
             for dev in skv.mesh.devices])


def phase2(skv: MeshKV, ph: Phase1, plan, transport: int = 1) -> list:
    """Phase 2 at ``plan`` from the pulled count matrix: each
    destination's ``(keys, values)`` block of ``cap_out`` rows, every
    source's slice at its base, sources in ascending order."""
    P = ph.P
    counts_mat = ph.known if ph.known is not None else ph.pull()[0]
    cap_out = _wire.plan_cap_out(plan)
    cols = ph.send_columns(plan)
    # per source: where each destination's slice starts in its sorted rows;
    # per destination: where each source's slice lands in the output
    src_off = np.concatenate([np.zeros((P, 1), np.int64),
                              np.cumsum(counts_mat, axis=1)], axis=1)
    dst_base = np.concatenate([np.zeros((1, P), np.int64),
                               np.cumsum(counts_mat, axis=0)], axis=0)
    pieces = [[None] * P for _ in range(P)]
    for s in range(P):
        ks, vs = cols[s]
        for d in range(P):
            n = int(counts_mat[s, d])
            if n:
                lo = int(src_off[s, d])
                pieces[s][d] = (ks[lo:lo + n], vs[lo:lo + n])
    out_k, out_v = _out_blocks(skv, cols, cap_out)
    bump_dispatch()
    for d, srcs, (k, v) in _route(skv.mesh, pieces, transport):
        at = int(dst_base[srcs[0], d])
        out_k[d][at:at + k.shape[0]].copy_(k, non_blocking=True)
        out_v[d][at:at + v.shape[0]].copy_(v, non_blocking=True)
    return _decode_blocks(skv, ph, plan, list(zip(out_k, out_v)))


def exchange_stats(skv, counts_mat: np.ndarray, plan, counters=None,
                   speculative: bool = False) -> ExchangeCallStats:
    """The telemetry of one exchange at the plan that ran (shared by the
    eager and the fused exchange and the rank exchange; JAX
    :749-776); the bytes also go to ``counters``."""
    P = counts_mat.shape[0]
    moved, pad, _ = exchange_volume(skv, counts_mat,
                                    _wire.plan_slots(plan), P)
    if counters is not None:
        counters.add(cssize=moved, crsize=moved, cspad=pad)
    bucket, nrounds = _wire.plan_rounds(plan)
    stats = ExchangeCallStats(nrounds=nrounds, bucket=bucket,
                              cap_out=_wire.plan_cap_out(plan),
                              rows=int(counts_mat.sum()),
                              speculative=speculative, sent_bytes=moved,
                              pad_bytes=pad,
                              bucket_min=int(counts_mat.min()),
                              bucket_max=int(counts_mat.max()))
    if plan[0] == "wire":
        s = skv.shards[0]
        stats.wire_bytes = _wire.wire_volume(
            _wire.col_spec(s.key, skv.key_dtype),
            _wire.col_spec(s.value, skv.value_dtype), counts_mat, plan)
        stats.wire_ratio = _wire.wire_ratio(moved, pad, stats.wire_bytes)
    # the live metrics and the request account: a direct feed, so the
    # counters hold even for spans the ring has dropped
    from ..obs.metrics import record_exchange
    record_exchange(stats)
    return stats


def _span_stats(sp, skv, stats: ExchangeCallStats) -> None:
    """An exchange's telemetry as its span's attributes (JAX
    :719-774)."""
    sp.set(speculative=stats.speculative, bucket=stats.bucket,
           nrounds=stats.nrounds, cap_out=stats.cap_out, rows=stats.rows,
           sent_bytes=stats.sent_bytes, pad_bytes=stats.pad_bytes,
           rowbytes=_rowbytes(skv), wire_bytes=stats.wire_bytes,
           wire_ratio=stats.wire_ratio)


def _spec_key(skv: MeshKV, dest, transport: int, wire_on: bool) -> tuple:
    """The speculative cache's key (JAX :670-671): the mesh, transport,
    destination, the frame's whole key and value shapes and dtypes, and
    whether the codec is on."""
    s = skv.shards[0]
    n = skv.nprocs * s.cap
    return (skv.mesh, transport, dest,
            (n,) + tuple(s.key.shape[1:]), np.dtype(skv.key_dtype).str,
            (n,) + tuple(s.value.shape[1:]), np.dtype(skv.value_dtype).str,
            wire_on)


def _spec_decision(spec, plan, bmax: int, nmax: int, kvrange) -> tuple:
    """``(the plan phase 2 runs at, speculative, the entry to keep)``
    from the cached plan ``spec`` (None: none to use) and the fresh
    ``plan`` (JAX :714-746): a cached plan that still holds runs,
    keeping its larger cap, and gives way to the fresh one for the next
    exchange when it is ≥ 4× too large or its tag differs; otherwise the
    fresh plan runs and is kept."""
    if spec is not None and _wire.plan_holds(spec, bmax, nmax, kvrange):
        keep = plan if (spec[0] != plan[0]
                        or _wire.plan_oversized(spec, bmax, nmax)) else spec
        return spec, True, keep
    return plan, False, plan


def _under_retry(skv, run: Callable, detail: str,
                 span: Optional[dict] = None):
    """``run()`` under the ft/ ``shuffle.exchange`` fault site and retry
    policy (JAX ``shuffle.py:575-616``).  The fault point comes before
    any launch, so a faulted attempt leaves no trace: the plan cache, the
    exchange and sync counters change only on a successful attempt.
    Torch never consumes its inputs, but the veto stays explicit: a
    retry needs every input shard still whole.  With ``span`` (its
    attributes), each attempt is ``run(sp)`` inside a
    ``shuffle.exchange`` span."""
    from ..ft.inject import fault_point
    from ..ft.retry import retry_call

    def _once():
        fault_point("shuffle.exchange")
        if span is None:
            return run()
        from ..obs import NULL_SPAN, get_tracer
        tr = get_tracer()
        if not tr.enabled:
            return run(NULL_SPAN)
        with tr.span("shuffle.exchange", cat="shuffle", **span) as sp:
            return run(sp)

    def _retryable(_e) -> bool:
        return all(s.key is not None and s.value is not None
                   for s in skv.shards)

    return retry_call("shuffle.exchange", _once, detail=detail,
                      retryable=_retryable)


def exchange(skv: MeshKV, dest, transport: int = 1, counters=None,
             site: str = "exchange") -> MeshKV:
    """Route every valid row of a mesh frame to its destination shard
    (``dest`` as in :func:`_dest_fn`); decode tables ride along.  A
    cached plan for this spec key that still holds is the one phase 2
    runs at (module docstring).  The new frame carries
    :class:`ExchangeCallStats` as ``exchange_stats``.  A rank frame
    (``parallel/dist.RankKV``) exchanges across the process group
    (:func:`exchange_ranks`, its rows' sync point named ``site``).  Runs
    under the ft/ ``shuffle.exchange`` retry policy (:func:`_under_retry`),
    after the cancellation barrier (JAX :589-596).
    """
    from ..obs.context import barrier_check
    barrier_check()
    if isinstance(skv, RankKV):
        return exchange_ranks(skv, dest, counters, site)
    return _under_retry(
        skv, lambda sp: _exchange_mesh(skv, dest, transport, counters, sp),
        f"P={skv.nprocs}", span={"nprocs": skv.nprocs,
                                 "transport": transport})


def _count_sync_span():
    """The ``shuffle.count_sync`` span around an exchange's one pull."""
    from ..obs import get_tracer
    return get_tracer().span("shuffle.count_sync", cat="shuffle")


def _exchange_mesh(skv: MeshKV, dest, transport: int, counters,
                   sp) -> MeshKV:
    wire_on = _wire.wire_enabled()
    ph = phase1(skv, dest, wire_on)
    key = _spec_key(skv, dest, transport, wire_on)
    with _SPEC_LOCK:
        spec = _SPEC_CACHE.get(key)
    with _count_sync_span():
        counts_mat, _ = ph.pull()
    plan, kvrange, bmax, nmax, new_counts = ph.plan()
    ran, speculative, keep = _spec_decision(spec, plan, bmax, nmax, kvrange)
    with _SPEC_LOCK:
        _SPEC_CACHE[key] = keep
    blocks = phase2(skv, ph, ran, transport)
    out = MeshKV(skv.mesh, [ShardedKV(k, v, np.array([n], np.int32),
                                      skv.key_dtype, skv.value_dtype,
                                      skv.key_decode, skv.value_decode)
                            for (k, v), n in zip(blocks, new_counts)])
    out.exchange_stats = exchange_stats(skv, counts_mat, ran, counters,
                                        speculative)
    _span_stats(sp, skv, out.exchange_stats)
    return out


# -- across ranks -------------------------------------------------------------

def exchange_ranks(skv: RankKV, dest, counters=None,
                   site: str = "exchange") -> RankKV:
    """The exchange across ranks (JAX ``shuffle.py:686-703`` over
    ``dist.host_pull``).  Rank r holds the shards ``r·L … r·L + L − 1``
    of a ``(W, L)`` mesh.  Phase 1 on each local block; the ``[P, P]``
    count and ``[P, P, 4]`` stats matrices in one gather on the metadata
    group under the ``count_sync`` watchdog (L rows a rank); the same
    plan on every rank (``wire.plan_from_pull``); then the hierarchical
    exchange of ``_route`` under the ``site`` watchdog: local copies
    gather each destination chip index's rows on the rank's shard of
    that index, and one ``all_to_all_single`` a chip index moves them
    between same-index peers, at the pack's width under a wire plan.
    ``all_to_all_single`` lays its output out by source rank, then by
    the source's local index: the mesh's source-major order, so every
    block, cap and count equals the one-process ``make_mesh(W·L)``'s
    shard byte for byte.  The new frame carries ``exchange_stats`` and
    the seconds of both sync points.

    Speculation (JAX :664-752 over ``host_pull``): each metadata row
    also carries the digest of the rank's cached plan for this
    exchange's key (:func:`_rank_spec_key`; 0 with none).  Phase 2 runs
    at the cached plan only where every rank's digest is the same and
    nonzero and the plan holds the gathered matrices; every rank then
    decides alike, so no two ranks enter ``all_to_all_single`` with
    different caps (a rank restarted with an empty cache makes the
    exchange fresh on all).  The entry is right-sized as on a mesh, and
    written only once the rows have arrived.  Over an equal history the
    caps and ``speculative`` equal the JAX mesh's.

    Runs under the ft/ ``shuffle.exchange`` retry policy, its fault point
    before the first collective: the seeded schedule is per process and
    every rank reaches its k-th exchange together, so a fault fires on
    every rank at the same call and every rank retries into the same
    collectives."""
    return _under_retry(
        skv, lambda sp: _exchange_ranks(skv, dest, counters, site, sp),
        f"P={skv.nprocs} rank {skv.rank}",
        span={"nprocs": skv.nprocs, "transport": 1})


def _rank_spec_key(skv: RankKV, dest, wire_on: bool) -> tuple:
    """The rank exchange's speculative key, computed alike on every rank:
    the world W, the local shards L, the group's generation, the
    destination, the frame's whole key and value shapes and dtypes, and
    whether the codec is on.  No mesh object (a rank frame has none);
    worlds of different widths never share an entry."""
    rt = _dist.active()
    s = skv.shards[0]
    n = skv.nprocs * s.cap
    return ("ranks", skv.nprocs // skv.nlocal, skv.nlocal,
            rt.gen if rt is not None else 0, dest,
            (n,) + tuple(s.key.shape[1:]), np.dtype(skv.key_dtype).str,
            (n,) + tuple(s.value.shape[1:]), np.dtype(skv.value_dtype).str,
            wire_on)


def _plan_digest(plan) -> int:
    """A nonzero int64 digest of a plan, equal on every rank that holds
    the same plan (0: no plan)."""
    if plan is None:
        return 0
    h = hashlib.blake2b(json.dumps(plan, default=int).encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little", signed=True) or 1


def _exchange_ranks(skv: RankKV, dest, counters, site: str,
                    sp) -> RankKV:
    if skv.key_decode is not None or skv.value_decode is not None:
        raise MRError("an exchange of interned columns across ranks is not "
                      "ported yet (intern tables are per process)")
    P, L, rank = skv.nprocs, skv.nlocal, skv.rank
    wire_on = _wire.wire_enabled()
    key = _rank_spec_key(skv, dest, wire_on)
    with _SPEC_LOCK:
        spec = _SPEC_CACHE.get(key)
    digest = torch.tensor([_plan_digest(spec)], dtype=torch.int64)
    s0 = skv.shards[0]
    kspec = _wire.col_spec(s0.key, skv.key_dtype)
    vspec = _wire.col_spec(s0.value, skv.value_dtype)
    elig = _wire.columns_eligible(kspec, vspec) if wire_on else None
    dest_of = _dest_fn(dest, P, skv.key_dtype)
    bump_dispatch()
    rows, metas = [], []
    for l, s in enumerate(skv.shards):
        k, v, sd, row = _phase1_core(P, dest_of, s, rank * L + l, wire_on)
        meta = [row]
        if wire_on:
            st = _wire.bucket_stats(P, k, v, sd, row, skv.key_dtype,
                                    skv.value_dtype, elig)
            meta.append(st.reshape(-1))
        else:
            st = None
        rows.append((k, v, sd, st))
        metas.append(torch.cat(meta))
    t0 = time.perf_counter()
    SyncStats.bump()          # the op's one pull: the count matrix
    with _count_sync_span():
        gathered = _dist.guard_call(
            "count_sync", lambda: _dist.all_gather_host(
                torch.cat([t for m in metas for t in (m.cpu(), digest)])
                .numpy())).reshape(P, -1)
    t1 = time.perf_counter()
    counts_mat = gathered[:, :P]
    # the straggler classifier's data-skew evidence (obs/fleetobs)
    _dist.note_sync_rows(counts_mat)
    stats_mat = gathered[:, P:-1].reshape(P, P, 4) if wire_on else None
    plan, kvrange, bmax, nmax, new_counts = _wire.plan_from_pull(
        kspec, vspec, counts_mat, stats_mat, wire_on, elig)
    # the cached plan is used only where every rank holds the same one
    digests = gathered[:, -1]
    agreed = bool((digests == digests[0]).all())
    ran, speculative, keep = _spec_decision(spec if agreed else None, plan,
                                            bmax, nmax, kvrange)
    kpack, vpack = _packs(ran)
    cols = []
    for k, v, sd, st in rows:
        if kpack:
            k = _wire.encode(k, skv.key_dtype, st[:, 0], sd, kpack)
        if vpack:
            v = _wire.encode(v, skv.value_dtype, st[:, 2], sd, vpack)
        cols.append((k, v))
    bump_dispatch()
    blocks = _dist.guard_call(site, _dist.all_to_all_rows, cols,
                              counts_mat, _wire.plan_cap_out(ran))
    t2 = time.perf_counter()
    with _SPEC_LOCK:
        _SPEC_CACHE[key] = keep
    shards = []
    for l, (k, v) in enumerate(blocks):
        d = rank * L + l
        if kpack or vpack:
            dev = k.device
            k, v = _decode_block(
                k, v, torch.from_numpy(counts_mat[:, d].copy()).to(dev),
                torch.from_numpy(stats_mat[:, d].copy()).to(dev),
                skv.key_dtype, skv.value_dtype, ran)
        shards.append(ShardedKV(k, v, new_counts[d:d + 1].copy(),
                                skv.key_dtype, skv.value_dtype))
    out = RankKV(rank, shards, new_counts)
    out.exchange_stats = exchange_stats(skv, counts_mat, ran, counters,
                                        speculative)
    _span_stats(sp, skv, out.exchange_stats)
    out.sync_seconds = {"count_sync": t1 - t0, site: t2 - t1}
    return out


# ---------------------------------------------------------------------------
# aggregate()
# ---------------------------------------------------------------------------

def aggregate_kv(backend, mr, hash_fn: Optional[Callable]) -> None:
    """``MapReduce.aggregate`` on a mesh of P > 1 (JAX :793-842): a host
    hash function partitions on the host (``_aggregate_host_hash``);
    otherwise the dataset goes onto the mesh (text columns interned
    first, into dest-sharded tables) and through the exchange under
    ``hash_fn`` (None: lookup3 of the key bytes)."""
    kv = mr.kv
    if hash_fn is not None and getattr(hash_fn, "host_hash", False):
        _aggregate_host_hash(backend, mr, hash_fn)
        return
    skv = backend.mesh_frame(kv)
    if skv is None:
        return
    out = exchange(skv, ("hash", hash_fn), transport=mr.settings.all2all,
                   counters=mr.counters)
    mr.last_exchange = out.exchange_stats
    kv.replace_frames(out)


def _key_bytes_rows(col) -> list:
    """Each key's raw bytes — what the reference's user hash receives."""
    from ..core.column import BytesColumn, ObjectColumn
    if isinstance(col, ObjectColumn):
        return col.pickles()
    if isinstance(col, BytesColumn):
        return col.tolist()
    data = np.ascontiguousarray(np.asarray(col.data))
    return [data[i].tobytes() for i in range(data.shape[0])]


def _aggregate_host_hash(backend, mr, hash_fn) -> None:
    """A host hash over each key's bytes (the C-ABI apphash and Python
    callbacks, src/mapreduce.cpp:469-471): rows ordered by destination
    on the host, then placed with that partition (JAX :856-873)."""
    kv = mr.kv
    P = backend.nprocs
    frame = kv.one_frame()
    if not isinstance(frame, KVFrame):
        frame = frame.to_host()
    if len(frame) == 0:
        return
    dest = (np.asarray(hash_fn(_key_bytes_rows(frame.key)))
            .astype(np.int64) % P).astype(np.int32)
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=P).astype(np.int32)
    kv.replace_frames(shard_frame_with_counts(frame.take(order),
                                              backend.mesh, counts))
