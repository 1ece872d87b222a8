"""The two-phase exchange: aggregate, gather and the data plane's shuffle.

The counterpart of ``gpu_mapreduce_tpu/parallel/shuffle.py`` (the
reference's ``MapReduce::aggregate`` over ``Irregular``,
src/mapreduce.cpp:385-563, src/irregular.cpp), over a mesh driven by one
process:

phase 1, per shard (:func:`phase1`, ``_phase1_core``, JAX :77-89): a
  destination for every valid row (the default lookup3 hash, a device
  hash function, or a fixed shard), a stable sort of the rows by
  destination, and the rows per destination; then the ``[P, P]`` counts
  come to the host in one transfer — the op's one sync
  (:class:`~.sharded.SyncStats`).

the plan (:func:`plan_from_pull`, ``_plan_caps``, JAX :452-466): the
  count matrix sizes the output; a cached plan is held against it by
  :func:`plan_holds` and :func:`plan_oversized`.

phase 2, per destination (:func:`phase2`, JAX ``phase2_shard_body``
  :324-359): output shard d is zeros ``[cap_out]``; each source's dest-d
  slice is copied to ``base[src]``, sources in ascending order, so shard
  d holds every source's rows for it, source-major and each in its
  original order.  ``all2all=1`` copies every source's slice to every
  destination; ``all2all=0`` runs the ring schedule of
  ``_ring_exchange`` (JAX :141-168): P-1 shifts in which destination d
  takes from ``(d-s) % P``.  The output is identical.  Between distinct
  cards the copies go device to device, never through host memory.

The eager exchange (:func:`exchange`) and the fused exchange group of
``plan/fuser.py`` share these three steps, so their layouts and
telemetry are one.  A rank frame of the process group
(``parallel/dist.RankKV``) takes the same phase 1 and plan on its own
block, the count matrix in one gather across ranks and phase 2 as one
``all_to_all_single`` a column (:func:`exchange_ranks`); rank d's block
equals the one-process mesh's shard d.  The JAX package's speculative
cap cache of the eager exchange, wire codec, buffer donation, retry
wrapper and trace spans give results bit-identical to this raw exchange
and are not ported (ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.frame import KVFrame
from ..core.runtime import MRError, bump_dispatch
from ..ops.hash import default_hash
from . import dist as _dist
from .dist import RankKV
from .sharded import (MeshKV, ShardedKV, SyncStats, round_cap,
                      shard_frame_with_counts)

_MAX_ROUNDS = 16     # the JAX schedule's round bound (telemetry here)


@dataclass
class ExchangeCallStats:
    """Flow-control telemetry of one exchange (the JAX package's
    ``ExchangeCallStats``): the bucket B and round count of the padded
    schedule the JAX exchange runs, the output cap, the rows routed, and
    the bytes that cross between shards (``sent_bytes``, the diagonal
    excluded) and the padding its schedule would send (``pad_bytes``);
    beside them the count matrix's smallest and largest bucket."""

    nrounds: int
    bucket: int
    cap_out: int
    rows: int
    sent_bytes: int = 0
    pad_bytes: int = 0
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


def _phase1_core(nprocs: int, dest_of: Callable, shard: ShardedKV, p: int):
    """One shard's valid rows stably sorted by destination, and the rows
    per destination ``[P]`` (int64, on the shard's device)."""
    c = int(shard.counts[0])
    key, value = shard.key[:c], shard.value[:c]
    if isinstance(dest_of, _RangeDest):
        return key, value, torch.from_numpy(
            dest_of.rows_per_dest(p, c)).to(key.device)
    sd, order = torch.sort(dest_of(key, p), stable=True)
    # rows per destination from the sorted destinations: no atomics on
    # P hot counters
    bounds = torch.searchsorted(sd, torch.arange(nprocs + 1,
                                                 device=key.device))
    return key[order], value[order], bounds[1:] - bounds[:-1]


def _plan_caps(counts_mat: np.ndarray):
    """(B, nrounds, cap_out, new_counts) from the count matrix: the
    JAX exchange pads buckets to about the mean nonzero bucket, in at
    most ``_MAX_ROUNDS`` rounds; the output cap is the power of two over
    the largest destination's rows."""
    Bmax = round_cap(int(counts_mat.max())) if counts_mat.max() else 8
    new_counts = counts_mat.sum(axis=0).astype(np.int32)
    cap_out = round_cap(int(new_counts.max())) if new_counts.max() else 8
    nz = counts_mat[counts_mat > 0]
    B = round_cap(int(np.ceil(nz.mean()))) if len(nz) else 8
    nrounds = -(-Bmax // B)
    if nrounds > _MAX_ROUNDS:
        nrounds = _MAX_ROUNDS
        B = round_cap(-(-Bmax // nrounds))
        nrounds = -(-Bmax // B)
    return B, nrounds, cap_out, new_counts


def _rowbytes(skv) -> int:
    s = skv.shard if isinstance(skv, RankKV) else skv.shards[0]
    k, v = s.key, s.value
    return (k.element_size() * (k.shape[1] if k.dim() > 1 else 1)
            + v.element_size() * (v.shape[1] if v.dim() > 1 else 1))


def exchange_volume(skv: MeshKV, counts_mat: np.ndarray, slots: int,
                    nprocs: int) -> tuple:
    """(moved, pad, rowbytes) of one exchange (JAX :509-528): the rows
    that leave their shard, and the empty slots of the padded schedule
    (``slots`` per bucket), the diagonal excluded on both sides."""
    rowbytes = _rowbytes(skv)
    useful = int(counts_mat.sum() - np.trace(counts_mat))
    sent_slots = nprocs * (nprocs - 1) * slots
    return (useful * rowbytes, max(0, sent_slots - useful) * rowbytes,
            rowbytes)


def _schedule(transport: int, nprocs: int):
    """The (src, dst) copies in issue order: ``all2all=1`` sources in
    ascending order for each destination; ``all2all=0`` the ring's shifts
    s = 0 (the self copy) .. P-1, destination d taking from (d-s) % P."""
    if transport == 1:
        return [(s, d) for d in range(nprocs) for s in range(nprocs)]
    return [((d - s) % nprocs, d) for s in range(nprocs)
            for d in range(nprocs)]


def phase1(skv: MeshKV, dest) -> tuple:
    """Phase 1 of an exchange: every shard's valid rows stably sorted by
    destination (``_phase1_core``), then the ``[P, P]`` count matrix on
    the host in one transfer — the op's one sync.  Returns
    ``(sorted_rows, counts_mat)``; the eager exchange and the fused
    exchange group (``plan/fuser.py``) share it."""
    mesh = skv.mesh
    P = mesh.size
    dest_of = _dest_fn(dest, P, skv.key_dtype)
    bump_dispatch()
    sorted_rows = [_phase1_core(P, dest_of, s, p)
                   for p, s in enumerate(skv.shards)]
    dev0 = mesh.devices[0]
    SyncStats.bump()          # the op's one pull: the count matrix
    counts_mat = torch.stack([c.to(dev0, non_blocking=True)
                              for _, _, c in sorted_rows]).cpu().numpy()
    return sorted_rows, counts_mat


# -- the plan: one planning step for the eager and the fused exchange -------
# A plan is ("raw", B, nrounds, cap_out): the padded schedule's bucket and
# round count (telemetry) and the output cap.  JAX parallel/wire.py keeps
# the same tuple for its raw schedule; its wire plans are not ported.

def plan_from_pull(counts_mat: np.ndarray) -> tuple:
    """The count matrix → ``(plan, bmax_raw, nmax_out, new_counts)``
    (JAX ``wire.plan_from_pull`` with the codec off): ``bmax_raw`` and
    ``nmax_out`` are the bounds a cached plan is held against."""
    B, nrounds, cap_out, new_counts = _plan_caps(counts_mat)
    return (("raw", B, nrounds, cap_out), int(counts_mat.max()),
            max(int(new_counts.max()), 8), new_counts)


def plan_slots(plan) -> int:
    """Slots per bucket of the plan's padded schedule."""
    return int(plan[1] * plan[2])


def plan_cap_out(plan) -> int:
    return int(plan[3])


def plan_holds(plan, bmax: int, nmax_out: int) -> bool:
    """Whether a cached plan still delivers every row: its slots cover
    the largest bucket and its cap the largest destination."""
    return plan_slots(plan) >= bmax and plan_cap_out(plan) >= nmax_out


def plan_oversized(plan, bmax: int, nmax_out: int) -> bool:
    """Whether a cached plan is ≥ 4× too large for this count matrix
    (the right-sizing rule of the JAX speculative caps)."""
    return (plan_slots(plan) > 4 * max(bmax, 8)
            or plan_cap_out(plan) > 4 * round_cap(nmax_out))


def phase2(skv: MeshKV, sorted_rows, counts_mat: np.ndarray, cap_out: int,
           transport: int = 1) -> list:
    """Phase 2 at a plan's ``cap_out``: each destination's ``(keys,
    values)`` block of ``cap_out`` rows, every source's slice at its base,
    sources in ascending order (``_schedule`` only orders the copies)."""
    mesh = skv.mesh
    P = mesh.size
    # per source: where each destination's slice starts in its sorted rows;
    # per destination: where each source's slice lands in the output
    src_off = np.concatenate([np.zeros((P, 1), np.int64),
                              np.cumsum(counts_mat, axis=1)], axis=1)
    dst_base = np.concatenate([np.zeros((1, P), np.int64),
                               np.cumsum(counts_mat, axis=0)], axis=0)
    k0, v0 = skv.shards[0].key, skv.shards[0].value
    out_k = [k0.new_zeros((cap_out,) + tuple(k0.shape[1:]), device=dev)
             for dev in mesh.devices]
    out_v = [v0.new_zeros((cap_out,) + tuple(v0.shape[1:]), device=dev)
             for dev in mesh.devices]
    bump_dispatch()
    for s, d in _schedule(transport, P):
        n = int(counts_mat[s, d])
        if not n:
            continue
        lo, at = int(src_off[s, d]), int(dst_base[s, d])
        sk, sv, _ = sorted_rows[s]
        out_k[d][at:at + n].copy_(sk[lo:lo + n], non_blocking=True)
        out_v[d][at:at + n].copy_(sv[lo:lo + n], non_blocking=True)
    return list(zip(out_k, out_v))


def exchange_stats(skv: MeshKV, counts_mat: np.ndarray, plan,
                   counters=None) -> ExchangeCallStats:
    """The telemetry of one exchange at ``plan`` (shared by the eager and
    the fused exchange); the bytes also go to ``counters``."""
    P = skv.nprocs
    moved, pad, _ = exchange_volume(skv, counts_mat, plan_slots(plan), P)
    if counters is not None:
        counters.add(cssize=moved, crsize=moved, cspad=pad)
    return ExchangeCallStats(nrounds=plan[2], bucket=plan[1],
                             cap_out=plan_cap_out(plan),
                             rows=int(counts_mat.sum()), sent_bytes=moved,
                             pad_bytes=pad,
                             bucket_min=int(counts_mat.min()),
                             bucket_max=int(counts_mat.max()))


def exchange(skv: MeshKV, dest, transport: int = 1, counters=None,
             site: str = "exchange") -> MeshKV:
    """Route every valid row of a mesh frame to its destination shard
    (``dest`` as in :func:`_dest_fn`); decode tables ride along.  The new
    frame carries :class:`ExchangeCallStats` as ``exchange_stats``.  A
    rank frame (``parallel/dist.RankKV``) exchanges across the process
    group (:func:`exchange_ranks`, its rows' sync point named ``site``)."""
    if isinstance(skv, RankKV):
        return exchange_ranks(skv, dest, counters, site)
    sorted_rows, counts_mat = phase1(skv, dest)
    plan, _bmax, _nmax, new_counts = plan_from_pull(counts_mat)
    blocks = phase2(skv, sorted_rows, counts_mat, plan_cap_out(plan),
                    transport)
    out = MeshKV(skv.mesh, [ShardedKV(k, v, np.array([n], np.int32),
                                      skv.key_dtype, skv.value_dtype,
                                      skv.key_decode, skv.value_decode)
                            for (k, v), n in zip(blocks, new_counts)])
    out.exchange_stats = exchange_stats(skv, counts_mat, plan, counters)
    return out


def exchange_ranks(skv: RankKV, dest, counters=None,
                   site: str = "exchange") -> RankKV:
    """The exchange across ranks (JAX ``shuffle.py:686-703`` over
    ``dist.host_pull``): phase 1 on this rank's block; the ``[P, P]``
    count matrix in one gather on the metadata group under the
    ``count_sync`` watchdog; the same plan on every rank; keys and values
    in one ``all_to_all_single`` each under the ``site`` watchdog, padded
    with zeros to ``cap_out``.  Rank d's block, cap and count equal the
    one-controller mesh's shard d byte for byte: ``all_to_all_single``
    lays its output out by source rank, which is the mesh's source-major
    order.  The new frame carries ``exchange_stats`` and the seconds of
    both sync points (``sync_seconds``)."""
    if skv.key_decode is not None or skv.value_decode is not None:
        raise MRError("an exchange of interned columns across ranks is not "
                      "ported yet (intern tables are per process)")
    P, rank = skv.nprocs, skv.rank
    dest_of = _dest_fn(dest, P, skv.key_dtype)
    bump_dispatch()
    key, value, row = _phase1_core(P, dest_of, skv.shard, rank)
    t0 = time.perf_counter()
    SyncStats.bump()          # the op's one pull: the count matrix
    counts_mat = _dist.guard_call(
        "count_sync", lambda: _dist.all_gather_host(row.cpu().numpy()))
    t1 = time.perf_counter()
    plan, _bmax, _nmax, new_counts = plan_from_pull(counts_mat)
    bump_dispatch()
    k, v = _dist.guard_call(site, _dist.all_to_all_rows, (key, value),
                            counts_mat, plan_cap_out(plan))
    t2 = time.perf_counter()
    out = RankKV(rank, ShardedKV(k, v, new_counts[rank:rank + 1].copy(),
                                 skv.key_dtype, skv.value_dtype),
                 new_counts)
    out.exchange_stats = exchange_stats(skv, counts_mat, plan, counters)
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
