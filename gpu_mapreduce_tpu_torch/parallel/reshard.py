"""Topology resharding: a resident mesh frame moves from N to M shards.

The counterpart of ``gpu_mapreduce_tpu/parallel/reshard.py``.  The
schedule (which global row range lands on which target shard) comes from
the per-shard counts the host already holds; the rows move only through
the exchange (``parallel/shuffle.py``) with the ``("range", offsets,
ends)`` destination, never through host memory:

* **narrowing (M ≤ N)** — one range exchange on the old mesh (every
  destination < M ≤ N exists there), then the first M output blocks are
  re-homed onto the new mesh;
* **widening (M > N)** — re-home first (the old blocks become the first N
  shards of an M-shard frame, the rest zero blocks), then the same range
  exchange on the new mesh.

Re-homing keeps a block's tensors where the new mesh's device is the
block's own; a block whose shard moves to another card is copied device
to device.  The range destination is monotone in the global row index,
so the exchange keeps the global row order exactly: an N → M → N round
trip is byte-identical.

A KMV frame moves at group granularity: groups stay whole.  The
group-boundary schedule needs each group's value count (one pull of
metadata), and the value rows follow their groups through a second range
exchange.  Decode tables ride along unchanged: a ``ShardTables`` routes
by id hash over its own table count, whatever the row placement.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .mesh import Mesh, mesh_axis_size
from .sharded import MeshKMV, MeshKV, ShardedKMV, ShardedKV, even_counts
from .shuffle import exchange


def _offsets(counts) -> Tuple[int, ...]:
    """Exclusive prefix sum: shard i's global row offset."""
    return tuple(int(x) for x in
                 np.concatenate([[0], np.cumsum(counts)])[:-1])


def _rehome(s: ShardedKV, device: torch.device) -> ShardedKV:
    """A one-device block on ``device``: the same tensors when it is
    there already, else a device-to-device copy."""
    if s.device == device:
        return s
    return ShardedKV(s.key.to(device), s.value.to(device), s.counts,
                     s.key_dtype, s.value_dtype, s.key_decode,
                     s.value_decode)


def _widen(mkv: MeshKV, new_mesh: Mesh) -> MeshKV:
    """An N-shard frame as the first N shards of an M-shard frame
    (M > N), zero blocks after them."""
    N, devs = mkv.nprocs, new_mesh.devices
    first = mkv.shards[0]
    shards = [_rehome(s, devs[j]) for j, s in enumerate(mkv.shards)]
    for j in range(N, new_mesh.size):
        shards.append(ShardedKV(
            torch.zeros_like(first.key, device=devs[j]),
            torch.zeros_like(first.value, device=devs[j]),
            np.zeros(1, np.int32), first.key_dtype, first.value_dtype,
            first.key_decode, first.value_decode))
    return MeshKV(new_mesh, shards)


def _narrow(out: MeshKV, new_mesh: Mesh) -> MeshKV:
    """The first M blocks of a routed exchange output as an M-shard frame
    (the counts past M are zero by construction)."""
    M = new_mesh.size
    assert all(int(c) == 0 for c in out.counts[M:]), \
        "narrow: rows routed past the target width"
    return MeshKV(new_mesh, [_rehome(s, new_mesh.devices[j])
                             for j, s in enumerate(out.shards[:M])],
                  exchange_stats=out.exchange_stats)


def _exchange_range(mkv: MeshKV, new_mesh: Mesh, ends: Tuple[int, ...],
                    transport: int, counters) -> MeshKV:
    """The rows of ``mkv`` in their global order onto ``new_mesh``, target
    shard j taking rows up to ``ends[j]``."""
    if new_mesh.size > mkv.nprocs:
        mkv = _widen(mkv, new_mesh)
        return exchange(mkv, ("range", _offsets(mkv.counts), ends),
                        transport=transport, counters=counters)
    out = exchange(mkv, ("range", _offsets(mkv.counts), ends),
                   transport=transport, counters=counters)
    return _narrow(out, new_mesh)


def reshard_kv(mkv: MeshKV, new_mesh: Mesh, transport: int = 1,
               counters=None) -> MeshKV:
    """A mesh KV frame onto ``new_mesh`` (any width), the global row order
    kept exactly."""
    tcounts = even_counts(len(mkv), mesh_axis_size(new_mesh))
    ends = tuple(int(x) for x in np.cumsum(tcounts))
    return _exchange_range(mkv, new_mesh, ends, transport, counters)


def reshard_kmv(mkmv: MeshKMV, new_mesh: Mesh, transport: int = 1,
                counters=None) -> MeshKMV:
    """A mesh KMV frame onto ``new_mesh`` at group granularity: two range
    exchanges (the groups with their sizes, then their value runs) share
    one schedule, and each new shard's value offsets come from it."""
    M = mesh_axis_size(new_mesh)
    G = len(mkmv)
    # the schedule's input: each group's value count, in global group
    # order (one pull of metadata, not of the rows)
    dev0 = mkmv.mesh.devices[0]
    nv_global = torch.cat(
        [s.nvalues[:int(s.gcounts[0])].to(dev0, non_blocking=True)
         for s in mkmv.shards]).cpu().numpy().astype(np.int64)

    tg = even_counts(G, M)                        # groups a target shard
    gends = tuple(int(x) for x in np.cumsum(tg))
    vcum = np.concatenate([[0], np.cumsum(nv_global)]).astype(np.int64)
    vends = tuple(int(vcum[e]) for e in gends)    # group-aligned cuts
    tv = np.diff(np.concatenate([[0], vends])).astype(np.int32)

    first = mkmv.shards[0]
    # exchange 1: the groups (key and size ride together)
    gkv = MeshKV(mkmv.mesh, [
        ShardedKV(s.ukey, s.nvalues, s.gcounts.astype(np.int32),
                  s.key_dtype, np.dtype(np.int32), s.key_decode)
        for s in mkmv.shards])
    gout = _exchange_range(gkv, new_mesh, gends, transport, counters)
    # exchange 2: the value rows by the same cuts (a 1-byte rider fills
    # the exchange's value column)
    vkv = MeshKV(mkmv.mesh, [
        ShardedKV(s.values, torch.zeros(s.values.shape[0], dtype=torch.int8,
                                        device=s.device),
                  s.vcounts.astype(np.int32), s.value_dtype,
                  np.dtype(np.int8), s.value_decode)
        for s in mkmv.shards])
    vout = _exchange_range(vkv, new_mesh, vends, transport, counters)

    shards = []
    gstart = 0
    for j, (g, v) in enumerate(zip(gout.shards, vout.shards)):
        nvj = nv_global[gstart:gstart + int(tg[j])]
        gstart += int(tg[j])
        voff = np.zeros(g.cap, np.int32)
        voff[:len(nvj)] = np.concatenate([[0], np.cumsum(nvj)])[:-1]
        shards.append(ShardedKMV(
            g.key, g.value, torch.from_numpy(voff).to(g.device), v.key,
            np.array([tg[j]], np.int32), np.array([tv[j]], np.int32),
            first.key_dtype, first.value_dtype, first.key_decode,
            first.value_decode))
    return MeshKMV(new_mesh, shards)
