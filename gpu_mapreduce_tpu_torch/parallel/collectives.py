"""gather, broadcast and the reduction across shards over the mesh.

The counterpart of ``gpu_mapreduce_tpu/parallel/collectives.py``, and of
the ``lax.psum``/``pmin``/``pmax`` inside the JAX package's ``shard_map``
bodies:

* :func:`gather_kv` — funnel every shard's rows onto the first n shards:
  the reference's rank-matched Send/Recv funnel
  (src/mapreduce.cpp:893-1036) as one exchange with the fixed
  destination ``i % n`` for shard i ("lo procs recv from hi procs with
  same ID % numprocs", src/mapreduce.cpp:919-928);
* :func:`broadcast_kv` — every shard ends with a copy of root's block
  (the reference's per-page MPI_Bcast, src/mapreduce.cpp:569-623), copied
  device to device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..obs.tracer import NULL_SPAN, get_tracer
from .sharded import MeshKV, ShardedKV
from .shuffle import _rowbytes, exchange


def gather_kv(backend, mr, nprocs: int) -> None:
    skv = backend.mesh_frame(mr.kv, dense_only=True)
    if skv is None:
        return      # host text rows are already "gathered"
    out = exchange(skv, ("fixed_mod", min(nprocs, backend.nprocs)),
                   transport=mr.settings.all2all, counters=mr.counters)
    mr.last_exchange = out.exchange_stats
    mr.kv.replace_frames(out)


def broadcast_kv(backend, mr, root: int) -> None:
    skv = backend.mesh_frame(mr.kv, dense_only=True)
    if skv is None:
        return
    src = skv.shards[root]
    n = int(src.counts[0])
    shards = [ShardedKV(src.key.to(dev, non_blocking=True),
                        src.value.to(dev, non_blocking=True),
                        np.array([n], np.int32), src.key_dtype,
                        src.value_dtype, src.key_decode, src.value_decode)
              for dev in skv.mesh.devices]
    moved = n * (backend.nprocs - 1) * _rowbytes(skv)
    mr.counters.add(cssize=moved, crsize=moved)
    mr.kv.replace_frames(MeshKV(skv.mesh, shards))


_REDUCE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def allreduce(tensors: Sequence[torch.Tensor], op: str
              ) -> List[torch.Tensor]:
    """Each shard's partial tensor (``tensors[p]`` on shard p's device)
    reduced elementwise by ``op`` ("sum", "min" or "max") in shard order on
    ``tensors[0]``'s device; returns one result a shard, on its device.
    Shards that share a device share one copy (the same tensor object),
    and a one-shard list returns its tensor as it is.  Traced, a call
    over more than one shard is a ``mesh.allreduce`` span whose ``bytes``
    are those copied between devices."""
    tr = get_tracer()
    with tr.span("mesh.allreduce", cat="mesh", op=op, shards=len(tensors),
                 bytes=_moved_bytes(tensors)) \
            if tr.enabled and len(tensors) > 1 else NULL_SPAN:
        fn = _REDUCE[op]
        acc = tensors[0]
        for t in tensors[1:]:
            acc = fn(acc, t.to(acc.device, non_blocking=True))
        return replicate(acc, [t.device for t in tensors])


def _moved_bytes(tensors: Sequence[torch.Tensor]) -> int:
    """Bytes :func:`allreduce` copies between devices: each partial off
    the first device to it, the result back to each other device."""
    dev = tensors[0].device
    off = [t for t in tensors[1:] if t.device != dev]
    others = {t.device for t in off}
    return sum(t.nbytes for t in off) + len(others) * tensors[0].nbytes


def replicate(t: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """``t`` on each of ``devices`` (one entry a shard): shards on ``t``'s
    own device get ``t``, shards that share another device one copy."""
    copies: Dict[torch.device, torch.Tensor] = {t.device: t}
    for dev in devices:
        if dev not in copies:
            copies[dev] = t.to(dev, non_blocking=True)
    return [copies[dev] for dev in devices]


def per_device(fn: Callable, *replicated: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """``fn`` over the replicas of one or more replicated values (lists of
    one tensor a shard, as :func:`allreduce` returns), called once a
    device with that device's replicas; the result is replicated the same
    way."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for args in zip(*replicated):
        dev = args[0].device
        if dev not in done:
            done[dev] = fn(*args)
        out.append(done[dev])
    return out
