"""gather and broadcast over the mesh.

The counterpart of ``gpu_mapreduce_tpu/parallel/collectives.py``:

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

import numpy as np

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
