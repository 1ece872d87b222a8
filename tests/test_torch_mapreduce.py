"""The port's MapReduce subset vs the JAX package's MapReduce on a
one-device mesh: map (scalar and batch adds), aggregate, convert, reduce
(per-group host form and batch form) and scan_kv, on the same pairs."""

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.parallel.group import reduce_sharded as j_reduce
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch import MapReduce, MRError
from gpu_mapreduce_tpu_torch.core.runtime import global_counters
from gpu_mapreduce_tpu_torch.parallel.group import reduce_sharded as t_reduce


def _pairs():
    rng = np.random.default_rng(21)
    keys = rng.integers(0, np.iinfo(np.uint64).max, 40, dtype=np.uint64)
    keys = keys[rng.integers(0, 40, 300)]          # repeated keys
    keys[:3] = [0, 1 << 63, np.iinfo(np.uint64).max]
    vals = rng.integers(0, 1 << 31, 300).astype(np.uint32)
    return keys, vals


def _mapper(keys, vals):
    def fn(itask, kv, ptr):
        if itask == 0:
            kv.add_batch(keys[:200], vals[:200])
        else:                                       # the scalar add path
            for k, v in zip(keys[200:].tolist(), vals[200:].tolist()):
                kv.add(k, v)
    return fn


def _scan(mr):
    out = []
    mr.scan_kv(lambda k, v, p: out.append((int(k), int(v))))
    return sorted(out)


@pytest.mark.parametrize("form", ["host", "batch_count", "batch_max"])
def test_mapreduce_chain_matches_jax(form):
    keys, vals = _pairs()
    results = []
    for mr, reduce_sharded in ((MapReduce(device="cpu"), t_reduce),
                               (JMapReduce(make_mesh(1)), j_reduce)):
        assert mr.map(2, _mapper(keys, vals)) == 300
        assert mr.aggregate() == 300
        before = global_counters().ndispatch
        ngroups = mr.convert()
        if isinstance(mr, MapReduce):       # the port counts its programs
            assert global_counters().ndispatch > before
        if form == "host":
            mr.reduce(lambda k, vs, kv, p: kv.add(k, sum(vs) % 1000003))
        else:
            op = form.split("_")[1]
            mr.reduce(lambda fr, kv, p: kv.add_frame(reduce_sharded(fr, op)),
                      batch=True)
        results.append((ngroups, _scan(mr)))
    assert results[0] == results[1]
    assert results[0][0] == len(np.unique(keys))


def test_mapreduce_errors():
    mr = MapReduce(device="cpu")
    with pytest.raises(MRError):
        mr.convert()                    # no KeyValue yet
    with pytest.raises(MRError):
        mr.reduce(lambda *a: None)      # no KeyMultiValue yet
    with pytest.raises(MRError):
        MapReduce(device="cpu", mapstyle=5)
    with pytest.raises(MRError):
        mr.map(1, lambda i, kv, p: kv.add_batch([b"a"], [1]))
