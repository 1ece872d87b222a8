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


def test_map_mr_add_collate_match_jax():
    """map with addflag, map_mr (batch on itself, and per pair), add,
    kv_stats and collate: the same counts and pairs as the JAX package."""
    from gpu_mapreduce_tpu.ops.reduces import count as j_count
    from gpu_mapreduce_tpu_torch.ops.reduces import count as t_count
    keys, vals = _pairs()
    results = []
    for make, count in ((lambda: MapReduce(device="cpu"), t_count),
                        (lambda: JMapReduce(make_mesh(1)), j_count)):
        mr, evens, pairs = make(), make(), make()
        mr.map(1, lambda i, kv, p: kv.add_batch(keys[:100], vals[:100]))
        n_add = mr.map(1, lambda i, kv, p: kv.add_batch(keys[100:],
                                                         vals[100:]),
                       addflag=1)
        mr.aggregate()
        n_self = mr.map_mr(mr, lambda fr, kv, p: kv.add_frame(fr), addflag=1,
                           batch=True)
        seen = []
        n_pairs = pairs.map_mr(mr, lambda itask, k, v, kv, p: seen.append(
            (itask, int(k), int(v))))
        evens.map(1, lambda i, kv, p: kv.add_batch(keys[::2], vals[::2]))
        n_total = mr.add(evens)
        n_stats = mr.kv_stats(0)[0]
        ngroups = mr.collate()
        mr.reduce(count, batch=True)
        results.append((n_add, n_self, n_pairs, seen, n_total, n_stats,
                        int(ngroups), _scan(mr)))
    assert results[0][:3] == (300, 600, 0) and results[0][4] == 750
    assert results[0] == results[1]


def test_add_batch_of_device_tensors():
    """Tensors stay a device frame with the logical dtypes given; the
    pairs and the byte count equal the host arrays'."""
    import torch
    keys, vals = _pairs()
    host, dev = MapReduce(device="cpu"), MapReduce(device="cpu")
    host.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
    dev.map(1, lambda i, kv, p: kv.add_batch(
        torch.from_numpy(keys.view(np.int64)),
        torch.from_numpy(vals.view(np.int32)), key_dtype=np.uint64,
        value_dtype=np.uint32))
    assert _scan(host) == _scan(dev)
    assert host.kv_stats(0) == dev.kv_stats(0) == (300, 300 * 12)
    with pytest.raises(MRError):
        dev.map(1, lambda i, kv, p: kv.add_batch(torch.zeros(3),
                                                 torch.zeros(2)))
