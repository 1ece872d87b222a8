"""The port's plan/ subset (recorder, fuser, cache) against the JAX
package's plan/ on a one-device mesh: the same aggregate → convert →
reduce(kernel) chain run eagerly, fused cold and fused warm must give the
same pairs in both packages, with ``MRTPU_PALLAS_GROUP=1`` on both so the
warm count/sum groups take the group table (the port's plain version of
``csrc/seg_table.cu``; the JAX package's Pallas kernel in interpret
mode).  Also the ops the top-N tail runs (``sort_sharded`` and the host
reduces) against their JAX twins."""

import warnings

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.ops import reduces as jr
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.plan import plan_cache as j_plan_cache
from gpu_mapreduce_tpu.plan import plan_history as j_plan_history
from gpu_mapreduce_tpu.plan.cache import fusion_stats as j_fusion_stats
from gpu_mapreduce_tpu_torch import MapReduce, MRError
from gpu_mapreduce_tpu_torch.ops import reduces as tr
from gpu_mapreduce_tpu_torch.ops.cuda import group as tgroup
from gpu_mapreduce_tpu_torch.plan import PendingCount, plan_cache, \
    plan_history

KERNELS = ["count", "sum_values", "max_values", "min_values", "cull"]


@pytest.fixture(autouse=True)
def fresh_plans(monkeypatch):
    """Both packages' plan caches start empty; the table is forced on."""
    monkeypatch.setenv("MRTPU_PALLAS_GROUP", "1")
    monkeypatch.delenv("MRTPU_FUSE", raising=False)
    plan_cache().clear()
    j_plan_cache().clear()
    yield
    plan_cache().clear()
    j_plan_cache().clear()


def intcount_keys(n=3000, card=97):
    """u64 keys with the top bit set on about half of them, repeated."""
    base = np.random.default_rng(card).integers(0, 1 << 64, card,
                                                dtype=np.uint64)
    return base[(np.arange(n) * 7919) % card]


def scan_pairs(mr):
    got = []
    mr.scan_kv(lambda k, v, p: got.append(
        (int(k), v if isinstance(v, float) else int(v))))
    return sorted(got)


def run_chain(port, fuse, kernel, keys, vals):
    mr = MapReduce(device="cpu", fuse=fuse) if port \
        else JMapReduce(make_mesh(1), fuse=fuse)
    mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
    mr.aggregate()
    mr.convert()
    n = mr.reduce(getattr(tr if port else jr, kernel), batch=True)
    return int(n), scan_pairs(mr)


def _port_group():
    """(mode, table) of the fused group of the last port plan."""
    fused = [g for g in plan_history()[-1]["groups"] if g["fused"]]
    assert len(fused) == 1
    return fused[0]["mode"], fused[0]["table"]


def _jax_group():
    fused = [g for g in j_plan_history()[-1]["groups"] if g["fused"]]
    assert len(fused) == 1
    return fused[0]["mode"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_eager_cold_warm_match_jax(kernel):
    keys = intcount_keys()
    vals = np.random.default_rng(1).integers(-(1 << 40), 1 << 40,
                                             len(keys)).astype(np.int64)
    table = kernel in ("count", "sum_values")
    results = {}
    for port in (True, False):
        runs = [run_chain(port, 0, kernel, keys, vals)]
        for want_mode in ("local", "local1"):
            p0 = j_fusion_stats()["pallas_groups"]
            runs.append(run_chain(port, 1, kernel, keys, vals))
            if port:
                assert _port_group() == (want_mode,
                                         table and want_mode == "local1")
            else:
                assert _jax_group() == want_mode
                took = j_fusion_stats()["pallas_groups"] - p0
                assert took == int(table and want_mode == "local1")
        assert runs[0] == runs[1] == runs[2]
        results[port] = runs[0]
    assert results[True] == results[False]
    assert results[True][0] == len(np.unique(keys))


def test_warm_run_that_outgrows_gcap_reruns_on_the_sort_path():
    """The cold run arms gcap for 97 groups; a warm run over the same
    frame shape with 3000 distinct keys overflows the table (T = 256),
    is thrown away and runs again cold — output still exact."""
    small = intcount_keys(card=97)
    big = intcount_keys(card=3000)
    vals = np.ones(len(small), np.int64)
    for port in (True, False):
        cold = run_chain(port, 1, "count", small, vals)
        grown = run_chain(port, 1, "count", big, vals)
        assert grown == run_chain(port, 0, "count", big, vals)
        assert cold == run_chain(port, 0, "count", small, vals)
        if port:
            assert _port_group() == ("local", False)  # the cold re-run
        else:
            assert _jax_group() == "local"
    # re-armed at the grown capacity: the next run is warm on the table
    assert run_chain(True, 1, "count", big, vals) == \
        run_chain(False, 1, "count", big, vals)
    assert _port_group() == ("local1", True)


def test_pipeline_and_pending_count():
    keys = intcount_keys()
    vals = np.ones(len(keys), np.int64)
    counts = []
    for mr in (MapReduce(device="cpu"), JMapReduce(make_mesh(1))):
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        with mr.pipeline():
            mr.aggregate()
            mr.convert()
            n = mr.reduce(tr.count if isinstance(mr, MapReduce)
                          else jr.count, batch=True)
            assert len(mr._plan.stages) == 3         # nothing ran yet
        counts.append((int(n), scan_pairs(mr)))
    assert counts[0] == counts[1]

    mr = MapReduce(device="cpu", fuse=1)
    mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
    n = mr.aggregate()
    assert isinstance(n, PendingCount) and len(mr._plan.stages) == 1
    assert int(n) == len(keys) and mr._plan is None  # int() flushed


def test_dataset_read_flushes_the_plan():
    keys = intcount_keys()
    mr = MapReduce(device="cpu", fuse=1)
    mr.map(1, lambda i, kv, p: kv.add_batch(keys, np.ones_like(keys)))
    mr.aggregate()
    mr.convert()
    mr.reduce(tr.count, batch=True)
    assert len(mr._plan.stages) == 3
    kv = mr.kv                                       # the barrier
    assert mr._plan is None and kv.nkv == len(np.unique(keys))


def test_discarded_pending_count_raises():
    mr = MapReduce(device="cpu", fuse=1)
    mr.map(1, lambda i, kv, p: kv.add_batch(np.arange(5), np.arange(5)))
    n = mr.aggregate()
    mr.discard_plan()
    with pytest.raises(MRError):
        int(n)
    with pytest.raises(ValueError):
        with mr.pipeline():
            mr.convert()
            raise ValueError("abort")          # the tail is discarded
    assert mr.kmv is None


def test_unsupported_chain_warns_once_and_matches(monkeypatch):
    monkeypatch.setattr(tgroup, "_WARNED", set())
    keys = intcount_keys()
    vals = (np.arange(len(keys)) % 17) * 0.25        # a float sum, exact
    eager = run_chain(True, 0, "sum_values", keys, vals)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cold = run_chain(True, 1, "sum_values", keys, vals)
        warm = run_chain(True, 1, "sum_values", keys, vals)
        warm2 = run_chain(True, 1, "sum_values", keys, vals)
    ours = [w for w in rec if "MRTPU_PALLAS_GROUP" in str(w.message)]
    assert len(ours) == 1 and "float" in str(ours[0].message)
    assert eager == cold == warm == warm2
    assert _port_group() == ("local1", False)
    assert warm == run_chain(False, 0, "sum_values", keys, vals)


@pytest.mark.parametrize("by", ["key", "value"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_sharded_matches_jax(by, descending):
    from gpu_mapreduce_tpu.parallel.group import sort_sharded as jsort
    from gpu_mapreduce_tpu.parallel.sharded import shard_frame
    from gpu_mapreduce_tpu.core.frame import KVFrame as JKVFrame
    from gpu_mapreduce_tpu_torch.interop import kv_from_numpy, to_numpy
    from gpu_mapreduce_tpu_torch.parallel.group import sort_sharded
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 64, 200, dtype=np.uint64)[
        rng.integers(0, 200, 300)]                    # ties on the key
    vals = rng.integers(0, 20, 300).astype(np.int64)  # ties on the value
    cap = 512
    kpad, vpad = np.zeros(cap, np.uint64), np.zeros(cap, np.int64)
    kpad[:300], vpad[:300] = keys, vals
    got = to_numpy(sort_sharded(kv_from_numpy(kpad, vpad, [300], "cpu"),
                                by, descending))
    jf = jsort(shard_frame(JKVFrame(keys, vals), make_mesh(1)), by,
               descending)
    np.testing.assert_array_equal(got["key"][:300], np.asarray(jf.key)[:300])
    np.testing.assert_array_equal(got["value"][:300],
                                  np.asarray(jf.value)[:300])


@pytest.mark.parametrize("kernel", KERNELS)
def test_host_reduces_match_jax(kernel):
    from gpu_mapreduce_tpu.core.frame import KMVFrame as JKMVFrame
    from gpu_mapreduce_tpu_torch.core.dataset import KeyValue
    from gpu_mapreduce_tpu_torch.core.frame import KMVFrame
    keys = np.array([3, 9, 12], np.uint64)
    nval = np.array([2, 1, 3], np.int64)
    offs = np.array([0, 2, 3, 6], np.int64)
    vals = np.array([5, -2, 7, 1, 1, 9], np.int64)
    kv = KeyValue()
    getattr(tr, kernel)(KMVFrame(keys, nval, offs, vals), kv)
    got = [(int(k), int(v)) for f in kv._batches for k, v in f.pairs()]
    jmr = JMapReduce()
    jkv = jmr._new_kv()
    getattr(jr, kernel)(JKMVFrame(keys, nval, offs, vals), jkv)
    jkv.complete()
    want = [(int(k), int(v)) for f in jkv.frames() for k, v in f.pairs()]
    assert got == want
