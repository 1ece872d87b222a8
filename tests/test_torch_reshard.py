"""Topology resharding of the port (``parallel/reshard.py``,
``MapReduce.reshard``) against the JAX package's, shard by shard.

A KV and a KMV go through ``make_mesh(3)`` → 2 → 5 → 3 on both packages;
after every step the frames must agree as ``test_torch_parallel.py``
compares them (counts, cap, rows in order, padded bytes; KMV values as a
sorted multiset inside a group).  Also: the range destination's
byte-identical round trip, whole groups, an empty frame, interned keys,
host-resident frames, and ``None`` → host."""

import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.parallel.reshard import even_counts as j_even_counts
from gpu_mapreduce_tpu_torch import MapReduce
from gpu_mapreduce_tpu_torch.core.frame import KMVFrame, KVFrame
from gpu_mapreduce_tpu_torch.parallel import reshard
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.parallel.sharded import (MeshKMV, MeshKV,
                                                      ShardedKV)

from test_torch_parallel import emit, one, same_kmv, same_kv, tmesh

WIDTHS = (2, 5, 3)


@pytest.fixture(autouse=True)
def _raw_jax_exchange(monkeypatch):
    monkeypatch.setenv("MRTPU_WIRE", "0")
    monkeypatch.setattr(jshuffle, "_SPEC_CACHE", {})
    monkeypatch.setattr(tshuffle, "_SPEC_CACHE", {})


def _pair(fn=emit, ntasks=6, op="aggregate"):
    jmr, tmr = JMapReduce(j_make_mesh(3)), _port(fn, ntasks, op)
    jmr.map(ntasks, fn)
    getattr(jmr, op)()
    return jmr, tmr


def _port(fn=emit, ntasks=6, op="aggregate"):
    tmr = MapReduce(comm=tmesh(3))
    tmr.map(ntasks, fn)
    getattr(tmr, op)()
    return tmr


def _rows(fr):
    """A mesh frame's valid rows in global order (shard by shard)."""
    k, v = fr.valid_rows()
    return k.numpy().tobytes(), v.numpy().tobytes()


def test_even_counts_match_jax():
    for n in (0, 1, 7, 1000):
        for m in (1, 2, 3, 5, 8):
            assert reshard.even_counts(n, m).tolist() == \
                j_even_counts(n, m).tolist()


def test_mr_reshard_kv_matches_jax():
    """3 → 2 → 5 → 3: every step equal to JAX's, the global row order
    unchanged, ``last_reshard`` and the pair count as JAX's."""
    jmr, tmr = _pair()
    start = _rows(one(tmr.kv))
    prev = 3
    for P in WIDTHS:
        n = jmr.reshard(j_make_mesh(P))
        assert tmr.reshard(tmesh(P)) == n == 3000
        assert tmr.nprocs == P and tmr.backend.nprocs == P
        same_kv(jmr, tmr)
        fr = one(tmr.kv)
        assert isinstance(fr, MeshKV) and fr.mesh == tmesh(P)
        assert fr.counts.tolist() == reshard.even_counts(3000, P).tolist()
        assert _rows(fr) == start
        for key in ("from", "to", "n"):
            assert tmr.last_reshard[key] == jmr.last_reshard[key]
        assert tmr.last_reshard["from"] == prev
        prev = P


def test_round_trip_is_byte_identical():
    """From an even split, N → M → N gives back the same blocks, padding
    included."""
    tmr = _port()
    tmr.reshard(tmesh(4))
    before = one(tmr.kv)
    tmr.reshard(tmesh(2))
    tmr.reshard(tmesh(4))
    after = one(tmr.kv)
    assert (after.cap, after.counts.tolist()) == \
        (before.cap, before.counts.tolist())
    for a, b in zip(before.shards, after.shards):
        assert torch.equal(a.key, b.key) and torch.equal(a.value, b.value)


def test_mr_reshard_kmv_keeps_groups_whole():
    jmr, tmr = _pair(op="collate")
    groups = sorted((k, sorted(v)) for k, v in
                    ((k, list(vals)) for k, vals in one(tmr.kmv).groups()))
    for P in WIDTHS:
        assert jmr.reshard(j_make_mesh(P)) == tmr.reshard(tmesh(P))
        same_kmv(jmr, tmr)
        fr = one(tmr.kmv)
        assert isinstance(fr, MeshKMV)
        assert fr.gcounts.tolist() == \
            reshard.even_counts(len(fr), P).tolist()
        got = sorted((k, sorted(v)) for k, v in
                     ((k, list(vals)) for k, vals in fr.groups()))
        assert got == groups


def test_reshard_kv_and_kmv_functions():
    """The module's functions on mesh frames: the range exchange's
    telemetry (every row routed)."""
    tmr = _port()
    mkv = one(tmr.kv)
    out = reshard.reshard_kv(mkv, tmesh(5))
    assert out.exchange_stats.rows == len(mkv) == len(out)
    assert out.counts.tolist() == reshard.even_counts(len(mkv), 5).tolist()
    back = reshard.reshard_kv(out, tmesh(2))
    assert back.nprocs == 2 and _rows(back) == _rows(mkv)
    tmr.convert()
    kmv = one(tmr.kmv)
    wide = reshard.reshard_kmv(kmv, tmesh(5))
    assert wide.nvalues_total == kmv.nvalues_total
    assert [len(list(s.groups())) for s in wide.shards] == \
        wide.gcounts.tolist()


def test_interned_keys_survive():
    def words(itask, kv, ptr):
        for i in range(300):
            kv.add(b"w%03d" % ((i * 7 + itask) % 37), i)
    jmr, tmr = _pair(fn=words, ntasks=2)
    for P in WIDTHS:
        jmr.reshard(j_make_mesh(P))
        tmr.reshard(tmesh(P))
        same_kv(jmr, tmr)


def test_empty_frame():
    jmr, tmr = _pair(fn=lambda i, kv, p: None)
    for P in WIDTHS:
        assert jmr.reshard(j_make_mesh(P)) == tmr.reshard(tmesh(P)) == 0
    assert len(tmr.kv.one_frame()) == 0


def test_host_resident_frames_stay_and_shard_later():
    """A one-device MR's host frames: reshard swaps the backend only; the
    rows shard at the next aggregate, like fresh data."""
    keys = np.arange(64, dtype=np.uint64)
    jmr, tmr = JMapReduce(), MapReduce(device="cpu")
    for mr in (jmr, tmr):
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, np.ones(64, np.int64)))
    frames = list(tmr.kv.frames())
    assert jmr.reshard(j_make_mesh(3)) == tmr.reshard(tmesh(3)) == 64
    assert list(tmr.kv.frames()) == frames and tmr.nprocs == 3
    for mr in (jmr, tmr):
        mr.aggregate()
    same_kv(jmr, tmr)


def test_none_compacts_to_host():
    """``None`` (or an int) brings mesh frames to the host: KV rows in
    global order, KMV groups whole, one device after."""
    jmr, tmr = _pair()
    rows = tmr.kv.one_frame().to_host()
    for mr in (jmr, tmr):
        mr.reshard(None)
    fr = one(tmr.kv)
    assert isinstance(fr, KVFrame) and tmr.nprocs == 1
    assert np.array_equal(fr.key.data, rows.key.data)
    assert np.array_equal(fr.value.data, rows.value.data)
    jf = jmr.kv.one_frame()
    assert np.array_equal(np.asarray(jf.key.data), fr.key.data)
    jmr, tmr = _pair(op="collate")
    want = sorted((k, sorted(v)) for k, v in one(tmr.kmv).groups())
    for mr in (jmr, tmr):
        mr.reshard(1)
    fr = one(tmr.kmv)
    assert isinstance(fr, KMVFrame)
    assert sorted((k, sorted(v)) for k, v in fr.groups()) == want
    assert tmr.kmv_stats()[:2] == jmr.kmv_stats()[:2]


def test_one_device_frame_moves_as_a_mesh_of_one():
    tmr = MapReduce(device="cpu")
    keys = np.arange(100, dtype=np.uint64) * 3
    tmr.map(1, lambda i, kv, p: kv.add_batch(keys, keys + 1))
    tmr.aggregate()
    assert isinstance(one(tmr.kv), ShardedKV)
    tmr.reshard(tmesh(4))
    fr = one(tmr.kv)
    assert isinstance(fr, MeshKV) and fr.counts.tolist() == [25] * 4
    tmr.reshard(tmesh(1))
    fr = one(tmr.kv)
    assert isinstance(fr, ShardedKV) and tmr.nprocs == 1
    assert fr.to_host().key.data.tolist() == keys.tolist()
