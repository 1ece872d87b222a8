"""The port's mesh data plane vs the JAX package's mesh, shard by shard.

The JAX package runs ``make_mesh(P)`` over the 8 CPU devices the
conftest fakes; the port runs ``make_mesh(P, devices=["cpu"] * P)``, one
process driving P shards.  For P in {1, 3, 8} and the same numpy inputs
every frame must agree shard by shard: ``counts``, ``cap``, the valid
rows in order (keys and values, bit for bit, dtypes included) and the
padded byte counts (``kv_stats``/``kmv_stats``).  Inside a KMV group the
values compare as a sorted multiset: the JAX convert sorts with
``jnp.lexsort``, which does not promise a stable order.

The JAX exchange's wire codec and speculative caps give results
bit-identical to its raw schedule; the flow-control telemetry compared
here is the raw schedule's, so those tests set ``MRTPU_WIRE=0`` and clear
the speculation cache."""

import collections
import json
import os

import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.oink.kernels import count as j_count
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel.group import reduce_sharded as j_reduce
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.parallel.sharded import SyncStats as JSyncStats
from gpu_mapreduce_tpu_torch import MapReduce, MRError, interop
from gpu_mapreduce_tpu_torch.core.column import ShardTables
from gpu_mapreduce_tpu_torch.ops.bits import to_numpy
from gpu_mapreduce_tpu_torch.ops.reduces import count as t_count
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.parallel.group import reduce_sharded as t_reduce
from gpu_mapreduce_tpu_torch.parallel.mesh import Mesh, make_mesh
from gpu_mapreduce_tpu_torch.parallel.sharded import (MeshKMV, MeshKV,
                                                      SyncStats)

PS = [1, 3, 8]


def tmesh(P):
    return make_mesh(P, devices=["cpu"] * P)


def emit(itask, kv, ptr):
    rng = np.random.default_rng(itask)
    keys = rng.integers(0, 97, size=500).astype(np.uint64)
    kv.add_batch(keys, keys * 10 + itask)


def oracle_pairs(ntasks=6):
    out = []
    for itask in range(ntasks):
        rng = np.random.default_rng(itask)
        keys = rng.integers(0, 97, size=500).astype(np.uint64)
        out.extend(zip(keys.tolist(), (keys * 10 + itask).tolist()))
    return out


def both(P, **settings):
    """A JAX and a port MapReduce over P shards (exchange caps cold)."""
    jshuffle._SPEC_CACHE.clear()
    return (JMapReduce(j_make_mesh(P), **settings),
            MapReduce(comm=tmesh(P), **settings))


# -- frame snapshots ---------------------------------------------------------

def _jdecode(table, ids):
    from gpu_mapreduce_tpu.parallel.sharded import _decode_col
    return _decode_col(table, ids).tolist()


def _host_kv(fr):
    """A host frame in :func:`jkv`'s form: no cap, one block."""
    def col(c):
        data = getattr(c, "data", None)
        if isinstance(data, np.ndarray) and data.dtype != object:
            return data, None
        return np.zeros(0), c.tolist()
    (k, kd), (v, vd) = col(fr.key), col(fr.value)
    return None, [len(fr)], [(k, v, kd, vd)]


def jkv(mr):
    """A JAX KV frame as (cap, counts, [(keys, values, decoded keys,
    decoded values)] per shard)."""
    fr = mr.kv.one_frame()
    if not hasattr(fr, "nprocs"):
        return _host_kv(fr)
    P, cap = fr.nprocs, fr.cap
    k = np.asarray(fr.key).reshape((P, cap) + fr.key.shape[1:])
    v = np.asarray(fr.value).reshape((P, cap) + fr.value.shape[1:])
    blocks = []
    for p in range(P):
        n = int(fr.counts[p])
        kp, vp = k[p, :n], v[p, :n]
        blocks.append((kp, vp,
                       _jdecode(fr.key_decode, kp) if fr.key_decode
                       is not None else None,
                       _jdecode(fr.value_decode, vp) if fr.value_decode
                       is not None else None))
    return cap, fr.counts.tolist(), blocks


def _shards(fr):
    return fr.shards if isinstance(fr, (MeshKV, MeshKMV)) else [fr]


def tkv(mr):
    """The port's KV frame in :func:`jkv`'s form."""
    fr = one(mr.kv)
    if not hasattr(fr, "counts"):
        return _host_kv(fr)
    blocks = []
    for s in _shards(fr):
        n = int(s.counts[0])
        kp, vp = to_numpy(s.key[:n], s.key_dtype), \
            to_numpy(s.value[:n], s.value_dtype)
        blocks.append((kp, vp,
                       s.key_decode.decode_batch(kp) if s.key_decode
                       is not None else None,
                       s.value_decode.decode_batch(vp) if s.value_decode
                       is not None else None))
    return fr.cap, fr.counts.tolist(), blocks


def one(ds):
    frames = list(ds.frames())
    assert len(frames) == 1, frames
    return frames[0]


def same_kv(jmr, tmr):
    jc, jn, jb = jkv(jmr)
    tc, tn, tb = tkv(tmr)
    assert (tc, tn) == (jc, jn)
    for p, (a, b) in enumerate(zip(jb, tb)):
        assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype, p
        np.testing.assert_array_equal(b[0], a[0], err_msg=f"keys {p}")
        np.testing.assert_array_equal(b[1], a[1], err_msg=f"values {p}")
        assert b[2] == a[2] and b[3] == a[3], p
    assert tmr.kv_stats() == jmr.kv_stats()


def _groups(hf):
    keys = hf.key.tolist()
    vals = [sorted(hf.group_values(i).tolist(), key=repr)
            for i in range(len(hf))]
    return keys, np.asarray(hf.nvalues).tolist(), vals


def same_kmv(jmr, tmr):
    jf = jmr.kmv.one_frame()
    tf = one(tmr.kmv)
    assert (tf.gcap, tf.vcap) == (jf.gcap, jf.vcap)
    assert tf.gcounts.tolist() == jf.gcounts.tolist()
    assert tf.vcounts.tolist() == jf.vcounts.tolist()
    for p, s in enumerate(_shards(tf)):
        assert _groups(s.to_host()) == _groups(jf.shard_to_host(p)), p
    assert tmr.kmv_stats() == jmr.kmv_stats()


# -- aggregate, convert, reduce ----------------------------------------------

@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("all2all", [1, 0])
def test_aggregate_matches_jax(P, all2all):
    jmr, tmr = both(P, all2all=all2all)
    assert jmr.map(6, emit) == tmr.map(6, emit) == 3000
    assert jmr.aggregate() == tmr.aggregate() == 3000
    same_kv(jmr, tmr)
    if P > 1:
        fr = one(tmr.kv)
        assert isinstance(fr, MeshKV) and fr.nprocs == P
        # every key sits on its lookup3 shard
        from gpu_mapreduce_tpu_torch.ops.hash import default_hash
        for p, s in enumerate(fr.shards):
            k = s.key[:int(s.counts[0])]
            assert bool((default_hash(k, np.uint64) % P == p).all())
        assert tmr.stats()["cssize"] >= tmr.last_exchange.sent_bytes > 0


@pytest.mark.parametrize("P", PS)
def test_collate_reduce_matches_jax(P):
    jmr, tmr = both(P)
    jmr.map(6, emit)
    tmr.map(6, emit)
    assert jmr.collate() == tmr.collate() == 97
    same_kmv(jmr, tmr)
    assert jmr.reduce(j_count, batch=True) == \
        tmr.reduce(t_count, batch=True) == 97
    same_kv(jmr, tmr)
    got = {}
    tmr.scan_kv(lambda k, v, p: got.update({int(k): int(v)}))
    assert got == dict(collections.Counter(k for k, _ in oracle_pairs()))


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_reduce_sharded_ops_match_jax(P, op):
    jmr, tmr = both(P)
    jmr.map(6, emit)
    tmr.map(6, emit)
    jmr.collate()
    tmr.collate()
    jfr = jmr.kmv.one_frame()
    tfr = one(tmr.kmv)
    j, t = j_reduce(jfr, op), t_reduce(tfr, op)
    assert t.counts.tolist() == j.counts.tolist() and t.cap == j.cap
    assert dict(t.to_host().pairs()) == dict(j.to_host().pairs())
    for p, s in enumerate(_shards(t)):
        a, b = j.shard_to_host(p), s.to_host()
        np.testing.assert_array_equal(b.key.data, a.key.data)
        np.testing.assert_array_equal(b.value.data, a.value.data)


@pytest.mark.parametrize("P", PS)
def test_host_reduce_on_mesh_kmv(P):
    """The per-group host callback runs shard by shard, in shard order."""
    jmr, tmr = both(P)
    seen = {"j": [], "t": []}
    for name, mr in (("j", jmr), ("t", tmr)):
        mr.map(2, emit)
        mr.collate()
        mr.reduce(lambda k, vals, kv, ptr, name=name: (
            seen[name].append(int(k)), kv.add(k, max(vals))))
    assert seen["t"] == seen["j"]
    same_kv(jmr, tmr)


# -- sorts -------------------------------------------------------------------

@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("by,flag", [("keys", 1), ("keys", -1),
                                     ("values", 1), ("values", -1)])
def test_sorts_match_jax(P, by, flag):
    jmr, tmr = both(P)
    for mr in (jmr, tmr):
        mr.map(6, emit)
        mr.aggregate()
        getattr(mr, f"sort_{by}")(flag)
    same_kv(jmr, tmr)


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("flag", [1, -1])
def test_sort_multivalues_matches_jax(P, flag):
    jmr, tmr = both(P)
    for mr in (jmr, tmr):
        mr.map(6, emit)
        mr.collate()
        mr.sort_multivalues(flag)
    same_kmv(jmr, tmr)
    for p, s in enumerate(_shards(one(tmr.kmv))):
        hf = s.to_host()
        jf = jmr.kmv.one_frame().shard_to_host(p)
        for i in range(len(hf)):      # sorted groups: the order itself
            assert hf.group_values(i).tolist() == \
                jf.group_values(i).tolist()


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("by,flag", [("keys", 5), ("keys", -5),
                                     ("values", 5)])
def test_sort_interned_matches_jax(P, by, flag):
    """Interned text sorts by the rows' bytes; on a mesh the JAX sort is
    global, valid rows packed into the first shards."""
    words = [b"pear", b"apple", b"fig", b"zoo", b"beta", b"kiwi",
             b"mango", b"date", b"apple", b"fig"]
    jmr, tmr = both(P)
    for mr in (jmr, tmr):
        if by == "keys":
            mr.map(1, lambda i, kv, p: [kv.add(w, np.uint64(j))
                                        for j, w in enumerate(words)])
        else:
            mr.map(1, lambda i, kv, p: [kv.add(np.uint64(j), w)
                                        for j, w in enumerate(words)])
        mr.aggregate()
        getattr(mr, f"sort_{by}")(flag)
    same_kv(jmr, tmr)
    got = []
    tmr.scan_kv(lambda k, v, p: got.append(bytes(k if by == "keys" else v)))
    assert got == sorted(words, reverse=flag < 0)


# -- gather, broadcast, scrunch ------------------------------------------------

@pytest.mark.parametrize("P", PS)
def test_gather_and_broadcast_match_jax(P):
    jmr, tmr = both(P)
    for mr in (jmr, tmr):
        mr.map(6, emit)
        mr.aggregate()
    for n in (2, 1):
        jshuffle._SPEC_CACHE.clear()
        assert jmr.gather(n) == tmr.gather(n) == 3000
        same_kv(jmr, tmr)
    assert jmr.broadcast(0) == tmr.broadcast(0) == 3000 * P
    same_kv(jmr, tmr)
    assert tmr.stats()["cssize"] == jmr.stats()["cssize"] or P == 1


@pytest.mark.parametrize("P", [3, 8])
def test_gather_reference_mod_layout(P):
    """gather(n): producing shard i's rows land on shard i % n (reference
    src/mapreduce.cpp:919-928), byte for byte as the JAX mesh."""
    keys = np.arange(64, dtype=np.uint64)
    jmr, tmr = both(P)
    owner = {}
    for mr in (jmr, tmr):
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, keys))
        mr.aggregate()
    for p, s in enumerate(one(tmr.kv).shards):
        for k in to_numpy(s.key[:int(s.counts[0])], np.uint64).tolist():
            owner[k] = p
    jshuffle._SPEC_CACHE.clear()
    jmr.gather(2)
    tmr.gather(2)
    same_kv(jmr, tmr)
    for d, s in enumerate(one(tmr.kv).shards):
        for k in to_numpy(s.key[:int(s.counts[0])], np.uint64).tolist():
            assert owner[k] % 2 == d


@pytest.mark.parametrize("P", PS)
def test_scrunch_matches_jax(P):
    jmr, tmr = both(P)
    for mr in (jmr, tmr):
        mr.map(2, emit)
        mr.aggregate()
        assert mr.scrunch(1, np.uint64(7)) == 1
    assert tmr.kmv_stats()[:2] == jmr.kmv_stats()[:2] == (1, 2000)
    a = jmr.kmv.one_frame().group_values(0).tolist()
    b = one(tmr.kmv).group_values(0).tolist()
    assert a == b


# -- text columns --------------------------------------------------------------

def emit_bv(itask, kv, ptr):
    rng = np.random.default_rng(40 + itask)
    for _ in range(200):
        kv.add(np.uint64(int(rng.integers(0, 37))),
               b"doc-%03d" % rng.integers(0, 50))


@pytest.mark.parametrize("P", PS)
def test_bytes_values_match_jax(P):
    jmr, tmr = both(P)
    for mr in (jmr, tmr):
        mr.map(4, emit_bv)
        mr.aggregate()
    same_kv(jmr, tmr)
    if P > 1:
        assert isinstance(one(tmr.kv).value_decode, ShardTables)
    for mr in (jmr, tmr):
        mr.convert()
    same_kmv(jmr, tmr)


@pytest.mark.parametrize("P", PS)
def test_bytes_keys_and_values_match_jax(P):
    pairs = [(b"alpha", b"d1"), (b"beta", b"d2"), (b"alpha", b"d2"),
             (b"gamma", b"d3"), (b"beta", b"d1"), (b"alpha", b"d1")]
    jmr, tmr = both(P)
    for mr in (jmr, tmr):
        mr.map(1, lambda i, kv, p: [kv.add(k, v) for k, v in pairs])
        mr.aggregate()
    same_kv(jmr, tmr)
    grouped = {}
    for mr in (jmr, tmr):
        mr.convert()
        out = {}
        mr.scan_kmv(lambda k, vals, p: out.__setitem__(
            bytes(k), sorted(bytes(v) for v in vals)))
        grouped[mr is tmr] = out
    assert grouped[True] == grouped[False]
    same_kmv(jmr, tmr)


@pytest.mark.parametrize("P", PS)
def test_add_cross_domain_keys_group(P):
    """A bytes-keyed mesh dataset added to an object-keyed one: one id
    per logical key after the concat, so equal keys group."""
    groups = {}
    for name, make in (("j", lambda: JMapReduce(j_make_mesh(P))),
                       ("t", lambda: MapReduce(comm=tmesh(P)))):
        a, b = make(), make()
        a.map(1, lambda i, kv, p: [kv.add(b"x", 1), kv.add(b"y", 2)])
        a.aggregate()
        b.map(1, lambda i, kv, p: [kv.add(b"x", 3), kv.add((1, "t"), 4)])
        b.aggregate()
        a.add(b)
        a.collate()
        g = {}

        def take(k, vals, kv, ptr, g=g):
            key = tuple(k) if isinstance(k, (list, tuple)) else k
            g[key] = sorted(int(v) for v in vals)
            kv.add(0, len(vals))

        a.reduce(take)
        groups[name] = (g, a)
    assert groups["t"][0] == groups["j"][0]
    assert groups["t"][0][b"x"] == [1, 3]
    same_kv(groups["j"][1], groups["t"][1])


# -- the exchange itself ------------------------------------------------------

@pytest.mark.parametrize("all2all", [1, 0])
@pytest.mark.parametrize("skew", ["one_shard", "hub_tail"])
def test_skewed_exchange_matches_jax(all2all, skew, monkeypatch):
    """Skewed exchanges: every row to one shard (cap_out sized by that
    shard alone), and a hub plus one row or so to each other shard (the
    mean bucket far below the largest: the raw schedule takes several
    rounds).  Frame and telemetry equal the JAX exchange's."""
    from gpu_mapreduce_tpu.core.column import DenseColumn as JDense
    from gpu_mapreduce_tpu.core.frame import KVFrame as JKVFrame
    from gpu_mapreduce_tpu.parallel.sharded import shard_frame as j_shard
    from gpu_mapreduce_tpu_torch.core.frame import KVFrame
    from gpu_mapreduce_tpu_torch.parallel.sharded import shard_frame_mesh
    monkeypatch.setenv("MRTPU_WIRE", "0")
    jshuffle._SPEC_CACHE.clear()
    rng = np.random.default_rng(99)
    hub = np.zeros(2000, np.uint64)              # dest 0 by key % 8
    mult = 8 if skew == "one_shard" else 1       # tail to 0 or to 1..7
    tail = (rng.integers(1, 8, size=56) * mult).astype(np.uint64)
    keys = np.concatenate([hub, tail])
    rng.shuffle(keys)
    vals = np.arange(len(keys), dtype=np.uint64)
    jout = jshuffle.exchange(
        j_shard(JKVFrame(JDense(keys), JDense(vals)), j_make_mesh(8)),
        ("hash", lambda k: k.astype(np.uint32)), transport=all2all)
    tout = tshuffle.exchange(
        shard_frame_mesh(KVFrame(keys, vals), tmesh(8)),
        ("hash", lambda k: k & 0xFFFFFFFF), transport=all2all)
    assert tout.counts.tolist() == jout.counts.tolist()
    assert tout.cap == jout.cap
    js, ts = jout.exchange_stats, tout.exchange_stats
    assert (ts.nrounds, ts.bucket, ts.cap_out, ts.rows, ts.sent_bytes,
            ts.pad_bytes) == (js.nrounds, js.bucket, js.cap_out, js.rows,
                              js.sent_bytes, js.pad_bytes)
    if skew == "one_shard":
        assert tout.counts.tolist() == [2056] + [0] * 7
        assert ts.cap_out == tout.cap == 4096
    else:
        assert ts.nrounds > 1
    jk, jv, _ = _jax_blocks(jout)
    for p, s in enumerate(tout.shards):
        n = int(s.counts[0])
        np.testing.assert_array_equal(to_numpy(s.key[:n], np.uint64),
                                      jk[p, :n])
        np.testing.assert_array_equal(to_numpy(s.value[:n], np.uint64),
                                      jv[p, :n])


def test_one_sync_per_mesh_op():
    """aggregate pulls its count matrix once and convert its group
    counts once; a batch reduce pulls nothing — as the JAX mesh."""
    jmr, tmr = both(8)
    for mr in (jmr, tmr):
        mr.map(6, emit)
    deltas = {}
    for name, mr, stats, red in (("j", jmr, JSyncStats, j_count),
                                 ("t", tmr, SyncStats, t_count)):
        out = []
        for op in (mr.aggregate, mr.convert,
                   lambda mr=mr, red=red: mr.reduce(red, batch=True)):
            snap = stats.snapshot()
            op()
            out.append(stats.delta(snap))
        deltas[name] = out
    assert deltas["t"] == deltas["j"] == [1, 1, 0]
    same_kv(jmr, tmr)


@pytest.mark.parametrize("P", [3, 8])
def test_default_hash_matches_jax(P):
    from gpu_mapreduce_tpu.parallel.shuffle import default_hash as j_hash
    from gpu_mapreduce_tpu_torch.ops.bits import to_torch
    from gpu_mapreduce_tpu_torch.ops.hash import default_hash as t_hash
    import jax.numpy as jnp
    rng = np.random.default_rng(P)
    cases = [rng.integers(0, 1 << 63, 257, dtype=np.uint64) * 2 + 1,
             rng.integers(0, 1 << 32, 257).astype(np.uint32),
             rng.integers(-(1 << 31), 1 << 31, 257).astype(np.int32),
             rng.integers(0, 1 << 16, 257).astype(np.uint16),
             rng.integers(-128, 128, 257).astype(np.int8),
             rng.integers(0, 1 << 63, (257, 2), dtype=np.uint64),
             rng.standard_normal(257)]
    for keys in cases:
        want = np.asarray(j_hash(jnp.asarray(keys))).astype(np.int64) % P
        got = (t_hash(to_torch(keys, "cpu"), keys.dtype) % P).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(keys.dtype))


# -- interop -------------------------------------------------------------------

def _jax_blocks(fr):
    P, cap = fr.nprocs, fr.cap
    return (np.asarray(fr.key).reshape((P, cap) + fr.key.shape[1:]),
            np.asarray(fr.value).reshape((P, cap) + fr.value.shape[1:]),
            fr.counts.copy())


def test_interop_jax_mesh_frame_roundtrip():
    """A JAX make_mesh(3) frame crosses to the port and back unchanged,
    padding included."""
    jmr = JMapReduce(j_make_mesh(3))
    jmr.map(6, emit)
    jmr.aggregate()
    key, value, counts = _jax_blocks(jmr.kv.one_frame())
    fr = interop.mesh_kv_from_numpy(key, value, counts, tmesh(3))
    assert isinstance(fr, MeshKV) and fr.counts.tolist() == counts.tolist()
    back = interop.to_numpy(fr)
    for a, b in ((back["key"], key), (back["value"], value)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back["counts"], counts)
    jmr.convert()
    jk = jmr.kmv.one_frame()
    P = jk.nprocs
    arrs = [np.asarray(x).reshape((P, -1) + np.asarray(x).shape[1:])
            for x in (jk.ukey, jk.nvalues, jk.voffsets, jk.values)]
    kmv = interop.mesh_kmv_from_numpy(*arrs, jk.gcounts, jk.vcounts,
                                      tmesh(3))
    back = interop.to_numpy(kmv)
    for name, a in zip(("ukey", "nvalues", "voffsets", "values"), arrs):
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    assert back["gcounts"].tolist() == jk.gcounts.tolist()


def test_interop_exchanged_frame_equals_jax(monkeypatch):
    """The port's exchange of a frame carried over from JAX equals the
    JAX exchange of the same frame, shard by shard."""
    monkeypatch.setenv("MRTPU_WIRE", "0")
    jshuffle._SPEC_CACHE.clear()
    jmr = JMapReduce(j_make_mesh(3))
    jmr.map(6, emit)
    jmr.aggregate()
    src = jmr.kv.one_frame()
    key, value, counts = _jax_blocks(src)
    jout = jshuffle.exchange(src, ("fixed_mod", 2))
    tout = tshuffle.exchange(
        interop.mesh_kv_from_numpy(key, value, counts, tmesh(3)),
        ("fixed_mod", 2))
    jk, jv, jc = _jax_blocks(jout)
    back = interop.to_numpy(tout)
    np.testing.assert_array_equal(back["counts"], jc)
    np.testing.assert_array_equal(back["key"], jk)
    np.testing.assert_array_equal(back["value"], jv)


# -- the mesh and its refusals ----------------------------------------------------

def test_make_mesh():
    m = make_mesh(3, devices=["cpu"] * 4)
    assert isinstance(m, Mesh) and m.size == 3 and m.shape == {"p": 3}
    assert all(d == torch.device("cpu") for d in m.devices)
    if not torch.cuda.is_available():
        with pytest.raises(MRError):
            make_mesh(2)
    with pytest.raises(MRError):
        make_mesh(5, devices=["cpu"] * 4)
    # one shard is the one-device backend
    mr = MapReduce(comm=make_mesh(1, devices=["cpu"]))
    assert mr.nprocs == 1 and mr.backend.mesh is None
    with pytest.raises(MRError):
        MapReduce(comm=3)


def _ops_open(mr, mod, d):
    """open with addflag: the shards' pairs stay, another MR's adds join
    them as host pages, the next aggregate routes them."""
    other = mr.copy()
    kv = mr.open(1)
    other.map_mr(other, lambda i, k, v, _kv, p: kv.add(k, v + 1))
    mr.close()
    mr.aggregate()


def _ops_close(mr, mod, d):
    mr.open()
    assert mr.close() == 0
    with pytest.raises(Exception, match="Cannot close without open"):
        mr.close()
    mr.map(2, emit)
    mr.aggregate()


def _ops_save(mr, mod, d):
    mr.save(d)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert man["mesh"] == {"nprocs": 3}
    assert man["frames"][0]["shards"] == _counts(mr)
    assert len(man["frames"][0]["shard_digests"]) == 3


def _ops_load(mr, mod, d):
    mr.save(d + ".w")
    mr.load(d + ".w")
    mr.aggregate()


def _ops_pipeline(mr, mod, d):
    with mr.pipeline():
        mr.convert()
        mr.reduce(mod.count, batch=True)


def _ops_outofcore(mr, mod, d):
    mr.set(outofcore=1, memsize=1, maxpage=1, fpath=d)
    mr.map(2, emit, addflag=1)
    mr.aggregate()
    mr.convert()


def _ops_fuse(mr, mod, d):
    mr.set(fuse=1)
    mr.map(2, emit, addflag=1)
    mr.aggregate()
    mr.convert()
    mr.reduce(mod.count, batch=True)


def _counts(mr):
    fr = mr.kv.one_frame() if hasattr(mr.kv, "one_frame") else one(mr.kv)
    return [int(c) for c in fr.counts]


MESH_OPS = {
    "map_mr": lambda mr, mod, d: mr.map_mr(
        mr, lambda i, k, v, kv, p: kv.add(k, v * 3)),
    "compress": lambda mr, mod, d: mr.compress(mod.count, batch=True),
    "clone": lambda mr, mod, d: mr.clone(),
    "collapse": lambda mr, mod, d: mr.collapse(1),
    "open": _ops_open,
    "close": _ops_close,
    "save": _ops_save,
    "load": _ops_load,
    "pipeline": _ops_pipeline,
    "outofcore": _ops_outofcore,
    "fuse": _ops_fuse,
}


@pytest.mark.parametrize("op", sorted(MESH_OPS))
def test_ops_run_on_a_mesh(op, tmp_path, monkeypatch):
    """Each op and setting once refused at P > 1 runs at P = 3, on a
    frame the aggregate put on the mesh, as the JAX mesh runs it."""
    from gpu_mapreduce_tpu.oink import kernels as jkernels
    from gpu_mapreduce_tpu.plan import plan_cache as j_plan_cache
    from gpu_mapreduce_tpu_torch.oink import kernels as tkernels
    from gpu_mapreduce_tpu_torch.plan import plan_cache
    monkeypatch.delenv("MRTPU_FUSE", raising=False)
    plan_cache().clear()          # the fused ops run cold in both
    j_plan_cache().clear()
    jmr, tmr = both(3)
    for name, mr, mod in (("j", jmr, jkernels), ("t", tmr, tkernels)):
        mr.map(4, emit)
        mr.aggregate()
        MESH_OPS[op](mr, mod, str(tmp_path / name))
    if tmr.kmv is not None:
        tf = one(tmr.kmv)
        if isinstance(tf, MeshKMV):
            same_kmv(jmr, tmr)
        else:               # collapse: one host group over every shard
            assert _groups(tf) == _groups(jmr.kmv.one_frame())
    else:
        same_kv(jmr, tmr)
    MapReduce(comm=tmesh(3), fuse=1, outofcore=1)


def test_oink_nprocs_reads_the_mesh():
    """A script's ``nprocs`` is the mesh width; its MRs live on the mesh;
    an OINK command runs there (every command against the JAX package:
    ``test_torch_mesh_oink.py``)."""
    import io
    from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
    from gpu_mapreduce_tpu_torch import OinkScript
    for P in (1, 3):
        port = OinkScript(comm=tmesh(P), screen=io.StringIO())
        ref = JOinkScript(comm=j_make_mesh(P), screen=io.StringIO())
        assert port.variables.specials["nprocs"]() == \
            ref.variables.specials["nprocs"]() == P
        assert port.obj.create_mr().nprocs == P
    port.one("rmat 4 2 0.25 0.25 0.25 0.25 0.0 1 -o NULL x")
    fr = one(port.obj.named["x"].kv)
    assert isinstance(fr, MeshKV) and fr.nprocs == 3 and len(fr) == 32


@pytest.mark.parametrize("P", [3, 8])
def test_hash_fns_match_jax(P):
    """aggregate(hash_fn): a device hash over the key column (JAX: a jnp
    array of u64; the port: their int64 bits) and a host hash over each
    key's bytes (``host_hash``) route as the JAX mesh does."""
    import zlib

    def host(rows):
        return [zlib.crc32(r) for r in rows]
    host.host_hash = True
    for jfn, tfn in ((lambda k: k * 7 + 3, lambda k: k * 7 + 3),
                     (host, host)):
        jmr, tmr = both(P)
        for mr, fn in ((jmr, jfn), (tmr, tfn)):
            mr.map(6, emit)
            mr.aggregate(fn)
        same_kv(jmr, tmr)


@pytest.mark.parametrize("P", [3, 8])
def test_copy_print_scan_stats_match_jax(P, tmp_path):
    """copy, print (pairs, then groups) and scan_kmv on a mesh equal the
    JAX mesh's; the stats counters move by the exchange's bytes."""
    jmr, tmr = both(P)
    out = {}
    for name, mr in (("j", jmr), ("t", tmr)):
        mr.map(6, emit)
        before = mr.stats()["cssize"]
        mr.aggregate()
        cp = mr.copy()
        mr.print(file=str(tmp_path / f"{name}.kv"))
        mr.collate()
        mr.print(nstride=2, file=str(tmp_path / f"{name}.kmv"))
        groups = []
        mr.scan_kmv(lambda k, vals, p: groups.append(
            (int(k), sorted(int(v) for v in vals))))
        out[name] = (groups, mr.kmv_stats(), cp.kv_stats(),
                     mr.stats()["cssize"] - before)
    assert out["t"] == out["j"]
    assert (tmp_path / "t.kv").read_text() == (tmp_path / "j.kv").read_text()
    # a group's values print in its convert order, which jnp.lexsort does
    # not promise: compare each line's values sorted
    rows = {name: [(ln.split()[0], sorted(ln.split()[1:])) for ln in
                   (tmp_path / f"{name}.kmv").read_text().splitlines()]
            for name in ("t", "j")}
    assert rows["t"] == rows["j"]
