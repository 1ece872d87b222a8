"""Per-shard file ingest on the port's mesh vs the JAX package's.

``map_files`` and ``map_file_char`` on a mesh of P > 1 map each shard's
contiguous, byte-balanced slice of the files into a frame on that
shard's device; text columns intern into dest-sharded tables.  For P in
{1, 3, 8} the port's frames equal the JAX mesh's shard by shard (counts,
cap, rows in order, decoded rows, padded bytes), before and after the
aggregate.  Values inside a group compare as a sorted multiset (the JAX
convert's ``jnp.lexsort`` promises no stable order)."""

import collections

import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu.core.mapreduce import MapReduce as JMapReduce
from gpu_mapreduce_tpu.oink.kernels import read_words as j_read_words
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel.ingest import balance_by_bytes as j_balance
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu_torch import MapReduce, MRError
from gpu_mapreduce_tpu_torch.core.column import ShardTables, dest_of_ids
from gpu_mapreduce_tpu_torch.oink.kernels import read_words
from gpu_mapreduce_tpu_torch.ops.bits import to_numpy
from gpu_mapreduce_tpu_torch.ops.reduces import count
from gpu_mapreduce_tpu_torch.parallel.ingest import balance_by_bytes
from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch.parallel.sharded import MeshKV

from test_torch_parallel import one, same_kmv, same_kv

PS = [1, 3, 8]


def tmesh(P):
    return make_mesh(P, devices=["cpu"] * P)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import random
    r = random.Random(7)
    d = tmp_path_factory.mktemp("ingest")
    vocab = [f"w{i:03d}".encode() for i in range(120)]
    files, oracle = [], collections.Counter()
    for i in range(10):
        ws = r.choices(vocab, k=400 + 50 * i)   # uneven: balance matters
        oracle.update(ws)
        p = d / f"f{i}.txt"
        p.write_bytes(b" ".join(ws))
        files.append(str(p))
    return files, oracle


def test_balance_by_bytes_matches_jax(corpus):
    files, _ = corpus
    for P in (1, 3, 8, 16):
        got = [(a, b, c.tolist()) for a, b, c in balance_by_bytes(files, P)]
        want = [(a, b, c.tolist()) for a, b, c in j_balance(files, P)]
        assert got == want


@pytest.mark.parametrize("P", PS)
def test_map_files_per_shard_matches_jax(corpus, P):
    """read_words: the same frame as the JAX mesh ingest, then the same
    aggregate, convert and count."""
    files, oracle = corpus
    jshuffle._SPEC_CACHE.clear()
    jmr, tmr = JMapReduce(j_make_mesh(P)), MapReduce(comm=tmesh(P))
    assert jmr.map_files(files, j_read_words) == \
        tmr.map_files(files, read_words) == sum(oracle.values())
    if P > 1:
        st, jst = tmr.last_ingest, jmr.last_ingest
        assert st["mode"] == jst["mode"] == "mesh"
        assert st["files_per_shard"] == jst["files_per_shard"]
        assert st["rows_per_shard"] == jst["rows_per_shard"]
        fr = one(tmr.kv)
        assert isinstance(fr, MeshKV)
        assert isinstance(fr.key_decode, ShardTables)
        sizes = [len(t) for t in fr.key_decode.tables]
        assert sum(sizes) == len(oracle) and max(sizes) < len(oracle)
    same_kv(jmr, tmr)
    for mr in (jmr, tmr):
        mr.aggregate()
    same_kv(jmr, tmr)
    for mr in (jmr, tmr):
        mr.convert()
    same_kmv(jmr, tmr)
    assert tmr.reduce(count, batch=True) == len(oracle)


@pytest.mark.parametrize("P", [3, 8])
def test_post_aggregate_decode_locality(corpus, P):
    """After the default-hash aggregate shard d's ids decode from
    ``tables[d]`` alone, and ``dest_of_ids`` is the exchange's routing."""
    files, _ = corpus
    mr = MapReduce(comm=tmesh(P))
    mr.map_files(files, read_words)
    mr.aggregate()
    fr = one(mr.kv)
    kd = fr.key_decode
    for p, s in enumerate(fr.shards):
        ids = to_numpy(s.key[:int(s.counts[0])], np.uint64)
        assert all(int(h) in kd.tables[p] for h in ids.tolist())
        assert (dest_of_ids(ids, P) == p).all()


@pytest.mark.parametrize("P", PS)
def test_wordfreq_mesh_matches_jax_and_serial(corpus, P):
    from gpu_mapreduce_tpu.apps.wordfreq import wordfreq as j_wordfreq
    from gpu_mapreduce_tpu_torch.apps.wordfreq import wordfreq
    files, oracle = corpus
    jshuffle._SPEC_CACHE.clear()
    got = wordfreq(files, ntop=7, comm=tmesh(P))
    want = j_wordfreq(files, ntop=7, comm=j_make_mesh(P))
    assert got == want
    assert got[:2] == (sum(oracle.values()), len(oracle))
    assert all(oracle[w] == c for w, c in got[2])


@pytest.mark.parametrize("P", [3, 8])
def test_wordfreq_interned_mesh_matches_jax(corpus, P):
    from gpu_mapreduce_tpu.apps.wordfreq import wordfreq_interned as j_wfi
    from gpu_mapreduce_tpu_torch.apps.wordfreq import wordfreq_interned
    files, oracle = corpus
    jshuffle._SPEC_CACHE.clear()
    got = wordfreq_interned(files, 7, comm=tmesh(P))
    assert got == j_wfi(files, 7, comm=j_make_mesh(P))
    assert got[:2] == (sum(oracle.values()), len(oracle))
    # against one device only the counts: equal counts tie-break by the
    # rows' arrival order, which the exchange permutes
    serial = wordfreq_interned(files, 7, device="cpu")
    assert [c for _, c in got[2]] == [c for _, c in serial[2]]


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("mapstyle", [0, 2])
def test_map_file_char_chunks_match_jax(corpus, P, mapstyle):
    """Chunked mesh ingest: the JAX mesh's chunks, task ids and frame;
    the chunks concatenate to the files."""
    files, oracle = corpus
    seen = {"j": {}, "t": {}}

    def cb(name):
        def fn(itask, chunk, kv, ptr):
            seen[name][itask] = bytes(chunk)
            for w in bytes(chunk).split():
                kv.add(w, 1)
        return fn

    jshuffle._SPEC_CACHE.clear()
    jmr = JMapReduce(j_make_mesh(P), mapstyle=mapstyle)
    tmr = MapReduce(comm=tmesh(P), mapstyle=mapstyle)
    assert jmr.map_file_char(16, files, 0, 0, " ", 16, cb("j")) == \
        tmr.map_file_char(16, files, 0, 0, " ", 16, cb("t")) == \
        sum(oracle.values())
    assert seen["t"] == seen["j"]
    assert b"".join(seen["t"][i] for i in sorted(seen["t"])) == \
        b"".join(open(f, "rb").read() for f in files)
    if P > 1:
        assert tmr.last_ingest["mode"] == "mesh"
        assert tmr.last_ingest["ntasks"] == len(seen["t"])
        assert tmr.last_ingest["chunks_per_shard"] == \
            jmr.last_ingest["chunks_per_shard"]
    same_kv(jmr, tmr)
    for mr in (jmr, tmr):
        mr.collate()
    same_kmv(jmr, tmr)


def test_host_fallbacks(corpus):
    """addflag appends through the host path; a frame payload or shards
    of different dtypes are unshardable and replay into the host KV,
    every callback run once; out of core ingests on the host."""
    files, oracle = corpus
    mesh = tmesh(8)
    mr = MapReduce(comm=mesh)
    mr.map_files(files[:2], read_words)
    assert mr.last_ingest["mode"] == "mesh"
    mr.map_files(files[2:], read_words, addflag=1)
    assert mr.last_ingest["mode"] == "host"
    assert mr.kv.nkv == sum(oracle.values())
    ooc = MapReduce(comm=mesh, outofcore=1, memsize=1, maxpage=4)
    assert ooc.map_files(files[:2], read_words) == \
        sum(len(open(f, "rb").read().split()) for f in files[:2])
    assert ooc.last_ingest["mode"] == "host"
    from gpu_mapreduce_tpu_torch.core.frame import KVFrame
    calls = []

    def framed(itask, fname, kv, ptr):
        calls.append(itask)
        kv.add_frame(KVFrame(np.arange(2, dtype=np.uint64) + itask,
                             np.zeros(2, np.uint8)))
    mr3 = MapReduce(comm=mesh)
    assert mr3.map_files(files, framed) == 2 * len(files)
    assert mr3.last_ingest["mode"] == "host"
    assert "fallback" in mr3.last_ingest
    assert calls == list(range(len(files)))

    def mixed_dtype(itask, fname, kv, ptr):
        dt = np.uint32 if itask < 5 else np.float64
        kv.add_batch(np.arange(2, dtype=dt), np.zeros(2, np.uint8))

    jmr = JMapReduce(j_make_mesh(8))
    mr4 = MapReduce(comm=mesh)
    assert mr4.map_files(files, mixed_dtype) == \
        jmr.map_files(files, mixed_dtype) == 2 * len(files)
    assert mr4.last_ingest["mode"] == jmr.last_ingest["mode"] == "host"
    same_kv(jmr, mr4)


@pytest.mark.parametrize("P", [3, 8])
def test_object_keys_mesh_match_jax(tmp_path, P):
    """Object keys (the pickle tier) ride the mesh ingest; duplicates
    across shards share one id and group together."""
    files = []
    for i in range(6):
        p = tmp_path / f"o{i}.txt"
        p.write_bytes(b"x" * 100)
        files.append(str(p))

    def emit(itask, fname, kv, ptr):
        kv.add(("tup", itask % 3), 1)
        kv.add(("tup", "shared"), 1)

    from gpu_mapreduce_tpu_torch.ops.reduces import sum_values
    from gpu_mapreduce_tpu.ops.reduces import sum_values as j_sum_values
    jshuffle._SPEC_CACHE.clear()
    jmr, tmr = JMapReduce(j_make_mesh(P)), MapReduce(comm=tmesh(P))
    assert jmr.map_files(files, emit) == tmr.map_files(files, emit) == 12
    assert tmr.last_ingest["mode"] == "mesh"
    assert one(tmr.kv).key_decode.kind == "object"
    same_kv(jmr, tmr)
    jmr.collate()
    tmr.collate()
    same_kmv(jmr, tmr)
    jmr.reduce(j_sum_values, batch=True)
    tmr.reduce(sum_values, batch=True)
    same_kv(jmr, tmr)
    got = dict(one(tmr.kv).to_host().pairs())
    assert got[("tup", "shared")] == 6 and got[("tup", 0)] == 2


def test_shardtables_match_jax():
    from gpu_mapreduce_tpu.core.column import ShardTables as JShardTables
    t, j = ShardTables(4), JShardTables(4)
    ids = np.array([1, 2, 3, (1 << 64) - 1], np.uint64)
    rows = [b"a", b"b", b"c", b"z"]
    t.absorb(ids, rows)
    j.absorb(ids, rows)
    assert [dict(x) for x in t.tables] == [dict(x) for x in j.tables]
    with pytest.raises(ValueError, match="collision"):
        t.absorb(np.array([2], np.uint64), [b"DIFFERENT"])
    u = ShardTables(4)
    u.absorb(np.array([4], np.uint64), [b"d"])
    m = t.merge(u)
    assert len(m) == 5 and m[2] == b"b" and m[4] == b"d"
    assert 3 in m and m.get(99) is None
    assert m.decode_batch(np.array([1, 4], np.uint64)) == [b"a", b"d"]
    ids = np.arange(1000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    from gpu_mapreduce_tpu.core.column import dest_of_ids as j_dest
    for P in (3, 8):
        np.testing.assert_array_equal(dest_of_ids(ids, P), j_dest(ids, P))


def test_lopsided_ingest_resplits_evenly(corpus):
    """One file over eight shards: the rows re-split ceil(n/P) a shard,
    in order, as the JAX ingest does."""
    files, _ = corpus
    jshuffle._SPEC_CACHE.clear()
    jmr, tmr = JMapReduce(j_make_mesh(8)), MapReduce(comm=tmesh(8))
    jmr.map_files(files[:1], j_read_words)
    tmr.map_files(files[:1], read_words)
    same_kv(jmr, tmr)
    counts = one(tmr.kv).counts
    assert counts.max() - counts.min() <= 1
