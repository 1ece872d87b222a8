"""The port's InvertedIndex slice vs the JAX package on the CPU, exactly.

* the fused extract (``_extract_core``) against the JAX one with the
  Pallas mark in interpret mode, with and without a cap retry and the
  wide fallback;
* the whole run (pairs, unique URLs, stats, ``part-00000`` bytes and the
  reduced (url id → count) pairs) against ``InvertedIndex`` on a
  one-device mesh;
* convert/reduce started from the KV the JAX map stage produced, carried
  across with ``interop``;
* the corpus generator against ``bench.make_corpus``.

Values inside a group compare as a sorted multiset: the JAX convert sorts
with ``jnp.lexsort``, which does not promise a stable order."""

import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gpu_mapreduce_tpu.apps import invertedindex as J
from gpu_mapreduce_tpu.parallel import group as jgroup
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.parallel.sharded import ShardedKV as JShardedKV
from gpu_mapreduce_tpu_torch import InvertedIndex, MapReduce, MRError
from gpu_mapreduce_tpu_torch import interop
from gpu_mapreduce_tpu_torch.apps import invertedindex as T
from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
from gpu_mapreduce_tpu_torch.parallel import group as tgroup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = {"plain": {}, "dense": {"dense": True}, "skew": {"skew": True}}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    out = {}
    for kind, flags in KINDS.items():
        d = tmp_path_factory.mktemp(kind)
        out[kind] = make_corpus(str(d), 1, **flags)
    return out


def _words(paths):
    corpus, fstarts = J._build_corpus(paths)
    W = J._bucket_words(-(-len(corpus) // 4))
    wp = np.zeros(W, np.uint32)
    w = J.bytes_view_u32(corpus)
    wp[:len(w)] = w
    cap = max(8, 1 << (max(1, len(corpus) // 1024) - 1).bit_length())
    return wp, fstarts, cap


def _steps(kind, cap):
    """The (cap, wide) sequence the cap-retry loop takes on each corpus."""
    if kind == "dense":
        return [(cap, False), (2 * cap, False), (2 * cap, True)]
    return [(cap, False)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_extract_core_matches_jax(corpora, kind):
    paths, _, _ = corpora[kind]
    wp, fstarts, cap0 = _words(paths)
    seen = []
    for cap, wide in _steps(kind, cap0):
        jout = J._extract_build(cap, True, True, wide)(jnp.asarray(wp),
                                                       jnp.asarray(fstarts))
        tout = T._extract_core(torch.from_numpy(wp.view(np.int32)),
                               torch.from_numpy(fstarts), cap=cap, wide=wide)
        stats = tuple(int(x) for x in jout[5:])
        assert tout[5:] == stats                 # nhits npairs ncoll nlong
        seen.append(stats)
        n = stats[1]
        for j, t in zip(jout[:5], tout[:5]):
            j = np.asarray(j)[:n]
            t = t[:n].numpy()
            np.testing.assert_array_equal(t.view(j.dtype) if j.dtype.kind
                                          == "u" else t, j)
    if kind == "dense":     # a cap retry, then too many long URLs: wide
        assert seen[0][0] > cap0 and seen[1][3] > max(8, 2 * cap0 // 4)


def _pairs(mr):
    out = []
    mr.scan_kv(lambda k, v, p: out.append((int(k), int(v))))
    return sorted(out)


@pytest.mark.parametrize("kind,batch_bytes", [
    ("plain", None), ("dense", None), ("skew", None),
    ("plain", 300_000),            # several corpus batches (rounds)
])
def test_run_matches_jax(corpora, tmp_path, kind, batch_bytes):
    paths, nref, nuniq = corpora[kind]
    ti = InvertedIndex(device="cpu")
    ji = J.InvertedIndex(comm=make_mesh(1), engine="xla")
    if batch_bytes:
        ti._BATCH_BYTES = ji._BATCH_BYTES = batch_bytes
    got = ti.run(paths, outdir=str(tmp_path / "t"))
    want = ji.run(paths, outdir=str(tmp_path / "j"))
    assert got == want == (nref, nuniq)
    assert ti.stats == ji.stats
    assert (tmp_path / "t" / "part-00000").read_bytes() == \
        (tmp_path / "j" / "part-00000").read_bytes()
    assert _pairs(ti.mr) == _pairs(ji.mr)
    assert ti.urls == ji.urls
    assert set(ti.timer.times) >= {"read", "h2d", "map_device", "url_dict",
                                   "aggregate", "convert", "reduce"}


def test_run_without_outdir_matches_jax(corpora):
    paths, nref, nuniq = corpora["skew"]
    ti = InvertedIndex(device="cpu")
    ji = J.InvertedIndex(comm=make_mesh(1), engine="xla")
    assert ti.run(paths) == ji.run(paths) == (nref, nuniq)
    assert _pairs(ti.mr) == _pairs(ji.mr)


def test_run_matches_jax_on_window_edges(tmp_path):
    """URL lengths around the 64-byte first window and the 256-byte
    limit, hrefs at file ends, an empty file and repeated URLs across
    files — the places where the two tiers and the file gaps meet."""
    rng = np.random.default_rng(9)
    files = []
    for fi in range(4):
        parts = []
        for n in list(range(0, 4)) + list(range(58, 70)) + \
                list(range(250, 260)) + [5, 5, 63, 64]:
            url = bytes(rng.integers(97, 123, n, dtype=np.uint8))
            url = url if n != 5 else b"same!"
            parts.append(b"<p>" + bytes(rng.integers(32, 34, fi * 3 + 1,
                                                     dtype=np.uint8)))
            parts.append(b'<a href="' + url + b'">x</a>')
        if fi == 1:
            parts.append(b'<a href="tail-without-quote')
        if fi == 2:
            parts = []                                  # an empty file
        if fi == 3:
            parts.append(b'<a href="')                  # pattern at EOF
        f = tmp_path / f"f{fi}.html"
        f.write_bytes(b"".join(parts))
        files.append(str(f))
    ti = InvertedIndex(device="cpu")
    ji = J.InvertedIndex(comm=make_mesh(1), engine="xla")
    assert ti.run(files, outdir=str(tmp_path / "t")) == \
        ji.run(files, outdir=str(tmp_path / "j"))
    assert ti.stats == ji.stats and ti.stats["nlong_max"] > 0
    assert (tmp_path / "t" / "part-00000").read_bytes() == \
        (tmp_path / "j" / "part-00000").read_bytes()
    assert _pairs(ti.mr) == _pairs(ji.mr)


def _jax_map_output(paths):
    """The KV the JAX map stage emits: packed (ids, docs) [cap] + count."""
    wp, fstarts, cap = _words(paths)
    out = J._extract_build(cap, False, True, False)(jnp.asarray(wp),
                                                    jnp.asarray(fstarts))
    return np.asarray(out[0]), np.asarray(out[2]), int(out[6])


def _assert_kmv_equal(t, j):
    tn, g = interop.to_numpy(t), int(j.gcounts[0])
    assert int(tn["gcounts"][0]) == g
    assert int(tn["vcounts"][0]) == int(j.vcounts[0])
    np.testing.assert_array_equal(tn["ukey"][:g], np.asarray(j.ukey)[:g])
    np.testing.assert_array_equal(tn["nvalues"][:g],
                                  np.asarray(j.nvalues)[:g])
    np.testing.assert_array_equal(tn["voffsets"][:g],
                                  np.asarray(j.voffsets)[:g])
    th, jh = t.to_host(), j.to_host()
    for (tk, tv), (jk, jv) in zip(th.groups(), jh.groups()):
        assert tk == jk and sorted(tv) == sorted(jv)


@pytest.mark.parametrize("kind", ["plain", "skew"])
def test_convert_reduce_from_carried_state(corpora, kind):
    ids, docs, n = _jax_map_output(corpora[kind][0])
    counts = np.array([n], np.int32)
    jkmv = jgroup.convert_sharded(JShardedKV(make_mesh(1), jnp.asarray(ids),
                                             jnp.asarray(docs), counts))
    tkmv = tgroup.convert_sharded(interop.kv_from_numpy(ids, docs, counts,
                                                        "cpu"))
    _assert_kmv_equal(tkmv, jkmv)
    # the same state carried the other way round, into a KMV frame
    jn = interop.to_numpy(tkmv)
    _assert_kmv_equal(interop.kmv_from_numpy(
        jn["ukey"], jn["nvalues"], jn["voffsets"], jn["values"],
        jn["gcounts"], jn["vcounts"], "cpu"), jkmv)
    for op in ("count", "sum", "max", "min"):
        t = interop.to_numpy(tgroup.reduce_sharded(tkmv, op))
        j = jgroup.reduce_sharded(jkmv, op)
        g = int(j.counts[0])
        assert int(t["counts"][0]) == g
        np.testing.assert_array_equal(t["key"][:g], np.asarray(j.key)[:g])
        np.testing.assert_array_equal(t["value"][:g],
                                      np.asarray(j.value)[:g])


def test_unsigned_order_of_ids(corpora):
    """About half the ids have the top bit set; groups and part files
    list them in ascending UNSIGNED order."""
    ids, docs, n = _jax_map_output(corpora["plain"][0])
    assert (ids[:n] >= np.uint64(1 << 63)).any()
    kmv = tgroup.convert_sharded(interop.kv_from_numpy(
        ids, docs, np.array([n], np.int32), "cpu"))
    ukey = interop.to_numpy(kmv)["ukey"][:len(kmv)]
    assert (ukey[1:] > ukey[:-1]).all()


def test_host_collision_count():
    ids = np.array([5, 5, 7, 7, 9], np.uint64)
    alts = np.array([1, 1, 2, 3, 4], np.uint64)
    assert T._host_collision_count(ids, alts) == \
        J._host_collision_count(ids, alts) == 1
    valid = torch.ones(5, dtype=torch.bool)
    assert T._count_collisions(torch.from_numpy(ids.view(np.int64)),
                               torch.from_numpy(alts.view(np.int64)),
                               valid) == 1


@pytest.mark.parametrize("flags", [{}, {"skew": True}, {"dense": True}])
def test_make_corpus_matches_bench(tmp_path, flags):
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    pa, *ca = make_corpus(str(tmp_path / "a"), 1, 3, **flags)
    pb, *cb = bench.make_corpus(str(tmp_path / "b"), 1, 3, **flags)
    assert ca == cb
    assert [open(p, "rb").read() for p in pa] == \
        [open(p, "rb").read() for p in pb]


@pytest.mark.parametrize("data,expect,urls", [
    (b'<a href="http://ok/">fine</a><a href="no-close-quote', (1, 1),
     [b"http://ok/"]),
    (b'<a href="">empty</a><a href="http://x/">x</a>', (2, 2),
     [b"", b"http://x/"]),
    (b"no links at all", (0, 0), []),
])
def test_edge_cases(tmp_path, data, expect, urls):
    f = tmp_path / "e.html"
    f.write_bytes(data)
    ti = InvertedIndex(device="cpu")
    assert ti.run([str(f)]) == expect
    assert sorted(ti.urls.values()) == urls


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(MRError):
        InvertedIndex()
    with pytest.raises(MRError):
        MapReduce()
    assert MapReduce(device="cpu").device.type == "cpu"
