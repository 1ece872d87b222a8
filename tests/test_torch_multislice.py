"""The two-level mesh (``make_mesh2``) of the port against the JAX
package's, on CPU shards.

The cases of ``tests/test_multislice.py`` that need no TPU and no
second controller, run through the port's ``make_mesh2(S, C, devices=
["cpu"] * S·C)`` beside the JAX ``make_mesh2(S, C)`` over the conftest's
eight CPU devices: the hierarchical exchange against the flat mesh of
``S·C`` shards and against JAX's (shard by shard, telemetry included,
codec on and off), the whole MapReduce pipeline, cc_find, gather and
broadcast, the per-shard InvertedIndex ingest and its per-shard part
files, OINK lines with one ``-o`` file a shard; then a JAX frame on a
two-axis mesh carried over by ``interop`` bit for bit."""

import collections
import os

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.apps import invertedindex as J
from gpu_mapreduce_tpu.core.column import DenseColumn as JDense
from gpu_mapreduce_tpu.core.frame import KVFrame as JKVFrame
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel.mesh import make_mesh2 as j_make_mesh2
from gpu_mapreduce_tpu.parallel.sharded import shard_frame as j_shard
from gpu_mapreduce_tpu_torch import (InvertedIndex, MapReduce, MRError,
                                    interop)
from gpu_mapreduce_tpu_torch.core.frame import KVFrame
from gpu_mapreduce_tpu_torch.ops.reduces import count
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.parallel.mesh import (flat_axis_index,
                                                   make_mesh, make_mesh2,
                                                   mesh_axes,
                                                   mesh_axis_size)
from gpu_mapreduce_tpu_torch.parallel.sharded import MeshKV, shard_frame_mesh

from test_torch_parallel import same_kv
from test_torch_wire import same_exchange


def tmesh2(S, C):
    return make_mesh2(S, C, devices=["cpu"] * (S * C))


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    monkeypatch.setattr(jshuffle, "_SPEC_CACHE", {})
    monkeypatch.setattr(tshuffle, "_SPEC_CACHE", {})


def test_make_mesh2_layout():
    m = tmesh2(2, 4)
    assert mesh_axes(m) == ("s", "c") and m.shape == {"s": 2, "c": 4}
    assert mesh_axis_size(m) == m.size == 8
    assert [flat_axis_index(m, s, c) for s in range(2)
            for c in range(4)] == list(range(8))
    assert make_mesh2(2, devices=["cpu"] * 6).shape == {"s": 2, "c": 3}
    assert m != make_mesh(8, devices=["cpu"] * 8)
    with pytest.raises(MRError):
        flat_axis_index(m, 2, 0)
    with pytest.raises(MRError):
        make_mesh2(2, 4, devices=["cpu"] * 7)


@pytest.mark.parametrize("wire", ["0", "1"])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2)])
def test_hier_exchange_matches_flat_and_jax(shape, wire, monkeypatch):
    """The hierarchical route gives the flat mesh's shards byte for byte,
    and JAX make_mesh2's, on both transports, three exchanges a
    transport (the later ones speculative)."""
    monkeypatch.setenv("MRTPU_WIRE", wire)
    S, C = shape
    P = S * C
    rng = np.random.default_rng(12345)
    keys = rng.integers(0, 1 << 40, 500).astype(np.uint64)
    vals = rng.integers(0, 1 << 30, 500).astype(np.uint64)
    for transport in (1, 0):
        for _ in range(3):
            hier = tshuffle.exchange(
                shard_frame_mesh(KVFrame(keys, vals), tmesh2(S, C)),
                ("hash", None), transport=transport)
            flat = tshuffle.exchange(
                shard_frame_mesh(KVFrame(keys, vals),
                                 make_mesh(P, devices=["cpu"] * P)),
                ("hash", None), transport=transport)
            jout = jshuffle.exchange(
                j_shard(JKVFrame(JDense(keys), JDense(vals)),
                        j_make_mesh2(S, C)), ("hash", None),
                transport=transport)
            same_exchange(jout, hier)
            assert hier.cap == flat.cap
            assert hier.counts.tolist() == flat.counts.tolist()
            for a, b in zip(hier.shards, flat.shards):
                assert a.key.equal(b.key) and a.value.equal(b.value)


def test_full_pipeline_on_multislice_mesh():
    rng = np.random.default_rng(12345)
    keys = rng.integers(0, 50, 3000).astype(np.uint64)
    want = collections.Counter(keys.tolist())
    from gpu_mapreduce_tpu.ops.reduces import count as j_count
    jmr = JMapReduce(j_make_mesh2(2, 4))
    tmr = MapReduce(comm=tmesh2(2, 4))
    for mr, red in ((jmr, j_count), (tmr, count)):
        mr.map(1, lambda i, kv, p: kv.add_batch(
            keys, np.ones(len(keys), np.uint64)))
        mr.collate()
        assert mr.reduce(red, batch=True) == len(want)
    same_kv(jmr, tmr)
    got = {}
    tmr.scan_kv(lambda k, v, p: got.__setitem__(int(k), int(v)))
    assert got == dict(want)


def test_cc_find_on_multislice_mesh(tmp_path):
    from gpu_mapreduce_tpu.oink import ObjectManager as JObjects
    from gpu_mapreduce_tpu.oink import run_command as j_run
    from gpu_mapreduce_tpu_torch.oink.command import run_command
    from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
    rng = np.random.default_rng(12345)
    e = rng.integers(0, 80, (200, 2)).astype(np.uint64)
    e = np.unique(e[e[:, 0] != e[:, 1]], axis=0)
    path = tmp_path / "g.txt"
    path.write_text("\n".join(f"{a} {b}" for a, b in e) + "\n")
    jout, tout = tmp_path / "j.out", tmp_path / "t.out"
    jcmd = j_run("cc_find", ["0"], obj=JObjects(comm=j_make_mesh2(2, 4)),
                 inputs=[str(path)], outputs=[str(jout)], screen=False)
    tcmd = run_command("cc_find", ["0"],
                       obj=ObjectManager(comm=tmesh2(2, 4)),
                       inputs=[str(path)], outputs=[(str(tout), None)],
                       screen=False)
    assert tcmd.ncc == jcmd.ncc
    got = np.loadtxt(tout, dtype=np.uint64).reshape(-1, 2)
    want = np.loadtxt(jout, dtype=np.uint64).reshape(-1, 2)
    assert sorted(map(tuple, got.tolist())) == \
        sorted(map(tuple, want.tolist()))


def test_gather_and_broadcast_on_multislice():
    keys = np.arange(64, dtype=np.uint64)
    jmr = JMapReduce(j_make_mesh2(2, 4))
    tmr = MapReduce(comm=tmesh2(2, 4))
    for mr in (jmr, tmr):
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, keys))
        mr.aggregate()
        mr.gather(2)
    same_kv(jmr, tmr)
    fr = tmr.kv.one_frame()
    assert isinstance(fr, MeshKV)
    assert (fr.counts[2:] == 0).all() and fr.counts[:2].sum() == 64
    for mr in (jmr, tmr):
        mr.broadcast(0)
    same_kv(jmr, tmr)
    fr = tmr.kv.one_frame()
    assert all(int(c) == int(fr.counts[0]) for c in fr.counts)


def _html(tmp_path, n, body):
    paths = []
    for i in range(n):
        p = tmp_path / f"f{i}.html"
        p.write_bytes(body(i))
        paths.append(str(p))
    return paths


def test_spmd_ingestion_on_multislice_mesh(tmp_path):
    """The per-shard InvertedIndex ingest and extract on a (slice, chip)
    mesh equal the one-device run and JAX's make_mesh2 run."""
    paths = _html(tmp_path, 8, lambda i: b'<a href="http://s%d.org/p">x'
                  b'</a>fill' % (i % 3) * 5)
    one_dev = InvertedIndex(device="cpu")
    t = InvertedIndex(comm=tmesh2(2, 4))
    j = J.InvertedIndex(comm=j_make_mesh2(2, 4), engine="xla")
    assert one_dev.run(paths) == t.run(paths) == j.run(paths)
    assert one_dev.urls == t.urls == j.urls


def test_per_shard_output_on_multislice_mesh(tmp_path):
    """Per-shard part files and destination-sharded url dicts on a
    (slice, chip) mesh: 8 part files, each equal to JAX's."""
    oracle = collections.defaultdict(set)

    def body(i):
        out = []
        for j in range(30):
            u = "http://m%d.org/q%d" % (j % 5, j)
            out.append('<a href="%s">x</a> words ' % u)
            oracle[u.encode()].add(str(tmp_path / f"f{i}.html"))
        return "".join(out).encode()
    paths = _html(tmp_path, 6, body)
    t = InvertedIndex(comm=tmesh2(2, 4))
    j = J.InvertedIndex(engine="xla", comm=j_make_mesh2(2, 4))
    td, jd = str(tmp_path / "t"), str(tmp_path / "j")
    assert t.run(paths, outdir=td) == j.run(paths, outdir=jd)
    parts = sorted(os.listdir(td))
    assert parts == sorted(os.listdir(jd)) == \
        [f"part-{p:05d}" for p in range(8)]
    got = {}
    for part in parts:
        data = open(os.path.join(td, part), "rb").read()
        assert data == open(os.path.join(jd, part), "rb").read()
        for line in data.decode().splitlines():
            url, names = line.split("\t")
            got[url.encode()] = set(names.split(" "))
    assert got == dict(oracle)


def test_interop_two_axis_frame():
    """A JAX frame on make_mesh2(2, 4), pulled out as per-axis blocks
    [S, C, cap] with counts [S, C], becomes the port's make_mesh2(2, 4)
    frame bit for bit, and its exchange equals JAX's."""
    jmr = JMapReduce(j_make_mesh2(2, 4))
    keys = np.random.default_rng(4).integers(0, 1 << 62, 900,
                                             dtype=np.uint64)
    jmr.map(1, lambda i, kv, p: kv.add_batch(keys, keys ^ 7))
    jmr.aggregate()
    fr = jmr.kv.one_frame()
    cap = fr.cap
    key = np.asarray(fr.key).reshape(2, 4, cap)
    value = np.asarray(fr.value).reshape(2, 4, cap)
    tf = interop.mesh_kv_from_numpy(key, value, fr.counts.reshape(2, 4),
                                    tmesh2(2, 4))
    back = interop.to_numpy(tf)
    np.testing.assert_array_equal(back["key"], key.reshape(8, cap))
    np.testing.assert_array_equal(back["value"], value.reshape(8, cap))
    assert back["counts"].tolist() == fr.counts.tolist()
    with pytest.raises(ValueError, match="axes"):
        interop.mesh_kv_from_numpy(key.reshape(4, 2, cap),
                                   value.reshape(4, 2, cap),
                                   fr.counts.reshape(4, 2), tmesh2(2, 4))
    same_exchange(jshuffle.exchange(fr, ("fixed_mod", 3)),
                  tshuffle.exchange(tf, ("fixed_mod", 3)))


def test_oink_per_shard_files_on_multislice_mesh(tmp_path, monkeypatch):
    """OINK lines on a (slice, chip) mesh: rmat, edge_upper, degree and
    pagerank's message lines and every ``-o`` file (one a shard for a
    mesh dataset) equal JAX make_mesh2(2, 2)'s."""
    from gpu_mapreduce_tpu.oink import OinkScript as JOinkScript
    from gpu_mapreduce_tpu_torch import OinkScript
    from test_torch_mesh_oink import _drive, _files
    monkeypatch.setenv("MRTPU_WIRE", "0")
    lines = [("rmat", "rmat 8 4 0.57 0.19 0.19 0.05 0.0 99 -o tmp.e mre"),
             ("upper", "edge_upper -i mre -o tmp.upper mru"),
             ("degree", "degree 0 -i mre -o tmp.deg mrd"),
             ("cc", "cc_find 0 -i mru -o tmp.cc mrc")]
    got = {}
    for side, interp in (("jax", JOinkScript(comm=j_make_mesh2(2, 2),
                                             screen=False)),
                         ("port", OinkScript(comm=tmesh2(2, 2),
                                             screen=False))):
        d = tmp_path / side
        d.mkdir()
        got[side] = (_drive(d, interp, lines), _files(d))
    assert got["port"][0] == got["jax"][0]
    jf, tf = got["jax"][1], got["port"][1]
    assert sorted(tf) == sorted(jf)
    assert any(name.startswith("tmp.deg.") for name in tf)
    for name in jf:
        assert sorted(tf[name].splitlines()) == \
            sorted(jf[name].splitlines()), name
