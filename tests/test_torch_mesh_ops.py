"""The MapReduce ops that now run on a mesh of P > 1 against the JAX
package's ``make_mesh(P)``, shard by shard: ``map_mr`` (per pair, batch,
self-map, through the registered OINK kernels), ``clone``, ``collapse``,
``compress``, ``open``/``close``, out of core (``outofcore=1``:
aggregate, the demote to host pages, the external convert and sorts, the
interned sort past the budget), ``save``/``load`` across widths with the
writer-shard digest refusal, and a named-MR script.

Every frame compares as in ``test_torch_parallel.py``: ``counts``,
``cap``, the valid rows in order, the padded byte counts, and inside a
KMV group the values as a sorted multiset."""

import io
import json
import os

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.core.runtime import MRError as JMRError
from gpu_mapreduce_tpu.oink import kernels as jkernels
from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.utils.integrity import file_digest
from gpu_mapreduce_tpu_torch import MapReduce, MRError, OinkScript
from gpu_mapreduce_tpu_torch.core.frame import KMVFrame, KVFrame
from gpu_mapreduce_tpu_torch.oink import kernels
from gpu_mapreduce_tpu_torch.parallel.sharded import MeshKMV, MeshKV

from test_torch_parallel import (_groups, both, emit, one, same_kmv,
                                 same_kv, tmesh)

P = 3


def edges(itask, kv, ptr):
    """Edges with self-loops and repeats, u64 ids near 2^64 among them."""
    rng = np.random.default_rng(100 + itask)
    e = rng.integers(0, 40, (300, 2)).astype(np.uint64)
    e[:5] = [[(1 << 64) - 1, 1], [3, 3], [1 << 63, 2], [7, 7], [2, 9]]
    kv.add_batch(e, np.zeros(len(e), np.uint8))


def agg_both(P=P, fn=emit, ntasks=6, **settings):
    jmr, tmr = both(P, **settings)
    for mr in (jmr, tmr):
        mr.map(ntasks, fn)
        mr.aggregate()
    return jmr, tmr


def host_pairs(mr):
    out = []
    mr.scan_kv(lambda k, v, p: out.append((repr(k), repr(v))))
    return out


# -- map_mr ------------------------------------------------------------------

def test_map_mr_per_pair_walks_the_shards_in_order():
    jmr, tmr = agg_both()
    seen = {}
    for name, mr, cls in (("j", jmr, JMapReduce), ("t", tmr, MapReduce)):
        out = cls(j_make_mesh(P)) if name == "j" else cls(comm=tmesh(P))
        calls = seen[name] = []

        def per_pair(itask, k, v, kv, ptr, calls=calls):
            calls.append((itask, int(k)))
            kv.add(int(k) + 1, int(v) * 2)
        assert out.map_mr(mr, per_pair) == 3000
        seen[name + "kv"] = host_pairs(out)
    assert seen["t"] == seen["j"]
    assert seen["tkv"] == seen["jkv"]
    # shard-major: the source frame's shards in order
    src = one(tmr.kv)
    assert [k for _, k in seen["t"]] == \
        [int(k) for s in src.shards for k, _ in s.to_host().pairs()]


def test_map_mr_batch_self_map_keeps_its_snapshot():
    """A batch callback that adds the source's own mesh frame, as a
    self-map: the new KV holds the same frame; the ops after it make new
    tensors, so the snapshot another MR took stays as it was."""
    jmr, tmr = agg_both()
    snaps = {}
    for name, mr in (("j", jmr), ("t", tmr)):
        keep = mr.copy()
        frames = []

        def add_twice(fr, kv, ptr, frames=frames):
            frames.append(fr)
            kv.add_frame(fr)
            kv.add_frame(fr)
        assert mr.map_mr(mr, add_twice, batch=True) == 6000
        assert len(frames) == 1
        snaps[name] = host_pairs(keep)
        mr.sort_keys(-1)
        mr.collate()
        assert host_pairs(keep) == snaps[name]
    assert snaps["t"] == snaps["j"]
    assert isinstance(frames[0], MeshKV)
    same_kmv(jmr, tmr)


@pytest.mark.parametrize("name", ["edge_to_vertices", "edge_to_vertex",
                                  "edge_to_vertex_pair",
                                  "edge_both_directions", "edge_upper",
                                  "invert", "add_weight"])
def test_map_mr_oink_kernel_on_mesh_frames(name):
    """A registered OINK kernel over a mesh frame runs its device body
    shard by shard: the same counts, cap (the body's rows per input row
    times the input cap) and rows as the JAX ``skv_map``."""
    jmr, tmr = agg_both(fn=edges, ntasks=4)
    jmr.map_mr(jmr, jkernels.MAP_MR_KERNELS[name], batch=True)
    tmr.map_mr(tmr, kernels.MAP_MR_KERNELS[name], batch=True)
    assert isinstance(one(tmr.kv), MeshKV)
    same_kv(jmr, tmr)
    for mr in (jmr, tmr):
        mr.collate()
    same_kmv(jmr, tmr)


# -- clone, collapse, compress ----------------------------------------------

def test_clone_matches_jax():
    jmr, tmr = agg_both()
    assert jmr.clone() == tmr.clone() == 3000
    assert isinstance(one(tmr.kmv), MeshKMV)
    same_kmv(jmr, tmr)
    for mr, fn in ((jmr, jkernels.count), (tmr, kernels.count)):
        mr.reduce(fn, batch=True)
    same_kv(jmr, tmr)


def test_collapse_builds_one_host_group():
    jmr, tmr = agg_both()
    assert jmr.collapse(7) == tmr.collapse(7) == 1
    tf, jf = one(tmr.kmv), jmr.kmv.one_frame()
    assert isinstance(tf, KMVFrame)
    assert tf.key.tolist() == jf.key.tolist() == [7]
    np.testing.assert_array_equal(tf.values.data, jf.values.data)
    assert tf.values.data.dtype == jf.values.data.dtype
    assert tmr.kmv_stats() == jmr.kmv_stats()


def test_collapse_refuses_mixed_types():
    def mixed(itask, kv, ptr):
        for i in range(20):
            kv.add(i, b"w%d" % i)
    jmr, tmr = agg_both(fn=mixed, ntasks=1)
    assert one(tmr.kv).value_decode is not None
    with pytest.raises(JMRError, match="common type"):
        jmr.collapse(1)
    with pytest.raises(MRError, match="common type"):
        tmr.collapse(1)


@pytest.mark.parametrize("kernel", ["count", "sum_values", "cull"])
def test_compress_matches_jax(kernel):
    jmr, tmr = agg_both()
    assert jmr.compress(getattr(jkernels, kernel), batch=True) == \
        tmr.compress(getattr(kernels, kernel), batch=True) == 97
    same_kv(jmr, tmr)


def test_compress_host_callback_on_a_mesh():
    jmr, tmr = agg_both()
    for mr in (jmr, tmr):
        mr.compress(lambda k, vals, kv, p: kv.add(k, len(vals)))
    assert host_pairs(tmr) == host_pairs(jmr)


# -- open / close --------------------------------------------------------------

def test_open_close_cross_mr_adds():
    """Another MR's callbacks add into an opened mesh MR; the adds are
    host pages until the next aggregate routes them to the shards."""
    jmr, tmr = agg_both()
    jdst, tdst = JMapReduce(j_make_mesh(P)), MapReduce(comm=tmesh(P))
    for src, dst in ((jmr, jdst), (tmr, tdst)):
        kv = dst.open()
        mapper = src.copy()

        def into(itask, k, v, _kv, ptr, kv=kv):
            if int(k) % 3 == 0:
                kv.add(int(k), int(v))
        mapper.map_mr(src, into)
        mapper.map_mr(src, into)     # the opened KV keeps taking adds
        want = 2 * sum(int(k) % 3 == 0 for k, _ in
                       src.kv.one_frame().to_host().pairs())
        assert dst.close() == want > 0
        dst.aggregate()
    same_kv(jdst, tdst)
    with pytest.raises(MRError, match="Cannot close without open"):
        tdst.close()


# -- out of core ---------------------------------------------------------------

NOOC = 300_000


def big(itask, kv, ptr):
    rng = np.random.default_rng(itask)
    keys = rng.integers(0, 5000, NOOC).astype(np.uint64)
    keys[:10] = [(1 << 64) - 1, 1 << 63, 0, 0, 1, 1, 2, 2, 2, 3]
    kv.add_batch(keys, np.arange(NOOC, dtype=np.int64) % 7)


def ooc_both(tmp_path, fn=big):
    out = []
    for side in ("j", "t"):
        d = tmp_path / side
        kw = dict(outofcore=1, memsize=1, maxpage=1, fpath=str(d))
        mr = JMapReduce(j_make_mesh(P), **kw) if side == "j" \
            else MapReduce(comm=tmesh(P), **kw)
        mr.map(1, fn)
        mr.aggregate()
        out.append(mr)
    return out


def pages(mr, which="kv"):
    """Every frame of the dataset on the host, in order (a spilled page
    loads): KV rows exactly, KMV groups with sorted values."""
    ds = mr.kv if which == "kv" else mr.kmv
    out = []
    for fr in ds.frames():
        fr = fr if isinstance(fr, (KVFrame, KMVFrame)) else fr.to_host()
        if which == "kv":
            out.append((fr.key.tolist(), fr.value.tolist()))
        else:
            out.append(_groups(fr))
    return out


def test_outofcore_map_files_takes_the_host_path(tmp_path):
    paths = []
    for i in range(4):
        p = tmp_path / f"k{i}.bin"
        np.arange(i, 4000, 3, dtype=np.uint32).tofile(p)
        paths.append(str(p))
    from gpu_mapreduce_tpu.apps.intcount import _map_file as j_map_file
    from gpu_mapreduce_tpu_torch.apps.intcount import _map_file
    jmr, tmr = both(P, outofcore=1, fpath=str(tmp_path / "spill"))
    assert jmr.map_files(paths, j_map_file) == \
        tmr.map_files(paths, _map_file)
    assert tmr.last_ingest["mode"] == jmr.last_ingest["mode"] == "host"
    assert pages(tmr) == pages(jmr)


def test_outofcore_convert_demotes_then_merges(tmp_path):
    jmr, tmr = ooc_both(tmp_path)
    same_kv(jmr, tmr)
    assert tmr._mesh_over_budget(tmr.kv) and jmr._mesh_over_budget(jmr.kv)
    w0 = {"j": jmr.stats()["wsize"], "t": tmr.stats()["wsize"]}
    assert jmr.convert() == tmr.convert()
    assert tmr.kmv.nframes == jmr.kmv.nframes > 1
    assert pages(tmr, "kmv") == pages(jmr, "kmv")
    assert tmr.stats()["wsize"] - w0["t"] == jmr.stats()["wsize"] - w0["j"]
    for mr, fn in ((jmr, jkernels.count), (tmr, kernels.count)):
        mr.reduce(fn, batch=True)
    assert pages(tmr) == pages(jmr)


@pytest.mark.parametrize("flag", [1, -1])
def test_outofcore_sort_keys_demotes_in_shard_order(tmp_path, flag):
    """The demoted pages are shard-major, and the external sort's stable
    runs keep that order among equal keys (reversed when descending)."""
    jmr, tmr = ooc_both(tmp_path)
    assert jmr.sort_keys(flag) == tmr.sort_keys(flag) == NOOC
    assert tmr.kv.nframes == jmr.kv.nframes > 1
    assert pages(tmr) == pages(jmr)


def words(itask, kv, ptr):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 3000, 60_000)
    kv.add_batch([b"w%05d" % i for i in ids], ids.astype(np.int64))


@pytest.mark.parametrize("flag", [1, -1])
def test_outofcore_interned_sort_past_the_budget(tmp_path, flag):
    """An interned key sort over the budget demotes the mesh frame to
    host pages and sorts by the rows' bytes there."""
    jmr, tmr = ooc_both(tmp_path, fn=words)
    fr = one(tmr.kv)
    assert fr.key_decode is not None
    assert fr.nbytes() > tmr._hbm_budget_bytes()
    assert jmr.sort_keys(flag) == tmr.sort_keys(flag)
    assert tmr.kv.is_host_dataset()
    assert pages(tmr) == pages(jmr)


# -- save / load -----------------------------------------------------------------

def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    for fm in man["frames"]:
        fm.pop("digest")
    return man


@pytest.mark.parametrize("which", ["kv", "kmv"])
def test_save_at_p3_loads_at_p1_and_p8(tmp_path, which):
    jmr, tmr = agg_both()
    if which == "kmv":
        jmr.convert()
        tmr.convert()
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    assert jmr.save(jd) == tmr.save(td) == 1
    man = _manifest(td)
    assert man == _manifest(jd)
    assert man["mesh"] == {"nprocs": P}
    fm = man["frames"][0]
    counts = one(tmr.kv if which == "kv" else tmr.kmv)
    counts = counts.counts if which == "kv" else counts.gcounts
    assert fm["shards"] == counts.tolist()
    assert len(fm["shard_digests"]) == (P if which == "kv" else 0)
    for width in (1, 8):
        jl, tl = both(width)
        assert jl.load(td) == tl.load(jd) == tl.load(td)
        if which == "kmv":
            assert pages(tl, "kmv") == pages(jl, "kmv")
            continue
        for mr in (jl, tl):
            mr.aggregate()
        same_kv(jl, tl)
        for mr, fn in ((jl, jkernels.count), (tl, kernels.count)):
            mr.compress(fn, batch=True)
        same_kv(jl, tl)


def test_load_names_the_writer_shard(tmp_path):
    """A frame whose file digest holds but whose rows contradict a
    shard's stamp: the load refuses and names the writer shard."""
    jmr, tmr = agg_both()
    for name, mr in (("j", jmr), ("t", tmr)):
        ck = str(tmp_path / name)
        mr.save(ck)
        mpath = os.path.join(ck, "manifest.json")
        man = json.load(open(mpath))
        fm = man["frames"][0]
        fpath = os.path.join(ck, fm["file"])
        with np.load(fpath) as z:
            arrs = {k: z[k].copy() for k in z.files}
        arrs["v_arr"][fm["shards"][0] + 1] ^= 1     # in writer shard 1
        np.savez(fpath, **arrs)
        fm["digest"] = file_digest(fpath)
        json.dump(man, open(mpath, "w"))
    with pytest.raises(OSError, match="writer shard 1"):
        JMapReduce(j_make_mesh(2)).load(str(tmp_path / "t"))
    for ck in ("t", "j"):
        with pytest.raises(OSError, match="writer shard 1"):
            MapReduce(comm=tmesh(2)).load(str(tmp_path / ck))


# -- a named-MR script -----------------------------------------------------------

SCRIPT = """\
mr a
a map/file tmp.e read_edge
a aggregate NULL
a copy c
c map/mr c edge_to_vertex_pair
c copy q
q clone
c clone
c reduce count
mr k
k map/mr a edge_to_vertices
k compress count
k save ck
mr r
r load ck
r aggregate NULL
r compress count
mr s
s map/mr a edge_to_vertex_pair
s collapse int 7
mr z
z map/mr a edge_to_vertex_pair
z open
z close
mr o
o open 1
o close
"""


def _script_run(tmp_path, side):
    d = tmp_path / side
    d.mkdir()
    rng = np.random.default_rng(3)
    e = rng.integers(0, 30, (200, 2))
    (d / "tmp.e").write_text("".join(f"{a} {b}\n" for a, b in e)
                             + "18446744073709551615 1\n4 4\n")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        s = OinkScript(comm=tmesh(P), screen=io.StringIO()) \
            if side == "t" else JOinkScript(comm=j_make_mesh(P),
                                            screen=io.StringIO())
        s.run_string(SCRIPT)
        return s.obj.named
    finally:
        os.chdir(cwd)


def test_named_mr_script_on_a_mesh(tmp_path):
    jn, tn = _script_run(tmp_path, "j"), _script_run(tmp_path, "t")
    assert sorted(tn) == sorted(jn)
    for name in ("a", "k", "r"):
        same_kv(jn[name], tn[name])
    for name in ("q", "s"):
        if name == "q":
            same_kmv(jn[name], tn[name])
        else:
            assert pages(tn[name], "kmv") == pages(jn[name], "kmv")
    same_kv(jn["c"], tn["c"])
    for name in ("o", "z"):          # open without addflag empties
        assert tn[name].kv.nkv == jn[name].kv.nkv == 0


def test_skmv_map_and_concat_take_mesh_frames():
    """A KMV body over a mesh frame runs shard by shard (the same rows
    as the JAX ``skmv_map``), and ``concat_sharded`` of mesh frames is
    the shard-by-shard concatenation."""
    import jax.numpy as jnp
    import torch
    from gpu_mapreduce_tpu.parallel.devkernels import skmv_map as j_skmv
    from gpu_mapreduce_tpu_torch.parallel.backend import concat_mesh
    from gpu_mapreduce_tpu_torch.parallel.devkernels import skmv_map
    from gpu_mapreduce_tpu_torch.parallel.sharded import concat_sharded

    def j_first(uk, nv, vo, vals, gc, vc):
        return uk, vals[jnp.minimum(vo, vals.shape[0] - 1)], \
            jnp.arange(uk.shape[0]) < gc

    def t_first(uk, nv, vo, vals, gc, vc):
        return uk[:gc], vals[vo[:gc].to(torch.int64)], None
    jmr, tmr = agg_both()
    for mr in (jmr, tmr):
        mr.convert()
    j = j_skmv(jmr.kmv.one_frame(), j_first)
    t = skmv_map(one(tmr.kmv), t_first)
    assert isinstance(t, MeshKV) and t.counts.tolist() == j.counts.tolist()
    for p, s in enumerate(t.shards):
        a, b = j.shard_to_host(p), s.to_host()
        np.testing.assert_array_equal(b.key.data, a.key.data)
        np.testing.assert_array_equal(b.value.data, a.value.data)
    both_frames = concat_sharded([t, t])
    ref = concat_mesh([t, t])
    assert both_frames.counts.tolist() == ref.counts.tolist() == \
        (2 * t.counts).tolist()
    assert host_rows(both_frames) == host_rows(ref)


def host_rows(fr):
    return [list(s.to_host().pairs()) for s in fr.shards]
