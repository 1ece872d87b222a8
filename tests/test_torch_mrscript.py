"""Named-MR script lines and the kernel registries in the port against
the JAX package: each script runs in the port's ``OinkScript(device=
"cpu")`` and the JAX ``OinkScript(comm=make_mesh(1))`` from its own
directory, and every named MR must hold the same pairs (a KMV the same
groups, each group's values as a multiset, as ``jnp.lexsort`` promises
no order inside a group).  Also: the registries' names, the hash
callbacks against the JAX ``default_hash``/``hash_identity``, and
``MapReduce.copy``/``set``/``scan_kmv``/``kmv_stats``; the clone,
compress, open and close lines and ``edge_to_vertex_pair``."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu.oink import kernels as jkernels
from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.parallel.shuffle import default_hash
from gpu_mapreduce_tpu_torch import MapReduce, MRError, OinkScript
from gpu_mapreduce_tpu_torch.oink import kernels

FILES = [("tmp.e", "1 2\n2 3\n3 1\n18446744073709551615 1\n4 4\n2 3\n"),
         ("tmp.e2", "7 8\n9223372036854775808 7\n"),
         ("tmp.vw", "5 1.5\n6 -2.25\n5 0.5\n7 3.0\n6 9.75\n5 -1.0\n"),
         ("tmp.el", "1 2 7\n2 3 -1\n1 2 5\n18446744073709551615 4 7\n")]

SCRIPTS = {
    "reduces": """\
mr s
s map/file tmp.vw read_vertex_weight
s copy m
s copy x
s collate NULL
s reduce sum
m collate NULL
m reduce min
x aggregate NULL
x convert
x reduce max
""",
    "copy_add_count": """\
mr a
a map/file tmp.e read_edge
a copy b
b add a
b collate lookup3
b reduce count
b sort_values -1
""",
    "cull_sort_gather": """\
mr a
a map/file tmp.e read_edge
a map/mr a edge_upper
a aggregate identity
a convert
a reduce cull
a sort_keys -1
a gather 1
""",
    "path_variable_addflag": """\
variable f index tmp.e tmp.e2
mr a 0
a map/file v_f read_edge
a map/file tmp.e2 read_edge add
mr v
v map/mr a edge_to_vertices
v map/mr a edge_to_vertex add
v map/mr a edge_both_directions add
v collate NULL
mr w
w map/mr a add_weight
w map/mr w invert
""",
    "clone_compress_open_close": """\
mr a
a map/file tmp.e read_edge
a map/file tmp.e2 read_edge add
a copy c
c map/mr c edge_to_vertex_pair
c copy q
q clone
c clone
c reduce count
mr k
k map/mr a edge_to_vertices
k compress count
k copy o
o open 1
o close
mr z
z map/mr a edge_to_vertex_pair
z open
z close
""",
    "edge_labels": """\
mr l
l map/file tmp.el read_edge_label
l copy m
l collate NULL
m sort_values -1
""",
    "kmv_and_delete": """\
mr a
a map/file tmp.e read_edge
a map/mr a edge_both_directions
a collate NULL
mr d
d map/file tmp.e read_edge
d delete
""",
}


def _contents(mr):
    if mr.kmv is not None:
        out = []
        mr.scan_kmv(lambda k, vs, p: out.append(
            (repr(k), sorted(repr(v) for v in vs))))
        return ("kmv", out)
    if mr.kv is None:
        return None
    out = []
    mr.scan_kv(lambda k, v, p: out.append((repr(_py(k)), repr(_py(v)))))
    return ("kv", out)


def _py(x):
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_py(e) for e in x]
    return float(x) if isinstance(x, (float, np.floating)) else int(x)


def _run(tmp_path, side, script):
    d = tmp_path / side
    d.mkdir()
    for name, text in FILES:
        (d / name).write_text(text)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        buf = io.StringIO()
        s = OinkScript(device="cpu", screen=buf) if side == "port" \
            else JOinkScript(comm=make_mesh(1), screen=buf)
        s.run_string(script)
        return buf.getvalue(), {name: _contents(mr)
                                for name, mr in sorted(s.obj.named.items())}
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_named_mr_lines_match_jax(tmp_path, name):
    port = _run(tmp_path, "port", SCRIPTS[name])
    ref = _run(tmp_path, "jax", SCRIPTS[name])
    assert port == ref
    assert port[1] and all(c is not None for c in port[1].values())
    if name == "clone_compress_open_close":
        mrs = port[1]
        assert mrs["q"][0] == "kmv" and all(len(v) == 1 for _, v in
                                             mrs["q"][1])
        assert mrs["o"] == mrs["k"] and mrs["z"] == ("kv", [])
    if name == "kmv_and_delete":
        assert "d" not in port[1] and port[1]["a"][0] == "kmv"


def test_registries_against_jax():
    """Every JAX registry name resolves in the port or raises "not ported
    yet"; an unknown name raises as the JAX _lookup does."""
    tables = [("map/file", jkernels.MAP_FILE_KERNELS,
               kernels.MAP_FILE_KERNELS),
              ("map/mr", jkernels.MAP_MR_KERNELS, kernels.MAP_MR_KERNELS),
              ("reduce", jkernels.REDUCE_KERNELS, kernels.REDUCE_KERNELS),
              ("hash", jkernels.HASH_KERNELS, kernels.HASH_KERNELS)]
    missing = []
    for what, jt, tt in tables:
        assert set(tt) <= set(jt)
        for name in jt:
            if name in tt:
                assert kernels.lookup(tt, name, what) is tt[name]
                assert tt[name].__name__ == jt[name].__name__ or \
                    what == "reduce"
            else:
                with pytest.raises(MRError, match="not ported yet"):
                    kernels.lookup(tt, name, what)
                missing.append(name)
        with pytest.raises(MRError, match=f"unknown {what} kernel 'zz'"):
            kernels.lookup(tt, "zz", what)
    assert missing == []


@pytest.mark.parametrize("cols", [1, 2])
def test_hash_callbacks_match_jax(cols):
    rng = np.random.default_rng(cols)
    keys = rng.integers(0, (1 << 64) - 1, (500, cols), dtype=np.uint64,
                        endpoint=True)
    keys[:3] = np.array([[(1 << 64) - 1, 0], [1 << 63, 5],
                         [0, (1 << 64) - 1]], np.uint64)[:, :cols]
    keys = keys[:, 0] if cols == 1 else keys
    t = torch.from_numpy(keys.view(np.int64))
    want = np.asarray(default_hash(jnp.asarray(keys)))
    assert np.array_equal(kernels.hash_lookup3(t).numpy(),
                          want.astype(np.int64))
    want = np.asarray(jkernels.hash_identity(jnp.asarray(keys)))
    assert np.array_equal(kernels.hash_identity(t).numpy(),
                          want.astype(np.int64))


def test_copy_set_scan_kmv_and_stats(capsys):
    mr = MapReduce(device="cpu", memsize=8)
    keys = np.array([3, 1, 3, 2, 1, 3], np.uint64)
    vals = np.arange(6, dtype=np.int64)
    mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
    cp = mr.copy()
    assert cp.settings == mr.settings and cp.device == mr.device
    assert cp.kv_stats() == mr.kv_stats() == (6, 96)
    cp.set(memsize=16, verbosity=1)
    assert (cp.settings.memsize, mr.settings.memsize) == (16, 8)
    for bad in ({"onfault": "retry"}, {"onfault": "skip"}):
        with pytest.raises(MRError, match="not ported yet"):
            cp.set(**bad)
    with pytest.raises(MRError, match="Invalid memsize"):
        cp.set(memsize=0)
    assert cp.collate() == 3
    groups = []
    assert cp.scan_kmv(lambda k, vs, p: groups.append((k, sorted(vs)))) == 3
    assert groups == [(1, [1, 4]), (2, [3]), (3, [0, 2, 5])]
    frames = []
    cp.scan_kmv(lambda fr, p: frames.append(len(fr)), batch=True)
    assert frames == [3]
    # a device KMV counts its padded tensors, as the JAX package does:
    # 8 group slots of u64 key + int32 size + int32 offset, 8 u64 values
    assert cp.kmv_stats(1) == (3, 6, 8 * 16 + 8 * 8)
    assert "3 pairs, 6 values" in capsys.readouterr().out
    assert mr.kmv_stats() == (0, 0, 0) and mr.kv.nkv == 6
    with pytest.raises(MRError, match="without KeyMultiValue"):
        mr.scan_kmv(lambda k, vs, p: None)
