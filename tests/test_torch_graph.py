"""The port's graph layer against the JAX package on the same inputs:
two-column keys through convert/reduce, the R-MAT generator, device
staging, cc and PageRank (on edges carried across by ``interop``), and
the interop round trip.  Everything is exact except PageRank, whose
float32 sums run in another order (ranks rtol 1e-5, atol 1e-9; the step
count within one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.models import cc as jcc
from gpu_mapreduce_tpu.models import pagerank as jpr
from gpu_mapreduce_tpu.models import rmat as jrmat
from gpu_mapreduce_tpu.oink.command import run_command as j_run
from gpu_mapreduce_tpu.oink.objects import ObjectManager as JObjects
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.parallel.staging import stage_graph as j_stage
from gpu_mapreduce_tpu_torch import MapReduce
from gpu_mapreduce_tpu_torch.interop import (mapreduce_from_numpy,
                                             mapreduce_to_numpy)
from gpu_mapreduce_tpu_torch.models import cc as tcc
from gpu_mapreduce_tpu_torch.models import pagerank as tpr
from gpu_mapreduce_tpu_torch.models import rmat as trmat
from gpu_mapreduce_tpu_torch.oink.command import run_command as t_run
from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
from gpu_mapreduce_tpu_torch.ops import prng
from gpu_mapreduce_tpu_torch.ops.reduces import count, cull
from gpu_mapreduce_tpu_torch.parallel.staging import stage_graph

U64MAX = np.iinfo(np.uint64).max


def _j_pairs(mr):
    out = []
    mr.scan_kv(lambda k, v, p: out.append((k, v)))
    return out


def _two_col_keys(n, ndistinct, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, U64MAX, (ndistinct, 2), dtype=np.uint64,
                        endpoint=True)
    rows[0] = [U64MAX, 0]
    rows[1] = [1 << 63, U64MAX]
    rows[2] = [1 << 63, 5]                # same column 0 as row 1
    keys = rows[rng.integers(0, ndistinct, n)]
    keys[:ndistinct] = rows               # every row present
    vals = rng.integers(0, U64MAX, n, dtype=np.uint64, endpoint=True)
    vals[::3] |= np.uint64(1 << 63)       # values with the top bit set
    return keys, vals


@pytest.mark.parametrize("n, ndistinct, seed", [(20, 9, 1), (300, 41, 2),
                                                (1000, 400, 3)])
@pytest.mark.parametrize("reduce_fn", ["count", "cull", "host"])
def test_two_column_keys_group_like_jax(n, ndistinct, seed, reduce_fn):
    """convert + reduce on [n, 2] u64 keys: the same groups, in the same
    order, with the same values as the JAX package on one device."""
    from gpu_mapreduce_tpu.ops import reduces as jreduces
    keys, vals = _two_col_keys(n, ndistinct, seed)
    fns = {"count": (count, jreduces.count), "cull": (cull, jreduces.cull)}
    out = []
    for mr, side in ((MapReduce(device="cpu"), 0),
                     (JMapReduce(make_mesh(1)), 1)):
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        mr.aggregate()
        ng = mr.convert()
        if reduce_fn == "host":
            mr.reduce(lambda k, vs, kv, p: kv.add(k, len(vs)))
        else:
            mr.reduce(fns[reduce_fn][side], batch=True)
        out.append((int(ng), [(tuple(int(x) for x in k), int(v))
                              for k, v in _j_pairs(mr)]))
    assert out[0][0] == ndistinct
    assert out[0] == out[1]


def test_two_column_keys_fused_group_like_eager():
    """The fuser's local group (sort path; the table refuses 2-D keys)
    groups [n, 2] keys as the eager ops do."""
    keys, vals = _two_col_keys(500, 60, 4)
    got = []
    for fuse in (0, 1):
        mr = MapReduce(device="cpu", fuse=fuse)
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        mr.collate()
        mr.reduce(count, batch=True)
        got.append(_j_pairs(mr))
    assert got[0] == got[1] and len(got[0]) == 60


def test_group_table_refuses_two_column_keys():
    from gpu_mapreduce_tpu_torch.ops.cuda.group import group_supported
    from gpu_mapreduce_tpu_torch.parallel.sharded import tensor_frame
    skv = tensor_frame(torch.zeros(8, 2, dtype=torch.int64),
                       torch.zeros(8, dtype=torch.int64), np.uint64)
    ok, reason = group_supported(skv, "kv", "count")
    assert not ok and "1-D" in reason


# ---------------------------------------------------------------------------
# R-MAT
# ---------------------------------------------------------------------------

RMAT_CASES = [(1, 8), (2, 16), (5, 100), (8, 1000), (12, 4096), (16, 4096),
              (16, 8)]


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("nlevels, m", RMAT_CASES)
def test_rmat_edges_exact(noisy, nlevels, m):
    abcd = (0.57, 0.19, 0.19, 0.05)
    frac = 0.4 if noisy else 0.0
    jvi, jvj = jrmat.rmat_edges(jax.random.PRNGKey(99 + nlevels), m, nlevels,
                                jnp.asarray(abcd), frac, noisy=noisy)
    tvi, tvj = trmat.rmat_edges(prng.PRNGKey(99 + nlevels), m, nlevels,
                                abcd, frac, noisy)
    assert np.array_equal(np.asarray(jvi), tvi.numpy().view(np.uint64))
    assert np.array_equal(np.asarray(jvj), tvj.numpy().view(np.uint64))


@pytest.mark.parametrize("seed, nlevels, nnz, abcd, frac", [
    (3, 10, 8, (0.57, 0.19, 0.19, 0.05), 0.0),
    (4, 9, 4, (0.25, 0.25, 0.25, 0.25), 0.0),
    (5, 8, 16, (0.45, 0.15, 0.15, 0.25), 0.2)])
def test_generate_unique_exact(seed, nlevels, nnz, abcd, frac):
    jadded, tadded = [], []
    je, jn = jrmat.generate_unique(seed, nlevels, nnz, abcd, frac,
                                   add_edges=jadded.append)
    te, tn = trmat.generate_unique(seed, nlevels, nnz, abcd, frac,
                                   add_edges=tadded.append)
    assert jn == tn and jn > 1
    assert np.array_equal(je, te.numpy().view(np.uint64))
    assert len(jadded) == len(tadded)
    for a, b in zip(jadded, tadded):
        assert np.array_equal(a, b.numpy().view(np.uint64))


# ---------------------------------------------------------------------------
# staging, cc, PageRank
# ---------------------------------------------------------------------------

def _edges(seed, nlevels=9, nnz=4, abcd=(0.57, 0.19, 0.19, 0.05)):
    e, _ = jrmat.generate_unique(seed, nlevels, nnz, abcd)
    rng = np.random.default_rng(seed)
    big = np.uint64(1 << 63)
    e = e.copy()
    e[rng.integers(0, len(e), 40)] |= big      # ids past 2^63
    e = e[rng.permutation(len(e))]             # not sorted by key
    return e, np.zeros(len(e), np.uint8)


def _port_mr(e, v):
    return mapreduce_from_numpy(e, v, device="cpu")


def _jax_mr(e, v):
    mr = JMapReduce(make_mesh(1))
    mr.map(1, lambda i, kv, p: kv.add_batch(e, v))
    return mr


@pytest.mark.parametrize("seed", [11, 12])
def test_staging_exact(seed):
    e, v = _edges(seed)
    jsg = j_stage(_jax_mr(e, v), make_mesh(1))
    tsg = stage_graph(_port_mr(e, v))
    assert tsg.n == jsg.n
    assert np.array_equal(tsg.verts.numpy().view(np.uint64), jsg.verts)
    valid = np.asarray(jsg.valid)
    assert valid.sum() == len(e)
    assert np.array_equal(np.asarray(jsg.src)[valid], tsg.src.numpy())
    assert np.array_equal(np.asarray(jsg.dst)[valid], tsg.dst.numpy())
    want = np.searchsorted(jsg.verts, e)               # host oracle
    assert np.array_equal(np.stack([tsg.src.numpy(), tsg.dst.numpy()], 1),
                          want)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_cc_exact(seed):
    e, v = _edges(seed, nlevels=10, nnz=1, abcd=(0.25, 0.25, 0.25, 0.25))
    sg = stage_graph(_port_mr(e, v))
    jlab, jit = jcc.cc(sg.src.numpy().astype(np.int32),
                       sg.dst.numpy().astype(np.int32), sg.n)
    tlab, tit = tcc.cc(sg.src, sg.dst, sg.n)
    assert tit == int(jit) and tit > 1
    assert np.array_equal(np.asarray(jlab), tlab.numpy())


def test_cc_maxiter_and_empty():
    src = torch.arange(0, 63, dtype=torch.int64)
    lab, it = tcc.cc(src, src + 1, 64, maxiter=2)
    jlab, jit = jcc.cc(src.numpy().astype(np.int32),
                       (src + 1).numpy().astype(np.int32), 64, maxiter=2)
    assert it == int(jit) == 2 and np.array_equal(np.asarray(jlab),
                                                  lab.numpy())
    lab, it = tcc.cc(src[:0], src[:0], 0)
    assert it == 0 and lab.numel() == 0


@pytest.mark.parametrize("seed, tol, maxiter", [(31, 1e-6, 40),
                                                (32, 1e-4, 40),
                                                (33, 1e-9, 12)])
def test_pagerank_model_close(seed, tol, maxiter):
    e, v = _edges(seed)
    sg = stage_graph(_port_mr(e, v))
    jr, jit = jpr.pagerank(sg.src.numpy().astype(np.int32),
                           sg.dst.numpy().astype(np.int32), sg.n, tol=tol,
                           maxiter=maxiter, damping=0.85)
    tr, tit = tpr.pagerank(sg.src, sg.dst, sg.n, tol=tol, maxiter=maxiter,
                           damping=0.85)
    assert abs(tit - int(jit)) <= 1
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-9)


def test_pagerank_command_on_carried_edges():
    """rmat in the JAX package; its edge KV carried into the port by
    interop; pagerank in both on exactly those edges."""
    jobj = JObjects(comm=make_mesh(1))
    j_run("rmat", ["10", "8", "0.57", "0.19", "0.19", "0.05", "0.0", "5"],
          obj=jobj, outputs=[(None, "mre")], screen=False)
    jkeys = []
    jobj.named["mre"].scan_kv(lambda k, v, p: jkeys.append(k))
    e = np.asarray(jkeys, np.uint64)
    tobj = ObjectManager(device="cpu")
    tobj.name_mr("mre", mapreduce_from_numpy(e, np.zeros(len(e), np.uint8),
                                             device="cpu"))
    args = ["1e-7", "60", "0.85"]
    jcmd = j_run("pagerank", args, obj=jobj, inputs=["mre"],
                 outputs=[(None, "mrr")], screen=False)
    tcmd = t_run("pagerank", args, obj=tobj, inputs=["mre"],
                 outputs=[(None, "mrr")], screen=False)
    assert tcmd.nvert == jcmd.nvert and tcmd.nedge == len(e)
    assert abs(tcmd.niterate - jcmd.niterate) <= 1
    jv = np.array(sorted(jcmd.ranks))
    tv, tr = mapreduce_to_numpy(tobj.named["mrr"])
    assert np.array_equal(tv, jv)
    np.testing.assert_allclose(tr, [jcmd.ranks[int(x)] for x in jv],
                               rtol=1e-5, atol=1e-9)
    assert abs(tr.sum() - 1.0) < 1e-4


def test_interop_round_trip():
    """JAX MR → numpy → port MR → numpy is bit-identical."""
    e, _ = _edges(41)
    vals = np.random.default_rng(41).integers(0, U64MAX, len(e),
                                              dtype=np.uint64, endpoint=True)
    jmr = _jax_mr(e, vals)
    jmr.aggregate()
    jk, jv = [], []
    jmr.scan_kv(lambda k, v, p: (jk.append(k), jv.append(v)))
    jk, jv = np.asarray(jk, np.uint64), np.asarray(jv, np.uint64)
    tk, tv = mapreduce_to_numpy(mapreduce_from_numpy(jk, jv, device="cpu"))
    assert tk.dtype == np.uint64 and tv.dtype == np.uint64
    assert np.array_equal(tk, jk) and np.array_equal(tv, jv)
