"""sssp's layer in the port against the JAX package on the same inputs,
exactly: the staging's ``need_weights``, ``bellman_ford``'s dist, pred
and round count (float64 weights, and unit weights where many paths tie),
and the sssp command's sources, ``results``, ``niters``, files and
named-MR rows."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.models import rmat as jrmat
from gpu_mapreduce_tpu.models import sssp as jsssp
from gpu_mapreduce_tpu.oink.command import run_command as j_run
from gpu_mapreduce_tpu.oink.objects import ObjectManager as JObjects
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.parallel.staging import stage_graph as j_stage
from gpu_mapreduce_tpu_torch.interop import (mapreduce_from_numpy,
                                             mapreduce_to_numpy)
from gpu_mapreduce_tpu_torch.models import sssp as tsssp
from gpu_mapreduce_tpu_torch.oink.command import run_command as t_run
from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
from gpu_mapreduce_tpu_torch.parallel.staging import (as_float64,
                                                      stage_graph)


def _weighted(seed, nlevels=9, nnz=3, unit=False):
    e, _ = jrmat.generate_unique(seed, nlevels, nnz,
                                 (0.45, 0.15, 0.15, 0.25))
    rng = np.random.default_rng(seed)
    e = e.copy()
    e[rng.integers(0, len(e), 25)] |= np.uint64(1 << 63)
    w = np.ones(len(e)) if unit else rng.random(len(e)) * 10.0
    order = rng.permutation(len(e))
    return e[order], w[order]


def _jax_mr(e, w):
    mr = JMapReduce(make_mesh(1))
    mr.map(1, lambda i, kv, p: kv.add_batch(e, w))
    return mr


@pytest.mark.parametrize("seed", [1, 2])
def test_staging_weights_exact(seed):
    e, w = _weighted(seed)
    jsg = j_stage(_jax_mr(e, w), make_mesh(1), need_weights=True)
    tsg = stage_graph(mapreduce_from_numpy(e, w, device="cpu"),
                      need_weights=True)
    valid = np.asarray(jsg.valid)
    assert tsg.n == jsg.n
    assert np.array_equal(np.asarray(jsg.src)[valid], tsg.src.numpy())
    assert np.array_equal(np.asarray(jsg.dst)[valid], tsg.dst.numpy())
    assert tsg.weights.dtype == torch.float64
    assert np.array_equal(np.asarray(jsg.weights)[valid],
                          tsg.weights.numpy())


def test_as_float64_rounds_u64_like_numpy():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(0, (1 << 64) - 1, 5000,
                                     dtype=np.uint64, endpoint=True),
                        np.array([0, 1, (1 << 53) + 1, (1 << 63) - 1,
                                  1 << 63, (1 << 63) + 1025,
                                  (1 << 64) - 1], np.uint64)])
    got = as_float64(torch.from_numpy(x.view(np.int64)), np.uint64)
    assert np.array_equal(got.numpy(), x.astype(np.float64))
    u8 = np.array([0, 1, 255], np.uint8)
    assert as_float64(torch.from_numpy(u8), np.uint8).tolist() == \
        [0.0, 1.0, 255.0]


@pytest.mark.parametrize("seed, unit", [(11, False), (12, True),
                                        (13, True), (14, False)])
def test_bellman_ford_exact(seed, unit):
    e, w = _weighted(seed, unit=unit)
    sg = stage_graph(mapreduce_from_numpy(e, w, device="cpu"),
                     need_weights=True)
    s32, d32 = sg.src.numpy().astype(np.int32), sg.dst.numpy().astype(
        np.int32)
    rng = np.random.default_rng(seed)
    for source in rng.integers(0, sg.n, 4).tolist():
        jd, jp, jit = jsssp.bellman_ford(s32, d32, jnp.asarray(w), sg.n,
                                         jnp.int32(source))
        dist, pred, it = tsssp.bellman_ford(sg.src, sg.dst, sg.weights,
                                            sg.n, source)
        assert it == int(jit)
        assert dist.dtype == torch.float64 and pred.dtype == torch.int32
        assert np.array_equal(dist.numpy(), np.asarray(jd))
        assert np.array_equal(pred.numpy(), np.asarray(jp))
        assert dist[source] == 0.0 and pred[source] == -1


def test_bellman_ford_maxiter():
    src = torch.arange(0, 49, dtype=torch.int64)
    w = torch.ones(49, dtype=torch.float64)
    dist, pred, it = tsssp.bellman_ford(src, src + 1, w, 50, 0, maxiter=4)
    jd, jp, jit = jsssp.bellman_ford(src.numpy().astype(np.int32),
                                     (src + 1).numpy().astype(np.int32),
                                     jnp.asarray(w.numpy()), 50,
                                     jnp.int32(0), maxiter=4)
    assert it == int(jit) == 4
    assert np.array_equal(dist.numpy(), np.asarray(jd))
    assert np.array_equal(pred.numpy(), np.asarray(jp))


@pytest.mark.parametrize("ncnt, seed", [(3, 7), (1, 12345)])
def test_sssp_command_matches_jax(tmp_path, ncnt, seed):
    e, w = _weighted(21, nlevels=7, nnz=3)
    jobj = JObjects(comm=make_mesh(1))
    jobj.name_mr("mre", _jax_mr(e, w))
    tobj = ObjectManager(device="cpu")
    tobj.name_mr("mre", mapreduce_from_numpy(e, w, device="cpu"))
    cmds, texts = [], []
    for side, run, obj in (("jax", j_run, jobj), ("port", t_run, tobj)):
        buf = io.StringIO()
        path = str(tmp_path / f"{side}.sssp")
        cmds.append(run("sssp", [str(ncnt), str(seed)], obj=obj,
                        inputs=["mre"], outputs=[(path, "mrs")], screen=buf))
        files = [path] if ncnt == 1 else [f"{path}.{i}"
                                          for i in range(ncnt)]
        texts.append((buf.getvalue(), [open(f).read() for f in files]))
    jcmd, tcmd = cmds
    assert texts[0] == texts[1]
    assert list(tcmd.niters) == list(jcmd.niters)
    assert tcmd.niters == jcmd.niters and tcmd.results == jcmd.results
    jrows = []
    jobj.named["mrs"].scan_kv(lambda k, v, p: jrows.append((k, v)))
    tk, tv = mapreduce_to_numpy(tobj.named["mrs"])
    assert np.array_equal(tk, np.array([k for k, _ in jrows], np.uint64))
    assert np.array_equal(tv, np.array([v for _, v in jrows]))
    assert (tv[:, 1] == -1.0).sum() >= 1          # NO_PRED kept as -1.0
