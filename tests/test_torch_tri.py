"""tri_find's layer in the port against the JAX package on the same
inputs, exactly: ``_pair_expand`` at every triangular boundary up to
t = 2^40, ``triangles_ranked``'s rows in order (duplicate rows,
self-loops, ids past 2^63, batches cut small), and
the tri_find command's rows against a brute-force triangle set."""

import itertools

import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu.models import rmat as jrmat
from gpu_mapreduce_tpu.models import tri as jtri
from gpu_mapreduce_tpu_torch.interop import (mapreduce_from_numpy,
                                             mapreduce_to_numpy)
from gpu_mapreduce_tpu_torch.models import tri as ttri
from gpu_mapreduce_tpu_torch.oink.command import run_command as t_run
from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
from gpu_mapreduce_tpu_torch.parallel.staging import stage_graph


def _boundaries(jmax: int) -> np.ndarray:
    """t at, just below and just above every j(j-1)/2 for j < jmax."""
    j = np.arange(1, jmax, dtype=np.int64)
    tb = j * (j - 1) // 2
    t = np.concatenate([tb, tb + 1, np.maximum(tb - 1, 0), tb + j - 1])
    return np.unique(t)


def test_pair_expand_exact_at_every_boundary():
    # every j with j(j-1)/2 <= 2^40 (j < 1,482,911), t at, around and at
    # the end of each row of the triangular enumeration
    jmax = int((1 + np.sqrt(1 + 8.0 * 2**40)) / 2) + 2
    t = _boundaries(jmax)
    assert t.max() >= 2**40
    i, j = ttri._pair_expand(torch.from_numpy(t))
    i, j = i.numpy(), j.numpy()
    assert np.all((0 <= i) & (i < j))
    assert np.array_equal(j * (j - 1) // 2 + i, t)
    ji, jj = jtri._pair_expand(t)
    assert np.array_equal(i, ji) and np.array_equal(j, jj)


def _ranked(seed, nlevels, nnz, n_dup=0, n_loops=0):
    e, _ = jrmat.generate_unique(seed, nlevels, nnz,
                                 (0.45, 0.15, 0.15, 0.25))
    rng = np.random.default_rng(seed)
    e = e.copy()
    if n_dup:                                  # reversed and repeated rows
        e = np.concatenate([e, e[rng.integers(0, len(e), n_dup)][:, ::-1]])
    if n_loops:
        v = rng.choice(e.reshape(-1), n_loops)
        e = np.concatenate([e, np.stack([v, v], 1)])
    e[rng.integers(0, len(e), 20)] |= np.uint64(1 << 63)
    e = e[rng.permutation(len(e))]
    sg = stage_graph(mapreduce_from_numpy(e, np.zeros(len(e), np.uint8),
                                          device="cpu"))
    return sg


@pytest.mark.parametrize("seed, nlevels, nnz, n_dup, n_loops", [
    (1, 8, 8, 0, 0), (2, 9, 6, 200, 20), (3, 7, 16, 50, 5),
    (4, 10, 4, 0, 30)])
def test_triangles_ranked_exact(seed, nlevels, nnz, n_dup, n_loops):
    sg = _ranked(seed, nlevels, nnz, n_dup, n_loops)
    verts = sg.verts.numpy().view(np.uint64)
    want = jtri.triangles_ranked(sg.src.numpy(), sg.dst.numpy(), sg.n,
                                 verts, use_device=False)
    got, nwedges = ttri.triangles_ranked(sg.src, sg.dst, sg.n, sg.verts)
    assert got.shape[0] == len(want) > 10
    assert np.array_equal(got.numpy().view(np.uint64), want)
    assert nwedges >= len(want)


def test_triangles_batches_keep_wedge_order(monkeypatch):
    """Batches of 7 wedges give the same rows in the same order."""
    sg = _ranked(5, 7, 8, 30, 3)
    whole, nw = ttri.triangles_ranked(sg.src, sg.dst, sg.n, sg.verts)
    monkeypatch.setattr(ttri, "_BATCH", 7)
    cut, nw7 = ttri.triangles_ranked(sg.src, sg.dst, sg.n, sg.verts)
    assert nw7 == nw > 7 * 10 and torch.equal(whole, cut)


def _brute(e):
    adj = {}
    for a, b in e.tolist():
        if a != b:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set()).add(a)
    return {frozenset(t) for t in itertools.combinations(sorted(adj), 3)
            if all(y in adj[x] for x, y in itertools.combinations(t, 2))}


def test_tri_find_command_rows():
    rng = np.random.default_rng(9)
    ids = np.array([3, 1 << 63, (1 << 64) - 1, 7, 9, 11, (1 << 63) + 2, 40],
                   np.uint64)
    pairs = rng.integers(0, 8, (60, 2))
    e = ids[pairs]
    obj = ObjectManager(device="cpu")
    obj.name_mr("mre", mapreduce_from_numpy(e, np.zeros(len(e), np.uint8),
                                            device="cpu"))
    cmd = t_run("tri_find", [], obj=obj, inputs=["mre"],
                outputs=[(None, "mrt")], screen=False)
    rows, vals = mapreduce_to_numpy(obj.named["mrt"])
    want = _brute(e)
    assert cmd.ntri == len(rows) == len(want) > 5
    assert {frozenset(r) for r in rows.tolist()} == want
    assert vals.dtype == np.uint8
