"""The plain references against the system at tiny sizes on the CPU:
PageRank, edge_upper, cc_find (both engines), the InvertedIndex job and
the lookup3 intern id."""

import io
import random

import numpy as np
import pytest
import torch

from mrbench.gen import graph500, html
from mrbench.ref import graph, invindex, lookup3

ABCD = (0.57, 0.19, 0.19, 0.05)
SEED = 2 ** 31 + 4242
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def script():
    """An OinkScript on the CPU holding the scale-10 graph as ``mre``."""
    from gpu_mapreduce_tpu_torch import OinkScript
    edges = graph500.generate(SEED, 10, 16, ABCD)["edges"]
    s = OinkScript(device=CPU, screen=False, logfile=None)
    mr = s.obj.create_mr()
    null = torch.zeros(edges.shape[0], dtype=torch.uint8)
    mr.map(1, lambda i, kv, p: kv.add_batch(edges, null, key_dtype=np.uint64))
    s.obj.name_mr("mre", mr)
    return s, edges


def _run(s, line):
    s.screen = buf = io.StringIO()
    s.one(line)
    return buf.getvalue()


def _pairs(mr):
    from gpu_mapreduce_tpu_torch.interop import mapreduce_to_numpy
    k, v = mapreduce_to_numpy(mr)
    if k.ndim > 1:
        return k, v
    order = np.argsort(k, kind="stable")
    return k[order], v[order]


def test_pagerank_reference_agrees_with_the_system(script):
    s, edges = script
    msg = _run(s, "pagerank 1e-8 100 0.85 -i mre -o NULL mrpr")
    k, v = _pairs(s.obj.named.pop("mrpr"))
    verts, r, steps = graph.pagerank([edges], 1e-8, 100, 0.85)
    assert np.array_equal(k, verts.numpy().astype(np.uint64))
    assert np.abs(v - r.numpy()).max() / r.max().item() < 1e-5
    assert f"{steps} iterations" in msg or abs(
        int(msg.split()[-2]) - steps) <= 1


def test_edge_upper_reference_agrees_with_the_system(script):
    s, edges = script
    _run(s, "edge_upper -i mre -o NULL mrup")
    k, _ = _pairs(s.obj.named.pop("mrup"))
    want = graph.edge_upper(edges).numpy().astype(np.uint64)
    got = np.asarray(k).reshape(-1, 2)
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("engine", ["fused", "composed"])
def test_components_reference_agrees_with_the_system(script, engine,
                                                      monkeypatch):
    s, edges = script
    monkeypatch.setenv("GPUMR_CC_ENGINE", engine)
    _run(s, "edge_upper -i mre -o NULL mru")
    msg = _run(s, "cc_find 0 -i mru -o NULL mrc")
    k, v = _pairs(s.obj.named.pop("mrc"))
    s.obj.delete_mr("mru")
    verts, zones, _ = graph.components(graph.edge_upper(edges))
    assert np.array_equal(k, verts.numpy().astype(np.uint64))
    assert np.array_equal(v, zones.numpy().astype(np.uint64))
    assert f"{torch.unique(zones).numel()} components" in msg


def test_components_stopped_early_is_wrong(script):
    _, edges = script
    up = graph.edge_upper(edges)
    _, zones, rounds = graph.components(up)
    _, early, _ = graph.components(up, max_rounds=rounds - 2)
    assert rounds >= 3 and not torch.equal(zones, early)


def test_lookup3_reference_agrees_with_the_system():
    from gpu_mapreduce_tpu_torch.ops.hash import hash_bytes64
    rng = random.Random(5)
    keys = [bytes(rng.randrange(256) for _ in range(n))
            for n in [0, 1, 11, 12, 13, 23, 24, 25, 60, 199, 255]
            + [rng.randrange(1, 80) for _ in range(40)]]
    got = lookup3.intern_ids(keys)
    assert got.tolist() == [hash_bytes64(k) for k in keys]


def test_invertedindex_reference_agrees_with_the_system(tmp_path):
    from gpu_mapreduce_tpu_torch.apps.invertedindex import InvertedIndex
    from gpu_mapreduce_tpu_torch.interop import mapreduce_to_numpy
    paths, info = html.make_corpus(str(tmp_path), SEED, 1 << 20, 4, 1 << 10,
                                   2.1, 50)
    ii = InvertedIndex(CPU)
    npairs, nurl = ii.run(paths, outdir=str(tmp_path / "out"))
    want = invindex.index(paths)
    assert (npairs, nurl) == invindex.totals(want)
    ids, counts = mapreduce_to_numpy(ii.mr)
    assert {int(i): int(c) for i, c in zip(ids.tolist(), counts.tolist())} \
        == {k: c for k, (c, _) in want.items()}
    # the part file's file sets, by URL
    names = {p: i for i, p in enumerate(paths)}
    byurl = {}
    for line in open(tmp_path / "out" / "part-00000"):
        url, files = line.rstrip("\n").split("\t")
        byurl[lookup3.intern_ids([url.encode()])[0].item()] = tuple(
            sorted(names[f] for f in files.split()))
    assert byurl == {k: d for k, (_, d) in want.items()}
    # the 64-byte window alone loses every long URL
    short = invindex.index(paths, 64)
    assert invindex.mismatches(short, want) > 0
