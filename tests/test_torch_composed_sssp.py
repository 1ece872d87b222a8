"""The port's composed sssp engine (``engine="composed"``: Bellman-Ford
rounds over ``compress`` and ``open``/``close`` with the device bodies of
``parallel/devkernels.py``) against the JAX package's composed engine on
``make_mesh(1)``, on one directed R-MAT graph with float64 weights
carried into both as numpy: equal message lines, equal output files,
``results`` (dist and pred) and ``niters`` exactly; the distances also
equal the port's fused engine's."""

import io

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.models import rmat as jrmat
from gpu_mapreduce_tpu.oink.command import run_command as j_run
from gpu_mapreduce_tpu.oink.objects import ObjectManager as JObjects
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch.interop import (mapreduce_from_numpy,
                                             mapreduce_to_numpy)
from gpu_mapreduce_tpu_torch.oink.command import run_command as t_run
from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager


def _graph():
    """R-MAT at scale 8 (8 edges a vertex), directed, rows in a seeded
    order, weights in [0, 10)."""
    e, _ = jrmat.generate_unique(5, 8, 8, (0.45, 0.15, 0.15, 0.25))
    e = e[np.random.default_rng(5).permutation(len(e))]
    return e, np.random.default_rng(7).random(len(e)) * 10.0


def _run(side, tmp_path, engine):
    """sssp 2 12345 on one side: (message, output files, command, the
    named MR's pairs)."""
    e, w = GRAPH
    if side == "jax":
        obj, run = JObjects(comm=make_mesh(1)), j_run
        mr = JMapReduce(make_mesh(1))
        mr.map(1, lambda i, kv, p: kv.add_batch(e, w))
        obj.name_mr("mre", mr)
    else:
        obj, run = ObjectManager(device="cpu"), t_run
        obj.name_mr("mre", mapreduce_from_numpy(e, w, device="cpu"))
    buf = io.StringIO()
    path = tmp_path / f"{side}-{engine}.sssp"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GPUMR_SSSP_ENGINE", engine)
        cmd = run("sssp", ["2", "12345"], obj=obj, inputs=["mre"],
                  outputs=[(str(path), "mrs")], screen=buf)
    files = [(tmp_path / f"{path.name}.{i}").read_text() for i in range(2)]
    pairs = []
    if side == "jax":
        obj.named["mrs"].scan_kv(lambda k, v, p: pairs.append(
            (int(k), tuple(np.asarray(v).tolist()))))
    else:
        k, v = mapreduce_to_numpy(obj.named["mrs"])
        pairs = list(zip(k.tolist(), map(tuple, v.tolist())))
    return buf.getvalue(), files, cmd, sorted(pairs)


GRAPH = _graph()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("composed_sssp")
    return {(side, eng): _run(side, d, eng)
            for side, eng in (("jax", "composed"), ("port", "composed"),
                              ("port", "fused"))}


def test_composed_sssp_lines_match_jax(runs):
    """Equal message lines and output files (each in ascending v)."""
    j, t = runs["jax", "composed"], runs["port", "composed"]
    assert t[0] == j[0] and t[0].count("SSSP: source") == 2
    assert t[1] == j[1]


def test_composed_sssp_results_match_jax(runs):
    """results (dist and pred a vertex) and niters exactly."""
    j, t = runs["jax", "composed"][2], runs["port", "composed"][2]
    assert list(t.niters) == list(j.niters) and t.niters == j.niters
    assert t.results == j.results
    assert max(t.niters.values()) >= 3


def test_composed_sssp_named_mr_matches_jax(runs):
    """The named output holds the last source's state rows [1, pred,
    dist, 1], pred -1.0 where there is none."""
    j, t = runs["jax", "composed"][3], runs["port", "composed"][3]
    assert t == j and len(t) > 100
    assert any(v[1] == -1.0 for _, v in t)


def test_composed_sssp_distances_equal_fused(runs):
    c = runs["port", "composed"][2].results
    f = runs["port", "fused"][2].results
    assert list(c) == list(f)
    for source in c:
        assert {v: d for v, (d, _) in c[source].items()} == \
            {v: d for v, (d, _) in f[source].items()}
