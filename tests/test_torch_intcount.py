"""The port's ``intcount`` against the JAX package's on a one-device mesh,
on the same small binary files of u32 keys: the totals and the top-N
(count descending, then key descending) must be equal, eagerly and under
``MRTPU_FUSE=1`` (cold, then warm on the group table)."""

import numpy as np
import pytest

from gpu_mapreduce_tpu.apps.intcount import intcount as jintcount
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.plan import plan_cache as j_plan_cache
from gpu_mapreduce_tpu_torch import intcount
from gpu_mapreduce_tpu_torch.plan import plan_cache, plan_history


@pytest.fixture
def files(tmp_path):
    """Two files; many keys share a count, so the top-N has ties, and
    keys with the top bit of a u32 set sit among them."""
    rng = np.random.default_rng(9)
    paths = []
    for i, n in enumerate((3000, 1700)):
        keys = rng.integers(0, 600, n).astype(np.uint32)
        keys[:50] = np.uint32(0xFFFFFFF0) + np.uint32(i)
        keys[50:60] = 0
        p = tmp_path / f"ints{i}.bin"
        keys.tofile(p)
        paths.append(str(p))
    return paths


def oracle(paths, ntop):
    keys = np.concatenate([np.fromfile(p, np.uint32) for p in paths])
    uk, c = np.unique(keys, return_counts=True)
    order = np.lexsort((-uk.astype(np.int64), -c))
    return len(keys), len(uk), [(int(uk[i]), int(c[i]))
                                for i in order[:ntop]]


@pytest.mark.parametrize("fuse", ["0", "1"])
@pytest.mark.parametrize("ntop", [0, 5, 40])
def test_intcount_matches_jax(files, monkeypatch, fuse, ntop):
    monkeypatch.setenv("MRTPU_FUSE", fuse)
    monkeypatch.setenv("MRTPU_PALLAS_GROUP", "1")
    plan_cache().clear()
    j_plan_cache().clear()
    want = oracle(files, ntop)
    if ntop:                                         # ties in the top-N
        assert len({c for _, c in want[2]}) < ntop
    jn, ju, jtop = jintcount(files, ntop=ntop, comm=make_mesh(1))
    assert (int(jn), int(ju), jtop) == want
    for run in ("cold", "warm"):
        assert intcount(files, ntop=ntop, device="cpu") == want
        if fuse == "1":
            group = next(g for e in reversed(plan_history())
                         for g in e["groups"] if g["fused"])
            assert (group["mode"], group["table"]) == (
                ("local", False) if run == "cold" else ("local1", True))
