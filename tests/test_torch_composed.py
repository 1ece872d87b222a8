"""The composed graph engines of the port (``engine="composed"``:
cc_find, luby_find, tri_find over MapReduce ops and the device bodies of
``parallel/devkernels.py``) against the JAX package's composed engines
on ``make_mesh(1)``, on one R-MAT graph carried into both as numpy:
equal message lines, equal output lines as sorted lists (row order
inside a group is not promised).  Then against the port's fused engines,
the MapReduce ops the engines brought (clone, compress, open/close)
against JAX on small KVs, and the host reads of the round loops (sssp's
too; its parity is in test_torch_composed_sssp.py)."""

import io

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.models import rmat as jrmat
from gpu_mapreduce_tpu.oink.command import run_command as j_run
from gpu_mapreduce_tpu.oink.objects import ObjectManager as JObjects
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch import MRError, MapReduce
from gpu_mapreduce_tpu_torch.core.frame import KVFrame
from gpu_mapreduce_tpu_torch.interop import (mapreduce_from_numpy,
                                             mapreduce_to_numpy)
from gpu_mapreduce_tpu_torch.oink.command import run_command as t_run
from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
from gpu_mapreduce_tpu_torch.parallel.sharded import (ShardedKMV, ShardedKV,
                                                      shard_frame)

ENGINES = {"cc_find": "GPUMR_CC_ENGINE", "luby_find": "GPUMR_LUBY_ENGINE",
           "tri_find": "GPUMR_TRI_ENGINE", "sssp": "GPUMR_SSSP_ENGINE"}
COMMANDS = [("cc_find", ["0"]), ("luby_find", ["6789"]), ("tri_find", [])]


def _graph():
    """R-MAT at scale 10 (8 edges a vertex) after edge_upper, rows in a
    seeded order."""
    e, _ = jrmat.generate_unique(5, 10, 8, (0.45, 0.15, 0.15, 0.25))
    lo, hi = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    keep = lo != hi
    upper = np.unique(np.stack([lo[keep], hi[keep]], 1), axis=0)
    return upper[np.random.default_rng(6).permutation(len(upper))]


def _run(side, tmp_path, engine):
    """The three commands on one side, each engine set to ``engine``:
    {command: (message, sorted output lines, the command)}."""
    null = np.zeros(len(GRAPH), np.uint8)
    if side == "jax":
        obj, run = JObjects(comm=make_mesh(1)), j_run
        mr = JMapReduce(make_mesh(1))
        mr.map(1, lambda i, kv, p: kv.add_batch(GRAPH, null))
        obj.name_mr("mru", mr)
    else:
        obj, run = ObjectManager(device="cpu"), t_run
        obj.name_mr("mru", mapreduce_from_numpy(GRAPH, null, device="cpu"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, args in COMMANDS:
            mp.setenv(ENGINES[name], engine)
            buf = io.StringIO()
            path = tmp_path / f"{side}-{engine}.{name}"
            cmd = run(name, args, obj=obj, inputs=["mru"],
                      outputs=[(str(path), f"out_{name}")], screen=buf)
            files = sorted(tmp_path.glob(path.name + "*"))
            lines = sorted(ln for f in files for ln in f.read_text()
                           .splitlines())
            out[name] = (buf.getvalue(), lines, cmd)
    return out


GRAPH = _graph()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("composed")
    return {(side, eng): _run(side, d, eng)
            for side, eng in (("jax", "composed"), ("port", "composed"),
                              ("port", "fused"))}


@pytest.mark.parametrize("name", [c for c, _ in COMMANDS])
def test_composed_matches_jax(runs, name):
    """Equal message lines and equal output lines, sorted."""
    jmsg, jlines, _ = runs["jax", "composed"][name]
    tmsg, tlines, _ = runs["port", "composed"][name]
    assert tmsg == jmsg and tmsg
    assert tlines == jlines and len(tlines) > 50


def test_composed_cc_equals_fused(runs):
    """The same (v, zone) pairs: each vertex named by its component's
    least id."""
    c = runs["port", "composed"]["cc_find"]
    f = runs["port", "fused"]["cc_find"]
    assert c[1] == f[1]
    assert c[2].ncc == f[2].ncc


def test_composed_tri_equals_fused(runs):
    """The same triangles as vertex sets (the engines name a triangle's
    corners in another order)."""
    c = runs["port", "composed"]["tri_find"]
    f = runs["port", "fused"]["tri_find"]

    def tris(lines):
        return {frozenset(ln.split()) for ln in lines}

    assert tris(c[1]) == tris(f[1]) and len(c[1]) == len(f[1]) > 100
    assert c[2].ntri == f[2].ntri


def test_composed_luby_is_independent_and_maximal(runs):
    upper = GRAPH
    mis = {int(ln) for ln in runs["port", "composed"]["luby_find"][1]}
    lo, hi = upper[:, 0].tolist(), upper[:, 1].tolist()
    assert not any(a in mis and b in mis for a, b in zip(lo, hi))
    covered = set(mis)
    for a, b in zip(lo, hi):
        if a in mis:
            covered.add(b)
        if b in mis:
            covered.add(a)
    assert covered == set(lo) | set(hi)


# ---------------------------------------------------------------------------
# the MapReduce ops the composed engines brought, against JAX
# ---------------------------------------------------------------------------

def _pairs(mr):
    out = []
    mr.scan_kv(lambda k, v, p: out.append((k, v)))
    return sorted(out)


def _both(keys, values):
    """The same pairs in a JAX MR on make_mesh(1) and a port MR."""
    j = JMapReduce(make_mesh(1))
    j.map(1, lambda i, kv, p: kv.add_batch(keys, values))
    return j, mapreduce_from_numpy(keys, values, device="cpu")


def _count(fr, kv, ptr):
    from gpu_mapreduce_tpu.ops.reduces import count as jcount
    from gpu_mapreduce_tpu_torch.ops.reduces import count as tcount
    (tcount if isinstance(fr, ShardedKMV) else jcount)(fr, kv, ptr)


def _small_kv(seed=3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 12, 200).astype(np.uint64)
    keys[:5] |= np.uint64(1 << 63)
    return keys, rng.integers(0, 1 << 40, 200).astype(np.uint64)


def test_clone_matches_jax():
    """clone: each pair its own group; a count over it gives 1 a pair."""
    j, t = _both(*_small_kv())
    j.aggregate()            # onto the device, as the port's frame is
    assert t.clone() == j.clone() == 200
    # a device KMV counts its padded tensors: 256-row caps on both sides
    assert t.kmv_stats() == j.kmv_stats() == (200, 200, 256 * 24)
    assert t.reduce(_count, batch=True) == j.reduce(_count, batch=True)
    assert _pairs(t) == _pairs(j)


def test_compress_matches_jax():
    j, t = _both(*_small_kv())
    assert t.compress(_count, batch=True) == j.compress(_count, batch=True)
    assert _pairs(t) == _pairs(j)
    assert len(_pairs(t)) == len(np.unique(_small_kv()[0]))


@pytest.mark.parametrize("addflag", [0, 1])
def test_open_close_match_jax(addflag):
    """Another MR's reduce adds into the open MR through ptr; close
    returns the pair count; with addflag the earlier pairs stay."""
    keys, values = _small_kv(4)
    got = []
    for j_side in (True, False):
        src_j, src_t = _both(keys, values)
        dst_j, dst_t = _both(keys[:7], values[:7])
        src, dst = (src_j, dst_j) if j_side else (src_t, dst_t)
        dst.open(addflag)
        src.collate()

        def into(fr, kv, ptr):
            _count(fr, ptr.kv, None)

        src.reduce(into, ptr=dst, batch=True)
        got.append((dst.close(), _pairs(dst)))
    assert got[0] == got[1]
    assert got[0][0] == len(np.unique(keys)) + 7 * addflag


@pytest.mark.parametrize("op", ["clone", "compress", "close"])
def test_errors_match_jax(op):
    args = {"compress": (_count,)}.get(op, ())
    msgs = []
    for mr in (JMapReduce(make_mesh(1)), MapReduce(device="cpu")):
        with pytest.raises(Exception) as err:
            getattr(mr, op)(*args)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(MRError):
        getattr(MapReduce(device="cpu"), op)(*args)


def test_one_frame_moves_host_frames_to_the_device():
    """A host frame added to a device-resident KV joins it on the device
    (a host row into the device state, as the composed sssp's source
    row): no device frame is pulled to the host."""
    rng = np.random.default_rng(8)
    k, v = rng.integers(0, 9, (40, 2)).astype(np.uint64), rng.random(40)
    mr = MapReduce(device="cpu")
    dev = shard_frame(KVFrame(k[:30], v[:30]), mr.device)
    mr.map(1, lambda i, kv, p: kv.add_frame(dev))
    mr.map(1, lambda i, kv, p: kv.add_batch(k[30:], v[30:]), addflag=1)
    pulled = []
    orig = ShardedKV.to_host
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ShardedKV, "to_host",
                   lambda self: pulled.append(self) or orig(self))
        fr = mr.kv.one_frame()
    assert isinstance(fr, ShardedKV) and not pulled
    host = fr.to_host()
    assert np.array_equal(host.key.data, k) and np.array_equal(
        host.value.data, v)


# ---------------------------------------------------------------------------
# host reads of the round loops
# ---------------------------------------------------------------------------

def _loop_graph(name, n):
    """A graph whose round count grows with ``n``: a path 0-1-..-(n-1)
    for cc, both ways for sssp; for luby (a path takes it one round) a
    seeded random graph of 4n edges."""
    if name == "luby_find":
        e = np.random.default_rng(n).integers(0, n, (4 * n, 2))
        return e.astype(np.uint64), np.zeros(4 * n, np.uint8)
    v = np.arange(n, dtype=np.uint64)
    e = np.stack([v[:-1], v[1:]], 1)
    if name == "sssp":
        e = np.concatenate([e, e[:, ::-1]])
        return e, np.ones(len(e))
    return e, np.zeros(len(e), np.uint8)


@pytest.mark.parametrize("name, args, sizes", [
    ("cc_find", ["0"], (8, 32)), ("luby_find", ["3"], (8, 512)),
    ("sssp", ["1", "1"], (8, 32))])
def test_round_loops_pull_no_frame_to_the_host(monkeypatch, name, args,
                                               sizes):
    """Count every to_host of a device frame during a composed command
    whose output goes to a named MR: none, at two sizes that take
    different numbers of rounds."""
    monkeypatch.setenv(ENGINES[name], "composed")
    pulls, rounds = [], []
    for cls in (ShardedKV, ShardedKMV):
        orig = cls.to_host
        monkeypatch.setattr(cls, "to_host", lambda self, orig=orig: (
            pulls.append(self), orig(self))[1])
    for n in sizes:
        del pulls[:]
        obj = ObjectManager(device="cpu")
        obj.name_mr("g", mapreduce_from_numpy(*_loop_graph(name, n),
                                              device="cpu"))
        cmd = t_run(name, args, obj=obj, inputs=["g"],
                    outputs=[(None, "out")], screen=False)
        rounds.append(list(cmd.niters.values()) if name == "sssp"
                      else cmd.niterate)
        assert not pulls, f"{len(pulls)} frames pulled at n={n}"
    assert rounds[0] != rounds[1]
    monkeypatch.undo()
    assert mapreduce_to_numpy(obj.named["out"])[0].shape[0] > 0
