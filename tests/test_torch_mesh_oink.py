"""The OINK commands on a mesh of P = 3 against the JAX package's
``make_mesh(3)``: one script through the JAX ``OinkScript`` and one
through the port's ``OinkScript(comm=make_mesh(3, devices=["cpu"] * 3))``,
each in its own directory (module-scoped: the JAX run takes ≈ 30 s).

Every registered command runs once; each case compares one command's
result lines, the files it wrote (one a shard for a mesh dataset, one
for a host or one-device dataset), byte for byte, and its named MRs
shard by shard (``same_kv``/``same_kmv`` of ``test_torch_parallel.py``;
a JAX host frame against the port's one-device frame row by row).
PageRank's ranks compare within rtol 1e-5 and its step count within one
(float32 sums in another order).  The JAX exchange's speculative caps
(a previous exchange's larger ``cap_out`` kept when it still fits) and
its wire codec are off: the port has neither, and both give the same
rows.

Also here: the JAX ``degree_weight`` fails on a mesh (its body reads
host frames), so the port's P = 3 run is held against the JAX serial
interpreter; vertex id 2^64-1 at P = 3 (the JAX mesh staging refuses it,
the port equals the JAX serial interpreter); R-MAT's shard layout at a
second size; ``invertedindex`` at P = 1 and 3; the mesh staging and the
fused models' reductions across shards against the JAX ``shard_map``
models; and ``parallel/collectives.allreduce``."""

import io
import os

import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu.models import cc as jcc
from gpu_mapreduce_tpu.models import pagerank as jpr
from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.parallel.staging import stage_graph as j_stage
from gpu_mapreduce_tpu_torch import OinkScript
from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
from gpu_mapreduce_tpu_torch.models import cc as tcc
from gpu_mapreduce_tpu_torch.models import luby as tluby
from gpu_mapreduce_tpu_torch.models import pagerank as tpr
from gpu_mapreduce_tpu_torch.models import sssp as tsssp
from gpu_mapreduce_tpu_torch.oink.command import COMMANDS
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.parallel.collectives import (allreduce,
                                                          per_device,
                                                          replicate)
from gpu_mapreduce_tpu_torch.parallel.sharded import MeshKV
from gpu_mapreduce_tpu_torch.parallel.staging import stage_graph

from test_torch_parallel import jkv, same_kmv, same_kv, tkv, tmesh

P = 3

# (label, line, named MRs it makes): every registered command once
SCRIPT = [
    ("rmat", "rmat 7 4 0.57 0.19 0.19 0.05 0.0 12345 -o tmp.rmat mre",
     ["mre"]),
    ("rmat2", "rmat2 6 4 0.45 0.15 0.15 0.25 0.2 777 -o tmp.rmat2 mre2",
     ["mre2"]),
    ("degree", "degree 0 -i mre -o tmp.deg mrd", ["mrd"]),
    ("degree_stats", "degree_stats 1 -i mre", []),
    ("edge_upper", "edge_upper -i mre -o tmp.upper mru", ["mru"]),
    ("vertex_extract", "vertex_extract -i mre -o tmp.vx mrvx", ["mrvx"]),
    ("neighbor", "neighbor -i mru -o tmp.nb mrn", ["mrn"]),
    ("pagerank", "pagerank 1e-8 100 0.85 -i mre -o tmp.pr mrpr", ["mrpr"]),
    ("cc_find", "cc_find 0 -i mru -o tmp.cc mrc", ["mrc"]),
    ("cc_stats", "cc_stats -i mrc", []),
    ("mr", "mr mrv", []),
    ("map", "mrv map/mr mre edge_to_vertices", []),
    ("histo", "histo -i mrv -o tmp.histo NULL", []),
    ("luby_find", "luby_find 6789 -i mru -o tmp.luby mrl", ["mrl"]),
    ("tri_find", "tri_find -i mru -o tmp.tri mrt", ["mrt"]),
    # neighbor's output is a file a shard, as in the JAX package: the
    # glob reads them all back
    ("neigh_tri", "neigh_tri tmp.nt -i tmp.nb.* tmp.tri", []),
    ("add_weight", "mre map/mr mre add_weight", ["mre"]),
    ("sssp", "sssp 2 12345 -i mre -o tmp.sssp mrs", ["mrs"]),
    ("files", "variable files index w1.txt w2.txt", []),
    ("wordfreq", "wordfreq 5 -i v_files -o tmp.wf mrwf", ["mrwf"]),
    ("docs", "variable docs index docs", []),
    ("invertedindex", "invertedindex -i v_docs -o tmp.ii NULL", []),
]
DEGREE_WEIGHT = "degree_weight -i tmp.upper.* tmp.deg.* -o tmp.dw NULL"


def _inputs(d):
    """Two word files and a small HTML corpus, from seeds."""
    rng = np.random.default_rng(3)
    vocab = [f"w{i}" for i in range(300)]
    p = 1.0 / np.arange(1, 301)
    for name in ("w1.txt", "w2.txt"):
        (d / name).write_text(" ".join(rng.choice(vocab, 3000,
                                                  p=p / p.sum())))
    (d / "docs").mkdir()
    make_corpus(str(d / "docs"), 1, nfiles=6, skew=True)


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            path = os.path.join(root, n)
            rel = os.path.relpath(path, d)
            if rel.startswith("tmp."):
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def _drive(d, interp, lines):
    """``lines`` through ``interp`` from ``d``: {label: result lines, or
    the exception a line raised}."""
    cwd = os.getcwd()
    os.chdir(d)
    out = {}
    try:
        for label, line in lines:
            interp.screen = buf = io.StringIO()
            try:
                interp.one(line)
            except Exception as e:          # held against the other side
                out[label] = e
                continue
            out[label] = buf.getvalue().splitlines()
    finally:
        os.chdir(cwd)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_oink")
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshuffle, "_SPEC_CACHE", {})
        mp.setattr(tshuffle, "_SPEC_CACHE", {})
        mp.setenv("MRTPU_WIRE", "0")
        for side in ("jax", "port"):
            d = root / side
            d.mkdir()
            _inputs(d)
            s = JOinkScript(comm=j_make_mesh(P), screen=False) \
                if side == "jax" else OinkScript(comm=tmesh(P), screen=False)
            msgs = _drive(d, s, [(lb, ln) for lb, ln, _ in SCRIPT])
            msgs.update(_drive(d, s, [("degree_weight", DEGREE_WEIGHT)]))
            got[side] = {"msgs": msgs, "files": _files(d), "obj": s.obj,
                         "dir": d}
    # degree_weight against the serial JAX interpreter, on the same files
    d = root / "serial"
    d.mkdir()
    for name, data in got["port"]["files"].items():
        if name.startswith(("tmp.upper", "tmp.deg")):
            (d / name).write_bytes(data)
    s = JOinkScript(screen=False)
    got["serial"] = {"msgs": _drive(d, s, [("degree_weight",
                                            DEGREE_WEIGHT)]),
                     "files": _files(d)}
    return got


def _command_lines(command):
    return [lb for lb, ln, _ in SCRIPT if ln.split()[0] == command]


def _pagerank_rows(data: bytes):
    rows = [ln.split() for ln in data.decode().splitlines()]
    return [int(v) for v, _ in rows], np.array([float(r) for _, r in rows])


def same_files(jfiles, tfiles, prefix):
    names = sorted(n for n in jfiles if n.split("/")[0].split(".")[1]
                   == prefix)
    assert names == sorted(n for n in tfiles
                           if n.split("/")[0].split(".")[1] == prefix)
    for n in names:
        if prefix == "pr":
            jv, jr = _pagerank_rows(jfiles[n])
            tv, tr = _pagerank_rows(tfiles[n])
            assert tv == jv
            np.testing.assert_allclose(tr, jr, rtol=1e-5)
        else:
            assert tfiles[n] == jfiles[n], n
    return names


def same_named(jmr, tmr, rtol=None):
    """Two named MRs equal: shard by shard where the JAX one is a mesh
    frame; row by row where it is a host frame (the port keeps the same
    rows in one frame on the first shard's device)."""
    if jmr.kmv is not None:
        same_kmv(jmr, tmr)
        return
    if hasattr(jmr.kv.one_frame(), "nprocs") and rtol is None:
        same_kv(jmr, tmr)
        return
    _, jn, jb = jkv(jmr)
    _, tn, tb = tkv(tmr)
    assert sum(tn) == sum(jn)
    for c in (0, 1):
        a = np.concatenate([b[c] for b in jb])
        b = np.concatenate([b[c] for b in tb])
        assert a.dtype == b.dtype
        if rtol is None:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol)


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_oink_commands_run_on_a_mesh(runs, command):
    """Every registered command at P = 3 equals the JAX package's run:
    its result lines, its files (one a shard for a mesh dataset), its
    named MRs shard by shard."""
    jax, port = runs["jax"], runs["port"]
    if command == "degree_weight":
        # the JAX mesh path fails inside its body; the serial interpreter
        # is the reference
        assert isinstance(jax["msgs"]["degree_weight"], AttributeError)
        jax = runs["serial"]
    labels = _command_lines(command) or [command]
    for label in labels:
        tm, jm = port["msgs"][label], jax["msgs"][label]
        assert not isinstance(tm, Exception), tm
        if command == "pagerank":
            (tw, jw) = (m[0].split() for m in (tm, jm))
            assert tw[:-2] == jw[:-2] and abs(int(tw[-2]) - int(jw[-2])) <= 1
        else:
            assert tm == jm
    line = {lb: ln for lb, ln, _ in SCRIPT}.get(labels[0], DEGREE_WEIGHT)
    words = line.split()
    if command == "degree_weight":
        # the serial interpreter's rows, in another order than P = 3's
        assert sorted(port["files"]["tmp.dw"].splitlines()) == \
            sorted(jax["files"]["tmp.dw"].splitlines())
    elif "-o" in words:
        path = words[words.index("-o") + 1]
        if path != "NULL":
            assert same_files(jax["files"], port["files"],
                              path.split(".")[1])
    if command == "neigh_tri":
        assert same_files(jax["files"], port["files"], "nt")
    for _, ln, names in SCRIPT:
        if ln.split()[0] == command:
            for name in names:
                same_named(jax["obj"].named[name], port["obj"].named[name],
                           rtol=1e-5 if command == "pagerank" else None)


def test_files_a_shard_follow_the_jax_layout(runs):
    """Mesh datasets write ``path.<p>``; host and one-device datasets the
    exact path; sssp one file a source; invertedindex a part a shard."""
    files = runs["port"]["files"]
    for stem in ("rmat", "rmat2", "deg", "upper", "vx", "nb", "wf",
                 "histo"):
        assert f"tmp.{stem}" not in files
        assert sorted(n for n in files if n.startswith(f"tmp.{stem}.")) \
            == [f"tmp.{stem}.{p}" for p in range(P)], stem
    for single in ("tmp.pr", "tmp.cc", "tmp.luby", "tmp.tri", "tmp.dw"):
        assert single in files
    assert sorted(n for n in files if n.startswith("tmp.sssp")) == \
        ["tmp.sssp.0", "tmp.sssp.1"]
    assert sorted(n for n in files if n.startswith("tmp.ii/")) == \
        [f"tmp.ii/part-{p:05d}" for p in range(P)]


def test_output_percent_names_the_shard(tmp_path):
    """A ``%`` in an ``-o`` path given to the object manager takes the
    shard id (its first ``%`` only), as in the JAX package.  (A script's
    ``-o`` path has every ``%`` replaced by 0 before, in both.)"""
    from gpu_mapreduce_tpu.oink.command import run_command as j_run
    from gpu_mapreduce_tpu.oink.objects import ObjectManager as JObjects
    from gpu_mapreduce_tpu_torch.oink.command import run_command
    from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
    args = ["5", "2", "0.25", "0.25", "0.25", "0.25", "0.0", "3"]
    got = {}
    for side, obj, run in (("jax", JObjects(comm=j_make_mesh(P)), j_run),
                           ("port", ObjectManager(comm=tmesh(P)),
                            run_command)):
        d = tmp_path / side
        d.mkdir()
        run("rmat", args, obj=obj, outputs=[(str(d / "e%.x%"), None)],
            screen=False)
        got[side] = {f.name: f.read_bytes() for f in d.iterdir()}
    assert sorted(got["port"]) == [f"e{p}.x%" for p in range(P)]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("scale", [7, 9])
def test_rmat_layout_matches_jax_at_two_sizes(runs, scale):
    """rmat hands the port's collate a device batch and JAX's a host one;
    the shard layout after the cull equals JAX's at two sizes."""
    if scale == 7:
        jmr, tmr = runs["jax"]["obj"].named["mre2"], \
            runs["port"]["obj"].named["mre2"]
    else:
        line = f"rmat {scale} 4 0.57 0.19 0.19 0.05 0.0 99 -o NULL x"
        pulls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jshuffle, "_SPEC_CACHE", {})
            mp.setattr(tshuffle, "_SPEC_CACHE", {})
            j = JOinkScript(comm=j_make_mesh(P), screen=False)
            t = OinkScript(comm=tmesh(P), screen=False)
            j.one(line)
            pull = MeshKV.to_host
            mp.setattr(MeshKV, "to_host",
                       lambda fr: pulls.append(fr) or pull(fr))
            t.one(line)
        # each round's batch joins the rounds before on the device
        assert not pulls
        jmr, tmr = j.obj.named["x"], t.obj.named["x"]
    assert isinstance(next(iter(tmr.kv.frames())), MeshKV)
    same_kv(jmr, tmr)


def _big_id_edges():
    ids = [1, 2, 3, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 2, 2**64 - 1]
    rng = np.random.default_rng(64)
    pairs = [(a, b) for a in range(8) for b in range(8)
             if a != b and rng.random() < 0.6] + [(0, 0), (4, 4)]
    return "".join(f"{ids[a]} {ids[b]}\n" for a, b in pairs)


BIG_IDS = [("cc", "cc_find 0 -i tmp.edges -o tmp.cc NULL"),
           ("pr", "pagerank 1e-6 50 0.85 -i tmp.edges -o tmp.pr NULL"),
           ("luby", "luby_find 7 -i tmp.edges -o tmp.luby NULL"),
           ("tri", "tri_find -i tmp.edges -o tmp.tri NULL"),
           ("w", "mr w"), ("read", "w map/file tmp.edges read_edge"),
           ("wt", "w map/mr w add_weight"),
           ("sssp", "sssp 3 5 -i w -o tmp.sssp NULL")]


def test_big_ids_at_p3_match_serial_jax(tmp_path):
    """Vertex id 2^64-1 stays an ordinary id at P = 3: the port equals
    the JAX serial interpreter file for file, while the JAX mesh staging
    refuses the id as its padding sentinel."""
    got = {}
    for side in ("serial", "port"):
        d = tmp_path / side
        d.mkdir()
        (d / "tmp.edges").write_text(_big_id_edges())
        s = JOinkScript(screen=False) if side == "serial" \
            else OinkScript(comm=tmesh(P), screen=False)
        got[side] = (_drive(d, s, BIG_IDS), _files(d))
    (tmsgs, tfiles), (jmsgs, jfiles) = got["port"], got["serial"]
    for label, _ in BIG_IDS:
        if label == "pr":
            assert tmsgs[label][0].split()[:-2] == \
                jmsgs[label][0].split()[:-2]
            same_files(jfiles, tfiles, "pr")
        else:
            assert tmsgs[label] == jmsgs[label], label
    assert sorted(tfiles) == sorted(jfiles)
    for name in tfiles:
        if name != "tmp.pr":
            assert tfiles[name] == jfiles[name], name
    assert str(2**64 - 1).encode() in tfiles["tmp.cc"]
    d = tmp_path / "mesh"
    d.mkdir()
    (d / "tmp.edges").write_text(_big_id_edges())
    refused = _drive(d, JOinkScript(comm=j_make_mesh(P), screen=False),
                     BIG_IDS[:1])["cc"]
    assert isinstance(refused, ValueError) and "sentinel" in str(refused)


@pytest.mark.parametrize("nprocs", [1, 3])
def test_invertedindex_command_matches_jax(tmp_path, nprocs):
    """``invertedindex -i v_docs -o dir``: the message and every
    ``part-<shard>`` file equal the JAX command's."""
    got = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        (d / "docs").mkdir()
        make_corpus(str(d / "docs"), 1, nfiles=4, skew=True)
        if side == "jax":
            s = JOinkScript(comm=j_make_mesh(nprocs), screen=False)
        elif nprocs == 1:
            s = OinkScript(device="cpu", screen=False)
        else:
            s = OinkScript(comm=tmesh(nprocs), screen=False)
        got[side] = (_drive(d, s, [("v", "variable docs index docs"),
                                   ("ii", "invertedindex -i v_docs "
                                          "-o tmp.ii NULL")]), _files(d))
    (tmsgs, tfiles), (jmsgs, jfiles) = got["port"], got["jax"]
    assert tmsgs == jmsgs and tmsgs["ii"][0].startswith("InvertedIndex: 4")
    assert tfiles == jfiles
    assert sorted(tfiles) == [f"tmp.ii/part-{p:05d}"
                              for p in range(nprocs)]


def _jax_mr(e, v):
    from gpu_mapreduce_tpu import MapReduce as JMapReduce
    mr = JMapReduce(j_make_mesh(P))
    mr.map(1, lambda i, kv, p: kv.add_batch(e, v))
    return mr


def _port_mr(e, v):
    from gpu_mapreduce_tpu_torch import MapReduce
    mr = MapReduce(comm=tmesh(P))
    mr.map(1, lambda i, kv, p: kv.add_batch(e, v))
    return mr


def _edges(seed, n=300, nv=60):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, nv, (n, 2)).astype(np.uint64)
    e[rng.integers(0, n, 20)] |= np.uint64(1 << 63)
    return e, rng.integers(1, 9, n).astype(np.uint64)


@pytest.mark.parametrize("drop_self", [False, True])
def test_mesh_staging_matches_jax(drop_self):
    """The vertex table and each shard's ranked edges equal the JAX mesh
    staging's (its valid rows of shard p, in order); the weights too."""
    e, w = _edges(5)
    e[:7, 1] = e[:7, 0]                                  # self-loops
    jsg = j_stage(_jax_mr(e, w), j_make_mesh(P), drop_self=drop_self,
                  need_weights=True)
    tsg = stage_graph(_port_mr(e, w), drop_self=drop_self,
                      need_weights=True)
    assert tsg.n == jsg.n
    assert np.array_equal(tsg.verts.numpy().view(np.uint64), jsg.verts)
    assert len(tsg.shards) == P
    rows = len(np.asarray(jsg.src)) // P
    for p, s in enumerate(tsg.shards):
        valid = np.asarray(jsg.valid)[p * rows:(p + 1) * rows]
        for mine, theirs in ((s.src, jsg.src), (s.dst, jsg.dst)):
            ref = np.asarray(theirs)[p * rows:(p + 1) * rows][valid]
            assert np.array_equal(mine.numpy(), ref)
        ref = np.asarray(jsg.weights)[p * rows:(p + 1) * rows][valid]
        assert np.array_equal(s.weights.numpy(), ref.astype(np.float64))
    assert torch.equal(tsg.src, torch.cat([s.src for s in tsg.shards]))


def _blocks(src, dst, nprocs):
    """The JAX ``pad_edges_for_mesh`` split: P contiguous blocks of
    ceil(m / P) rows."""
    per = -(-len(src) // nprocs)
    return [(torch.from_numpy(src[i:i + per].astype(np.int64)),
             torch.from_numpy(dst[i:i + per].astype(np.int64)))
            for i in range(0, per * nprocs, per)]


@pytest.mark.parametrize("seed", [1, 2])
def test_sharded_models_match_jax(seed):
    """cc's per-shard rounds then min across shards give the JAX
    ``cc_sharded``'s labels and round count on the same split; PageRank
    summed across shards is within rtol 1e-5 of the JAX
    ``pagerank_sharded``, its steps within one; luby and sssp over the
    shards equal one device's."""
    rng = np.random.default_rng(seed)
    n = 200
    src = rng.integers(0, n, 500).astype(np.int32)
    dst = np.where(rng.random(500) < 0.5, src + 1, rng.integers(0, n, 500))
    dst = np.minimum(dst, n - 1).astype(np.int32)
    shards = _blocks(src, dst, P)
    jlab, jit = jcc.cc_sharded(j_make_mesh(P), src, dst, n)
    tlab, tit = tcc.cc_sharded(shards, n)
    assert tit == jit and np.array_equal(tlab.numpy(), jlab)
    jr, jit = jpr.pagerank_sharded(j_make_mesh(P), src, dst, n, tol=1e-7,
                                   maxiter=60)
    tr, tit = tpr.pagerank_sharded(shards, n, tol=1e-7, maxiter=60)
    assert abs(tit - jit) <= 1
    np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-5, atol=1e-9)
    s64, d64 = (torch.from_numpy(x.astype(np.int64)) for x in (src, dst))
    prio = torch.from_numpy(rng.random(n))
    loop = s64 != d64                       # self-loops never block a MIS
    one = tluby.luby_mis(s64[loop], d64[loop], prio, n)
    many = tluby.luby_mis_sharded([(s[s != d], d[s != d])
                                   for s, d in shards], prio, n)
    assert many[1] == one[1] > 1 and torch.equal(many[0], one[0])
    w = torch.from_numpy(rng.integers(1, 5, 500).astype(np.float64))
    per = -(-500 // P)
    wshards = [(s, d, w[i * per:(i + 1) * per])
               for i, (s, d) in enumerate(shards)]
    d1, p1, i1 = tsssp.bellman_ford(s64, d64, w, n, 3)
    dn, pn, i_n = tsssp.bellman_ford_sharded(wshards, n, 3)
    assert i_n == i1 and torch.equal(dn, d1) and torch.equal(pn, p1)


def test_allreduce_and_replicas():
    """sum, min and max in shard order; the shards of one device share
    one result; one shard returns its own tensor."""
    parts = [torch.tensor([1.0, 5.0, -2.0]), torch.tensor([4.0, 0.5, 7.0]),
             torch.tensor([2.0, 3.0, 1.0])]
    want = {"sum": [7.0, 8.5, 6.0], "min": [1.0, 0.5, -2.0],
            "max": [4.0, 5.0, 7.0]}
    for op, ref in want.items():
        out = allreduce(parts, op)
        assert len(out) == 3 and out[0] is out[1] is out[2]
        assert out[0].tolist() == ref
    assert parts[0].tolist() == [1.0, 5.0, -2.0]          # inputs kept
    assert allreduce(parts[:1], "sum")[0] is parts[0]
    # float32 sums in shard order, bit for bit
    a = [torch.tensor([0.1], dtype=torch.float32),
         torch.tensor([1e8], dtype=torch.float32),
         torch.tensor([-1e8], dtype=torch.float32)]
    assert allreduce(a, "sum")[0].item() == ((a[0] + a[1]) + a[2]).item()
    reps = replicate(torch.arange(4), [torch.device("cpu")] * 3)
    assert reps[0] is reps[1] is reps[2]
    calls = []
    out = per_device(lambda x, y: calls.append(1) or x + y, reps, reps)
    assert len(calls) == 1 and out[0] is out[2]
    assert out[0].tolist() == [0, 2, 4, 6]
