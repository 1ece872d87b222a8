"""The four composed graph engines (cc_find, luby_find, tri_find, sssp
over MapReduce ops and the device bodies of ``parallel/devkernels.py``)
on a mesh of P = 3 against the JAX package's composed engines on
``make_mesh(3)``: one script through each package's ``OinkScript``, in
its own directory (module-scoped: the JAX engines take ≈ 60 s here).

Each engine's result lines, its files (one a shard for its mesh output;
sssp one a source), byte for byte, and its named MR shard by shard must
be equal; so must every device body's output frame, call by call, in
``(cap, counts)``: a KV body's cap is its rows per input row times the
input cap, a KMV body's its static output length (the gcap or the vcap),
as the JAX ``skv_map``/``skmv_map`` shapes are.  The JAX exchange's
speculative caps (a previous exchange's larger ``cap_out`` kept while it
still fits: another cap, the same rows) and its wire codec are off; the
port has neither.  Last, the composed engines against the port's fused
ones at P = 3."""

import collections

import numpy as np
import pytest

import gpu_mapreduce_tpu.oink.commands as jcommands
import gpu_mapreduce_tpu_torch.oink.commands as tcommands
from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu_torch import OinkScript
from gpu_mapreduce_tpu_torch.parallel.sharded import MeshKV

from test_torch_mesh_oink import NoSpeculation, _drive, _files
from test_torch_parallel import same_kv, tmesh

P = 3
ENGINES = {"cc_find": ("GPUMR_CC_ENGINE", "cc"),
           "luby_find": ("GPUMR_LUBY_ENGINE", "luby"),
           "tri_find": ("GPUMR_TRI_ENGINE", "tri"),
           "sssp": ("GPUMR_SSSP_ENGINE", "sssp")}
SCRIPT = [("rmat", "rmat 7 4 0.57 0.19 0.19 0.05 0.0 12345 -o NULL mre"),
          ("edge_upper", "edge_upper -i mre -o NULL mru"),
          ("cc_find", "cc_find 0 -i mru -o tmp.cc mrc"),
          ("luby_find", "luby_find 6789 -i mru -o tmp.luby mrl"),
          ("tri_find", "tri_find -i mru -o tmp.tri mrt"),
          ("add_weight", "mre map/mr mre add_weight"),
          ("sssp", "sssp 2 12345 -i mre -o tmp.sssp mrs")]
NAMED = {"cc_find": "mrc", "luby_find": "mrl", "tri_find": "mrt",
         "sssp": "mrs"}


def _recording(mp, package, log):
    """Wrap ``skv_map``/``skmv_map`` in the engines' command modules:
    each call appends (engine, body, cap, counts) of its output frame."""
    for engine, (_, module) in ENGINES.items():
        mod = getattr(package, module)
        for name in ("skv_map", "skmv_map"):
            fn = getattr(mod, name)

            def wrapped(fr, body, *args, _fn=fn, _engine=engine, **kw):
                out = _fn(fr, body, *args, **kw)
                log.append((_engine, body.__name__, int(out.cap),
                            [int(c) for c in np.asarray(out.counts)]))
                return out
            mp.setattr(mod, name, wrapped)


def _run(d, interp, lines):
    return _drive(d, interp, lines), _files(d)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_composed")
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshuffle, "_SPEC_CACHE", NoSpeculation())
        mp.setenv("MRTPU_WIRE", "0")
        for env, _ in ENGINES.values():
            mp.setenv(env, "composed")
        for side, package in (("jax", jcommands), ("port", tcommands)):
            log = []
            _recording(mp, package, log)
            d = root / side
            d.mkdir()
            s = JOinkScript(comm=j_make_mesh(P), screen=False) \
                if side == "jax" else OinkScript(comm=tmesh(P), screen=False)
            msgs, files = _run(d, s, SCRIPT)
            got[side] = {"msgs": msgs, "files": files, "obj": s.obj,
                         "bodies": log}
        for env, _ in ENGINES.values():
            mp.setenv(env, "fused")
        d = root / "fused"
        d.mkdir()
        s = OinkScript(comm=tmesh(P), screen=False)
        msgs, files = _run(d, s, SCRIPT)
        got["fused"] = {"msgs": msgs, "files": files, "obj": s.obj}
    return got


def _stem(command):
    line = dict(SCRIPT)[command].split()
    return line[line.index("-o") + 1]


@pytest.mark.parametrize("command", sorted(ENGINES))
def test_composed_engine_matches_jax_on_a_mesh(runs, command):
    jax, port = runs["jax"], runs["port"]
    assert port["msgs"][command] == jax["msgs"][command]
    stem = _stem(command)
    names = sorted(n for n in jax["files"] if n.startswith(stem))
    assert names == sorted(n for n in port["files"] if n.startswith(stem))
    if command == "sssp":
        assert names == [f"{stem}.0", f"{stem}.1"]    # one a source
    elif command != "luby_find":    # luby's MR holds a frame a round: one
        assert names == [f"{stem}.{p}" for p in range(P)]
    for n in names:
        assert port["files"][n] == jax["files"][n], n
    jmr, tmr = jax["obj"].named[NAMED[command]], \
        port["obj"].named[NAMED[command]]
    if command == "luby_find":
        # one frame a round (open/close): the frames joined shard by shard
        jfr, tfr = jmr.kv.one_frame(), tmr.kv.one_frame()
        assert tmr.kv.nframes > 1 and isinstance(tfr, MeshKV)
        assert (tfr.cap, tfr.counts.tolist()) == \
            (jfr.cap, jfr.counts.tolist())
        for p in range(P):
            a, b = jfr.shard_to_host(p), tfr.shard_to_host(p)
            assert b.key.data.tolist() == a.key.data.tolist()
            assert b.value.data.tolist() == a.value.data.tolist()
    else:
        assert isinstance(next(iter(tmr.kv.frames())), MeshKV)
        same_kv(jmr, tmr)


@pytest.mark.parametrize("command", sorted(ENGINES))
def test_composed_bodies_match_jax_caps(runs, command):
    """Every device body's output frame, call by call, has the JAX
    frame's ``(cap, counts)``."""
    def by_body(log):
        out = collections.defaultdict(list)
        for engine, body, cap, counts in log:
            if engine == command:
                out[body].append((cap, counts))
        return dict(out)
    jb, tb = by_body(runs["jax"]["bodies"]), by_body(runs["port"]["bodies"])
    assert tb and sorted(tb) == sorted(jb)
    for body in jb:
        assert tb[body] == jb[body], body


def _lines(files, stem):
    return sorted(ln for n, data in files.items() if n.startswith(stem)
                  for ln in data.decode().splitlines())


def test_composed_equals_fused_on_a_mesh(runs):
    """The port's composed engines against its fused ones at P = 3: cc's
    (v, zone) lines, tri's triangles (each row's ids sorted), sssp's
    lines; luby's two sets are both maximal independent sets of the
    upper edges (their winner rules differ)."""
    comp, fused = runs["port"], runs["fused"]
    for stem in ("tmp.cc", "tmp.sssp"):
        assert _lines(comp["files"], stem) == _lines(fused["files"], stem)

    def tris(files):
        return sorted(tuple(sorted(int(w) for w in ln.split()))
                      for ln in _lines(files, "tmp.tri"))
    assert tris(comp["files"]) == tris(fused["files"])
    upper = comp["obj"].named["mru"].kv.one_frame().to_host().key.data
    for files in (comp["files"], fused["files"]):
        mis = {int(ln) for ln in _lines(files, "tmp.luby")}
        inside = np.isin(upper, np.array(sorted(mis), np.uint64))
        assert not np.any(inside[:, 0] & inside[:, 1])        # independent
        covered = set(mis)
        for a, b in upper.tolist():
            if a in mis:
                covered.add(b)
            if b in mis:
                covered.add(a)
        assert covered == set(upper.reshape(-1).tolist())     # maximal
