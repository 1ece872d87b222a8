"""OINK scripts through the port's ``OinkScript(device="cpu")`` and the
JAX package's ``OinkScript(comm=make_mesh(1))`` (for the script with
``degree_weight``, whose JAX body reads host frames only, the JAX
package's serial ``OinkScript()``), each in its own directory: the
printed result lines must be equal (lines that print the ``time``
variable are not compared), the output files byte-identical,
except PageRank's, whose vertex column must be equal and ranks within
rtol 1e-5 (float32 sums in another order)."""

import io
import os

import numpy as np
import pytest

from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch import MRError, OinkScript

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONTROL = """\
variable t equal time
variable n index 5 6
variable a loop 3
label again
variable e equal 2^v_a+1
print "n=$n a=$a e=$e"
if "$a == 2" then "print two" elif "$a > 2" "print big" else "print small"
rmat $n 2 0.25 0.25 0.25 0.25 0.0 $a -o tmp.r$a mre
degree_stats 0 -i mre
print "took $t"
next a
jump SELF again
print "after the loop, n=$n"
include tmp.inc
"""

INCLUDED = """\
variable w string included
print "from the $w file"
"""

GRAPH = """\
rmat2 8 4 0.45 0.15 0.15 0.25 0.2 777 -o tmp.edges mre
degree 0 -i tmp.edges -o tmp.deg NULL
degree_stats 1 -i mre
edge_upper -i tmp.edges -o tmp.upper NULL
neighbor -i tmp.upper -o tmp.nb NULL
degree_weight -i tmp.edges tmp.deg -o tmp.dw NULL
vertex_extract -i tmp.dw -o tmp.vx NULL
cc_find 0 -i tmp.upper -o tmp.cc2 NULL
cc_stats -i tmp.cc2
pagerank 1e-5 50 0.85 -i tmp.dw -o tmp.pr2 NULL
mr mrv
mrv map/mr mre edge_to_vertices
histo -i mrv -o tmp.histo NULL
tri_find -i tmp.upper -o tmp.tri NULL
neigh_tri tmp.nt -i tmp.nb tmp.tri
"""

# ids at the u64 edges (2^64-1 is the JAX mesh staging's padding
# sentinel, an ordinary id on one device and in the serial interpreter)
EDGE_IDS = [1, 2, 3, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 2, 2**64 - 1]

BIG_IDS = """\
cc_find 0 -i tmp.edges -o tmp.cc NULL
luby_find 7 -i tmp.edges -o tmp.luby NULL
tri_find -i tmp.edges -o tmp.tri NULL
mr w
w map/file tmp.edges read_edge
w map/mr w add_weight
sssp 3 5 -i w -o tmp.sssp NULL
"""


def _run(tmp_path, side, script, files=(), mesh=True):
    d = tmp_path / side
    d.mkdir()
    for name, text in files:
        (d / name).write_text(text)
    (d / "in.script").write_text(script)
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        s = OinkScript(device="cpu", screen=buf) if side == "port" \
            else JOinkScript(comm=make_mesh(1) if mesh else None,
                             screen=buf)
        s.run_file(str(d / "in.script"))
        s.close()
    finally:
        os.chdir(cwd)
    lines = [ln for ln in buf.getvalue().splitlines()
             if "secs" not in ln and "took" not in ln]
    outs = {p.name: ({f.name: f.read_bytes() for f in p.iterdir()}
                     if p.is_dir() else p.read_bytes())
            for p in d.iterdir() if p.name.startswith("tmp.")}
    return lines, outs


def _compare(tmp_path, script, files=(), ranks=(), mesh=True):
    port = _run(tmp_path, "port", script, files)
    ref = _run(tmp_path, "jax", script, files, mesh)
    assert port[0] == ref[0]
    assert sorted(port[1]) == sorted(ref[1])
    for name in port[1]:
        if name in ranks:
            a = np.loadtxt(io.BytesIO(port[1][name]), dtype=str)
            b = np.loadtxt(io.BytesIO(ref[1][name]), dtype=str)
            assert np.array_equal(a[:, 0], b[:, 0])
            np.testing.assert_allclose(a[:, 1].astype(float),
                                       b[:, 1].astype(float), rtol=1e-5)
        else:
            assert port[1][name] == ref[1][name], name
    return port


@pytest.mark.parametrize("example, ranks", [("in.rmat", ()),
                                            ("in.cc", ()),
                                            ("in.pagerank", ("tmp.pr",)),
                                            ("in.luby", ()), ("in.tri", ()),
                                            ("in.sssp", ())])
def test_example_scripts_match_jax(tmp_path, example, ranks):
    with open(os.path.join(ROOT, "examples", example)) as f:
        script = f.read()
    lines, outs = _compare(tmp_path, script, ranks=ranks)
    word = {"in.rmat": "DegreeStats:", "in.cc": "CCStats:",
            "in.pagerank": "PageRank:", "in.luby": "Luby_find:",
            "in.tri": "Tri_find:", "in.sssp": "SSSP:"}[example]
    assert any(ln.startswith(word) for ln in lines)
    if example == "in.cc":
        assert "tmp.cc" in outs and outs["tmp.cc"].count(b"\n") > 60000
    if example == "in.tri":
        assert outs["tmp.tri"].count(b"\n") == int(lines[-1].split()[1]) \
            > 100
    if example == "in.sssp":
        assert sorted(outs) == [f"tmp.sssp.{i}" for i in range(10)]


def test_control_flow_script_matches_jax(tmp_path):
    lines, outs = _compare(tmp_path, CONTROL,
                           files=[("tmp.inc", INCLUDED)])
    assert lines[0] == "n=5 a=1 e=3 " and "after the loop, n=5 " in lines
    assert "from the included file " in lines
    assert sorted(outs) == ["tmp.inc", "tmp.r1", "tmp.r2", "tmp.r3"]


def test_graph_commands_match_jax(tmp_path):
    lines, outs = _compare(tmp_path, GRAPH, ranks=("tmp.pr2",), mesh=False)
    for word in ("RMAT2:", "Degree:", "DegreeStats:", "EdgeUpper:",
                 "DegreeWeight:", "CC_find:", "CCStats:", "PageRank:",
                 "Histo:", "Tri_find:", "Neigh_tri:"):
        assert any(ln.startswith(word) for ln in lines), word
    nvert = int(next(ln for ln in lines if ln.startswith("Neigh_tri:"))
                .split()[1])
    assert len(outs["tmp.nt"]) == nvert > 100


def test_big_ids_match_serial_jax(tmp_path):
    """Ids near 2^63 and 2^64 (2^64-1 included), with duplicate rows and
    self-loops, through cc_find, luby_find, tri_find and sssp: the port
    on the CPU against the serial JAX interpreter (whose mesh staging
    refuses 2^64-1), byte for byte."""
    rng = np.random.default_rng(64)
    ids = np.array(EDGE_IDS, np.uint64)
    pairs = np.array([(a, b) for a in range(8) for b in range(8)
                      if a != b and rng.random() < 0.6] +
                     [(k, k) for k in (0, 4, 7)])      # self-loops
    pairs = np.concatenate([pairs, pairs[rng.integers(0, len(pairs), 9)]])
    pairs = pairs[rng.permutation(len(pairs))]
    text = "".join(f"{ids[a]} {ids[b]}\n" for a, b in pairs)
    lines, outs = _compare(tmp_path, BIG_IDS, files=[("tmp.edges", text)],
                           mesh=False)
    assert str(2**64 - 1).encode() in outs["tmp.cc"]
    assert outs["tmp.tri"] and outs["tmp.luby"] and outs["tmp.sssp.0"]
    assert any(ln.startswith("Luby_find:") for ln in lines)


@pytest.mark.parametrize("line", ["shell mkdir x", "resume somewhere"])
def test_unported_builtins_raise(line):
    s = OinkScript(device="cpu", screen=False)
    with pytest.raises(MRError, match="not ported yet"):
        s.one(line)


MR_LINES = """\
rmat 7 4 0.45 0.15 0.15 0.25 0.0 31 -o NULL mre
mr x
x map/mr mre edge_to_vertices
x collate NULL
x reduce count
x copy y
y sort_values -1
histo -i x -o tmp.h NULL
degree_stats 0 -i mre
"""


def test_mr_builtin_and_lines_match_jax(tmp_path):
    """The mr builtin and named-MR lines (map/mr, collate, reduce, copy,
    sort_values) against the JAX interpreter: equal lines and outputs,
    and the same pairs in x and y."""
    got = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            buf = io.StringIO()
            s = OinkScript(device="cpu", screen=buf) if side == "port" \
                else JOinkScript(comm=make_mesh(1), screen=buf)
            s.run_string(MR_LINES)
            pairs = {}
            for name in ("x", "y"):
                out = []
                s.obj.named[name].scan_kv(
                    lambda k, v, p: out.append((int(k), int(v))))
                pairs[name] = out
            got[side] = (buf.getvalue(), pairs, (d / "tmp.h").read_bytes())
        finally:
            os.chdir(cwd)
    assert got["port"] == got["jax"]
    x, y = got["port"][1]["x"], got["port"][1]["y"]
    assert sorted(x) == sorted(y) and len(x) > 50
    assert [v for _, v in y] == sorted((v for _, v in x), reverse=True)


def _mr_line_state(s):
    """What a named-MR line can change: each MR's settings and dataset,
    and the files it wrote."""
    out = {}
    for name in sorted(s.obj.named):
        mr = s.obj.named[name]
        data = None
        if mr.kv is not None:
            data = [(f.key.tolist(), f.value.tolist())
                    for f in (fr.to_host() for fr in mr.kv.frames())]
        elif mr.kmv is not None:
            data = [(f.key.tolist(), np.asarray(f.nvalues).tolist(),
                     f.values.tolist())
                    for f in (fr.to_host() for fr in mr.kmv.frames())]
        st = mr.settings
        out[name] = (data, st.verbosity, st.timer, st.memsize,
                     st.outofcore)
    if os.path.isdir("d"):
        import json
        with open("d/manifest.json") as f:
            man = json.load(f)
        for fm in man["frames"]:
            fm.pop("digest")
            fm.pop("shard_digests")
        out["d"] = (man, sorted(os.listdir("d")))
    return out


@pytest.mark.parametrize("line", ["x collapse int 7", "x save d",
                                  "x scrunch 1 int 7", "x broadcast 0",
                                  "x set timer 1", "mr z 0 1"])
def test_ported_mr_lines_match_jax(tmp_path, monkeypatch, line):
    """The lines the port refused before this slice, against the JAX
    interpreter: the same MRs, settings, datasets and files after."""
    keys = np.array([5, 1 << 63, 5, 2], np.uint64)
    vals = np.arange(4, dtype=np.uint64)
    got = {}
    for side, s in (("port", OinkScript(device="cpu", screen=False)),
                    ("jax", JOinkScript(screen=False))):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        s.one("mr x")
        s.obj.named["x"].map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        s.one(line)
        got[side] = _mr_line_state(s)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("line, match", [
    ("x reduce nosuch", "unknown reduce kernel 'nosuch'"),
    ("x frobnicate", "Unknown MR object method"),
    ("mr x", "already in use")])
def test_unported_mr_lines_raise(line, match):
    s = OinkScript(device="cpu", screen=False)
    s.one("mr x")
    with pytest.raises(MRError, match=match):
        s.one(line)


def test_composed_cc_engine_raises(tmp_path, monkeypatch):
    """An engine name other than fused or composed raises, as the JAX
    command's does; composed itself runs (against JAX in
    test_torch_composed.py)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GPUMR_CC_ENGINE", "composd")
    s = OinkScript(device="cpu", screen=False)
    s.one("rmat 5 2 0.25 0.25 0.25 0.25 0.0 1 -o NULL mre")
    with pytest.raises(MRError, match="unknown engine 'composd' "
                                      r"\(use 'fused' or 'composed'\)"):
        s.one("cc_find 0 -i mre")
    monkeypatch.setenv("GPUMR_CC_ENGINE", "composed")
    s.one("cc_find 0 -i mre")


@pytest.mark.parametrize("env, line", [
    ("GPUMR_LUBY_ENGINE", "luby_find 5 -i mre"),
    ("GPUMR_TRI_ENGINE", "tri_find -i mre"),
    ("GPUMR_SSSP_ENGINE", "sssp 1 5 -i mre")])
def test_composed_graph_engines_raise(tmp_path, monkeypatch, env, line):
    """As above for luby_find, tri_find and sssp: an unknown engine name
    raises; fused and composed run."""
    monkeypatch.chdir(tmp_path)
    s = OinkScript(device="cpu", screen=False)
    s.one("rmat 5 2 0.25 0.25 0.25 0.25 0.0 1 -o NULL mre")
    s.one("mre map/mr mre add_weight")
    monkeypatch.setenv(env, "serial")
    with pytest.raises(MRError, match="unknown engine 'serial'"):
        s.one(line)
    for engine in ("fused", "composed"):
        monkeypatch.setenv(env, engine)
        s.one(line)


def test_main_runs_a_script_on_the_cpu(tmp_path, monkeypatch):
    from gpu_mapreduce_tpu_torch.oink.script import main
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.x").write_text(
        "rmat 6 2 0.25 0.25 0.25 0.25 0.0 9 -o tmp.e NULL\n")
    assert main(["-in", "in.x", "-device", "cpu", "-screen", "none",
                 "-log", "none"]) == 0
    assert (tmp_path / "tmp.e").read_text().count("\n") == 128
