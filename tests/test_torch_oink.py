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
    outs = {p.name: p.read_bytes() for p in d.iterdir()
            if p.name.startswith("tmp.")}
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
                                            ("in.pagerank", ("tmp.pr",))])
def test_example_scripts_match_jax(tmp_path, example, ranks):
    with open(os.path.join(ROOT, "examples", example)) as f:
        script = f.read()
    lines, outs = _compare(tmp_path, script, ranks=ranks)
    word = {"in.rmat": "DegreeStats:", "in.cc": "CCStats:",
            "in.pagerank": "PageRank:"}[example]
    assert any(ln.startswith(word) for ln in lines)
    if example == "in.cc":
        assert "tmp.cc" in outs and outs["tmp.cc"].count(b"\n") > 60000


def test_control_flow_script_matches_jax(tmp_path):
    lines, outs = _compare(tmp_path, CONTROL,
                           files=[("tmp.inc", INCLUDED)])
    assert lines[0] == "n=5 a=1 e=3 " and "after the loop, n=5 " in lines
    assert "from the included file " in lines
    assert sorted(outs) == ["tmp.inc", "tmp.r1", "tmp.r2", "tmp.r3"]


def test_graph_commands_match_jax(tmp_path):
    lines, outs = _compare(tmp_path, GRAPH, ranks=("tmp.pr2",), mesh=False)
    for word in ("RMAT2:", "Degree:", "DegreeStats:", "EdgeUpper:",
                 "DegreeWeight:", "CC_find:", "CCStats:", "PageRank:"):
        assert any(ln.startswith(word) for ln in lines), word


@pytest.mark.parametrize("line", ["mr foo", "shell mkdir x",
                                  "resume somewhere"])
def test_unported_builtins_raise(line):
    s = OinkScript(device="cpu", screen=False)
    with pytest.raises(MRError, match="not ported yet"):
        s.one(line)


def test_composed_cc_engine_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GPUMR_CC_ENGINE", "composed")
    s = OinkScript(device="cpu", screen=False)
    s.one("rmat 5 2 0.25 0.25 0.25 0.25 0.0 1 -o NULL mre")
    with pytest.raises(MRError, match="not ported yet"):
        s.one("cc_find 0 -i mre")


def test_main_runs_a_script_on_the_cpu(tmp_path, monkeypatch):
    from gpu_mapreduce_tpu_torch.oink.script import main
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.x").write_text(
        "rmat 6 2 0.25 0.25 0.25 0.25 0.0 9 -o tmp.e NULL\n")
    assert main(["-in", "in.x", "-device", "cpu", "-screen", "none",
                 "-log", "none"]) == 0
    assert (tmp_path / "tmp.e").read_text().count("\n") == 128
