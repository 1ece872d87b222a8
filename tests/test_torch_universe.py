"""Multi-world (``-partition``) runs and the ``shell`` builtin in the port
against the JAX package, on the CPU at four shards: the world specs and
their consistency message, the WORLD/UNIVERSE/ULOOP variables with a
world context (and ULOOP's shared counter), per-world ``screen.N`` and
``log.oink.N`` files, ULOOP work sharing across worlds, a MapReduce a
world over its sub-mesh, the CLI, errors reported per world, and the
shell verbs.  Each case runs in both packages and compares what they
give."""

import os
import re

import pytest

from gpu_mapreduce_tpu.core.runtime import MRError as JMRError
from gpu_mapreduce_tpu.oink import universe as juni
from gpu_mapreduce_tpu.oink import variables as jvars
from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
from gpu_mapreduce_tpu.oink.script import main as jmain
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu_torch import MRError, OinkScript
from gpu_mapreduce_tpu_torch.oink import universe as tuni
from gpu_mapreduce_tpu_torch.oink import variables as tvars
from gpu_mapreduce_tpu_torch.oink.script import main as tmain

from test_torch_parallel import tmesh

P = 4
SIDES = {"port": (tuni, tvars, MRError), "jax": (juni, jvars, JMRError)}


def _run(side, script, specs, **kw):
    uni = SIDES[side][0]
    if side == "port":
        return uni.run_universe(script, specs, comm=tmesh(P), device="cpu",
                                uscreen=False, **kw)
    return uni.run_universe(script, specs, comm=j_make_mesh(P),
                            uscreen=False, **kw)


def _in_dirs(tmp_path, monkeypatch, text, fn):
    """Run ``fn(side, script)`` in a directory a side; returns the
    files each side wrote, by name."""
    out = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        script = d / "in.script"
        script.write_text(text)
        fn(side, str(script))
        out[side] = {f: (d / f).read_text() for f in sorted(os.listdir(d))
                     if (d / f).is_file() and f != "in.script"}
    return out


# -- the layout (universe.cpp:55-99) -------------------------------------------

@pytest.mark.parametrize("specs", [["2x3", "2"], [None], ["1x4"],
                                   ["3", "1"]])
def test_add_world_specs_match_jax(specs):
    got = {}
    for side in SIDES:
        u = SIDES[side][0].Universe(8)
        for spec in specs:
            u.add_world(spec)
        got[side] = (u.nworlds, u.procs_per_world, u.root_proc,
                     u.consistent())
    assert got["port"] == got["jax"]


def test_inconsistent_partitions_raise(tmp_path):
    script = tmp_path / "in.empty"
    script.write_text("print done\n")
    for side in SIDES:
        with pytest.raises(SIDES[side][2], match="inconsistent"):
            _run(side, str(script), ["3x1"], logname="none",
                 screenname="none")


# -- variables with a world context (variable.cpp:166-240) ---------------------

def _vars(side, iworld=0, nworlds=1, counter=None):
    v = SIDES[side][1]
    if counter is None and nworlds == 1 and iworld == 0:
        return v.Variables()
    return v.Variables(v.WorldContext(iworld, nworlds,
                                      counter or v.UloopCounter(nworlds)))


def _outcome(fn):
    try:
        return ("ok", fn())
    except (MRError, JMRError) as e:
        return ("err", str(e))


@pytest.mark.parametrize("case", [
    (1, 3, ["w", "world", "a", "b", "c"]),
    (0, 2, ["w", "world", "a", "b", "c"]),
    (0, 4, ["u", "universe", "a", "b"]),
    (2, 4, ["u", "universe", "a", "b", "c", "d", "e"]),
    (1, 2, ["u", "uloop", "5", "pad"])])
def test_world_variables_match_jax(case):
    iworld, nworlds, args = case
    got = {}
    for side in SIDES:
        v = _vars(side, iworld, nworlds)
        got[side] = (_outcome(lambda: v.set(args)),
                     _outcome(lambda: v.retrieve(args[0])))
    assert got["port"] == got["jax"]


def test_uni_vars_must_share_length():
    for side in SIDES:
        v = _vars(side)
        v.set(["a", "uloop", "4"])
        with pytest.raises(SIDES[side][2], match="same # of values"):
            v.set(["b", "universe", "x", "y", "z"])


def test_uloop_shared_counter_matches_jax():
    """Two worlds drain one ULOOP: world i starts at i, then each next
    claims the shared counter's next index until it runs out."""
    got = {}
    for side in SIDES:
        mod = SIDES[side][1]
        counter = mod.UloopCounter(2)
        v0, v1 = (_vars(side, i, 2, counter) for i in (0, 1))
        for v in (v0, v1):
            v.set(["u", "uloop", "5"])
        seq = [v0.retrieve("u"), v1.retrieve("u")]
        for v in (v0, v1, v1, v1):
            seq.append((v.next(["u"]), v.retrieve("u")))
        got[side] = seq
    assert got["port"] == got["jax"]
    assert got["port"][:4] == ["0", "1", (False, "2"), (False, "3")]


@pytest.mark.parametrize("lines", [
    [["u", "uloop", "3"]],
    [["u", "uloop", "10", "pad"]],
    [["a", "uloop", "3"], ["b", "uloop", "5"]]])
def test_single_world_uloop_progression_matches_jax(lines):
    got = {}
    for side in SIDES:
        v = _vars(side)
        seen = []
        for args in lines:
            v.set(args)
            seen.append(v.retrieve(args[0]))
            while not v.next([args[0]]):
                seen.append(v.retrieve(args[0]))
        got[side] = seen
    assert got["port"] == got["jax"]


# -- end-to-end -partition runs (threads over sub-meshes) ----------------------

def test_partition_world_variable_and_files_match_jax(tmp_path,
                                                      monkeypatch):
    text = ('variable p equal nprocs\n'
            'variable w world alpha beta\n'
            'print "world=$w nprocs=${p}"\n')
    got = _in_dirs(tmp_path, monkeypatch, text,
                   lambda side, s: _run(side, s, ["2x2"]))
    assert got["port"] == got["jax"]
    assert set(got["port"]) == {"log.oink.0", "log.oink.1", "screen.0",
                                "screen.1"}
    assert "world=alpha nprocs=2" in got["port"]["log.oink.0"]
    assert "world=beta nprocs=2" in got["port"]["log.oink.1"]
    assert "Processor partition = 0" in got["port"]["screen.0"]


def test_partition_uloop_work_sharing(tmp_path, monkeypatch):
    text = ('variable u uloop 6\n'
            'label top\n'
            'print "claimed $u"\n'
            'next u\n'
            'jump SELF top\n')
    got = _in_dirs(tmp_path, monkeypatch, text,
                   lambda side, s: _run(side, s, ["2x2"]))
    for side in SIDES:
        claimed = [int(m) for i in (0, 1) for m in re.findall(
            r"claimed (\d+)", got[side][f"log.oink.{i}"])]
        assert sorted(claimed) == [0, 1, 2, 3, 4, 5], side


def test_partition_runs_mapreduce_per_world_like_jax(tmp_path,
                                                     monkeypatch):
    """Each world drives its own two-shard MapReduce (R-MAT edges and
    their degrees, a seed a world): per-shard files equal the JAX
    package's, line for line."""
    text = ('variable w world 0 1\n'
            'rmat 6 4 0.25 0.25 0.25 0.25 0.0 ${w} -o NULL edges$w\n'
            'degree 0 -i edges$w -o deg.$w NULL\n')
    got = _in_dirs(tmp_path, monkeypatch, text,
                   lambda side, s: _run(side, s, ["2x2"],
                                        screenname="none"))
    for w in (0, 1):
        for side in SIDES:
            shards = [f for f in got[side] if f.startswith(f"deg.{w}.")]
            assert len(shards) == 2, (side, shards)
        port = sorted(ln for f, t in got["port"].items()
                      if f.startswith(f"deg.{w}.") for ln in t.splitlines())
        jax = sorted(ln for f, t in got["jax"].items()
                     if f.startswith(f"deg.{w}.") for ln in t.splitlines())
        assert port == jax and port


def test_cli_partition_requires_in():
    for fn in (jmain, tmain):
        with pytest.raises(SystemExit, match="-in"):
            fn(["-partition", "1x1"])


def test_cli_partition_builds_mesh_and_keeps_screen_file(tmp_path,
                                                         monkeypatch):
    """``-partition 2x2`` sizes a four-shard mesh and writes per-world
    logs; ``-screen FILE`` writes FILE.N only, never FILE."""
    text = 'variable w world a b\nprint "w=$w"\n'

    def run(side, script):
        (tmp_path / side / "scr").write_text("precious")
        extra = ["-device", "cpu"] if side == "port" else []
        fn = tmain if side == "port" else jmain
        assert fn(["-in", script, "-partition", "2x2", "-screen", "scr",
                   *extra]) == 0
    got = _in_dirs(tmp_path, monkeypatch, text, run)
    assert got["port"] == got["jax"]
    assert got["port"]["scr"] == "precious"
    assert "w=a" in got["port"]["log.oink.0"]
    assert "w=b" in got["port"]["scr.1"]


def test_world_errors_are_reported_per_world(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ok = tmp_path / "in.ok"
    ok.write_text('print "hi"\n')
    bad = tmp_path / "in.bad"
    bad.write_text("definitely_not_a_command\n")
    msgs = {}
    for side in SIDES:
        uni, _v, err = SIDES[side]
        kw = {"device": "cpu"} if side == "port" else {}
        with pytest.raises(err, match="world 0") as e1:
            uni.run_universe(str(ok), ["1"], comm=None, uscreen=False,
                             screenname="none",
                             logname=str(tmp_path / "nodir" / "log"), **kw)
        with pytest.raises(err, match="Unknown command") as e2:
            uni.run_universe(str(bad), ["1"], comm=None, uscreen=False,
                             screenname="none", logname="none", **kw)
        msgs[side] = (str(e1.value).split(":")[0], str(e2.value))
    assert msgs["port"] == msgs["jax"]


# -- the shell builtin (input.cpp:751-791) -------------------------------------

@pytest.mark.parametrize("lines", [
    ["shell mkdir a b/c", "shell mv a d", "shell rmdir b/c b",
     "shell rm nofile"],
    ["shell mkdir x", "shell cd x", "shell mkdir y", "shell cd .."],
    ["shell"], ["shell mv onlyone"], ["shell cd"], ["shell format c:"]])
def test_shell_builtin_matches_jax(tmp_path, monkeypatch, lines):
    got = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        s = OinkScript(device="cpu", screen=False) if side == "port" \
            else JOinkScript(screen=False)
        outcome = []
        for line in lines:
            outcome.append(_outcome(lambda: s.one(line)))
        got[side] = (outcome, sorted(os.path.relpath(os.path.join(r, n), d)
                                     for r, ds, fs in os.walk(d)
                                     for n in ds + fs))
    assert got["port"] == got["jax"]
