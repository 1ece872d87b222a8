"""``python -m gpu_mapreduce_tpu_torch.plan`` (the port's offline plan
dump) against the JAX package's ``scripts/plan_dump.py`` over
``examples/in.wordfreq``, both called in process: the same script output
and the same plans' stages; the groups equal the JAX interpreter's on
``make_mesh(1)`` (the port's one device is that path, not the JAX serial
host path the script takes), and with ``-var fuse 0`` neither records a
plan."""

import importlib.util
import io
import os
import subprocess
import sys

import pytest

from gpu_mapreduce_tpu_torch.plan import __main__ as plan_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "in.wordfreq")


def _jax_plan_dump():
    spec = importlib.util.spec_from_file_location(
        "_jax_plan_dump", os.path.join(ROOT, "scripts", "plan_dump.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _split(lines):
    """(script lines without the timing line, plan lines, group lines)."""
    script = [ln for ln in lines if ln.startswith(("WordFreq:", "  "))
              and not ln.startswith("  cache:") and not ln.startswith(
                  "  group") and "secs on" not in ln]
    plans = [ln for ln in lines if ln.startswith("plan ")]
    groups = [ln for ln in lines if ln.startswith("  group")]
    return script, plans, groups


@pytest.fixture
def data(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MRTPU_FUSE", "1")
    (tmp_path / "data.txt").write_text("to be or not to be\nthat is it\n")
    return "data.txt"


def _run(capsys, fn, argv):
    capsys.readouterr()
    assert fn(argv) == 0
    return capsys.readouterr().out.splitlines()


def test_plan_dump_matches_jax(data, capsys):
    got = _run(capsys, plan_main.main,
               [SCRIPT, "-var", "files", data, "-device", "cpu"])
    want = _run(capsys, _jax_plan_dump().main, [SCRIPT, "-var", "files",
                                                data])
    g_script, g_plans, g_groups = _split(got)
    w_script, w_plans, _ = _split(want)
    # the top lines' tied counts come in another order (the JAX serial
    # host path orders ties by first appearance): counts in order, the
    # lines as a set
    assert g_script[0] == w_script[0] == "WordFreq: 1 files, 9 words, 7 " \
        "unique"
    assert [ln.split()[0] for ln in g_script] == \
        [ln.split()[0] for ln in w_script]
    assert sorted(g_script) == sorted(w_script)
    assert g_plans == w_plans == [
        "plan 0: aggregate(None) -> convert() -> reduce(count, batch=True)",
        "plan 1: sort_values(-1)"]
    # the groups of the JAX interpreter on make_mesh(1)
    from gpu_mapreduce_tpu.oink.commands.dump_plan import format_plans
    from gpu_mapreduce_tpu.oink.script import OinkScript
    from gpu_mapreduce_tpu.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu.plan import clear_history, plan_history
    clear_history()
    s = OinkScript(comm=make_mesh(1), screen=io.StringIO())
    s.variables.set(["files", "index", data])
    s.variables.set(["fuse", "index", "1"])
    s.run_file(SCRIPT)
    _, m_plans, m_groups = _split(format_plans(plan_history()).splitlines())
    assert m_plans == g_plans and g_groups == m_groups
    assert "  group 1 [local reduce_op=count]: convert(); " \
        "reduce(count, batch=True)" in g_groups


def test_plan_dump_with_fuse_off_records_none(data, capsys):
    args = [SCRIPT, "-var", "files", data, "-var", "fuse", "0"]
    os.environ.pop("MRTPU_FUSE")
    got = _run(capsys, plan_main.main, args + ["-device", "cpu"])
    os.environ.pop("MRTPU_FUSE")
    want = _run(capsys, _jax_plan_dump().main, args)
    assert got[-1] == want[-1] == \
        "(no plans recorded — set fuse 1 / MRTPU_FUSE=1)"


def test_plan_dump_help_and_module_entry(tmp_path):
    """``-h`` prints the usage; the module runs as ``python -m`` without
    JAX in the process."""
    r = subprocess.run([sys.executable, "-m", "gpu_mapreduce_tpu_torch.plan",
                        "-h"], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert r.returncode == 0 and "python -m gpu_mapreduce_tpu_torch.plan" \
        in r.stdout
