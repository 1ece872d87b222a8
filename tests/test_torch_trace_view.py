"""The port's trace viewer (``python -m
gpu_mapreduce_tpu_torch.obs.trace_view``) against the reference package's
``scripts/trace_view.py``, on the CPU.

The inputs are the port's own: a JSONL span trace of an OINK run
(``MRTPU_TRACE``), the run directory of a two-rank ``python -m
gpu_mapreduce_tpu_torch.launch --device cpu`` (per-rank trace shards and
sync records) and a probe log.  Every mode — the per-op table,
``--json``, ``--cat``, ``--traces``, ``--trace ID``, ``--chrome``, a run
directory (rank shards rebased on ``wall``, the sync alignment table),
``--probe`` and the usage errors — gives the same exit code and the same
stdout through both (the usage text aside, which names each viewer's
own command), and ``--chrome`` the same file.  The viewer
imports nothing of JAX (``tests/test_torch_no_jax.py``)."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest

from gpu_mapreduce_tpu_torch.obs import trace_view
from gpu_mapreduce_tpu_torch.obs.fleetobs import read_trace_dir

from test_torch_serve import ROOT

_spec = importlib.util.spec_from_file_location(
    "ref_trace_view", os.path.join(ROOT, "scripts", "trace_view.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)


def run(mod, argv):
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = mod.main(argv)
    return rc, o.getvalue(), e.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tv")
    env = {**os.environ, "PYTHONPATH": ROOT}
    corpus = tmp / "c.txt"
    corpus.write_text("a b c a b a\nd e a\n" * 50)
    script = tmp / "in.x"
    script.write_text(f"variable files index {corpus}\n"
                      "wordfreq 2 -i v_files\n"
                      "mr x\nx map/file " + str(corpus) + " read_words\n"
                      "x collate NULL\nx reduce count\n")
    trace = tmp / "t.jsonl"
    subprocess.run([sys.executable, "-m", "gpu_mapreduce_tpu_torch.oink."
                    "script", "-in", str(script), "-device", "cpu"],
                   cwd=str(tmp), env={**env, "MRTPU_TRACE": str(trace)},
                   check=True, capture_output=True, timeout=300)
    rundir = tmp / "run"
    subprocess.run([sys.executable, "-m", "gpu_mapreduce_tpu_torch.launch",
                    "--np", "2", "--rundir", str(rundir), "--device", "cpu",
                    "wordfreq", "--files", str(corpus), "--out",
                    str(rundir / "out.txt"), "--chunks", "4"],
                   cwd=ROOT, env=env, check=True, capture_output=True,
                   timeout=300)
    probe = tmp / "probe.jsonl"
    with open(probe, "w") as f:
        for i, (phase, rc) in enumerate(
                [("probe", 0), ("probe", 1), ("probe", 1), ("step.run", 0),
                 ("probe", 0), ("probe", 1), ("step.run", 2)]):
            f.write(json.dumps({"ts": f"t{i}", "phase": phase, "rc": rc,
                                "latency_s": 0.5 * i}) + "\n")
        f.write('{"ts": "torn')
    tids = run(trace_view, [str(trace), "--traces", "--json"])[1]
    tid = max(json.loads(tids).items(), key=lambda kv: kv[1]["spans"])[0]
    launch = json.load(open(rundir / "launch.json"))
    return {"trace": str(trace), "rundir": str(rundir), "probe": str(probe),
            "tid": tid, "run_tid": launch["trace_id"], "tmp": str(tmp)}


CASES = {
    "table": ["{trace}"],
    "json": ["{trace}", "--json"],
    "cat": ["{trace}", "--cat", "mr_op"],
    "cat_json": ["{trace}", "--cat", "oink", "--json"],
    "traces": ["{trace}", "--traces"],
    "traces_json": ["{trace}", "--traces", "--json"],
    "trace": ["{trace}", "--trace", "{tid}"],
    "trace_json": ["{trace}", "--trace", "{tid}", "--json"],
    "trace_unknown": ["{trace}", "--trace", "0000000000000000"],
    "rundir": ["{rundir}"],
    "rundir_json": ["{rundir}", "--json"],
    "rundir_traces": ["{rundir}", "--traces"],
    "rundir_trace": ["{rundir}", "--trace", "{run_tid}"],
    "rundir_trace_json": ["{rundir}", "--trace", "{run_tid}", "--json"],
    "probe": ["--probe", "{probe}"],
    "probe_json": ["--probe", "{probe}", "--json"],
    "help": ["--help"],
    "no_args": [],
    "probe_no_path": ["--probe"],
    "missing_value": ["{trace}", "--trace"],
    "unknown_arg": ["{trace}", "--nope"],
    "empty_rundir": ["{tmp}/empty"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stdout_equals_the_reference_viewer(inputs, case):
    os.makedirs(os.path.join(inputs["tmp"], "empty"), exist_ok=True)
    argv = [a.format(**inputs) for a in CASES[case]]
    got = run(trace_view, argv)
    want = run(ref, argv)
    if case in ("help", "no_args"):
        # the usage text names each viewer's own command
        assert got[0::2] == want[0::2]
        assert got[1] == trace_view.__doc__.strip() + "\n"
        return
    assert got == want
    if case in ("table", "rundir", "trace", "rundir_trace", "probe"):
        assert got[0] == 0 and got[1].strip()


def test_chrome_export_equals_the_reference(inputs):
    outs = {}
    for name, mod in (("port", trace_view), ("ref", ref)):
        path = os.path.join(inputs["tmp"], f"chrome-{name}.json")
        rc, so, se = run(mod, [inputs["trace"], "--chrome", path])
        outs[name] = (rc, so, se.replace(path, "<out>"),
                      open(path).read())
    assert outs["port"] == outs["ref"]
    assert json.loads(outs["port"][3])["traceEvents"]


def test_run_dir_merge_is_the_reference_merge(inputs):
    """The rank shards rebased on ``wall`` and namespaced per rank: the
    port's ``fleetobs.read_trace_dir`` is the reference viewer's merge."""
    got, n = read_trace_dir(inputs["rundir"])
    want, m = ref.read_trace_dir(inputs["rundir"])
    assert (got, n) == (want, m) and n == 2
    assert {e["rank"] for e in got} == {0, 1}
    assert all(e["id"] >> 32 == e["rank"] + 1 for e in got if e.get("id"))
    assert trace_view.sync_alignment(inputs["rundir"]) == \
        ref.sync_alignment(inputs["rundir"])
    assert trace_view.sync_alignment(inputs["rundir"])
