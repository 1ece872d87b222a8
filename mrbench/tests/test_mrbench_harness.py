"""The harness at tiny sizes on the CPU: every cell runs and reads
correct; the control and each fault a cell can have read not correct; a
cell, a configuration and a per-layer metric are found by name as new
files alone; the contract's shape of ``BENCHMARK.json``."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from mrbench import run, spec

CPU = [torch.device("cpu")]
SEED = 2 ** 31 + 101
TINY = {"rmat22-pagerank": {"scale": 10},
        "rmat22-cc-composed": {"scale": 10},
        "invertedindex-html": {"total_bytes": 1 << 20, "vocab": 1 << 10},
        "rmat26-pagerank-p4": {"scale": 10}}
CELLS = sorted(TINY)


def _run(cell, trace=False, **kw):
    """A run on the CPU, a CPU shard for each card the cell asks for."""
    chips = spec.cell(spec.benchmark(), cell)["chips"]
    return run.run_cell(cell, SEED, 0.3, trace, devices=CPU * chips,
                        config_override=TINY[cell], **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 spec.end_to_end(spec.benchmark(), cell)}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(cell):
    r = _run(cell, control=True)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _fault(monkeypatch, target, wrap):
    mod_name, attr = target.split(":")
    import importlib
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))


def test_fault_step_returns_its_state_unchanged(monkeypatch):
    _fault(monkeypatch, "gpu_mapreduce_tpu_torch.models.pagerank:pagerank_step",
           lambda fn: lambda ranks, *a, **k: [r.clone() for r in ranks])
    r = _run("rmat22-pagerank")
    assert not r["correct"] and r["failed"] > 0


def test_fault_exchange_between_cards_left_out(monkeypatch):
    _fault(monkeypatch, "gpu_mapreduce_tpu_torch.models.pagerank:allreduce",
           lambda fn: lambda tensors, op: list(tensors))
    r = _run("rmat26-pagerank-p4")
    assert not r["correct"] and r["failed"] > 0


def test_traced_run_reads_the_cross_card_sum(monkeypatch):
    """The four-card cell's traced run opens the benchmark's ranges
    around the sum, the staging and the steps; a card's work launched
    under a range is charged to it (a trace of the shape the profiler
    writes, since the CPU has no device events)."""
    from mrbench import trace
    made = []
    init = trace.TraceSummary.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        made.append(self)
    monkeypatch.setattr(trace.TraceSummary, "__init__", keep)
    r = _run("rmat26-pagerank-p4", trace=True)
    assert r["correct"]
    for name in ("mrbench.allreduce", "mrbench.stage_graph",
                 "mrbench.pagerank_step"):
        assert made[0].ranges[name][0] > 0

    def ev(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "tid": 1, "args": args}
    events = [ev("mrbench.window", "user_annotation", 0, 1000),
              ev("mrbench.allreduce", "user_annotation", 100, 100),
              ev("cudaMemcpyAsync", "cuda_runtime", 110, 5, correlation=1),
              ev("Memcpy PtoP", "gpu_memcpy", 120, 40, correlation=1,
                 device=1),
              ev("add", "cuda_runtime", 300, 5, correlation=2),
              ev("add_kernel", "kernel", 310, 30, correlation=2, device=0)]
    ctx = run.Context()
    ctx.trace = trace.TraceSummary(events, ndevices=4)
    ctx.jobs = 1
    mod = spec.metric_module("allreduce_ms")
    assert mod.read(ctx) == pytest.approx(0.04)


def test_fault_pagerank_answer_altered(monkeypatch):
    def wrap(fn):
        def step(*a, **k):
            out = fn(*a, **k)
            out[0][0] += 1e-3
            return out
        return step
    _fault(monkeypatch, "gpu_mapreduce_tpu_torch.models.pagerank:pagerank_step",
           wrap)
    assert not _run("rmat22-pagerank")["correct"]


def test_fault_cc_answer_altered(monkeypatch):
    from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager

    def wrap(fn):
        def output(self, index, mr, printer=None):
            if mr.kv is not None and mr.kv.nkv:
                mr.kv.one_frame().value[:1] += 1
            return fn(self, index, mr, printer)
        return output
    monkeypatch.setattr(ObjectManager, "output", wrap(ObjectManager.output))
    r = _run("rmat22-cc-composed")
    assert not r["correct"] and r["checks"]["wrong_vertices"]["value"] > 0


def test_fault_invertedindex_answer_altered(monkeypatch):
    from gpu_mapreduce_tpu_torch.apps import invertedindex as ii
    from gpu_mapreduce_tpu_torch.parallel.sharded import ShardedKV

    def wrap(fn):
        def reduce(fr, op):
            out = fn(fr, op)
            value = out.value.clone()
            value[:1] += 1
            return ShardedKV(out.key, value, out.counts, out.key_dtype,
                             out.value_dtype)
        return reduce
    monkeypatch.setattr(ii, "reduce_sharded", wrap(ii.reduce_sharded))
    r = _run("invertedindex-html")
    assert not r["correct"] and r["checks"]["wrong_urls"]["value"] > 0


def test_cli_refuses_without_enough_cards(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "rmat22-pagerank", "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpu_mapreduce_tpu_torch_x", sys)
    assert "gpu_mapreduce_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gpu_mapreduce_tpu.core", sys)
    assert "gpu_mapreduce_tpu" in run.forbidden_modules()


def test_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """A copy of the benchmark with a configuration, a cell and a metric
    added as new files and entries only: the new cell runs and reports
    the new metric."""
    root = tmp_path / "co"
    shutil.copytree(spec.HERE, root / "mrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    before = {str(p.relative_to(root)): p.read_bytes()
              for p in (root / "mrbench").rglob("*") if p.is_file()}
    cfg = spec.config("rmat22")
    cfg.update(name="rmat11", scale=11)
    (root / "mrbench/configs/rmat11.json").write_text(json.dumps(cfg))
    wl = spec.workload("rmat22-pagerank")
    wl.update(config="rmat11", params={"tol": 1e-6, "maxiter": 50,
                                       "alpha": 0.9})
    (root / "mrbench/workloads/rmat11-pagerank.json").write_text(
        json.dumps(wl))
    (root / "mrbench/metrics/jobs_done.py").write_text(
        'LAYER = "End to end"\nUNIT = "jobs"\nMOVES = "job_s"\n\n\n'
        'def read(ctx):\n    return ctx.jobs\n')
    bench["configs"].append({**bench["configs"][0], "name": "rmat11",
                             "file": "mrbench/configs/rmat11.json"})
    bench["workloads"].append({"name": "rmat11-pagerank", "config": "rmat11",
                               "traffic": "pagerank-b", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({"name": "jobs_done", "unit": "jobs",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["rmat11-pagerank"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {str(p.relative_to(root)): p.read_bytes()
             for p in (root / "mrbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    code = ("import json, torch\nfrom mrbench import run\n"
            "r = run.run_cell('rmat11-pagerank', 7, 0.3, False, "
            "devices=[torch.device('cpu')])\nprint(json.dumps(r))\n")
    env = {**os.environ, "PYTHONPATH": spec.ROOT}
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"]["jobs_done"]["value"] >= 1


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_the_contract_shape():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(spec.HERE, "workloads",
                                           w["name"] + ".json"))
        assert spec.workload(w["name"])["config"] == w["config"]
        assert spec.per_layer(b, w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        mod = spec.metric_module(m["name"])
        assert (mod.UNIT, mod.MOVES) == (m["unit"], m.get("moves",
                                                          m["name"]))
        if "layer" in m:
            assert mod.LAYER == m["layer"]
            assert m["moves"] in e2e
    for c in b["configs"]:
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
