"""The port's own spans where the graph commands and the InvertedIndex do
their work, on the CPU:

* PageRank through ``OinkScript`` on one device and on a CPU mesh of two:
  ``graph.stage`` over a ``graph.unique`` and a ``graph.rank`` a shard
  (and ``graph.merge`` at P > 1), ``pagerank.loop`` over one
  ``pagerank.step`` and one ``pagerank.delta`` a step, ``mesh.allreduce``
  at P > 1 only, and ``steps`` on ``oink.pagerank``;
* cc_find: one ``cc.round`` a round of the composed engine, and
  ``rounds`` on ``oink.cc_find`` on both engines;
* InvertedIndex: one ``stage.pack`` before each ``stage.h2d``, and
  ``pack`` in its stage timer;
* tracing off builds no span and leaves the ring empty;
* under ``torch.profiler`` each span's interval, put on the profiler's
  clock by its ``wall``, holds its own ``record_function`` range, and so
  does ``trace_view --device``'s merged file;
* ``Tracer.enable`` reads the wall epoch afresh when it turns tracing
  on."""

import io
import json
import os
import re
import time

import pytest
import torch

from gpu_mapreduce_tpu_torch import InvertedIndex, OinkScript, obs
from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
from gpu_mapreduce_tpu_torch.apps.invertedindex import _GAP
from gpu_mapreduce_tpu_torch.obs import trace_view, tracer
from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh

RMAT = "rmat 8 4 0.57 0.19 0.19 0.05 0.0 12345 -o NULL mre"
PAGERANK = "pagerank 1e-8 100 0.85 -i mre -o NULL mrpr"
PR_MSG = re.compile(r"PageRank: (\d+) vertices, (\d+) edges, "
                    r"(\d+) iterations")
CC_MSG = re.compile(r"CC_find: (\d+) components in (\d+) iterations")
# the categories of the spans each job's checks read
CATS = ("graph", "mesh", "oink", "app")


@pytest.fixture(autouse=True)
def tr():
    """The process tracer, reset before and after every test."""
    t = obs.get_tracer()
    t.reset()
    yield t
    t.reset()


def _script(P):
    screen = io.StringIO()
    if P == 1:
        return OinkScript(device="cpu", screen=screen, logfile=None)
    return OinkScript(comm=make_mesh(P, devices=["cpu"] * P),
                      screen=screen, logfile=None)


def _graph_job(P, setup, line, msg, trace, jsonl=None):
    """``setup`` untraced, then ``line`` (traced when ``trace``); returns
    the numbers its message reports."""
    s = _script(P)
    for ln in setup:
        s.one(ln)
    if trace:
        obs.get_tracer().enable(jsonl=jsonl)
    s.screen = io.StringIO()
    s.one(line)
    return tuple(int(x) for x in msg.search(s.screen.getvalue()).groups())


def pagerank_job(P):
    return lambda trace, jsonl=None, **_: _graph_job(
        P, [RMAT], PAGERANK, PR_MSG, trace, jsonl)


def cc_job(P, engine):
    def run(trace, jsonl=None, monkeypatch=None, **_):
        monkeypatch.setenv("GPUMR_CC_ENGINE", engine)
        return _graph_job(P, [RMAT, "edge_upper -i mre -o NULL mru"],
                          "cc_find 0 -i mru -o NULL mrc", CC_MSG, trace,
                          jsonl)
    return run


def index_job(P):
    """InvertedIndex over six files, each a batch of its own."""
    def run(trace, jsonl=None, tmp_path=None, monkeypatch=None, **_):
        paths, refs, _ = make_corpus(str(tmp_path), 1, nfiles=6, skew=True)
        cap = max(os.path.getsize(p) for p in paths) + _GAP
        monkeypatch.setattr(InvertedIndex, "_BATCH_BYTES", cap)
        comm = make_mesh(P, devices=["cpu"] * P) if P > 1 else None
        ii = InvertedIndex(device="cpu", comm=comm)
        if trace:
            obs.get_tracer().enable(jsonl=jsonl)
        npairs, _ = ii.run(paths)
        assert npairs == refs
        return ii
    return run


JOBS = {"pagerank-1": pagerank_job(1), "pagerank-2": pagerank_job(2),
        "cc-composed-1": cc_job(1, "composed"),
        "cc-composed-2": cc_job(2, "composed"),
        "cc-fused-1": cc_job(1, "fused"),
        "invertedindex-1": index_job(1), "invertedindex-2": index_job(2)}


def _spans(events):
    """{name: [event, ...]} in emission order, each event with its parent
    span's name under ``"up"``."""
    byid = {e["id"]: e for e in events}
    out = {}
    for e in events:
        up = byid.get(e["parent"], {}).get("name")
        out.setdefault(e["name"], []).append({**e, "up": up})
    return out


@pytest.mark.parametrize("P", [1, 2])
def test_pagerank_spans(P, tr):
    nvert, nedge, steps = pagerank_job(P)(trace=True)
    sp = _spans(tr.events())
    (cmd,) = sp["oink.pagerank"]
    assert cmd["args"]["steps"] == steps
    (stage,) = sp["graph.stage"]
    assert stage["up"] == "oink.pagerank"
    assert (stage["args"]["shards"], stage["args"]["rows"],
            stage["args"]["n"]) == (P, nedge, nvert)
    for name in ("graph.unique", "graph.rank"):
        assert [e["args"]["shard"] for e in sp[name]] == list(range(P))
        assert {e["up"] for e in sp[name]} == {"graph.stage"}
    assert sum(e["args"]["rows"] for e in sp["graph.unique"]) == nedge
    if P > 1:
        (merge,) = sp["graph.merge"]
        assert merge["up"] == "graph.stage" and merge["args"]["ids"] >= nvert
    else:
        assert "graph.merge" not in sp
    (loop,) = sp["pagerank.loop"]
    assert loop["up"] == "oink.pagerank"
    assert loop["args"] == {"n": nvert, "shards": P, "steps": steps}
    assert len(sp["pagerank.step"]) == len(sp["pagerank.delta"]) == steps
    assert {e["up"] for e in sp["pagerank.step"] + sp["pagerank.delta"]} \
        == {"pagerank.loop"}
    deltas = [e["args"]["delta"] for e in sp["pagerank.delta"]]
    assert all(isinstance(d, float) for d in deltas)
    assert deltas[-1] <= 1e-8 < min(deltas[:-1])
    if P > 1:
        # the out-degrees' sum in the loop, then one sum a step
        ar = sp["mesh.allreduce"]
        assert [e["up"] for e in ar] == ["pagerank.loop"] \
            + ["pagerank.step"] * steps
        # every shard on the one CPU device: nothing moves between devices
        assert all(e["args"] == {"op": "sum", "shards": P, "bytes": 0}
                   for e in ar)
    else:
        assert "mesh.allreduce" not in sp


@pytest.mark.parametrize("job", ["cc-composed-1", "cc-composed-2",
                                 "cc-fused-1"])
def test_cc_round_spans(job, tr, monkeypatch):
    _, rounds = JOBS[job](trace=True, monkeypatch=monkeypatch)
    sp = _spans(tr.events())
    (cmd,) = sp["oink.cc_find"]
    assert cmd["args"]["rounds"] == rounds
    if "fused" in job:
        assert "cc.round" not in sp
        return
    got = sp["cc.round"]
    assert [e["args"]["round"] for e in got] == list(range(1, rounds + 1))
    assert {e["up"] for e in got} == {"oink.cc_find"}
    changed = [e["args"]["changed"] for e in got]
    assert changed[-1] == 0 and min(changed[:-1]) > 0


@pytest.mark.parametrize("job", ["invertedindex-1", "invertedindex-2"])
def test_pack_stage_spans(job, tr, tmp_path, monkeypatch):
    ii = JOBS[job](trace=True, tmp_path=tmp_path, monkeypatch=monkeypatch)
    sp = _spans(tr.events())
    packs = sp["stage.pack"]
    assert len(packs) == len(sp["stage.h2d"]) > 1
    if job.endswith("-1"):
        assert len(packs) == ii.stats["nbatches"]
        for e in packs:
            assert e["args"]["pad"] == -e["args"]["bytes"] % 4
    assert all(e["args"]["bytes"] > 0 and e["cat"] == "app" for e in packs)
    assert "pack" in ii.timer.times
    secs = sum(e["dur"] for e in packs) / 1e6
    assert abs(secs - ii.timer.times["pack"]) <= max(0.02 * secs, 1e-3)


@pytest.mark.parametrize("job", ["pagerank-1", "pagerank-2",
                                 "cc-composed-1", "invertedindex-1"])
def test_tracing_off_builds_no_span(job, tr, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was built with tracing off")
    monkeypatch.setattr(tracer.Span, "__init__", refuse)
    JOBS[job](trace=False, tmp_path=tmp_path, monkeypatch=monkeypatch)
    assert not tr.enabled and tr.events() == []


@pytest.mark.parametrize("job", ["pagerank-2", "cc-composed-1",
                                 "invertedindex-1"])
def test_spans_hold_their_profiler_ranges(job, tr, tmp_path, monkeypatch):
    """Each span of ``CATS``, put on the profiler's clock by the rule,
    holds its ``record_function`` range within 1 ms, in the tracer's
    events and in ``trace_view --device``'s merged file alike."""
    jsonl, prof_json, merged = (str(tmp_path / n) for n in
                                ("t.jsonl", "prof.json", "merged.json"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        JOBS[job](trace=True, jsonl=jsonl, tmp_path=tmp_path,
                  monkeypatch=monkeypatch)
    tr.disable()
    prof.export_chrome_trace(prof_json)
    with open(prof_json) as f:
        doc = json.load(f)
    base_us = doc["baseTimeNanoseconds"] / 1e3
    ranges = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
    spans = [e for e in tr.events() if e["cat"] in CATS]
    assert spans

    def check(placed):
        """``placed`` [(span, start µs on the profiler's clock)]."""
        by_name = {}
        for e, t in placed:
            by_name.setdefault(e["name"], []).append((t, e["dur"]))
        for name, got in by_name.items():
            want = sorted((r["ts"], r["dur"]) for r in ranges[name])
            assert len(got) == len(want), name
            for (t, d), (rt, rd) in zip(sorted(got), want):
                assert t <= rt + 1000 and rt + rd <= t + d + 1000, name
    check([(e, e["wall"] * 1e6 - base_us) for e in spans])
    assert trace_view.main([jsonl, "--chrome", merged, "--device",
                            prof_json]) == 0
    with open(merged) as f:
        out = json.load(f)["traceEvents"]
    placed = [(e, e["ts"]) for e in out
              if e.get("ph") == "X" and "wall" in e and e["cat"] in CATS]
    assert len(placed) == len(spans)
    check(placed)


def test_enable_reads_the_wall_epoch_afresh():
    """Turned on from off, the tracer reads the unix time at
    ``perf_counter`` zero again; already on, it keeps it; ``epoch``
    (the origin of ``ts``) never moves."""
    t = tracer.Tracer()
    epoch = t.epoch
    t.wall_epoch = 0.0
    t.enable()
    assert abs(t.wall_epoch - (time.time() - time.perf_counter())) < 0.01
    t.wall_epoch = 1.0
    t.enable()
    assert t.wall_epoch == 1.0 and t.epoch == epoch
    t.disable()
    t.enable()
    assert t.wall_epoch != 1.0 and t.epoch == epoch
    t.reset()
