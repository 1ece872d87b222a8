"""The port's tracing layer (``gpu_mapreduce_tpu_torch/obs``) against the
JAX package's on the same numpy inputs.

* the span tree: the same job (host frames, then aggregate → convert →
  reduce, collate, compress, a map_files wordfreq and a fused plan run
  cold then warm) on the JAX ``make_mesh(P)`` and the port's CPU mesh
  gives, thread by thread, the same spans in the same order — name,
  category, depth and parent — with equal pair counts and exchange,
  padding and spill bytes (launch counts differ by design);
* the sinks: the JSONL format either package reads, the Chrome export,
  rotation under ``MRTPU_TRACE_MAX_MB``, the disabled ``NULL_SPAN``;
* the card's side of a span: a ``torch.profiler`` range always, an NVTX
  range when CUDA is available (decided once), and no synchronise;
* request context: a scope charges exactly itself, threads never bleed,
  the prefetch producer, spill writer and ingest pool carry the
  submitting trace, a script is one trace that its journal records
  carry, and ``profile()`` has the JAX package's keys;
* the flight recorder on ``MRError``, ``SIGUSR1`` and an exhausted retry
  budget, and with every ``torch.cuda`` entry point raising;
* the commands ``dump_trace``, ``dump_metrics`` and ``dump_plan``
  (whose text equals the JAX package's);
* the ``stage.<name>`` spans of InvertedIndex against its StageTimer."""

import io
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu import obs as jobs
from gpu_mapreduce_tpu.obs import context as jcontext
from gpu_mapreduce_tpu.oink import kernels as jkernels
from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.plan import clear_history as j_clear_history
from gpu_mapreduce_tpu_torch import InvertedIndex, MapReduce, MRError
from gpu_mapreduce_tpu_torch import OinkScript
from gpu_mapreduce_tpu_torch import obs
from gpu_mapreduce_tpu_torch.core.runtime import global_counters
from gpu_mapreduce_tpu_torch.obs import context, flight, metrics, tracer
from gpu_mapreduce_tpu_torch.oink import kernels
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch.plan import clear_history

BYTE_ARGS = ("npairs", "shuffle_sent_bytes", "shuffle_pad_bytes",
             "spill_write_bytes", "spill_read_bytes")


def _reset_all():
    for pkg in (obs, jobs):
        pkg.get_tracer().reset()
        pkg.metrics.reset()
        pkg.flight.reset()
        pkg.context.reset()


@pytest.fixture(autouse=True)
def obs_state():
    """Both packages' process-global tracer, registry, flight recorder
    and process context, reset before and after every test."""
    from gpu_mapreduce_tpu.obs import flight as _jf    # noqa: F401
    from gpu_mapreduce_tpu.obs import metrics as _jm   # noqa: F401
    _reset_all()
    yield
    _reset_all()


def emit(itask, kv, ptr):
    rng = np.random.default_rng(itask)
    keys = rng.integers(0, 97, size=500).astype(np.uint64)
    kv.add_batch(keys, keys * 10 + itask)


def tree(events):
    """Each span as (thread index, name, cat, depth, parent name, byte
    attributes), in emission order; threads numbered by first span."""
    byid = {e["id"]: e for e in events}
    tids: dict = {}
    out = []
    for e in events:
        depth, p = 0, e["parent"]
        parent = byid[p]["name"] if p in byid else None
        while p in byid:
            depth += 1
            p = byid[p]["parent"]
        tid = tids.setdefault(e["tid"], len(tids))
        out.append((tid, e["name"], e["cat"], depth, parent)
                   + tuple(e["args"].get(k) for k in BYTE_ARGS))
    return out


def job(MR, mesh, k, words):
    """Host frames through the eager ops, a wordfreq and a fused plan run
    cold then warm."""
    mr = MR(mesh())
    mr.map(6, emit)
    mr.aggregate()
    mr.convert()
    mr.reduce(k.count, batch=True)
    mr.map(6, emit)
    mr.collate()
    mr.map(6, emit)
    mr.compress(k.count, batch=True)
    wf = MR(mesh())
    wf.map_files([words], k.read_words)
    wf.collate()
    wf.reduce(k.count, batch=True)
    fused = MR(mesh(), fuse=1)
    for _ in range(2):
        fused.map(6, emit)
        fused.aggregate()
        fused.convert()
        fused.reduce(k.count, batch=True)
        fused.kv
    return mr


def _words(tmp_path) -> str:
    path = tmp_path / "w.txt"
    path.write_text("a b c a b a d e f g h a b\n" * 50)
    return str(path)


@pytest.mark.parametrize("prefetch", ["0", "1"])
@pytest.mark.parametrize("P", [1, 3])
def test_span_tree_matches_jax(P, prefetch, tmp_path, monkeypatch):
    monkeypatch.setenv("MRTPU_PREFETCH", prefetch)
    words = _words(tmp_path)
    got = {}
    for name, pkg, MR, mesh, k in (
            ("jax", jobs, lambda m, **kw: JMapReduce(m, **kw),
             lambda: j_make_mesh(P), jkernels),
            ("torch", obs, lambda m, **kw: MapReduce(comm=m, **kw),
             lambda: make_mesh(P, devices=["cpu"] * P), kernels)):
        jshuffle._SPEC_CACHE.clear()
        tshuffle._SPEC_CACHE.clear()
        tr = pkg.get_tracer()
        tr.enable()
        job(MR, mesh, k, words)
        got[name] = tree(tr.events())
    assert got["torch"] == got["jax"]
    names = {t[1] for t in got["torch"]}
    assert {"map", "map_files", "aggregate", "convert", "reduce",
            "collate", "compress", "plan.execute", "plan.group"} <= names
    if P > 1:
        assert {"shuffle.exchange", "shuffle.count_sync", "ingest.read",
                "ingest.h2d"} <= names
        if prefetch == "1":
            assert "exec.prefetch" in names


def test_wordfreq_mesh_trace_acceptance(tmp_path):
    """A traced wordfreq at P = 3 (JAX
    ``test_wordfreq_mesh_trace_acceptance``): a JSONL trace whose Chrome
    export is valid, with the exchange under aggregate carrying its
    bytes and plan."""
    jsonl = str(tmp_path / "wf.jsonl")
    mr = MapReduce(comm=make_mesh(3, devices=["cpu"] * 3), trace=jsonl)
    mr.map_files([_words(tmp_path)], kernels.read_words)
    mr.collate()
    mr.reduce(kernels.count, batch=True)
    evs = obs.read_jsonl(jsonl)
    names = {e["name"] for e in evs}
    assert {"map_files", "aggregate", "convert", "collate",
            "reduce", "shuffle.exchange"} <= names
    ex = next(e for e in evs if e["name"] == "shuffle.exchange")
    agg = next(e for e in evs if e["name"] == "aggregate")
    assert ex["parent"] == agg["id"]
    assert ex["args"]["sent_bytes"] > 0 and ex["args"]["pad_bytes"] >= 0
    assert ex["args"]["bucket"] > 0 and ex["args"]["nrounds"] >= 1
    assert agg["args"]["shuffle_sent_bytes"] == ex["args"]["sent_bytes"]
    doc = obs.chrome_trace(evs)
    json.loads(json.dumps(doc))
    assert len(doc["traceEvents"]) == len(evs)
    assert mr.stats()["ops"]["aggregate"]["count"] == 1


# -- sinks ----------------------------------------------------------------------

def _events(n, t0=0.0):
    return [{"name": f"ev{i}", "cat": "op", "ph": "X", "ts": t0 + i,
             "dur": 1.5, "pid": 1, "tid": 2, "id": i + 1, "parent": 0,
             "wall": 1.0e9 + i, "args": {"n": np.int64(i),
                                         "b": b"x\xff", "f": np.float32(2)}}
            for i in range(n)]


def test_jsonl_round_trip_between_packages(tmp_path):
    """Either package's JSONL trace reads in the other, and both Chrome
    exports are the same document."""
    evs = _events(20)
    tp, jp = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    for path, pkg in ((tp, obs), (jp, jobs)):
        sink = pkg.JsonlSink(path, max_bytes=0)
        for ev in evs:
            sink.emit(ev)
        sink.close()
    assert open(tp).read() == open(jp).read()
    assert obs.read_jsonl(jp) == jobs.read_jsonl(tp)
    with open(tp, "a") as f:
        f.write('{"name": "torn')          # a killed run's last line
    assert len(obs.read_jsonl(tp)) == 20
    assert obs.chrome_trace(evs) == jobs.chrome_trace(evs)
    out = str(tmp_path / "chrome.json")
    assert obs.write_chrome_trace(out, evs) == 20
    doc = json.load(open(out))
    assert doc["displayTimeUnit"] == "ms"
    assert [e["name"] for e in doc["traceEvents"]] == \
        [f"ev{i}" for i in range(20)]
    assert all(e["ph"] == "X" for e in doc["traceEvents"])


def test_jsonl_rotation_under_max_mb(tmp_path, monkeypatch):
    monkeypatch.setenv("MRTPU_TRACE_MAX_MB", "0.002")
    monkeypatch.setenv("MRTPU_TRACE_KEEP", "2")
    path = str(tmp_path / "t.jsonl")
    sink = obs.JsonlSink(path)
    assert sink.max_bytes == int(0.002 * (1 << 20)) and sink.keep == 2
    rotated = metrics.get_registry().counter("mrtpu_trace_rotated_total")
    before = rotated.value()
    for ev in _events(300):
        sink.emit(ev)
    sink.close()
    assert sink.rotations >= 2
    assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
    assert not os.path.exists(path + ".3")
    tail = obs.read_jsonl(path + ".2") + obs.read_jsonl(path + ".1") \
        + obs.read_jsonl(path)
    names = [e["name"] for e in tail]
    assert names == [f"ev{i}" for i in range(300 - len(names), 300)]
    assert rotated.value() - before == sink.rotations


def test_disabled_tracing_is_the_null_span():
    tr = obs.get_tracer()
    assert not tr.enabled
    assert tr.span("x") is obs.NULL_SPAN
    with tr.span("x") as sp:
        sp.set(a=1)
    mr = MapReduce(device="cpu")
    mr.map(2, emit)
    mr.aggregate()
    assert tr.events() == []
    assert "ops" not in mr.stats()


# -- the card's side of a span -----------------------------------------------------

def test_span_is_a_profiler_range():
    tr = obs.get_tracer().enable()
    mr = MapReduce(device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mr.map(2, emit)
        mr.aggregate()
        mr.convert()
    keys = {e.key for e in prof.key_averages()}
    assert {"map", "aggregate", "convert"} <= keys
    assert [e["name"] for e in tr.events()] == ["map", "aggregate",
                                                "convert"]


def test_nvtx_ranges_decided_from_is_available(monkeypatch):
    """NVTX is on exactly when ``torch.cuda.is_available()`` says so at
    the tracer's construction: each span pushes and pops its range on
    its own thread, and no span synchronises the device."""
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(
                            ("push", name, threading.get_ident())))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(
                            ("pop", None, threading.get_ident())))

    def no_sync(*a, **kw):
        raise AssertionError("a span synchronised the device")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    assert not tracer.Tracer().nvtx            # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tr = tracer.Tracer().enable()
    assert tr.nvtx
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    t = threading.Thread(target=lambda: tr.span("side").__enter__()
                         .__exit__(None, None, None))
    t.start()
    t.join()
    me, other = threading.get_ident(), t.ident
    assert [(k, n) for k, n, _ in calls] == [
        ("push", "outer"), ("push", "inner"), ("pop", None),
        ("pop", None), ("push", "side"), ("pop", None)]
    assert [tid for _, _, tid in calls] == [me] * 4 + [other] * 2
    monkeypatch.setenv("MRTPU_TRACE_JAX", "0")
    assert not tracer.Tracer().nvtx            # the knob turns both off
    assert not tracer.Tracer().annotations


# -- request context ---------------------------------------------------------------

def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) and k not in
            ("retries", "plan_cache", "straggler", "stages") else None
            for k, v in d.items()}


def test_request_scope_charges_exactly_this_scope():
    with context.request_scope(tenant="t", label="a") as acct:
        global_counters().add(cssize=100, cspad=10, wsize=7, ndispatch=3)
        global_counters().mem(4096)
        global_counters().mem(-4096)
    prof = acct.profile()
    assert prof["exchange"]["sent_bytes"] == 100
    assert prof["exchange"]["pad_bytes"] == 10
    assert prof["spill"]["write_bytes"] == 7
    assert prof["dispatches"] == 3
    assert prof["hbm"]["hi_water_bytes"] == 4096
    assert prof["tenant"] == "t" and prof["trace_id"]
    global_counters().add(cssize=999)
    assert acct.profile()["exchange"]["sent_bytes"] == 100
    # the JAX package's profile, key for key
    assert _keys(prof) == _keys(jcontext.RequestAccount().profile())


def test_two_threads_never_bleed():
    accounts = {}
    barrier = threading.Barrier(2)

    def work(name, n, nbytes):
        with context.request_scope(label=name) as acct:
            accounts[name] = acct
            barrier.wait()
            for _ in range(n):
                global_counters().add(cssize=nbytes, ndispatch=1)
    ts = [threading.Thread(target=work, args=("a", 200, 13)),
          threading.Thread(target=work, args=("b", 300, 7))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    pa, pb = accounts["a"].profile(), accounts["b"].profile()
    assert pa["exchange"]["sent_bytes"] == 200 * 13
    assert pb["exchange"]["sent_bytes"] == 300 * 7
    assert pa["dispatches"] == 200 and pb["dispatches"] == 300
    assert pa["trace_id"] != pb["trace_id"]


def test_worker_threads_carry_the_submitting_trace(tmp_path):
    from gpu_mapreduce_tpu_torch.exec.prefetch import prefetch_iter
    from gpu_mapreduce_tpu_torch.exec.spill import SpillWriter, atomic_save
    jsonl = str(tmp_path / "t.jsonl")
    obs.get_tracer().enable(jsonl=jsonl)
    me = threading.get_ident() & 0x7FFFFFFF
    with context.request_scope(label="consumer") as acct:
        assert list(prefetch_iter(iter(range(32)), depth=2)) == \
            list(range(32))
        w = SpillWriter(path="spill")
        w.submit(lambda: atomic_save(str(tmp_path / "run0.npy"),
                                     np.arange(64, dtype=np.uint64))).wait()
        w.close()
        # mapstyle-2 pool tasks charge the request
        mr = MapReduce(device="cpu", mapstyle=2)

        def cb(itask, kv, ptr):
            global_counters().add(cssize=11)
            kv.add(str(itask), "x")
        mr.map(8, cb)
    evs = obs.read_jsonl(jsonl)
    for name in ("exec.prefetch", "exec.spill_write"):
        ev = next(e for e in evs if e["name"] == name)
        assert ev["trace"] == acct.trace_id and ev["tid"] != me, name
    assert {e.get("trace") for e in evs} == {acct.trace_id}
    assert acct.profile()["exchange"]["sent_bytes"] == 8 * 11


def test_mesh_ingest_pool_charges_the_request(tmp_path):
    """map_files on a mesh under mapstyle 2: every file's task runs on the
    pool under the submitting request."""
    paths = []
    for i in range(6):
        p = tmp_path / f"f{i}.txt"
        p.write_text("x y z\n" * (i + 1))
        paths.append(str(p))
    with context.request_scope(label="pooled") as acct:
        mr = MapReduce(comm=make_mesh(3, devices=["cpu"] * 3), mapstyle=2)

        def cb(itask, fname, kv, ptr):
            global_counters().add(cssize=5)
            kv.add(itask, 1)
        assert mr.map_files(paths, cb) == 6
    assert acct.profile()["exchange"]["sent_bytes"] == 6 * 5


def test_oink_script_is_one_trace_and_journal_stamps(tmp_path,
                                                     monkeypatch):
    from gpu_mapreduce_tpu_torch.ft import journal
    jdir = tmp_path / "journal"
    monkeypatch.setenv("MRTPU_JOURNAL", str(jdir))
    words = _words(tmp_path)
    tr = obs.get_tracer().enable()
    script = f"wordfreq 2 -i {words} -o NULL NULL\n"
    OinkScript(device="cpu", screen=False).run_string(script)
    ids = {e.get("trace") for e in tr.events()}
    assert len(ids) == 1 and None not in ids
    (tid,) = ids
    assert "oink.wordfreq" in {e["name"] for e in tr.events()}
    recs = journal.read_journal(str(jdir))
    assert recs and all(r.get("trace") == tid for r in recs), recs
    # a second top-level script is another request
    tr.clear()
    monkeypatch.delenv("MRTPU_JOURNAL")
    OinkScript(device="cpu", screen=False).run_string(script)
    ids2 = {e.get("trace") for e in tr.events()}
    assert len(ids2) == 1 and ids2 != ids


def test_process_context_and_profile_knob(monkeypatch):
    tr = obs.get_tracer().enable()
    mr = MapReduce(device="cpu")
    mr.map(1, emit)
    evs = tr.events()
    assert {e["trace"] for e in evs} == \
        {context.active_account().trace_id}
    monkeypatch.setenv("MRTPU_PROFILE", "0")
    context.reset()
    tr.clear()
    mr.map(1, emit)
    assert all(e.get("trace") is None for e in tr.events())
    assert context.active_account() is None


def test_cancel_stops_at_the_next_barrier():
    from gpu_mapreduce_tpu_torch.core.runtime import CancelledError
    mr = MapReduce(device="cpu")
    with context.request_scope() as acct:
        mr.map(1, emit)
        acct.cancel("client")
        with pytest.raises(CancelledError, match="client"):
            mr.aggregate()
        assert isinstance(CancelledError("x"), MRError)


# -- flight recorder ---------------------------------------------------------------

def _traced_ops():
    mr = MapReduce(device="cpu")
    mr.map(1, lambda i, kv, p: kv.add_batch(
        np.arange(64, dtype=np.uint64), np.ones(64, np.uint64)))
    mr.sort_keys(1)
    return mr


def _excepthook(exc):
    try:
        raise exc
    except MRError:
        sys.excepthook(*sys.exc_info())


def test_flight_dump_on_mrerror_and_device_error(tmp_path):
    from gpu_mapreduce_tpu_torch.core.runtime import DeviceError
    rec = flight.enable(dir=str(tmp_path))
    with context.request_scope() as acct:
        _traced_ops()
        _excepthook(MRError("induced failure"))
    doc = json.load(open(rec.last_dump))
    assert doc["reason"] == "unhandled:MRError"
    assert doc["trace_id"] == acct.trace_id
    ring = obs.get_tracer().events()
    assert [e["name"] for e in doc["spans"]][-len(ring):] == \
        [e["name"] for e in ring]
    assert "sort_keys" in [e["name"] for e in doc["spans"]]
    # the JAX package's artifact keys
    assert set(doc) >= {"reason", "utc", "pid", "argv", "trace_id",
                        "counters", "spans", "plan"}
    _excepthook(DeviceError("kernel did not launch"))
    assert json.load(open(rec.last_dump))["reason"] == \
        "unhandled:DeviceError"


def test_flight_dump_on_sigusr1(tmp_path):
    rec = flight.enable(dir=str(tmp_path))
    _traced_ops()
    os.kill(os.getpid(), signal.SIGUSR1)
    for _ in range(500):
        if rec.last_dump:
            break
        time.sleep(0.01)
    doc = json.load(open(rec.last_dump))
    assert doc["reason"] == "SIGUSR1"
    assert any(e["name"] == "sort_keys" for e in doc["spans"])


def test_exhausted_retry_budget_dumps_the_ft_span(tmp_path, monkeypatch):
    from gpu_mapreduce_tpu_torch import ft
    from gpu_mapreduce_tpu_torch.ft import retry as ftr
    metrics.enable_metrics(flight=False)
    rec = flight.enable(dir=str(tmp_path))
    monkeypatch.setattr(ftr, "_sleep", lambda s: None)
    ft.reset()
    ft.set_budget("spill.read", 2)
    try:
        _traced_ops()

        def torn_block():
            raise OSError("torn block read")
        with pytest.raises(MRError) as ei:
            ft.retry_call("spill.read", torn_block, detail="run-7.k.npy")
        _excepthook(ei.value)
        doc = json.load(open(rec.last_dump))
        assert doc["reason"] == "unhandled:MRError"
        spans = [e for e in doc["spans"] if e["name"] == "ft.retry"]
        assert spans[-1]["args"]["site"] == "spill.read"
        assert spans[-1]["args"]["outcome"] == "exhausted"
        assert spans[-1]["args"]["detail"] == "run-7.k.npy"
        got = {(s["labels"]["site"], s["labels"]["outcome"]): s["value"]
               for s in doc["metrics"]["mrtpu_retries_total"]["samples"]}
        assert got[("spill.read", "exhausted")] == 1
        assert got[("spill.read", "retry")] == 2
    finally:
        ft.reset()


def test_flight_dump_never_raises(tmp_path):
    rec = flight.enable(dir=str(tmp_path / ("no" * 200)))
    assert rec.dump("broken") is None


def test_flight_dump_touches_nothing_on_the_card(tmp_path, monkeypatch):
    """After a CUDA fault every CUDA call raises again: with every
    ``torch.cuda`` entry point patched to raise, the dump is written."""
    rec = flight.enable(dir=str(tmp_path))
    metrics.enable_metrics(flight=False)
    _traced_ops()

    def fault(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")
    for name in dir(torch.cuda):
        obj = getattr(torch.cuda, name)
        if callable(obj) and not isinstance(obj, type) \
                and not name.startswith("_"):
            monkeypatch.setattr(torch.cuda, name, fault)
    path = rec.dump("device_fault")
    assert path is not None
    doc = json.load(open(path))
    assert doc["reason"] == "device_fault"
    assert "sort_keys" in [e["name"] for e in doc["spans"]]
    assert "mrtpu_hbm_hiwater_bytes" in doc["metrics"]


# -- the commands ----------------------------------------------------------------

def test_dump_trace_and_dump_metrics_commands(tmp_path):
    words = _words(tmp_path)
    out, mj, mp = (tmp_path / "trace.json", tmp_path / "m.json",
                   tmp_path / "m.prom")
    obs.get_tracer().enable()
    screen = io.StringIO()
    OinkScript(device="cpu", screen=screen).run_string(
        f"dump_metrics {mj}\n"
        f"wordfreq 2 -i {words} -o NULL NULL\n"
        f"dump_trace {out}\n"
        f"dump_metrics {mp}\n")
    names = {e["name"] for e in json.load(open(out))["traceEvents"]}
    assert {"oink.wordfreq", "map_files", "collate", "reduce"} <= names
    assert "registry armed just now" in screen.getvalue()
    assert "DumpTrace:" in screen.getvalue()
    assert "mrtpu_plan_cache_hit_ratio" in json.load(open(mj))
    prom = mp.read_text()
    assert "# TYPE mrtpu_op_latency_seconds histogram" in prom
    assert 'mrtpu_op_latency_seconds_bucket{op="oink.wordfreq"' in prom


@pytest.mark.parametrize("P", [1, 3])
def test_dump_plan_text_equals_jax(P, tmp_path):
    words = _words(tmp_path)
    script = ("set fuse 1\n"
              f"variable files index {words}\n"
              "wordfreq 3 -i v_files -o NULL NULL\n"
              "wordfreq 3 -i v_files -o NULL NULL\n"
              "dump_plan {out}\n")
    text = {}
    for name, cls, kw, clear in (
            ("jax", JOinkScript, {"comm": j_make_mesh(P)},
             j_clear_history),
            ("torch", OinkScript,
             {"comm": make_mesh(P, devices=["cpu"] * P)}, clear_history)):
        jshuffle._SPEC_CACHE.clear()
        tshuffle._SPEC_CACHE.clear()
        clear()
        out = tmp_path / f"plan.{name}.txt"
        cls(screen=io.StringIO(), **kw).run_string(script.format(out=out))
        text[name] = out.read_text()
    assert text["torch"] == text["jax"]
    assert "cache: HIT" in text["torch"]
    assert ("[exchange" in text["torch"]) == (P > 1)


# -- InvertedIndex stages ----------------------------------------------------------

def test_stage_spans_match_stage_timer(tmp_path):
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    paths, _, _ = make_corpus(str(tmp_path), 1, skew=True)
    tr = obs.get_tracer().enable()
    ii = InvertedIndex(device="cpu")
    ii.run(paths)
    stages = {}
    for e in tr.events():
        if e["name"].startswith("stage."):
            assert e["cat"] == "app"
            name = e["name"][len("stage."):]
            stages[name] = stages.get(name, 0.0) + e["dur"] / 1e6
    assert stages and set(stages) == set(ii.timer.times)
    for name, secs in ii.timer.times.items():
        assert abs(stages[name] - secs) <= max(0.02 * secs, 1e-3), name
