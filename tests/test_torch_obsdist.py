"""The port's fleet observability (``gpu_mapreduce_tpu_torch/obs/
fleetobs.py`` and its hooks in ``parallel/dist.py`` and ``launch.py``)
against the JAX package's.

* the straggler classes, ``SyncObserver``'s spread, slowest rank and
  cause, torn peer lines, its metrics and the request's ``straggler``
  section;
* ``note_sync_rows`` folding 2 ranks × 2 shards onto the ranks;
* the rank metrics dump (read back by either package), the fleet
  table's ``federate_text`` (byte-equal to the JAX package's, escaping
  included), ``read_trace_dir`` (equal to ``scripts/trace_view.py``'s);
* the flight recorder's lease table;
* a 2-rank ``launch.py --device cpu`` run over gloo: one trace id across
  ``launch.json``, both trace shards and both rank dumps (reason
  ``done``), with the sync records every rank left."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gpu_mapreduce_tpu import obs as jobs
from gpu_mapreduce_tpu.obs import fleetobs as jfleet
from gpu_mapreduce_tpu_torch import obs
from gpu_mapreduce_tpu_torch.obs import context, flight, fleetobs, metrics
from gpu_mapreduce_tpu_torch.parallel import dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset_all():
    from gpu_mapreduce_tpu.obs import context as jc, flight as jf
    for tr, m, f, c in ((obs.get_tracer(), metrics, flight, context),
                        (jobs.get_tracer(), jobs.metrics, jf, jc)):
        tr.reset()
        m.reset()
        f.reset()
        c.reset()


@pytest.fixture(autouse=True)
def obs_state():
    _reset_all()
    yield
    _reset_all()


@pytest.mark.parametrize("slowest,rows,ratio", [
    (2, [10, 10, 100], None), (2, [10, 10, 12], None), (0, [], None),
    (5, [1, 2], None), (1, [0, 0, 0], None), (1, [1, 3, 1], "1.5"),
    (1, [1, 3, 1], "4")])
def test_classify_straggler_matches_jax(slowest, rows, ratio,
                                        monkeypatch):
    if ratio:
        monkeypatch.setenv("MRTPU_DIST_SKEW_RATIO", ratio)
    assert fleetobs.classify_straggler(slowest, rows) == \
        jfleet.classify_straggler(slowest, rows)


def _stamp(rundir, rank, site, seq, ts, gen=0, torn=False):
    """A peer's arrival record, as its SyncObserver writes it."""
    path = fleetobs.sync_path(rundir, rank, gen)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = json.dumps({"site": site, "seq": seq, "rank": rank,
                       "ts": ts}).encode()
    with open(path, "ab") as f:
        f.write(data[:-4] if torn else data + b"\n")


def test_sync_observer_spread_slowest_and_cause(tmp_path):
    rundir = str(tmp_path)
    ob = fleetobs.SyncObserver(rundir, rank=0, world=3)
    try:
        with context.request_scope(label="t") as acct:
            rec = ob.arrive("exchange")
            _stamp(rundir, 1, "exchange", 0, rec["ts"] + 0.01)
            _stamp(rundir, 2, "exchange", 0, rec["ts"] + 0.5)
            out = ob.complete("exchange", rec)
            assert out["slowest"] == 2 and out["ranks_seen"] == 3
            assert 0.45 <= out["spread_s"] <= 0.55
            assert out["cause"] == "host_slow"
            ob.note_rows([10, 10, 100])
            rec = ob.arrive("exchange")
            assert rec["seq"] == 1 and rec["rows"] == 10
            _stamp(rundir, 1, "exchange", 1, rec["ts"] + 0.01)
            _stamp(rundir, 2, "exchange", 1, rec["ts"] + 0.5)
            out = ob.complete("exchange", rec)
            assert out["cause"] == "data_skew" and out["slowest"] == 2
            prof = acct.profile()
        spreads = [r for r in fleetobs.read_sync_records(rundir)
                   if r.get("kind") == "spread"]
        assert [r["cause"] for r in spreads] == ["host_slow", "data_skew"]
        # the JAX package reads the same records
        assert jfleet.read_sync_records(rundir) == \
            fleetobs.read_sync_records(rundir)
        snap = metrics.snapshot()
        assert snap["mrtpu_dist_sync_total"]["samples"][0]["value"] == 2
        assert snap["mrtpu_dist_sync_slowest_rank"]["samples"][0][
            "value"] == 2
        causes = {s["labels"]["cause"] for s in
                  snap["mrtpu_dist_sync_straggler_total"]["samples"]}
        assert causes == {"host_slow", "data_skew"}
        row = prof["straggler"]["exchange"]
        assert row["count"] == 2 and row["slowest_rank"] == 2
        assert row["ranks_seen"] == 3 and row["max_spread_s"] >= 0.45
    finally:
        ob.close()


def test_sync_observer_torn_peer_lines_and_no_evidence(tmp_path):
    rundir = str(tmp_path)
    ob = fleetobs.SyncObserver(rundir, rank=0, world=2)
    try:
        rec = ob.arrive("count_sync")
        _stamp(rundir, 1, "count_sync", 0, rec["ts"] + 0.1, torn=True)
        assert ob.complete("count_sync", rec) is None
        with open(fleetobs.sync_path(rundir, 1), "wb") as f:
            f.write(json.dumps({"site": "count_sync", "seq": 0, "rank": 1,
                                "ts": rec["ts"] + 0.1}).encode() + b"\n")
        out = ob.complete("count_sync", rec)
        assert out is not None and out["slowest"] == 1
    finally:
        ob.close()


def test_note_sync_rows_folds_shards_onto_ranks(tmp_path):
    rt = dist.DistRuntime(0, 2, str(tmp_path), heartbeat_s=0.1,
                          lease_s=1.0, skew_s=0.1)
    rt.sync_obs = fleetobs.SyncObserver(str(tmp_path), 0, 2)
    prev = dist.activate(rt)
    try:
        # P = 4 shards over 2 ranks: columns 0+1 → rank 0, 2+3 → rank 1
        mat = np.arange(16).reshape(4, 4)
        dist.note_sync_rows(mat)
        assert rt.sync_obs._rows == [24 + 28, 32 + 36]
        dist.note_sync_rows(np.arange(4).reshape(2, 2))   # one a rank
        assert rt.sync_obs._rows == [2, 4]
    finally:
        dist.activate(prev)
        rt.sync_obs.close()


def test_rank_metrics_dump_round_trip(tmp_path):
    context.set_process_trace_id("feedbeef01020304")
    metrics.get_registry().counter("t_obsdist_total", "t").inc(3)
    d = fleetobs.RankMetricsDumper(str(tmp_path), rank=2, gen=1,
                                   every_s=30.0)
    assert os.path.exists(d.dump_once("start"))
    d.stop("done")
    d.stop("exit")                     # the first reason wins
    for read in (fleetobs.read_rank_dumps, jfleet.read_rank_dumps):
        dumps = read(str(tmp_path))
        assert list(dumps) == [2]
        doc = dumps[2]
        assert (doc["rank"], doc["gen"], doc["reason"]) == (2, 1, "done")
        assert doc["trace_id"] == "feedbeef01020304"
        assert doc["metrics"]["t_obsdist_total"]["samples"][0][
            "value"] == 3
    assert fleetobs.rank_dump_stale(doc) < 5.0
    assert fleetobs.rank_dump_stale({"ts": "bogus"}) == float("inf")


def test_process_trace_id_outranks_the_profile_gate(monkeypatch):
    monkeypatch.setenv("MRTPU_PROFILE", "0")
    context.reset()
    assert context.current_trace_id() is None
    context.set_process_trace_id("aa00aa00aa00aa00")
    assert context.current_trace_id() == "aa00aa00aa00aa00"


def _counter_snap(name, value, labels=None):
    return {name: {"type": "counter", "help": "h",
                   "labelnames": sorted(labels or {}),
                   "samples": [{"labels": labels or {}, "value": value}]}}


def _members(mod):
    return [
        mod.member_row(replica="a", up=True, stale=False, age_s=0.2,
                       metrics=_counter_snap("x_total", 7,
                                             {"site": "exchange"}),
                       state="ready"),
        mod.member_row(replica='we"ird\\x\n', up=False, stale=True,
                       age_s=12.5, metrics=None, state="expired"),
        mod.member_row(rank="1", up=True, stale=False, age_s=1.0,
                       metrics={"lat_seconds": {
                           "type": "histogram", "help": "hh",
                           "labelnames": [], "samples": [{
                               "labels": {}, "count": 2, "sum": 0.5,
                               "buckets": {"0.1": 1, "+Inf": 2}}]},
                           **_counter_snap("x_total", 2.5,
                                           {"site": "c"})}),
    ]


def test_federate_text_equals_jax():
    text = fleetobs.federate_text(_members(fleetobs))
    assert text == jfleet.federate_text(_members(jfleet))
    assert 'mrtpu_fleet_member_up{replica="a",rank=""} 1' in text
    assert 'mrtpu_fleet_member_stale{replica="we\\"ird\\\\x\\n",rank=""}' \
        ' 1' in text
    assert 'x_total{site="exchange",replica="a",rank=""} 7' in text
    assert 'x_total{site="c",replica="",rank="1"} 2.5' in text
    assert 'lat_seconds_bucket{replica="",rank="1",le="0.1"} 1' in text
    assert text.count("# TYPE x_total counter") == 1


def _trace_view():
    spec = importlib.util.spec_from_file_location(
        "trace_view", os.path.join(ROOT, "scripts", "trace_view.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_read_trace_dir_rebases_like_trace_view(tmp_path):
    rundir = str(tmp_path)
    shards = {0: [{"name": "a", "id": 7, "parent": 0, "ts": 0.0,
                   "dur": 100.0, "wall": 1000.0, "trace": "t1"},
                  {"name": "b", "id": 8, "parent": 7, "ts": 500.0,
                   "dur": 50.0, "wall": 1000.0005, "trace": "t1"}],
              1: [{"name": "a", "id": 7, "parent": 0, "ts": 0.0,
                   "dur": 100.0, "wall": 1000.2, "trace": "t1"}]}
    for rank, evs in shards.items():
        with open(os.path.join(rundir, f"trace-r{rank}.jsonl"), "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        with open(os.path.join(rundir, f"trace-r{rank}.jsonl"), "a") as f:
            f.write('{"name": "torn')
    events, n = fleetobs.read_trace_dir(rundir)
    assert (events, n) == _trace_view().read_trace_dir(rundir)
    assert n == 2 and [e["rank"] for e in events] == [0, 0, 1]
    r0a, r0b, r1a = events
    assert r0a["ts"] == 0.0 and r0b["ts"] == 500.0
    assert abs(r1a["ts"] - 200000.0) < 1.0
    assert r0a["id"] != r1a["id"] and r0b["parent"] == r0a["id"]


def test_flight_snapshot_embeds_the_lease_table(tmp_path):
    rundir = str(tmp_path)
    rt = dist.DistRuntime(0, 2, rundir, heartbeat_s=0.1, lease_s=1.0,
                          skew_s=0.1)
    dist.write_beat(rundir, 0, 1.0)
    prev = dist.activate(rt)
    try:
        doc = flight.enable(dir=rundir).snapshot("test")
        table = doc["dist"]
        assert table["rank"] == 0 and table["world"] == 2
        assert table["peers"]["1"].get("missing") is True
        assert table["peers"]["1"]["expired"] is True
        assert table["peers"]["0"]["expired"] is False
        assert "1" in table["dead"]
    finally:
        dist.activate(prev)


def test_two_rank_launch_has_one_trace_id(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_dist import _expected_output, _write_corpus
    corpus = _write_corpus(str(tmp_path / "c.txt"))
    run, out = tmp_path / "run", tmp_path / "out.txt"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for k in ("MRTPU_FAULTS", "MRTPU_DIST_TRACE_ID", "MRTPU_FLIGHT",
              "MRTPU_TRACE"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "gpu_mapreduce_tpu_torch.launch", "--np",
         "2", "--rundir", str(run), "--device", "cpu", "wordfreq",
         "--files", corpus, "--out", str(out), "--chunks", "4"],
        env=env, cwd=ROOT, capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert out.read_bytes() == _expected_output([corpus])
    with open(run / "launch.json") as f:
        tid = json.load(f)["trace_id"]
    assert len(tid) == 16
    events, n = fleetobs.read_trace_dir(str(run))
    assert n == 2 and events
    assert {e["trace"] for e in events} == {tid}
    assert {e["rank"] for e in events} == {0, 1}
    assert {"shuffle.exchange", "shuffle.count_sync"} <= \
        {e["name"] for e in events}
    dumps = fleetobs.read_rank_dumps(str(run))
    assert sorted(dumps) == [0, 1]
    for rank, doc in dumps.items():
        assert doc["trace_id"] == tid and doc["reason"] == "done"
        assert doc["metrics"]["mrtpu_dist_world"]["samples"][0][
            "value"] == 2
        assert doc["metrics"]["mrtpu_dist_rank"]["samples"][0][
            "value"] == rank
        assert doc["metrics"]["mrtpu_dist_heartbeats_total"]["samples"][
            0]["value"] >= 1
    recs = fleetobs.read_sync_records(str(run))
    arrivals = [r for r in recs if "kind" not in r]
    spreads = [r for r in recs if r.get("kind") == "spread"]
    assert {r["rank"] for r in arrivals} == {0, 1}
    assert {r["site"] for r in arrivals} >= {"count_sync", "exchange"}
    assert spreads and all(r["ranks_seen"] == 2 for r in spreads)
