"""The port's metrics registry, its endpoint and its feeds against the JAX
package's (``gpu_mapreduce_tpu_torch/obs/metrics.py``, ``httpd.py``).

* the same registry calls give byte-equal Prometheus text and equal
  snapshots in both packages;
* after the same mesh job and the same ``fuse=1`` plan, the same metric
  names and label sets (the JAX package's XLA program caches aside) and
  equal exchange counters, which also equal the port's ``mr.stats()``;
* the registry under a thread hammer, the endpoint's scrape round trip
  on port 0, the snapshotter, one span bridge under racing enables;
* ``MRTPU_SLO``: a malformed objective is refused in both packages, a
  valid one arms the same SLO engine and its burn gauge;
* the catalog: every ``mrtpu_*`` name in the port is in
  ``doc/observability.md``, and every catalog name is in the port but
  those of modules not ported yet, listed here by name."""

import glob
import json
import os
import re
import threading
import urllib.request

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu import obs as jobs
from gpu_mapreduce_tpu.obs import context as _jcontext  # noqa: F401
from gpu_mapreduce_tpu.obs import flight as _jflight  # noqa: F401
from gpu_mapreduce_tpu.obs import metrics as jmetrics
from gpu_mapreduce_tpu.oink import kernels as jkernels
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.plan import cache as jcache
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu_torch import MapReduce, MRError
from gpu_mapreduce_tpu_torch import obs
from gpu_mapreduce_tpu_torch.obs import (context, flight,  # noqa: F401
                                          httpd, metrics)
from gpu_mapreduce_tpu_torch.oink import kernels
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch.plan import cache as tcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's compiled-program caches, which the port has no
# counterpart of (it compiles no programs)
JAX_ONLY_CACHES = {"shuffle_phase1", "shuffle_phase2"}

# catalog names whose owners are not ported yet: the serve fleet
# (serve/fleet.py, serve/router.py) and its federation
NOT_PORTED = {
    "mrtpu_fleet_replicas", "mrtpu_fleet_failovers_total",
    "mrtpu_fleet_failover_seconds", "mrtpu_fleet_fenced_total",
    "mrtpu_fleet_router_total",
}


def _reset_all():
    for pkg in (obs, jobs):
        pkg.get_tracer().reset()
        pkg.metrics.reset()
        pkg.flight.reset()
        pkg.context.reset()
    for cache in (tcache, jcache):
        cache.reset_fusion_stats()


@pytest.fixture(autouse=True)
def obs_state():
    _reset_all()
    yield
    _reset_all()


def emit(itask, kv, ptr):
    rng = np.random.default_rng(itask)
    keys = rng.integers(0, 97, size=500).astype(np.uint64)
    kv.add_batch(keys, keys * 10 + itask)


# -- the registry ------------------------------------------------------------------

def _same_calls(reg):
    c = reg.counter("c_total", "a counter", ("op",))
    c.inc(3, op='x"y\n\\z')
    c.inc(2, op="plain")
    g = reg.gauge("g", "a gauge")
    g.set(1.5)
    g.inc(2)
    reg.gauge("big", "a large value").set(2 ** 53 + 1.0)
    reg.gauge("neg", "", ("k",)).set(-0.125, k="a")
    h = reg.histogram("h_seconds", "a histogram", ("op",),
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0, 1.0):
        h.observe(v, op="a")
    h.observe(0.3, op="b")
    reg.histogram("dflt", "default buckets").observe(0.003)
    reg.counter("nohelp").inc()
    return reg


def test_prometheus_text_byte_equal_to_jax():
    t = _same_calls(metrics.MetricsRegistry())
    j = _same_calls(jmetrics.MetricsRegistry())
    assert t.prometheus_text() == j.prometheus_text()
    assert json.dumps(t.collect(), sort_keys=True) == \
        json.dumps(j.collect(), sort_keys=True)
    txt = t.prometheus_text()
    assert 'c_total{op="x\\"y\\n\\\\z"} 3' in txt
    assert 'h_seconds_bucket{op="a",le="+Inf"} 5' in txt
    assert "\ng 3.5\n" in txt


def test_registry_thread_hammer():
    reg = metrics.MetricsRegistry()
    c = reg.counter("h_total", "hammered counter", ("worker",))
    g = reg.gauge("h_gauge", "hammered gauge")
    h = reg.histogram("h_lat", "hammered histogram", ("worker",),
                      buckets=(0.001, 0.01, 1.0))
    nthreads, per = 8, 4000

    def work(w):
        lab = str(w % 2)
        for i in range(per):
            c.inc(1, worker=lab)
            g.inc(1)
            h.observe(0.0005 if i % 2 else 0.5, worker=lab)
    threads = [threading.Thread(target=work, args=(w,))
               for w in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = sum(s["value"] for s in c.samples())
    assert total == nthreads * per
    assert c.value(worker="0") == c.value(worker="1") == total // 2
    assert g.value() == nthreads * per
    for s in h.samples():
        assert s["buckets"]["0.001"] == s["count"] // 2
        assert s["buckets"]["+Inf"] == s["count"]


def test_registry_refuses_mismatches():
    reg = metrics.MetricsRegistry()
    c = reg.counter("m", "x", ("a",))
    for bad in (lambda: c.inc(1), lambda: c.inc(1, a="1", b="2"),
                lambda: c.inc(-1, a="1"), lambda: reg.gauge("m")):
        with pytest.raises(ValueError):
            bad()
    assert reg.counter("m", labelnames=("a",)) is c
    reg.histogram("hh", buckets=(0.1, 1.0))
    with pytest.raises(ValueError):
        reg.histogram("hh", buckets=(0.5,))


# -- the feeds ---------------------------------------------------------------------

def _job(MR, mesh, k, words):
    mr = MR(mesh())
    mr.map(6, emit)
    mr.aggregate()
    mr.convert()
    mr.reduce(k.count, batch=True)
    mr.map_files([words], k.read_words)
    mr.collate()
    fused = MR(mesh(), fuse=1)
    for _ in range(2):
        fused.map(6, emit)
        fused.aggregate()
        fused.convert()
        fused.reduce(k.count, batch=True)
        fused.kv
    return fused


def _labels(snap):
    out = {}
    for name, fam in snap.items():
        out[name] = {json.dumps(s["labels"], sort_keys=True)
                     for s in fam["samples"]
                     if s["labels"].get("cache") not in JAX_ONLY_CACHES}
    return out


@pytest.mark.parametrize("P", [1, 3])
def test_same_metrics_as_jax_after_the_same_job(P, tmp_path):
    words = tmp_path / "w.txt"
    words.write_text("a b c a b a d e f g h a b\n" * 50)
    snaps, stats = {}, {}
    # both packages' process-cumulative sources start from here: the
    # exec/ overlap records, the ft/ counters and the spill bytes the
    # bridge has counted
    from gpu_mapreduce_tpu import exec as jexec, ft as jft
    from gpu_mapreduce_tpu_torch import exec as texec, ft as tft
    from gpu_mapreduce_tpu.core.runtime import global_counters as jgc
    from gpu_mapreduce_tpu_torch.core.runtime import global_counters as tgc
    for ex, ft, m, gc in ((jexec, jft, jmetrics, jgc),
                          (texec, tft, metrics, tgc)):
        ex.reset_stats()
        ft.reset()
        snap = gc().snapshot()
        m._SPILL_SEEN.update(wsize=snap["wsize"], rsize=snap["rsize"])
    for name, m, MR, mesh, k in (
            ("jax", jmetrics, lambda me, **kw: JMapReduce(me, **kw),
             lambda: j_make_mesh(P), jkernels),
            ("torch", metrics, lambda me, **kw: MapReduce(comm=me, **kw),
             lambda: make_mesh(P, devices=["cpu"] * P), kernels)):
        jshuffle._SPEC_CACHE.clear()
        tshuffle._SPEC_CACHE.clear()
        m.enable_metrics(flight=False)
        c0 = (jgc if name == "jax" else tgc)().snapshot()
        mr = _job(MR, mesh, k, str(words))
        stats[name] = mr.stats()
        for f in ("cssize", "cspad"):
            stats[name][f] -= c0[f]          # this job's bytes
        snaps[name] = m.snapshot()
    t, j = snaps["torch"], snaps["jax"]
    assert set(t) == set(j)
    assert _labels(t) == _labels(j)
    for name in ("mrtpu_exchange_bytes_total", "mrtpu_exchanges_total",
                 "mrtpu_exchange_rows_total", "mrtpu_exchange_rounds_total",
                 "mrtpu_spill_bytes_total"):
        assert (name in t) == (name in j) == (P > 1 or "spill" in name)
        assert t.get(name) == j.get(name), name
    for name in ("mrtpu_op_latency_seconds", "mrtpu_plan_cache_hit_ratio"):
        assert [s["labels"] for s in t[name]["samples"]] == \
            [s["labels"] for s in j[name]["samples"]
             if s["labels"].get("cache") not in JAX_ONLY_CACHES], name
    st = stats["torch"]
    if P > 1:
        sent = {s["labels"]["kind"]: s["value"]
                for s in t["mrtpu_exchange_bytes_total"]["samples"]}
        assert sent["sent"] == st["cssize"] and sent["pad"] == st["cspad"]
    assert st["metrics"].get("mrtpu_exchange_bytes_total") == \
        t.get("mrtpu_exchange_bytes_total")
    # the fused groups' counts: the warm run is the JAX megafused group
    assert st["plan"]["fusion"]["groups"] == \
        stats["jax"]["plan"]["fusion"]["groups"]
    assert st["plan"]["fusion"]["mega_groups"] == \
        stats["jax"]["plan"]["fusion"]["mega_groups"] == 1


def test_endpoint_scrape_round_trip():
    port = httpd.ensure_server(0)
    try:
        assert port > 0 and httpd.ensure_server(0) == port
        mr = MapReduce(comm=make_mesh(3, devices=["cpu"] * 3))
        keys = np.arange(2000, dtype=np.uint64) % 101
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, np.ones_like(keys)))
        mr.collate()
        mr.reduce(kernels.count, batch=True)

        def get(path):
            return urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10)
        txt = get("/metrics").read().decode()
        assert "# TYPE mrtpu_op_latency_seconds histogram" in txt
        assert 'mrtpu_op_latency_seconds_bucket{op="aggregate"' in txt
        assert 'mrtpu_exchange_bytes_total{kind="sent"}' in txt
        assert "mrtpu_plan_cache_hit_ratio" in txt
        assert "mrtpu_hbm_hiwater_bytes" in txt
        j = json.loads(get("/metrics.json").read())
        assert j["mrtpu_op_latency_seconds"]["type"] == "histogram"
        hz = get("/healthz")
        assert hz.status == 200 and json.loads(hz.read()) == \
            {"status": "ok"}
        fl = json.loads(get("/flight").read())     # armed by the server
        assert fl["reason"] == "http" and fl["spans"]
        httpd.set_health(lambda: "draining")
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/healthz")
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/nope")
        assert ei.value.code == 404
    finally:
        httpd.set_health(None)
        httpd.stop_server()


def test_metrics_port_on_the_mapreduce():
    mr = MapReduce(device="cpu", metrics_port=0)
    srv = httpd.get_server()
    try:
        assert srv is not None and srv.running and metrics.enabled()
        mr.map(1, emit)
        assert "metrics" in mr.stats()
    finally:
        httpd.stop_server()


def test_one_bridge_under_racing_enables():
    from gpu_mapreduce_tpu_torch.obs.sinks import CallbackSink
    threads = [threading.Thread(
        target=lambda: metrics.enable_metrics(flight=False))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sinks = obs.get_tracer()._sinks
    assert sum(1 for s in sinks if isinstance(s, CallbackSink)
               and s.fn == metrics._bridge_emit) == 1


def test_snapshotter(tmp_path):
    metrics._REGISTRY = None
    path = str(tmp_path / "snap.jsonl")
    snap = metrics.start_snapshotter(path, every_s=3600)
    try:
        assert snap.is_alive()
        assert metrics.start_snapshotter(path, every_s=3600) is snap
        snap.write_once()
        snap.write_once()
    finally:
        snap.stop()
    lines = [json.loads(ln) for ln in open(path) if ln.strip()]
    assert len(lines) == 2
    assert "mrtpu_plan_cache_hit_ratio" in lines[0]["metrics"]
    assert lines[0]["utc"].endswith("Z")


def test_slo_is_refused(monkeypatch):
    """A malformed ``MRTPU_SLO`` is refused (warned and left unarmed) in
    both packages alike; a valid one arms the same engine in both, and
    the metrics' scrape-time collector exports its burn gauge."""
    from gpu_mapreduce_tpu.obs import slo as jslo
    from gpu_mapreduce_tpu_torch.obs import slo
    try:
        for spec in ("tenant=*", "tenant=*;bogus=1", "tenant=*;p99_ms=0"):
            monkeypatch.setenv("MRTPU_SLO", spec)
            slo.reset()
            jslo.reset()
            assert slo.get_engine() is None and jslo.get_engine() is None
        spec = "tenant=*;err_pct=5;windows=60,300"
        monkeypatch.setenv("MRTPU_SLO", spec)
        for mod in (slo, jslo):
            mod.reset()
        eng, jeng = slo.get_engine(), jslo.get_engine()
        assert eng.snapshot() == jeng.snapshot()
        assert slo.get_engine() is eng       # re-read only on a change
        reg = metrics.enable_metrics(flight=False)
        c = reg.counter("mrtpu_serve_sessions_total", "x",
                        ("tenant", "status"))
        c.inc(tenant="acme", status="failed")
        eng.tick(force=True)
        snap = reg.collect()
        assert snap["mrtpu_slo_burn_ratio"]["samples"][0]["labels"] == \
            {"tenant": "acme", "window": "60s"}
        MapReduce(device="cpu", metrics_port=0)
        assert httpd.get_server() is not None
    finally:
        slo.reset()
        jslo.reset()
        httpd.stop_server()


# -- the catalog -------------------------------------------------------------------

def _catalog():
    with open(os.path.join(ROOT, "doc", "observability.md")) as f:
        rows = [ln for ln in f if ln.startswith("| `mrtpu_")]
    return {m for ln in rows
            for m in re.findall(r"`(mrtpu_[a-z0-9_]*[a-z0-9])", ln)}


def test_every_port_metric_is_in_the_catalog_and_back():
    catalog = _catalog()
    used = set()
    for path in glob.glob(os.path.join(ROOT, "gpu_mapreduce_tpu_torch",
                                       "**", "*.py"), recursive=True):
        with open(path) as f:
            text = f.read()
        # a name ending in "_" is a prefix in prose (mrtpu_dist_*)
        used |= {m for m in re.findall(r"\bmrtpu_[a-z0-9_]+", text)
                 if not m.endswith("_")}
    assert used - catalog == set()
    assert catalog - used == NOT_PORTED
