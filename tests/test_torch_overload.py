"""The port's self-protecting serve plane against the JAX package's, on
the CPU: tenant auth (401/403 decided before any journal write), request
deadlines and cancellation at op barriers, the cancel-versus-complete
race and ``kill -9`` keeping ``cancelled`` terminal, shedding of a tenant
that burns its SLO budget, the disk monitor, the stall watchdog, the mesh
autoscaler on a CPU ``make_mesh(P)``, the client's ``Retry-After`` and
the SLO engine's burn ratios on the same counter feed.  Where both
daemons run, their HTTP codes, result records and journal record kinds
are equal; the timing-bound cases (a cancel mid-run, the race) run the
port's daemon and hold it to the JAX package's invariants."""

import errno
import hashlib
import json
import os
import signal
import time

import pytest

from gpu_mapreduce_tpu.obs import slo as jslo
from gpu_mapreduce_tpu.obs.metrics import MetricsRegistry as JRegistry
from gpu_mapreduce_tpu.obs.metrics import get_registry as j_get_registry
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.serve import ServeClient as JServeClient
from gpu_mapreduce_tpu.serve import Server as JServer
from gpu_mapreduce_tpu.serve.auth import TokenAuth as JTokenAuth
from gpu_mapreduce_tpu.serve.autoscale import \
    MeshAutoscaler as JMeshAutoscaler
from gpu_mapreduce_tpu.serve.overload import CostProfiles as JCostProfiles
from gpu_mapreduce_tpu.serve.overload import DiskMonitor as JDiskMonitor
from gpu_mapreduce_tpu_torch.core.runtime import CancelledError
from gpu_mapreduce_tpu_torch.ft.journal import Journal, read_journal
from gpu_mapreduce_tpu_torch.obs import slo as tslo
from gpu_mapreduce_tpu_torch.obs.context import RequestAccount
from gpu_mapreduce_tpu_torch.obs.metrics import (MetricsRegistry,
                                                 get_registry,
                                                 prometheus_text)
from gpu_mapreduce_tpu_torch.oink.script import OinkScript
from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch.serve import ServeClient, ServeError, Server
from gpu_mapreduce_tpu_torch.serve.auth import TokenAuth
from gpu_mapreduce_tpu_torch.serve.autoscale import MeshAutoscaler
from gpu_mapreduce_tpu_torch.serve.overload import (SHED_PRIORITY,
                                                    CostProfiles,
                                                    DiskMonitor)
from gpu_mapreduce_tpu_torch.serve.session import RUNNING, Session

from test_torch_serve import (WAIT, Pair, fresh, http,  # noqa: F401
                              journal_kinds, kinds, no_flight_left, record,
                              spawn_port_daemon, stop, wait_until,
                              wf_script, write_corpus)


def cpu_mesh(p):
    return make_mesh(p, devices=["cpu"] * p)


def slow_script(corpus, ncmds=300):
    """Many cheap commands: a session that runs for seconds and crosses a
    command barrier every few milliseconds."""
    return f"variable files index {corpus}\n" + \
        "wordfreq 3 -i v_files\n" * ncmds


def wait_state(client, sid, state):
    wait_until(lambda: client.status(sid)["state"] == state,
               msg=f"{sid} to reach {state!r}")


def port_server(tmp_path, name="state", **kw):
    kw.setdefault("workers", 1)
    srv = Server(port=0, state_dir=str(tmp_path / name), device="cpu", **kw)
    srv.start()
    return srv


# ---------------------------------------------------------------------------
# tenant auth
# ---------------------------------------------------------------------------

def test_token_auth_decisions_match_jax(tmp_path):
    f = tmp_path / "tokens"
    f.write_text("# comment\nacme=ft1\nbroken-line\nbeta=ft2\n*=fr\n")
    hdr = lambda t: {"Authorization": f"Bearer {t}"}  # noqa: E731
    probes = [({}, None, False), (hdr("t1"), "acme", False),
              (hdr("t1"), "beta", False), (hdr("t1"), None, True),
              (hdr("root"), "beta", False), (hdr("root"), None, True),
              (hdr("nope"), "acme", False), (hdr("ft1"), "acme", False),
              (hdr("fr"), None, True), (hdr("broken-line"), None, False),
              ({"authorization": "bearer t2"}, "beta", False),
              ({"Authorization": "Basic t1"}, "acme", False)]
    for spec in ("acme=t1, beta=t2,*=root", str(f), "", "bad,acme=t1"):
        t, j = TokenAuth(spec), JTokenAuth(spec)
        assert t.armed == j.armed and t.snapshot() == j.snapshot()
        for h, tenant, admin in probes:
            assert t.identify(h) == j.identify(h)
            assert t.gate(h, tenant=tenant, admin=admin) == \
                j.gate(h, tenant=tenant, admin=admin)


def test_auth_rejects_before_any_journal_write(tmp_path, monkeypatch):
    monkeypatch.setenv("MRTPU_SERVE_TOKENS", "acme=tok-a,*=tok-admin")
    corpus = write_corpus(tmp_path / "w.txt", ["a", "b"], 20)
    body = {"script": wf_script(corpus)}
    with Pair(tmp_path, workers=1) as p:
        sizes = [os.path.getsize(os.path.join(s, "journal.jsonl"))
                 for s in (p.jstate, p.tstate)]
        for path, payload, token in (
                ("/v1/jobs", body, None),
                ("/v1/jobs", {**body, "tenant": "beta"}, "tok-a"),
                ("/v1/jobs", body, "wrong"),
                ("/v1/drain", None, "tok-a"),
                ("/v1/stats", None, "tok-a"),
                ("/v1/slo", None, None),
                ("/v1/shutdown", None, "tok-a")):
            (code, _, hdr), _ = p.http("GET" if path in ("/v1/stats",
                                                         "/v1/slo")
                                       else "POST", path, payload, token)
            assert code in (401, 403)
            if code == 401:
                assert hdr.get("WWW-Authenticate") == "Bearer"
        assert [os.path.getsize(os.path.join(s, "journal.jsonl"))
                for s in (p.jstate, p.tstate)] == sizes
        # the token names the tenant when the body omits it
        (code, out, _), (tcode, tout, _) = p.http("POST", "/v1/jobs", body,
                                                  "tok-a")
        assert code == 202 and out["tenant"] == tout["tenant"] == "acme"
        for c in (p.jc, p.tc):
            c.token = "tok-a"
        a = p.jc.wait(out["id"], WAIT)
        b = p.tc.wait(tout["id"], WAIT)
        assert record(a) == record(b) and b["status"] == "done"
        # a foreign token reads a tenant's session as nonexistent (404),
        # the admin acts on it (a terminal cancel: 409)
        (code, _, _), _ = p.http("GET", f"/v1/jobs/{out['id']}", None,
                                 "tok-b-unknown")
        assert code == 401
        (code, _, _), _ = p.http("DELETE", f"/v1/jobs/{out['id']}", None,
                                 "tok-admin")
        assert code == 409
        (code, jl, _), (_, tl, _) = p.http("GET", "/v1/jobs", None, "tok-a")
        assert code == 200 and len(jl["jobs"]) == len(tl["jobs"]) == 1
        (code, _, _), _ = p.http("POST", "/v1/drain", None, "tok-admin")
        assert code == 200
        p.journal_kinds()


# ---------------------------------------------------------------------------
# deadlines and cancellation
# ---------------------------------------------------------------------------

def test_deadline_cancels_and_bad_deadlines_are_400(tmp_path):
    corpus = write_corpus(tmp_path / "w.txt", ["a", "b", "c"], 50)
    with Pair(tmp_path, workers=1) as p:
        for script in (wf_script(corpus), "set fuse 1\n" + wf_script(corpus)):
            a, b = p.same(script=script, deadline_ms=1)
            assert b["status"] == "cancelled"
            assert b["meta"]["cancel_reason"] == \
                a["meta"]["cancel_reason"] == "deadline"
        p.same(script=wf_script(corpus))     # the daemon runs on
        for bad in (0, -5, "soon"):
            (code, _, _), _ = p.http("POST", "/v1/jobs",
                                     {"script": wf_script(corpus),
                                      "deadline_ms": bad})
            assert code == 400
        assert p.t.budgets.snapshot()["default"]["bytes_in_use"] == 0
        p.journal_kinds()


def test_delete_midrun_releases_pages_and_stays_resumable(tmp_path):
    corpus = write_corpus(tmp_path / "w.txt", ["a", "b", "c"], 20000)
    srv = port_server(tmp_path)
    try:
        c = ServeClient.local(srv.port)
        r = c.submit(script=slow_script(corpus, 1000), tenant="acme")
        wait_state(c, r["id"], "running")
        wait_until(lambda: "ckpt" in journal_kinds(srv.session_dir(r["id"])),
                   msg="a checkpoint before the cancel")
        assert c.cancel(r["id"])["state"] in ("cancelling", "cancelled")
        out = c.wait(r["id"], WAIT)
        assert out["status"] == "cancelled"
        assert out["meta"]["cancel_reason"] == "client"
        assert out["error"] == "cancelled (client)"
        assert srv.budgets.snapshot()["acme"]["pages_in_use"] == 0
        wait_until(lambda: "serve_done" in journal_kinds(srv.state_dir),
                   msg="the serve_done record")
        done = [x for x in read_journal(srv.state_dir)
                if x.get("kind") == "serve_done"]
        assert done[-1]["status"] == "cancelled"
        assert [x for x in kinds(read_journal(srv.state_dir))
                if x != "serve_done"] == ["serve_submit", "serve_cancel"]
        skinds = kinds(read_journal(srv.session_dir(r["id"])))
        assert "begin" in skinds and "ckpt" in skinds
        with pytest.raises(ServeError) as ei:
            c.cancel(r["id"])
        assert ei.value.code == 409
    finally:
        srv.shutdown()


def test_acknowledged_cancels_and_queued_cancels(tmp_path):
    """A journal with a ``serve_cancel`` but no terminal record recovers
    to ``cancelled`` in both packages; a queued session cancelled before
    it runs never runs."""
    for root in ("jax", "port"):
        j = Journal(str(tmp_path / root / "ack"), script_mode=True)
        j.append({"kind": "serve_submit", "sid": "s000001",
                  "tenant": "acme", "fmt": "oink", "payload": "mr x\n",
                  "seq": 1, "priority": 0, "utc": "", "trace": "aaaa"})
        j.append({"kind": "serve_cancel", "sid": "s000001",
                  "reason": "client", "trace": "aaaa"})
        j.close()
    with Pair(tmp_path, name="ack", workers=2) as p:
        a, b = p.jc.result("s000001"), p.tc.result("s000001")
        assert record(a) == record(b)
        assert b["status"] == "cancelled" and b["output"] == ""
        assert b["meta"] == a["meta"]
        assert p.journal_kinds()[-1] == "serve_done"
    corpus = write_corpus(tmp_path / "w.txt", ["a", "b"], 20)
    with Pair(tmp_path, name="queued", workers=0, paused=True) as p:
        sid = p.jc.submit(script=wf_script(corpus))["id"]
        assert p.tc.submit(script=wf_script(corpus))["id"] == sid
        (code, a, _), (_, b, _) = p.http("DELETE", f"/v1/jobs/{sid}")
        assert code == 202 and a == b
        a, b = p.jc.result(sid), p.tc.result(sid)
        assert record(a) == record(b) and b["meta"]["ran"] is False
        p.journal_kinds()


def test_cancel_versus_complete_race_never_corrupts(tmp_path):
    corpus = write_corpus(tmp_path / "w.txt", ["a", "b"], 30)
    srv = port_server(tmp_path, workers=2)
    try:
        c = ServeClient.local(srv.port)
        for _ in range(6):
            r = c.submit(script=wf_script(corpus))
            try:
                c.cancel(r["id"])
            except ServeError as e:
                assert e.code == 409
            out = c.wait(r["id"], WAIT)
            assert out["status"] in ("done", "cancelled")
            path = srv.result_path(r["id"])
            with open(path, "rb") as f:
                before = hashlib.sha256(f.read()).hexdigest()
            with pytest.raises(ServeError) as ei:
                c.cancel(r["id"])
            assert ei.value.code == 409
            with open(path, "rb") as f:
                assert hashlib.sha256(f.read()).hexdigest() == before
            assert json.load(open(path))["status"] == out["status"] == \
                c.status(r["id"])["state"]
    finally:
        srv.shutdown()


def test_kill9_replay_keeps_cancelled_terminal(tmp_path):
    corpora = [write_corpus(tmp_path / f"c{i}.txt", ["x", f"w{i}"], 30)
               for i in range(3)]
    scripts = [wf_script(c, out=f"tmp.wf{i}") for i, c in enumerate(corpora)]
    state = str(tmp_path / "state")
    p, port = spawn_port_daemon(state, ["--paused"])
    try:
        c = ServeClient.local(port)
        sids = [c.submit(script=s)["id"] for s in scripts]
        assert c.cancel(sids[1])["state"] == "cancelled"
    finally:
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
    p2, port2 = spawn_port_daemon(state, ["--workers", "2"])
    c2 = ServeClient.local(port2)
    try:
        for sid in (sids[0], sids[2]):
            assert c2.wait(sid, timeout=WAIT)["status"] == "done"
        out = c2.result(sids[1])
        assert out["status"] == "cancelled" and out["output"] == ""
        assert c2.status(sids[1])["state"] == "cancelled"
    finally:
        stop(p2, c2)


# ---------------------------------------------------------------------------
# shedding and the disk monitor
# ---------------------------------------------------------------------------

def test_shed_greedy_tenant_polite_unaffected(tmp_path):
    corpus = write_corpus(tmp_path / "w.txt", ["a", "b"], 20)
    spec = "tenant=*;err_pct=1;windows=60,600"
    with Pair(tmp_path, workers=1) as p:
        engines = []
        for slo, srv in ((tslo, p.t), (jslo, p.j)):
            slo.configure(slo.parse_slo(spec))
            reg = get_registry() if slo is tslo else j_get_registry()
            ctr = reg.counter(
                "mrtpu_serve_sessions_total",
                "finished sessions by tenant and status",
                ("tenant", "status"))
            for _ in range(5):
                ctr.inc(tenant="greedy", status="failed")
                ctr.inc(tenant="greedy", status="done")
            for _ in range(4):
                ctr.inc(tenant="cheap", status="failed")
            eng = slo.get_engine()
            eng.tick(force=True)
            assert eng.burning("greedy") and eng.burning("cheap")
            srv.profiles.record("polite", 0.05, 1000.0)
            srv.profiles.record("greedy", 10.0, 1e6)
            srv.profiles.record("cheap", 0.01, 100.0)
            engines.append(eng)
        assert engines[0].snapshot()["burn"] == engines[1].snapshot()["burn"]
        for _ in range(3):
            (code, _, hdr), _ = p.http("POST", "/v1/jobs",
                                       {"script": wf_script(corpus),
                                        "tenant": "greedy"})
            assert code == 429 and int(hdr["Retry-After"]) >= 1
        p.same(script=wf_script(corpus), tenant="polite")
        a, b = p.run(script=wf_script(corpus), tenant="cheap")
        assert record(a) == record(b) and b["status"] == "done"
        assert p.tc.status(b["id"])["priority"] == SHED_PRIORITY == \
            p.jc.status(a["id"])["priority"]
        sheds = [(x["tenant"], x["reason"]) for x in read_journal(p.tstate)
                 if x.get("kind") == "serve_shed"]
        assert sheds == [("greedy", "slo_burn")]
        assert p.journal_kinds().count("serve_shed") == 1
        samples = get_registry().collect()["mrtpu_serve_shed_total"][
            "samples"]
        assert [s["value"] for s in samples if s["labels"] ==
                {"tenant": "greedy", "reason": "slo_burn"}] == [3]


def test_disk_monitor_latch_and_pressure_sheds(tmp_path, monkeypatch):
    for cls in (DiskMonitor, JDiskMonitor):
        m = cls([str(tmp_path)], floor_mb=0)
        assert m.check() is None
        assert m.note_error(RuntimeError("wrapped")) is False
        chained = RuntimeError("session failed")
        chained.__cause__ = OSError(errno.ENOSPC, "No space left on device")
        assert m.note_error(chained) is True
        assert m.check() == "recent ENOSPC on a session path"
        m._last_enospc = 0.0
        m._last_probe = 0.0
        assert m.check() is None and m.trips == 1
    monkeypatch.setenv("MRTPU_SERVE_DISK_MIN", str(10 ** 9))
    corpus = write_corpus(tmp_path / "w.txt", ["a", "b"], 20)
    with Pair(tmp_path, workers=1) as p:
        assert p.t._health_status() == p.j._health_status() == "degraded"
        (code, _, _), _ = p.http("GET", "/healthz")
        assert code == 503
        (code, a, hdr), (_, b, _) = p.http("POST", "/v1/jobs",
                                           {"script": wf_script(corpus)})
        assert code == 503 and "Retry-After" in hdr
        assert a["error"].replace(p.jstate, p.tstate) == b["error"]
        for srv in (p.j, p.t):
            srv.disk.floor_mb = 0
            srv.disk._last_probe = 0.0
        assert p.t._health_status() == "ok"
        p.same(script=wf_script(corpus))
        assert "mrtpu_serve_degraded 0" in prometheus_text()
        assert p.journal_kinds() == ["serve_shed", "serve_submit",
                                     "serve_done"]


# ---------------------------------------------------------------------------
# the stall watchdog
# ---------------------------------------------------------------------------

def test_stall_watchdog_flags_cancels_and_clears(tmp_path, monkeypatch):
    monkeypatch.setenv("MRTPU_SERVE_STALL", "0.5")
    monkeypatch.setenv("MRTPU_SERVE_STALL_CANCEL", "1")
    srv = Server(port=0, workers=0, paused=True, device="cpu",
                 state_dir=str(tmp_path / "state"))
    assert srv.stall_s == 0.5 and srv.stall_cancel
    sess = Session(sid="sX", tenant="acme", payload="")
    sess.account = RequestAccount(tenant="acme")
    sess.state = RUNNING
    with srv._lock:
        srv.sessions["sX"] = sess
    sess.account.last_barrier = time.monotonic() - 10.0
    srv._stall_scan(time.monotonic())
    assert sess.stalled is True and srv.stall_count == 1
    assert sess.account.cancel_reason == "stall"
    with pytest.raises(CancelledError):
        sess.account.check_cancel()
    sess.account.last_barrier = time.monotonic()
    srv._stall_scan(time.monotonic())
    assert sess.stalled is False and srv.stall_count == 1
    monkeypatch.setenv("MRTPU_SERVE_STALL", "30")
    srv2 = port_server(tmp_path, name="quiet")
    try:
        c = ServeClient.local(srv2.port)
        corpus = write_corpus(tmp_path / "w.txt", ["a", "b"], 200)
        assert c.wait(c.submit(script=wf_script(corpus))["id"],
                      WAIT)["status"] == "done"
        assert srv2.stall_count == 0
    finally:
        srv2.shutdown()


# ---------------------------------------------------------------------------
# the mesh autoscaler
# ---------------------------------------------------------------------------

def test_autoscaler_width_matches_jax():
    tprof, jprof = CostProfiles(), JCostProfiles()
    t = MeshAutoscaler(cpu_mesh(4), tprof, enabled=True)
    j = JMeshAutoscaler(j_make_mesh(4), jprof, enabled=True)
    assert t.full_width == j.full_width == 4
    for prof in (tprof, jprof):
        prof.record("tiny", 0.05, 100.0)
        prof.record("mid", 0.5, 6 << 20)
        prof.record("heavy", 5.0, 1 << 30)
    for tenant in ("unknown", "tiny", "mid", "heavy"):
        assert t.width_for(tenant) == j.width_for(tenant)
    assert tprof.snapshot() == jprof.snapshot()
    assert t.mesh_for(1) is t.mesh_for(1) and t.mesh_for(4) is t.full
    assert list(t.mesh_for(2).devices) == list(t.full.devices)[:2]
    assert MeshAutoscaler(None, tprof, enabled=True).enabled is False
    os.environ["MRTPU_DIST_WIDTH_CAP"] = "2"
    try:
        capped = MeshAutoscaler(cpu_mesh(4), tprof, enabled=True)
        jcapped = JMeshAutoscaler(j_make_mesh(4), jprof, enabled=True)
        assert capped.snapshot() == jcapped.snapshot()
        assert capped.full_width == 2
    finally:
        del os.environ["MRTPU_DIST_WIDTH_CAP"]


def test_autoscaled_session_runs_narrow_with_the_same_output(tmp_path,
                                                             monkeypatch):
    corpus = write_corpus(tmp_path / "w.txt", ["to", "be", "or", "not"], 60)
    script = wf_script(corpus, out="tmp.wf")
    gold = JServer(port=0, workers=1, comm=j_make_mesh(4),
                   state_dir=str(tmp_path / "gold"))
    gold.start()
    try:
        gc = JServeClient.local(gold.port)
        want = gc.wait(gc.submit(script=script)["id"], WAIT)
    finally:
        gold.shutdown()
    monkeypatch.setenv("MRTPU_SERVE_MESH_AUTO", "1")
    srv = port_server(tmp_path, comm=cpu_mesh(4))
    try:
        assert srv.autoscaler.enabled and srv.stats()["mesh"] == \
            {"nprocs": 4}
        srv.profiles.record("tiny", 0.05, 100.0)
        c = ServeClient.local(srv.port)
        out = c.wait(c.submit(script=script, tenant="tiny")["id"], WAIT)
        assert out["status"] == "done" and out["meta"]["mesh_width"] == 1
        assert out["output"] == want["output"]
        assert srv.autoscaler.narrowed >= 1
    finally:
        srv.shutdown()


def test_autoscaler_live_promotion_reshards(tmp_path):
    a = MeshAutoscaler(cpu_mesh(4), CostProfiles(), enabled=True)
    corpus = write_corpus(tmp_path / "w.txt", ["p", "q", "r"], 40)
    s = OinkScript(comm=a.mesh_for(1), screen=False)
    s.run_string(f"variable files index {corpus}\n"
                 f"wordfreq 3 -i v_files -o NULL wf\n")
    assert s.obj.named["wf"].nprocs == 1
    acct = RequestAccount()
    acct.exchange_sent = 1 << 30
    promoted = []
    hook = a.promote_hook(acct, 1, on_promote=lambda: promoted.append(1))
    s.post_cmd.append(hook)
    s.run_string("wordfreq 3 -i v_files -o NULL wf2\n")
    assert a.promoted == 1 and promoted == [1] and hook not in s.post_cmd
    assert s.obj.named["wf"].nprocs == s.obj.named["wf2"].nprocs == 4
    assert s.obj.comm is a.mesh_for(4)
    assert a.promote_hook(acct, 4) is None


# ---------------------------------------------------------------------------
# the client and the SLO engine
# ---------------------------------------------------------------------------

def test_client_submit_honors_retry_after(tmp_path, monkeypatch):
    monkeypatch.setenv("MRTPU_SERVE_RATE", "0.5")
    monkeypatch.setenv("MRTPU_SERVE_BURST", "1")
    corpus = write_corpus(tmp_path / "w.txt", ["a", "b"], 20)
    srv = port_server(tmp_path)
    try:
        c = ServeClient.local(srv.port)
        assert c.submit(script=wf_script(corpus))["id"]
        with pytest.raises(ServeError) as ei:
            c.submit(script=wf_script(corpus))
        assert ei.value.code == 429 and ei.value.retry_after >= 1
        t0 = time.monotonic()
        assert c.submit(script=wf_script(corpus), retry_after_wait=30.0)["id"]
        assert time.monotonic() - t0 >= 1.0
        with pytest.raises(ServeError):
            c.submit(script=wf_script(corpus), retry_after_wait=0.2)
    finally:
        srv.shutdown()


def test_slo_burn_ratios_equal_jax_on_one_feed():
    spec = ("tenant=acme;p99_ms=2000;err_pct=0.5;windows=60,600|"
            "tenant=*;err_pct=5;windows=60,300")
    for bad in ("tenant=*", "tenant=*;bogus=1", "p99_ms=-1", "x",
                "tenant=*;err_pct=200"):
        with pytest.raises(ValueError):
            tslo.parse_slo(bad)
        with pytest.raises(ValueError):
            jslo.parse_slo(bad)
    engines = [tslo.SLOEngine(tslo.parse_slo(spec)),
               jslo.SLOEngine(jslo.parse_slo(spec))]
    regs = [MetricsRegistry(), JRegistry()]
    feed = [(0.0, []),
            (30.0, [("acme", "done", 0.5)] * 8 + [("acme", "failed", 3.0)]
             + [("beta", "done", 0.1)] * 3),
            (90.0, [("beta", "failed", 0.2)] * 2 + [("acme", "done", 9.0)]),
            (400.0, [("acme", "done", 0.1)] * 20)]
    outs = []
    for eng, reg in zip(engines, regs):
        got = []
        ctr = reg.counter("mrtpu_serve_sessions_total", "x",
                          ("tenant", "status"))
        hist = reg.histogram("mrtpu_serve_session_seconds", "x",
                             ("tenant", "status"))
        for now, events in feed:
            for tenant, status, secs in events:
                ctr.inc(tenant=tenant, status=status)
                hist.observe(secs, tenant=tenant, status=status)
            burn = eng.tick(now=now, reg=reg)
            got.append((burn, eng.burning("acme"), eng.burning("beta"),
                        sorted(eng.snapshot()["firing"])))
        got.append(reg.collect()["mrtpu_slo_burn_ratio"]["samples"])
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][1][0]["acme"]["60s"] > 1.0
