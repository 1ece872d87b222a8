"""The port's serve daemon (``gpu_mapreduce_tpu_torch/serve/``) against the
JAX package's, on the CPU.

An in-process JAX ``Server(comm=make_mesh(1))`` and a port
``Server(device="cpu")`` take the same submit sequence; their result
records (``status``, ``error``, ``output``, the files' sha256 and bytes,
``mrs``), session summaries, serve-journal record kinds and HTTP status
codes must be equal — ids, timestamps, trace ids and seconds aside.  Two
cases run the port's daemon as a subprocess with ``--device cpu`` and
``kill -9`` it: a paused queue replays byte-identical, and a session
killed after a checkpoint resumes from it.  A state directory is read
across both ways, and a daemon without a card refuses before writing any
state (fleet replicas too; the fleet itself is in ``test_torch_fleet.py``).
No case sleeps a fixed time: each polls with a deadline of 60 s or more."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from gpu_mapreduce_tpu.ft.journal import read_journal as j_read_journal
from gpu_mapreduce_tpu.obs import flight as jflight
from gpu_mapreduce_tpu.obs import metrics as jmetrics
from gpu_mapreduce_tpu.obs import slo as jslo
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel import dist as jdist
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.plan.cache import plan_cache as j_plan_cache
from gpu_mapreduce_tpu.serve import AdmissionQueue as JAdmissionQueue
from gpu_mapreduce_tpu.serve import ServeClient as JServeClient
from gpu_mapreduce_tpu.serve import Server as JServer
from gpu_mapreduce_tpu.serve import TenantBudgets as JTenantBudgets
from gpu_mapreduce_tpu.serve import memo as jmemo
from gpu_mapreduce_tpu.serve import normalize_payload as j_normalize
from gpu_mapreduce_tpu.serve.admission import \
    TenantRateLimiter as JTenantRateLimiter
from gpu_mapreduce_tpu.utils import cas as jcas
from gpu_mapreduce_tpu_torch import MRError
from gpu_mapreduce_tpu_torch.core.runtime import (PageAccount,
                                                  global_counters,
                                                  page_account_scope)
from gpu_mapreduce_tpu_torch.ft.journal import Journal, read_journal
from gpu_mapreduce_tpu_torch.obs import flight as tflight
from gpu_mapreduce_tpu_torch.obs import metrics as tmetrics
from gpu_mapreduce_tpu_torch.obs import slo as tslo
from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
from gpu_mapreduce_tpu_torch.oink.script import OinkScript
from gpu_mapreduce_tpu_torch.parallel import dist as tdist
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.plan.cache import plan_cache
from gpu_mapreduce_tpu_torch.serve import (AdmissionQueue, ServeClient,
                                           Server,
                                           TenantBudgets, memo,
                                           normalize_payload)
from gpu_mapreduce_tpu_torch.serve.admission import TenantRateLimiter
from gpu_mapreduce_tpu_torch.serve.session import TERMINAL
from gpu_mapreduce_tpu_torch.utils import cas as tcas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120.0          # every poll's deadline, seconds


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Both packages start cold: plan caches, exchange plan caches, the
    content store, memo counts, the SLO engine and the metrics."""
    for mod in (tshuffle, jshuffle):
        monkeypatch.setattr(mod, "_SPEC_CACHE", {})
    monkeypatch.delenv("MRTPU_CAS_DIR", raising=False)
    for fn in (plan_cache().clear, j_plan_cache().clear, tcas.reset_store,
               jcas.reset_store, memo.reset_counts, jmemo.reset_counts,
               tslo.reset, jslo.reset, tmetrics.reset, jmetrics.reset):
        fn()
    yield
    for fn in (plan_cache().clear, j_plan_cache().clear, tcas.reset_store,
               jcas.reset_store, tslo.reset, jslo.reset):
        fn()


@pytest.fixture(autouse=True)
def no_flight_left():
    """A daemon arms its package's flight recorder with the metrics, in
    the working directory, for the life of the process: disarm both after
    each test, so that a later test in this process that calls
    ``sys.excepthook`` (the JAX ``tests/test_metrics.py`` does) leaves no
    ``mr_flight.*.json`` there.  The other daemon test files import it."""
    yield
    tflight.reset()
    jflight.reset()


# ---------------------------------------------------------------------------
# helpers (the other serve test files import them)
# ---------------------------------------------------------------------------

def write_corpus(path, words, repeat):
    path.write_text((" ".join(words) + " ") * repeat)
    return str(path)


def wf_script(corpus, top=3, out=None, fuse=False, extra=()):
    lines = [f"variable files index {corpus}"]
    if fuse:
        lines.append("set fuse 1")
    lines.append(f"wordfreq {top} -i v_files" +
                 (f" -o {out} wf" if out else ""))
    lines.extend(extra)
    return "\n".join(lines) + "\n"


def record(res: dict) -> dict:
    """A result record without ids, timestamps, trace ids and seconds."""
    return {"status": res.get("status"), "error": res.get("error"),
            "output": res.get("output"), "mrs": res.get("mrs"),
            "files": {k: (v["sha256"], v["bytes"])
                      for k, v in (res.get("files") or {}).items()}}


def summary(st: dict) -> dict:
    return {k: v for k, v in st.items()
            if k not in ("submitted_utc", "wall_s", "trace_id")}


def kinds(recs):
    return [r.get("kind") for r in recs]


def journal_kinds(dir):
    """The record kinds of the journal under ``dir``; [] before it exists."""
    try:
        return kinds(read_journal(dir))
    except MRError:
        return []


def http(port, method, path, body=None, token=None):
    """(code, body, headers) of one raw request."""
    data = json.dumps(body).encode() if body is not None else None
    hdr = {"Content-Type": "application/json"} if data else {}
    if token:
        hdr["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method, headers=hdr)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode() or "{}"), \
                dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}"), \
            dict(e.headers)


def wait_until(fn, timeout=WAIT, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class Pair:
    """A JAX daemon and a port daemon with the same settings, each with
    its own state directory of the same basename."""

    def __init__(self, tmp_path, name="state", **kw):
        self.jstate = str(tmp_path / "jax" / name)
        self.tstate = str(tmp_path / "port" / name)
        jkw = dict(kw)
        if "budgets" in kw:
            b = kw["budgets"]
            jkw["budgets"] = JTenantBudgets(pages=b.pages, memsize=b.memsize)
        self.j = JServer(port=0, state_dir=self.jstate, comm=j_make_mesh(1),
                         **jkw)
        self.t = Server(port=0, state_dir=self.tstate, device="cpu", **kw)

    def __enter__(self):
        self.j.start()
        self.t.start()
        self.jc = JServeClient.local(self.j.port)
        self.tc = ServeClient.local(self.t.port)
        return self

    def __exit__(self, *exc):
        self.j.shutdown()
        self.t.shutdown()

    def run(self, timeout=WAIT, **submit):
        """Submit to both, wait for both; returns (jax, port) results."""
        js, ts = self.jc.submit(**submit), self.tc.submit(**submit)
        assert js["id"] == ts["id"] and js["state"] == ts["state"]
        return self.jc.wait(js["id"], timeout), self.tc.wait(ts["id"],
                                                             timeout)

    def same(self, **submit):
        a, b = self.run(**submit)
        assert record(a) == record(b)
        return a, b

    def http(self, method, path, body=None, token=None):
        """Both daemons' (code, body) of one raw request: codes equal."""
        a = http(self.j.port, method, path, body, token)
        b = http(self.t.port, method, path, body, token)
        assert a[0] == b[0], (a, b)
        return a, b

    def settled(self):
        """Every finished session's ``serve_done`` is in its daemon's
        journal (the worker appends it just after the result is read)."""
        for srv, reader in ((self.j, j_read_journal), (self.t, read_journal)):
            done = {r.get("sid") for r in reader(srv.state_dir)
                    if r.get("kind") == "serve_done"}
            with srv._lock:
                finished = {sid for sid, x in srv.sessions.items()
                            if x.state in TERMINAL}
            if not finished <= done:
                return False
        return True

    def journal_kinds(self):
        wait_until(self.settled, msg="the serve_done records")
        a = kinds(j_read_journal(self.jstate))
        b = kinds(read_journal(self.tstate))
        assert a == b
        return b


def spawn_port_daemon(state, extra=(), env_extra=None):
    """``python -m gpu_mapreduce_tpu_torch.serve --device cpu`` in a fresh
    interpreter; returns (process, port)."""
    env = {**os.environ, "PYTHONPATH": ROOT, **(env_extra or {})}
    p = subprocess.Popen(
        [sys.executable, "-m", "gpu_mapreduce_tpu_torch.serve",
         "--device", "cpu", "--port", "0", "--state", state, *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    line = json.loads(p.stdout.readline())
    assert line["device"] == "cpu" and line["fleet"] is None
    return p, int(line["serving"])


def stop(p, client=None):
    if client is not None and p.poll() is None:
        try:
            client.shutdown()
            p.wait(timeout=60)
        except Exception:
            pass
    if p.poll() is None:
        p.kill()
        p.wait()


# ---------------------------------------------------------------------------
# units and the hooks the daemon needs
# ---------------------------------------------------------------------------

def test_normalize_admission_and_rate_limiter_match_jax():
    for body in ({"script": "mr x\n"}, {"ops": ["mr x", "x delete"]}):
        assert normalize_payload(body) == j_normalize(body)
    for bad in ({}, {"script": ""}, {"ops": []}, {"ops": [1]},
                {"script": "a", "ops": ["b"]}):
        with pytest.raises(MRError):
            normalize_payload(bad)
    queues = [AdmissionQueue(3), JAdmissionQueue(3)]
    taken = []
    for q in queues:
        got = [q.offer("low1", priority=0), q.offer("hi", priority=5),
               q.offer("low2"), q.offer("x"), q.offer("mid", force=True,
                                                      priority=2)]
        q.close()
        taken.append((got, [q.take(0) for _ in range(5)], q.stats()))
    assert taken[0] == taken[1]
    for rate, burst in ((1.0, 2), (0.0, None), (0.5, 1)):
        a, b = TenantRateLimiter(rate, burst), JTenantRateLimiter(rate, burst)
        seq = [("a", 1000.0), ("a", 1000.0), ("a", 1000.0), ("b", 1000.0),
               ("a", 1001.0), ("a", 1001.5)]
        assert [a.check(t, now) for t, now in seq] == \
            [b.check(t, now) for t, now in seq]
        assert a.snapshot() == b.snapshot()


def test_budgets_page_account_and_hooks():
    """TenantBudgets' defaults equal JAX's; Counters.mem/add charge the
    thread's tenant account; the ObjectManager pins; `set prepend` is
    clamped to the session root; MRTPU_DIST_WIDTH_CAP caps the width."""
    for pages, memsize in ((0, 64), (1, 1), (8, 4)):
        t, j = TenantBudgets(pages, memsize), JTenantBudgets(pages, memsize)
        assert t.defaults_for("a", "/s") == j.defaults_for("a", "/s")
        assert t.account("a").snapshot() == j.account("a").snapshot()
    acct = PageAccount("acme", 1 << 20)
    with page_account_scope(acct):
        global_counters().mem(3 << 20)
        global_counters().mem(-(1 << 20))
        global_counters().add(wsize=100, rsize=7)
    global_counters().mem(-(2 << 20))         # outside the scope: not ours
    snap = acct.snapshot()
    assert (snap["bytes_in_use"], snap["hi_water"], snap["spilled_bytes"],
            snap["reread_bytes"], snap["pages_in_use"]) == \
        (2 << 20, 3 << 20, 100, 7, 2.0)
    om = ObjectManager(device="cpu")
    om.pin(maxpage=1, memsize=1)
    om.set_default("maxpage", 1)              # the same value passes
    with pytest.raises(MRError, match="pinned"):
        om.set_default("maxpage", 100000)
    s = OinkScript(device="cpu", screen=False, obj=om)
    s._path_root = "/sess/out"
    s.one("set prepend sub")
    assert s._path_prepend == "/sess/out/sub"
    with pytest.raises(MRError, match="pinned"):
        s.one("set prepend /tmp")
    s.one("clear")                            # pins survive a clear
    with pytest.raises(MRError, match="pinned"):
        s.one("set memsize 4096")
    os.environ["MRTPU_DIST_WIDTH_CAP"] = "3"
    try:
        assert tdist.surviving_width() == jdist.surviving_width() == 3
    finally:
        del os.environ["MRTPU_DIST_WIDTH_CAP"]
    assert tdist.surviving_width() is jdist.surviving_width() is None


def test_fleet_mode_and_no_card_refuse_before_state(tmp_path, monkeypatch):
    """What still refuses now that fleet mode is ported: a replica with
    no card and no ``--device cpu`` (before any state or fleet file is
    written), and ``--router`` without ``--fleet`` (the JAX package's
    usage error)."""
    from gpu_mapreduce_tpu.serve.__main__ import main as j_main
    from gpu_mapreduce_tpu_torch.serve.__main__ import main
    state, fleet = tmp_path / "state", tmp_path / "fleet"
    for m in (main, j_main):
        with pytest.raises(SystemExit) as ei:
            m(["--router", "--port", "0"])
        assert ei.value.code == 2
    r = subprocess.run(
        [sys.executable, "-m", "gpu_mapreduce_tpu_torch.serve", "--router",
         "--port", "0"], cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "--router requires --fleet DIR" in r.stderr
    # fleet mode is no refusal any more: a replica on the CPU joins
    srv = Server(port=0, device="cpu", fleet_dir=str(fleet),
                 replica_id="r0", lease_s=1.0, heartbeat_s=0.25)
    assert srv.state_dir == str(fleet / "replicas" / "r0")
    assert not fleet.joinpath("replicas").exists()
    if not torch.cuda.is_available():
        # the daemon runs on the card or not at all, a fleet replica too:
        # never on the host unless asked, and nothing written first
        with pytest.raises(MRError):
            Server(port=0, state_dir=str(state))
        monkeypatch.setenv("MRTPU_FLEET_DIR", str(tmp_path / "f2"))
        with pytest.raises(MRError):
            Server(port=0, replica_id="r1")
        monkeypatch.delenv("MRTPU_FLEET_DIR")
        r = subprocess.run(
            [sys.executable, "-m", "gpu_mapreduce_tpu_torch.serve", "--port",
             "0", "--fleet", str(tmp_path / "f3"), "--replica-id", "r0"],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
            capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "MRError" in r.stderr
        for d in (state, tmp_path / "f2", tmp_path / "f3"):
            assert not d.exists()


# ---------------------------------------------------------------------------
# the submit sequence, daemon against daemon
# ---------------------------------------------------------------------------

def test_roundtrip_failures_and_unknown_ids(tmp_path):
    corpus = write_corpus(tmp_path / "w.txt", ["to", "be", "or"], 40)
    with Pair(tmp_path, workers=2, queue_cap=8) as p:
        a, b = p.same(script=wf_script(corpus, out="tmp.wf"))
        assert b["status"] == "done" and "tmp.wf" in b["files"]
        assert "1 files, 120 words, 3 unique" in b["output"]
        p.same(ops=[f"variable files index {corpus}",
                    "wordfreq 3 -i v_files"], tenant="opsy")
        a, b = p.same(script="frobnicate 1 2\n")
        assert b["status"] == "failed" and "Unknown command" in b["error"]
        p.same(ops=["mr x", "x delete"])
        assert summary(p.jc.status("s000001")) == \
            summary(p.tc.status("s000001"))
        assert [summary(s) for s in p.jc.jobs()] == \
            [summary(s) for s in p.tc.jobs()]
        for method, path in (("GET", "/v1/jobs/s999999"),
                             ("GET", "/v1/jobs/s999999/result"),
                             ("GET", "/v1/jobs/s999999/profile"),
                             ("GET", "/v1/jobs/s999999/events"),
                             ("DELETE", "/v1/jobs/s999999"),
                             ("GET", "/v1/nope"),
                             ("POST", "/v1/jobs")):
            (code, _, _), _ = p.http(method, path)
            assert code in (400, 404)
        (code, _, _), _ = p.http("POST", "/v1/jobs", {"script": "mr x\n",
                                                      "priority": "hi"})
        assert code == 400
        (code, _, _), _ = p.http("DELETE", "/v1/jobs/s000001")
        assert code == 409                   # terminal: cancel is a no-op
        st = p.tc.stats()
        assert st["sessions"]["by_state"] == \
            p.jc.stats()["sessions"]["by_state"]
        assert st["device"] == "cpu" and st["fleet"] is None
        assert p.tc.healthz() and p.jc.healthz()
        assert p.tc.drain() == p.jc.drain() == {"draining": True}
        (code, _, hdr), _ = p.http("POST", "/v1/jobs", {"script": "mr x\n"})
        assert code == 503 and "Retry-After" in hdr
        p.journal_kinds()


def test_two_tenants_mr_x_at_once_and_budget_labels(tmp_path):
    """Two tenants run the same script shape (`mr x`) at once; a 1-page
    tenant budget spills the big corpus's tenant only; the labels and
    the page accounts are the JAX package's."""
    big = write_corpus(tmp_path / "big.txt",
                       [f"w{i:04d}" for i in range(200)], 1400)
    small = write_corpus(tmp_path / "small.txt", ["tiny", "data"], 10)
    assert os.path.getsize(big) > 1 << 20

    def script(corpus):
        return (f"mr x\nvariable files index {corpus}\n"
                f"wordfreq 5 -i v_files -o NULL x2\n")

    with Pair(tmp_path, workers=2, queue_cap=8,
              budgets=TenantBudgets(pages=1, memsize=1)) as p:
        subs = [(script(big), "a"), (script(small), "b")]
        ids = {}
        for name, c in (("j", p.jc), ("t", p.tc)):
            ids[name] = [c.submit(script=s, tenant=t)["id"]
                         for s, t in subs]
        res = {name: [c.wait(i, WAIT) for i in ids[name]]
               for name, c in (("j", p.jc), ("t", p.tc))}
        for a, b in zip(res["j"], res["t"]):
            assert record(a) == record(b) and b["status"] == "done"
        ta, tb = res["t"]
        assert ta["meta"]["pages"]["tenant"] == "a"
        assert ta["meta"]["pages"]["spilled_bytes"] > 0
        assert tb["meta"]["pages"]["spilled_bytes"] == 0
        for pkg in (tmetrics, jmetrics):
            # the worker counts a session just after its result is read
            wait_until(lambda: {s["labels"]["tenant"] for s in
                                pkg.get_registry().collect().get(
                                    "mrtpu_serve_sessions_total",
                                    {"samples": []})["samples"]} ==
                       {"a", "b"}, msg="both tenants' session counts")
            snap = pkg.get_registry().collect()
            assert {s["labels"]["tenant"] for s in
                    snap["mrtpu_tenant_pages"]["samples"]} == {"a", "b"}
        ts, js = p.tc.stats()["tenants"], p.jc.stats()["tenants"]
        assert set(ts) == set(js) == {"a", "b"}
        assert ts["b"]["spilled_bytes"] == js["b"]["spilled_bytes"] == 0
        assert all(ts[t]["bytes_in_use"] == 0 for t in ts)
        # the budget is pinned: the tenant's own `set` cannot lift it
        a, b = p.same(script="set maxpage 100000\nmr x\n", tenant="evil")
        assert b["status"] == "failed" and "pinned" in b["error"]
        p.same(script="clear\nset memsize 4096\n", tenant="evil")
        p.journal_kinds()


def test_repeated_request_hits_the_plan_cache(tmp_path):
    """The second identical request records no new plan in either
    package.  1,500 distinct words in 3,000 rows: the cold group's output
    keeps the rows' capacity (4,096), the warm one runs at the groups'
    (2,048), and the top-N's gather re-caps both alike."""
    corpus = write_corpus(tmp_path / "w.txt",
                          [f"w{i:04d}" for i in range(1500)], 2)
    script = wf_script(corpus, fuse=True, out="tmp.wf")
    with Pair(tmp_path, workers=2) as p:
        jc, tc = p.same(script=script)
        jw, tw = p.same(script=script)
    for cold, warm in ((jc, jw), (tc, tw)):
        assert cold["meta"]["plan_cache"]["plan"]["misses"] > 0
        assert warm["meta"]["plan_cache"]["plan"]["misses"] == 0
        assert warm["meta"]["plan_cache"]["plan"]["hits"] >= \
            cold["meta"]["plan_cache"]["plan"]["misses"]
        assert record(warm) == record(cold)
    assert tw["meta"]["dispatches"] == tc["meta"]["dispatches"]


def test_clear_prepend_and_a_torn_journal_tail(tmp_path):
    corpus = write_corpus(tmp_path / "w.txt", ["pre", "pend"], 10)
    with Pair(tmp_path, workers=1) as p:
        a, b = p.same(script=(f"mr pre\nclear\nvariable files index "
                              f"{corpus}\nwordfreq 2 -i v_files -o NULL "
                              f"after\n"))
        assert list(b["mrs"]) == ["after"]
        a, b = p.same(script=(f"set prepend sub\n"
                              f"variable files index {corpus}\n"
                              f"wordfreq 2 -i v_files -o nested.wf wf\n"))
        assert "sub/nested.wf" in b["files"]
        a, b = p.same(script="set prepend /tmp\nmr x\n")
        assert b["status"] == "failed" and "pinned" in b["error"]
    # a torn final record (kill -9 mid-append) is sealed on reopen, and
    # the JAX reader reads the port's journal the same way
    d = str(tmp_path / "j")
    j = Journal(d, script_mode=True)
    j.append({"kind": "serve_submit", "sid": "s1"})
    j.close()
    with open(j.path, "a") as f:
        f.write('{"kind": "serve_sub')
    j2 = Journal(d, script_mode=True)
    j2.append({"kind": "serve_submit", "sid": "s2"})
    j2.close()
    got = [(r.get("kind"), r.get("sid")) for r in read_journal(d)]
    assert got == [(r.get("kind"), r.get("sid")) for r in j_read_journal(d)]
    assert got == [("serve_submit", "s1"), ("serve_submit", "s2")]


def test_ttl_gc_and_priority_replay(tmp_path):
    with Pair(tmp_path, workers=1) as p:
        for srv in (p.j, p.t):
            srv.ttl_s = 0.05
        a, b = p.same(script="mr x\n")
        sdirs = (p.j.session_dir("s000001"), p.t.session_dir("s000001"))
        wait_until(lambda: all(time.time() - s.sessions["s000001"]
                               .finished_ts > 0.06 for s in (p.j, p.t)),
                   msg="the sessions to age past the TTL")
        wait_until(p.settled, msg="the serve_done records")
        assert p.j._gc_once() == p.t._gc_once() == 1
        assert not any(os.path.exists(d) for d in sdirs)
        (code, _, _), _ = p.http("GET", "/v1/jobs/s000001")
        assert code == 404
        assert p.journal_kinds() == ["serve_submit", "serve_done",
                                     "serve_gc"]
    # priority rides the journal: a restarted paused daemon takes the
    # high-priority session first, and the swept one never comes back
    with Pair(tmp_path, workers=0, paused=True) as p:
        lo = p.tc.submit(script="mr x\n", priority=0)["id"]
        hi = p.tc.submit(script="mr x\n", priority=7)["id"]
        assert p.jc.submit(script="mr x\n", priority=0)["id"] == lo
        assert p.jc.submit(script="mr x\n", priority=7)["id"] == hi
        assert summary(p.tc.status(hi)) == summary(p.jc.status(hi))
    t2 = Server(port=0, workers=0, paused=True, state_dir=p.tstate,
                device="cpu")
    t2.start()
    try:
        assert "s000001" not in t2.sessions
        first = t2.queue.take(0)
        assert (first.sid, first.priority) == (hi, 7)
        assert t2.queue.take(0).sid == lo
    finally:
        t2.shutdown()


def test_events_stream_and_trace_id_on_every_artifact(tmp_path):
    from gpu_mapreduce_tpu_torch import obs
    corpus = write_corpus(tmp_path / "w.txt", ["to", "be", "or"], 40)
    trace_path = str(tmp_path / "trace.jsonl")
    with Pair(tmp_path, workers=1) as p:
        obs.get_tracer().enable(jsonl=trace_path)
        r = p.tc.submit(script=wf_script(corpus), tenant="acme")
        rj = p.jc.submit(script=wf_script(corpus), tenant="acme")
        seen = list(p.tc.events(r["id"], timeout=WAIT))
        seen_j = list(p.jc.events(rj["id"], timeout=WAIT))
        for ev in (seen, seen_j):
            states = [e.get("state") for e in ev if e["event"] == "status"]
            assert states[-1] == "done"
            assert [e["event"] for e in ev][-2:] == ["profile", "status"]
        tid = r["trace_id"]
        res = p.tc.wait(r["id"])
        assert res["meta"]["trace_id"] == tid == \
            res["meta"]["profile"]["trace_id"]
        assert p.tc.status(r["id"])["trace_id"] == tid
        prof = p.tc.profile(r["id"])
        assert prof["trace_id"] == tid and prof["live"] is False
        assert prof["profile"]["stages"].get("oink.wordfreq")
        recs = read_journal(p.t.session_dir(r["id"]))
        assert recs and all(x.get("trace") == tid for x in recs)
        assert kinds(recs) == kinds(j_read_journal(p.j.session_dir(
            rj["id"])))
        mine = [e for e in obs.read_jsonl(trace_path)
                if e.get("trace") == tid]
        assert any(e["name"] == "oink.wordfreq" for e in mine)
        sub = [x for x in read_journal(p.tstate)
               if x.get("kind") == "serve_submit"]
        assert sub[0]["trace"] == tid
        # a finished session replays its profile, then the status
        assert [e["event"] for e in p.tc.events(r["id"], timeout=WAIT)] \
            == [e["event"] for e in p.jc.events(rj["id"], timeout=WAIT)] \
            == ["profile", "status"]
        obs.get_tracer().disable()


def test_meta_deltas_exact_under_two_concurrent_sessions(tmp_path):
    """Two sessions at once (a spilling one, a light one): each result's
    meta shows its own traffic only, and the light session's dispatches
    and plan deltas equal the same job run alone."""
    big = write_corpus(tmp_path / "big.txt",
                       [f"w{i:04d}" for i in range(200)], 1400)
    small = write_corpus(tmp_path / "small.txt", ["tiny", "data"], 10)
    light = wf_script(small, top=2, fuse=True)
    srv = Server(port=0, workers=2, state_dir=str(tmp_path / "state"),
                 device="cpu", budgets=TenantBudgets(pages=1, memsize=1))
    srv.start()
    try:
        c = ServeClient.local(srv.port)
        alone = c.wait(c.submit(script=light, tenant="light")["id"], WAIT)
        plan_cache().clear()
        ra = c.submit(script=wf_script(big, top=2), tenant="heavy")
        rb = c.submit(script=light, tenant="light")
        res_a, res_b = c.wait(ra["id"], WAIT), c.wait(rb["id"], WAIT)
    finally:
        srv.shutdown()
    assert res_a["status"] == res_b["status"] == "done"
    pa, pb = res_a["meta"]["profile"], res_b["meta"]["profile"]
    assert res_a["meta"]["trace_id"] != res_b["meta"]["trace_id"]
    assert pa["spill"]["write_bytes"] > 0
    assert pb["spill"]["write_bytes"] == pb["spill"]["read_bytes"] == 0
    assert "oink.wordfreq" in pa["stages"] and "oink.wordfreq" in pb["stages"]
    assert res_b["meta"]["dispatches"] == alone["meta"]["dispatches"]
    assert res_b["meta"]["plan_cache"]["plan"] == \
        alone["meta"]["plan_cache"]["plan"]
    assert record(res_b) == record(alone)


# ---------------------------------------------------------------------------
# kill -9 and the state directory read across the packages
# ---------------------------------------------------------------------------

def _golden(tmp_path, scripts, name="golden"):
    """The JAX daemon's uninterrupted results."""
    srv = JServer(port=0, workers=1, state_dir=str(tmp_path / name),
                  comm=j_make_mesh(1))
    srv.start()
    try:
        c = JServeClient.local(srv.port)
        return [c.wait(c.submit(script=s)["id"], WAIT) for s in scripts]
    finally:
        srv.shutdown()


def test_kill9_mid_queue_replays_byte_identical(tmp_path):
    corpora = [write_corpus(tmp_path / f"c{i}.txt",
                            [f"w{j}" for j in range(i + 2)], 30 + i)
               for i in range(3)]
    scripts = [wf_script(c, top=5, out=f"tmp.wf{i}")
               for i, c in enumerate(corpora)]
    golden = _golden(tmp_path, scripts)
    state = str(tmp_path / "state")
    p, port = spawn_port_daemon(state, ["--paused"])
    try:
        c = ServeClient.local(port)
        sids = [c.submit(script=s)["id"] for s in scripts]
        assert c.stats()["queue"]["depth"] == 3
    finally:
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
    p2, port2 = spawn_port_daemon(state, ["--workers", "2"])
    c2 = ServeClient.local(port2)
    try:
        replayed = [c2.wait(sid, timeout=WAIT) for sid in sids]
    finally:
        stop(p2, c2)
    for got, want in zip(replayed, golden):
        assert record(got) == record(want) and got["status"] == "done"
    assert kinds(read_journal(state)) == ["serve_submit"] * 3 + \
        ["serve_done"] * 3


def test_kill9_in_flight_session_resumes_from_checkpoint(tmp_path):
    """A session killed after its journal holds a checkpointed command
    resumes from the checkpoint on restart: its files equal an
    uninterrupted run's (the JAX daemon's), and it is flagged resumed."""
    corpus = write_corpus(tmp_path / "w.txt", ["p", "q", "p", "r"], 25)
    head = (f"variable files index {corpus}\n"
            f"wordfreq 3 -i v_files -o tmp.wf wf\n")
    tail = "wordfreq 2 -i v_files -o tmp.out NULL\n"
    script = head + "wordfreq 3 -i v_files\n" * 200 + tail
    # the commands between write no file: the golden files come from
    # the two that do
    golden = _golden(tmp_path, [head + tail])[0]
    state = str(tmp_path / "state")
    sjournal = os.path.join(state, "sessions", "s000001")
    p, port = spawn_port_daemon(state, ["--workers", "1"],
                                {"MRTPU_CKPT_EVERY": "1"})
    try:
        sid = ServeClient.local(port).submit(script=script)["id"]
        wait_until(lambda: "ckpt" in journal_kinds(sjournal),
                   msg="a checkpoint in the session journal")
    finally:
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
    assert "serve_done" not in kinds(read_journal(state))
    p2, port2 = spawn_port_daemon(state, ["--workers", "1"])
    c2 = ServeClient.local(port2)
    try:
        res = c2.wait(sid, timeout=WAIT)
    finally:
        stop(p2, c2)
    assert res["status"] == "done" and res["meta"]["resumed"] is True
    assert record(res)["files"] == record(golden)["files"]
    # the checkpointed commands' screen output is not replayed
    assert 0 < res["output"].count("WordFreq:") < 202


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_dir_read_across_the_packages(tmp_path, writer):
    """A paused daemon of one package accepts sessions; the other
    package's daemon replays its state directory and gives the files an
    uninterrupted run of the writer gives."""
    corpus = write_corpus(tmp_path / "w.txt", ["x", "y", "x", "z"], 30)
    scripts = [wf_script(corpus, out="tmp.wf"),
               "mr x\nx map/file " + corpus + " read_words\n"
               "x collate NULL\nx reduce count\n"]
    golden = _golden(tmp_path, scripts)
    state = str(tmp_path / "state")
    if writer == "jax":
        w = JServer(port=0, workers=0, paused=True, state_dir=state,
                    comm=j_make_mesh(1))
        w.start()
        c = JServeClient.local(w.port)
    else:
        w = Server(port=0, workers=0, paused=True, state_dir=state,
                   device="cpu")
        w.start()
        c = ServeClient.local(w.port)
    try:
        sids = [c.submit(script=s, priority=i)["id"]
                for i, s in enumerate(scripts)]
    finally:
        w.shutdown()
    if writer == "jax":
        r = Server(port=0, workers=1, state_dir=state, device="cpu")
        r.start()
        rc = ServeClient.local(r.port)
    else:
        r = JServer(port=0, workers=1, state_dir=state, comm=j_make_mesh(1))
        r.start()
        rc = JServeClient.local(r.port)
    try:
        got = [rc.wait(s, WAIT) for s in sids]
    finally:
        r.shutdown()
    for a, b in zip(got, golden):
        assert record(a) == record(b) and a["status"] == "done"
    recs = j_read_journal(state)
    assert kinds(recs) == kinds(read_journal(state)) == \
        ["serve_submit"] * 2 + ["serve_done"] * 2
    # replayed highest priority first
    assert [x["sid"] for x in recs if x["kind"] == "serve_done"] == \
        sids[::-1]


def _daemon_then_excepthook(root: str, cwd: str):
    """In one pytest process under ``root``'s tests, from ``cwd``: a
    daemon test, then the JAX test that calls ``sys.excepthook``."""
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("MRTPU_FLIGHT", None)
    tests = os.path.join(root, "tests")
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "--rootdir", root,
         os.path.join(tests, "test_torch_serve.py")
         + "::test_repeated_request_hits_the_plan_cache",
         os.path.join(tests, "test_metrics.py")
         + "::test_flight_dump_on_mrerror"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_daemon_tests_leave_no_flight_dump(tmp_path):
    """A daemon arms both packages' flight recorders in the working
    directory; after a daemon test, a later test's ``sys.excepthook`` in
    the same process must write no ``mr_flight.*.json`` there (the
    stray dumps of whole runs in the repo root)."""
    r = _daemon_then_excepthook(ROOT, str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "2 passed" in r.stdout
    assert not list(tmp_path.glob("mr_flight.*.json"))
