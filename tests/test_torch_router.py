"""The port's fleet router (``gpu_mapreduce_tpu_torch/serve/router.py``) and
the client's fleet discovery, against the JAX package's, on the CPU.

In-process ``Server(device="cpu")`` replicas behind a port ``Router``:
routing by consistent hash with reroutes, reads resolved along the claim
chain and answered from the shared result store when no live replica
holds the session, the honest 503 with ``Retry-After`` when none is
healthy, ``discover`` past a stale ``router.json``, the client's 307
follow.  One case drives a JAX fleet behind a JAX router and a port
fleet behind a port router through the same requests: the same status
codes, bodies (ids and times aside), members and router outcomes,
tokens armed and not.  The router runs as ``python -m
gpu_mapreduce_tpu_torch.serve --router`` too, and never initialises
CUDA.  No case sleeps a fixed time: each polls with a deadline."""

import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request

import pytest
import torch

from gpu_mapreduce_tpu.obs.metrics import get_registry as j_get_registry
from gpu_mapreduce_tpu.serve import Router as JRouter
from gpu_mapreduce_tpu_torch.obs.metrics import get_registry
from gpu_mapreduce_tpu_torch.serve import (FleetMember, Router, ServeClient,
                                           ServeError, owner_of)
from gpu_mapreduce_tpu_torch.serve.router import discover
from gpu_mapreduce_tpu_torch.serve.session import atomic_write_json

from test_torch_fleet import die, j_replica, replica, store_result
from test_torch_serve import (ROOT, WAIT, fresh,  # noqa: F401
                              no_flight_left, wait_until, wf_script,
                              write_corpus)


def test_client_finds_fleet_after_replica_death(tmp_path, monkeypatch):
    from gpu_mapreduce_tpu_torch.ft import retry as ft_retry
    monkeypatch.setattr(ft_retry, "_backoff", lambda a: 0.05)
    root = tmp_path / "fleet"
    a = replica(root, "a")
    b = replica(root, "b")
    a.start()
    b.start()
    try:
        c = ServeClient.from_state_dir(str(root), retries=4)
        assert c.stats()["fleet"] is not None
        victim = a if f":{a.port}" in c.base else b
        die(victim)
        wait_until(lambda: len(FleetMember(str(root), "probe").healthy())
                   == 1, msg="victim lease expiry")
        assert c.stats()["queue"]["cap"] == 8      # served by the survivor
    finally:
        for srv in (a, b):
            srv.shutdown()


def test_client_follows_router_redirect(tmp_path):
    root = tmp_path / "fleet"
    a = replica(root, "a")
    a.start()
    rt = Router(str(root), redirect_reads=True)
    rport = rt.start()
    try:
        c = ServeClient.local(rport)
        corpus = write_corpus(tmp_path / "w.txt", ["re", "direct"], 20)
        r = c.submit(script=wf_script(corpus, top=2))
        assert owner_of(r["id"]) == "a"
        assert c.wait(r["id"], WAIT)["status"] == "done"
        assert c.status(r["id"])["state"] == "done"     # via a 307 hop
        req = urllib.request.Request(
            f"http://127.0.0.1:{rport}/v1/jobs/{r['id']}")
        opener = urllib.request.build_opener(NoRedirect)
        with pytest.raises(urllib.error.HTTPError) as ei:
            opener.open(req, timeout=30)
        assert ei.value.code == 307
        assert ei.value.headers["Location"] == \
            f"http://127.0.0.1:{a.port}/v1/jobs/{r['id']}"
    finally:
        rt.stop()
        a.shutdown()


class NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kw):
        return None


def test_fleet_submit_read_roundtrip_via_router(tmp_path):
    root = tmp_path / "fleet"
    a = replica(root, "a")
    b = replica(root, "b")
    a.start()
    b.start()
    rt = Router(str(root))
    rport = rt.start()
    try:
        c = ServeClient.local(rport)
        corpus = write_corpus(tmp_path / "w.txt", ["to", "be", "or"], 40)
        subs = [c.submit(script=wf_script(corpus), tenant=f"t{i}",
                         session=f"k{i}") for i in range(4)]
        assert all(owner_of(r["id"]) in ("a", "b") for r in subs)
        for r in subs:
            res = c.wait(r["id"], timeout=WAIT)
            assert res["status"] == "done"
            assert "120 words, 3 unique" in res["output"]
            assert c.status(r["id"])["state"] == "done"
            assert c.profile(r["id"])["profile"]["dispatches"] >= 0
        st = c.stats()
        assert sorted(st["healthy"]) == ["a", "b"]
        assert {j["id"] for j in c.jobs()} >= {r["id"] for r in subs}
        # affinity: one session key lands on one replica
        same = {owner_of(c.submit(script=wf_script(corpus),
                                  session="sticky")["id"])
                for _ in range(3)}
        assert len(same) == 1
    finally:
        rt.stop()
        a.shutdown()
        b.shutdown()


def test_router_degraded_honest_503_and_healthy_subset(tmp_path):
    root = tmp_path / "fleet"
    os.makedirs(root, exist_ok=True)
    rt = Router(str(root))
    rport = rt.start()
    try:
        c = ServeClient.local(rport)
        with pytest.raises(ServeError) as ei:
            c.submit(script="mr x\n")
        assert ei.value.code == 503 and ei.value.retry_after >= 1
        with pytest.raises(ServeError) as ei:
            c.status("v.s000001")
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as hei:
            urllib.request.urlopen(f"http://127.0.0.1:{rport}/healthz",
                                   timeout=5)
        assert hei.value.code == 503
        a = replica(root, "a")
        b = replica(root, "b")
        a.start()
        b.start()
        try:
            corpus = write_corpus(tmp_path / "w.txt", ["s", "ub"], 10)
            r = c.submit(script=wf_script(corpus, top=2))
            assert c.wait(r["id"], timeout=WAIT)["status"] == "done"
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{b.port}/v1/drain", method="POST"),
                timeout=5)
            wait_until(lambda: rt.fleet.healthy() == ["a"],
                       msg="drained replica leaving the ring")
            for i in range(3):
                r2 = c.submit(script=wf_script(corpus, top=2),
                              session=f"k{i}")
                assert owner_of(r2["id"]) == "a"
            snap = get_registry().collect()["mrtpu_fleet_replicas"]
            by_state = {s["labels"]["state"]: s["value"]
                        for s in snap["samples"]}
            assert by_state.get("ready") == 1
            assert by_state.get("draining") == 1
        finally:
            a.shutdown()
            b.shutdown()
    finally:
        rt.stop()


def test_router_result_store_fallback_survives_owner_death(tmp_path):
    root = tmp_path / "fleet"
    a = replica(root, "a")
    a.start()
    rt = Router(str(root))
    rport = rt.start()
    try:
        c = ServeClient.local(rport)
        corpus = write_corpus(tmp_path / "w.txt", ["fa", "ll"], 12)
        r = c.submit(script=wf_script(corpus, top=2))
        res = c.wait(r["id"], timeout=WAIT)
        assert res["status"] == "done"
        die(a)
        wait_until(lambda: rt.fleet.healthy() == [],
                   msg="owner lease expiry")
        res2 = c.result(r["id"])
        assert res2["status"] == "done" and res2["output"] == res["output"]
        assert c.status(r["id"])["state"] == "done"
        prof = c.profile(r["id"])
        assert prof["live"] is False and prof["profile"]
        events = list(c.events(r["id"], timeout=30))
        assert events[-1]["event"] == "status"
        assert events[-1]["state"] == "done"
        with pytest.raises(ServeError) as ei:
            c.result("a.s999999")
        assert ei.value.code == 503
    finally:
        rt.stop()
        a.shutdown()


def test_router_reads_new_sids_on_rejoined_minter(tmp_path):
    root = tmp_path / "fleet"
    corpus = write_corpus(tmp_path / "w.txt", ["ne", "w"], 12)
    victim = replica(root, "v", workers=0, paused=True)
    victim.start()
    old_sid = ServeClient.local(victim.port).submit(
        script=wf_script(corpus, top=2))["id"]
    die(victim)
    survivor = replica(root, "s")
    survivor.start()
    rt = Router(str(root))
    rport = rt.start()
    v2 = None
    try:
        wait_until(lambda: store_result(root, old_sid) is not None,
                   msg="takeover result")
        v2 = replica(root, "v")
        v2.start()
        new_sid = ServeClient.local(v2.port).submit(
            script=wf_script(corpus, top=3))["id"]
        assert owner_of(new_sid) == "v" and new_sid != old_sid
        rc = ServeClient.local(rport)
        assert rc.status(new_sid)["state"] in ("queued", "running", "done")
        assert rc.wait(new_sid, timeout=WAIT)["status"] == "done"
        assert rc.result(old_sid)["status"] == "done"
    finally:
        rt.stop()
        if v2 is not None:
            v2.shutdown()
        survivor.shutdown()
        victim.shutdown()


def test_discover_skips_stale_router_record(tmp_path):
    root = tmp_path / "fleet"
    a = replica(root, "a")
    a.start()
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
        s.close()
        atomic_write_json(os.path.join(str(root), "router.json"),
                          {"port": dead_port, "pid": 2 ** 30})
        assert discover(str(root)) == ("replica", a.port)
        assert ServeClient.from_state_dir(str(root)).base.endswith(
            f":{a.port}")
        rt = Router(str(root))
        rport = rt.start()
        assert discover(str(root)) == ("router", rport)
        rt.stop()
        assert not os.path.exists(os.path.join(str(root), "router.json"))
        assert discover(str(root)) == ("replica", a.port)
    finally:
        a.shutdown()
    with pytest.raises(OSError):
        ServeClient.from_state_dir(str(root))     # nobody serves now


def test_router_fallback_when_claimant_never_adopted_sid(tmp_path):
    root = tmp_path / "fleet"
    corpus = write_corpus(tmp_path / "w.txt", ["ad", "opt"], 12)
    victim = replica(root, "v")
    victim.start()
    c = ServeClient.local(victim.port)
    sid = c.submit(script=wf_script(corpus, top=2))["id"]
    want = c.wait(sid, timeout=WAIT)
    assert want["status"] == "done"
    die(victim)
    survivor = replica(root, "s")
    survivor.start()
    rt = Router(str(root))
    rport = rt.start()
    try:
        wait_until(lambda: survivor._fleet.current_claim("v") is not None
                   and survivor._fleet.current_claim("v")[1].get("done"),
                   msg="claim completion")
        assert sid not in survivor.sessions
        rc = ServeClient.local(rport)
        assert rc.result(sid)["output"] == want["output"]
        assert rc.status(sid)["state"] == "done"
        with pytest.raises(ServeError) as ei:
            rc.result("v.s999999")
        assert ei.value.code == 404
    finally:
        rt.stop()
        survivor.shutdown()
        victim.shutdown()


# ---------------------------------------------------------------------------
# the same requests through a JAX fleet and a port fleet
# ---------------------------------------------------------------------------

def raw(port, method, path, body=None, token=None):
    """(code, parsed body or text, Retry-After) of one request."""
    data = body if isinstance(body, bytes) else \
        (json.dumps(body).encode() if body is not None else None)
    hdr = {"Content-Type": "application/json"} if data else {}
    if token:
        hdr["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method, headers=hdr)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            code, text, ra = r.status, r.read().decode(), \
                r.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        code, text, ra = e.code, e.read().decode(), \
            e.headers.get("Retry-After")
    try:
        return code, json.loads(text), ra
    except ValueError:
        return code, text, ra


_VOLATILE = {"submitted_utc", "wall_s", "trace_id", "utc", "age_s", "ts",
             "port", "epoch", "metrics", "stats", "fleet_dir"}


def scrub(x):
    """A body without ids' times, trace ids, ports and snapshots."""
    if isinstance(x, dict):
        return {k: scrub(v) for k, v in x.items() if k not in _VOLATILE}
    if isinstance(x, list):
        return [scrub(v) for v in x]
    return x


def drive_fleet(pkg, root, corpus, tokens):
    """One package's fleet (replica a, its router) through a fixed
    request sequence: [(step, code, scrubbed body, Retry-After)]."""
    mk = j_replica if pkg == "jax" else replica
    R = JRouter if pkg == "jax" else Router
    os.makedirs(root, exist_ok=True)
    out = []
    tok = {"admin": "tok-admin", "ta": "tok-a", "tb": "tok-b"} if tokens \
        else {"admin": None, "ta": None, "tb": None}

    def step(name, method, path, body=None, who="admin", keep=True):
        code, b, ra = raw(rport, method, path, body, tok[who])
        out.append((name, code, scrub(b) if keep else None,
                    ra is not None))
        return code, b

    rt = R(str(root))
    rport = rt.start()
    a = None
    try:
        step("submit-empty", "POST", "/v1/jobs", {"script": "mr x\n"})
        step("read-empty", "GET", "/v1/jobs/a.s000001")
        step("jobs-empty", "GET", "/v1/jobs")
        step("drain-empty", "POST", "/v1/drain")
        step("healthz-empty", "GET", "/healthz")
        a = mk(root, "a")
        a.start()
        step("bad-json", "POST", "/v1/jobs", b"{nope")
        code, sub = step("submit", "POST", "/v1/jobs",
                         {"script": wf_script(corpus, top=2),
                          "tenant": "ta", "session": "k0"}, who="ta")
        sid = sub["id"]
        wait_until(lambda: store_result(root, sid) is not None,
                   msg="the result")
        step("status", "GET", f"/v1/jobs/{sid}", who="ta")
        step("result", "GET", f"/v1/jobs/{sid}/result", who="ta",
             keep=False)
        step("cancel-done", "DELETE", f"/v1/jobs/{sid}", who="ta")
        step("unknown", "GET", "/v1/jobs/a.s999999")
        step("bad-path", "GET", "/v1/nope")
        step("jobs", "GET", "/v1/jobs")
        step("stats", "GET", "/v1/stats")
        step("stats-tenant", "GET", "/v1/stats", who="ta")
        code, fed = step("fleet-json", "GET", "/metrics/fleet.json",
                         keep=False)
        out.append(("members", code, [(m.get("replica"), m.get("up"),
                                       m.get("state"))
                                      for m in fed["members"]], False))
        code, text = step("fleet-text", "GET", "/metrics/fleet",
                          keep=False)
        out.append(("fleet-text-has-a", code, 'replica="a"' in text, False))
        step("healthz", "GET", "/healthz")
        die(a)
        wait_until(lambda: rt.fleet.healthy() == [],
                   msg="owner lease expiry")
        step("status-fallback", "GET", f"/v1/jobs/{sid}", who="ta")
        step("status-foreign", "GET", f"/v1/jobs/{sid}", who="tb")
        code, res = step("result-fallback", "GET", f"/v1/jobs/{sid}/result",
                         who="ta", keep=False)
        out.append(("result-output", code, res.get("output")
                    if isinstance(res, dict) else None, False))
        step("profile-fallback", "GET", f"/v1/jobs/{sid}/profile",
             who="ta", keep=False)
        step("cancel-fallback", "DELETE", f"/v1/jobs/{sid}", who="ta")
        step("unknown-down", "GET", "/v1/jobs/a.s999999")
        step("submit-down", "POST", "/v1/jobs", {"script": "mr x\n"})
        step("healthz-down", "GET", "/healthz")
        if tokens:
            code, b, ra = raw(rport, "GET", f"/v1/jobs/{sid}")
            out.append(("fallback-no-token", code, scrub(b), False))
    finally:
        rt.stop()
        if a is not None:
            a.shutdown()
    return out


@pytest.mark.parametrize("tokens", [False, True])
def test_router_answers_match_jax(tmp_path, monkeypatch, tokens):
    if tokens:
        monkeypatch.setenv("MRTPU_SERVE_TOKENS",
                           "ta=tok-a,tb=tok-b,*=tok-admin")
    corpus = write_corpus(tmp_path / "w.txt", ["ro", "ute", "ro"], 15)
    jreg = j_get_registry()
    before = {pkg: {} for pkg in ("jax", "port")}
    for pkg, reg in (("jax", jreg), ("port", get_registry())):
        c = reg.counter("mrtpu_fleet_router_total", "", ("outcome",))
        before[pkg] = {o: c.value(outcome=o) for o in
                       ("routed", "rerouted", "proxied", "fallback",
                        "unavailable")}
    got = {pkg: drive_fleet(pkg, str(tmp_path / pkg / "fleet"), corpus,
                            tokens) for pkg in ("jax", "port")}
    assert got["jax"] == got["port"]
    codes = {name: code for name, code, _, _ in got["port"]}
    assert codes["submit-empty"] == 503 and codes["read-empty"] == 503
    assert codes["result-fallback"] == 200
    assert codes["cancel-fallback"] == 409 and codes["unknown-down"] == 503
    if tokens:
        assert codes["status-foreign"] == 404
        assert codes["stats-tenant"] == 403
        assert codes["fallback-no-token"] == 401
    # the router's decisions, counted alike
    for pkg, reg in (("jax", jreg), ("port", get_registry())):
        c = reg.counter("mrtpu_fleet_router_total", "", ("outcome",))
        got[pkg] = {o: c.value(outcome=o) - before[pkg][o]
                    for o in before[pkg]}
    assert got["jax"] == got["port"]
    assert got["port"]["fallback"] >= 1 and got["port"]["unavailable"] >= 1


def test_router_process_serves_and_never_touches_the_card(tmp_path):
    """``python -m gpu_mapreduce_tpu_torch.serve --router --fleet D``
    serves (its first line names the fleet, its port lands in
    router.json); an in-process router leaves CUDA uninitialised."""
    root = tmp_path / "fleet"
    os.makedirs(root)
    p = subprocess.Popen(
        [sys.executable, "-m", "gpu_mapreduce_tpu_torch.serve", "--router",
         "--fleet", str(root), "--port", "0"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    try:
        line = json.loads(p.stdout.readline())
        assert line == {"serving": line["serving"], "router": True,
                        "fleet": str(root)}
        with open(root / "router.json") as f:
            assert json.load(f) == {"port": line["serving"], "pid": p.pid}
        assert discover(str(root)) == ("router", line["serving"])
        code, body, ra = raw(line["serving"], "POST", "/v1/jobs",
                             {"script": "mr x\n"})
        assert code == 503 and ra is not None
    finally:
        p.terminate()
        p.wait(timeout=60)
    assert p.returncode == 0
    assert not (root / "router.json").exists()
    # the same router with every way into CUDA booby-trapped, routing to
    # a live replica, federating its metrics and answering /metrics: it
    # calls none of them
    guard = ("import sys, runpy, torch\n"
             "def boom(*a, **k):\n"
             "    sys.stderr.write('CUDA CALLED\\n'); sys.stderr.flush()\n"
             "    raise RuntimeError('the router called into CUDA')\n"
             "for f in ('is_available', 'init', 'device_count',\n"
             "          'current_device', 'synchronize', 'set_device'):\n"
             "    setattr(torch.cuda, f, boom)\n"
             "torch._C._cuda_getDeviceCount = boom\n"
             "sys.argv = ['serve'] + sys.argv[1:]\n"
             "runpy.run_module('gpu_mapreduce_tpu_torch.serve',\n"
             "                 run_name='__main__', alter_sys=True)\n")
    a = replica(root, "a")
    a.start()
    p = subprocess.Popen(
        [sys.executable, "-c", guard, "--router", "--fleet", str(root),
         "--port", "0"], cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        port = json.loads(p.stdout.readline())["serving"]
        c = ServeClient.local(port)
        r = c.submit(script="mr x\n", session="k")
        assert c.wait(r["id"], WAIT)["status"] == "done"
        assert raw(port, "GET", "/metrics/fleet.json")[0] == 200
        code, text, _ = raw(port, "GET", "/metrics")
        assert code == 200 and "mrtpu_fleet_router_total" in text
        assert raw(port, "GET", "/healthz")[0] == 200
    finally:
        p.terminate()
        _, err = p.communicate(timeout=60)
        a.shutdown()
    assert p.returncode == 0 and b"CUDA CALLED" not in err, err[-2000:]
    rt = Router(str(root))
    rt.start()
    try:
        assert not torch.cuda.is_initialized()
        assert not hasattr(rt, "device")
    finally:
        rt.stop()
