"""The port's operator client (``python -m gpu_mapreduce_tpu_torch.ctl``)
against the reference package's ``scripts/mrctl.py``, on the CPU.

Each case runs one verb through the port's ``ctl`` against a port daemon
(``Server(device="cpu")``) and through ``scripts/mrctl.py`` against a
JAX daemon (``Server(comm=make_mesh(1))``) that took the same submits:
the exit codes must be equal, and so must stdout and stderr once ids'
times, trace ids, ports and paths are masked.  Masked as well are the
fields that differ between the packages by design: the device name, the
dispatch counts and per-op profiles (the two packages dispatch
differently), and the JAX package's own exchange-plan caches
(``shuffle_phase1``/``shuffle_phase2`` in ``stats``, ``shuffle.phase1``/
``shuffle.phase2`` in a result's ``plan_cache``), and the port's own
per-session kernel launch counts (``meta.kernels``).  ``top`` goes through each
package's router; ``_top_table`` is held equal on one document.  No case
sleeps a fixed time."""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import re
import socket

import pytest

from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.plan import cache as jcache
from gpu_mapreduce_tpu.serve import Router as JRouter
from gpu_mapreduce_tpu.serve import ServeClient as JServeClient
from gpu_mapreduce_tpu.serve import Server as JServer
from gpu_mapreduce_tpu.serve import memo as jmemo
from gpu_mapreduce_tpu.utils import cas as jcas
from gpu_mapreduce_tpu_torch import ctl
from gpu_mapreduce_tpu_torch.plan import cache as tcache
from gpu_mapreduce_tpu_torch.serve import Router, ServeClient, Server, memo
from gpu_mapreduce_tpu_torch.utils import cas as tcas

from test_torch_fleet import j_replica, replica
from test_torch_serve import (ROOT, WAIT, no_flight_left,  # noqa: F401
                              wait_until, write_corpus)

_spec = importlib.util.spec_from_file_location(
    "mrctl", os.path.join(ROOT, "scripts", "mrctl.py"))
mrctl = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mrctl)

DROP = {"trace_id", "submitted_utc", "wall_s", "utc", "port", "pid",
        "state_dir", "fleet_dir", "device", "dispatches", "profile", "ops",
        "critical_path", "shuffle_phase1", "shuffle_phase2",
        "shuffle.phase1", "shuffle.phase2", "age_s", "metrics", "kernels"}


def scrub(x):
    if isinstance(x, dict):
        return {k: scrub(v) for k, v in x.items() if k not in DROP}
    if isinstance(x, list):
        return [scrub(v) for v in x]
    if isinstance(x, float):
        return "<f>"
    return x


def mask(text: str, tmp: str) -> str:
    """stdout/stderr with the package's own tmp dir, times, trace ids
    and the by-design fields masked; JSON documents compared scrubbed."""
    text = text.replace(os.path.join(tmp, "jax"), "<pkg>").replace(
        os.path.join(tmp, "port"), "<pkg>")
    try:
        return json.dumps(scrub(json.loads(text)), sort_keys=True)
    except ValueError:
        pass
    out = []
    for line in text.splitlines():
        try:
            out.append(json.dumps(scrub(json.loads(line)), sort_keys=True))
        except ValueError:
            line = re.sub(r"\b[0-9a-f]{16}\b", "<hex>", line)
            line = re.sub(r"\d+\.\d+(e-?\d+)?", "<f>", line)
            out.append(re.sub(r"127\.0\.0\.1:\d+", "<addr>", line))
    return "\n".join(out)


def run(mod, argv):
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        try:
            rc = mod.main(argv)
        except SystemExit as x:
            rc = x.code
    return rc, o.getvalue(), e.getvalue()


class Pair:
    pass


def cold_counters():
    """Both packages' process-wide counters that ``stats`` and ``cache``
    print (the plan cache's, the fused groups', the memo's) back at 0,
    whatever ran earlier in this process."""
    for mod in (tcache, jcache):
        pc = mod.plan_cache()
        pc.clear()
        pc.hits = pc.misses = pc.evictions = 0
        mod.reset_fusion_stats()
    for fn in (memo.reset_counts, jmemo.reset_counts, tcas.reset_store,
               jcas.reset_store):
        fn()


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    """A JAX daemon and a port daemon with the same sessions: s000001
    done (a wordfreq with an -o file), s000002 failed; a paused replica
    of each package (queue of 2) and a one-replica fleet of each behind
    its router."""
    tmp = str(tmp_path_factory.mktemp("ctl"))
    cold_counters()
    p = Pair()
    p.tmp = tmp
    corpus = write_corpus(pathlib.Path(tmp, "w.txt"), ["a", "b", "a", "c"],
                          20)
    p.script = os.path.join(tmp, "s.oink")
    with open(p.script, "w") as f:
        f.write(f"variable files index {corpus}\n"
                f"wordfreq 2 -i v_files -o tmp.wf NULL\n")
    p.bad = os.path.join(tmp, "bad.oink")
    with open(p.bad, "w") as f:
        f.write("nosuchcommand 1\n")
    p.feed = os.path.join(tmp, "feed.txt")
    with open(p.feed, "w") as f:
        f.write("apple banana apple\ncherry\n")
    p.j = JServer(port=0, workers=1, comm=j_make_mesh(1),
                  state_dir=os.path.join(tmp, "jax", "state"))
    p.t = Server(port=0, workers=1, device="cpu",
                 state_dir=os.path.join(tmp, "port", "state"))
    p.jp = JServer(port=0, workers=0, paused=True, queue_cap=2,
                   comm=j_make_mesh(1), replica_id="p",
                   fleet_dir=os.path.join(tmp, "jax", "paused"))
    p.tp = Server(port=0, workers=0, paused=True, queue_cap=2,
                  device="cpu", replica_id="p",
                  fleet_dir=os.path.join(tmp, "port", "paused"))
    p.jf = j_replica(os.path.join(tmp, "jax", "fleet"), "a")
    p.tf = replica(os.path.join(tmp, "port", "fleet"), "a")
    for srv in (p.j, p.t, p.jp, p.tp, p.jf, p.tf):
        srv.start()
    p.jr = JRouter(os.path.join(tmp, "jax", "fleet"))
    p.tr = Router(os.path.join(tmp, "port", "fleet"))
    p.jr.start()
    p.tr.start()
    try:
        for C, srv in ((JServeClient, p.j), (ServeClient, p.t)):
            c = C.local(srv.port)
            for s in (p.script, p.bad):
                with open(s) as f:
                    c.wait(c.submit(script=f.read())["id"], WAIT)
        yield p
    finally:
        p.jr.stop()
        p.tr.stop()
        for srv in (p.j, p.t, p.jp, p.tp, p.jf, p.tf):
            srv.shutdown()


def both(d, args, where="main", pre=None):
    """One verb through mrctl (JAX daemon) and ctl (port daemon):
    (exit code, masked stdout, masked stderr) of each."""
    ports = {"main": (d.j.port, d.t.port), "paused": (d.jp.port, d.tp.port),
             "router": (d.jr.port, d.tr.port)}[where]
    out = []
    for mod, port in ((mrctl, ports[0]), (ctl, ports[1])):
        head = pre if pre is not None else ["--port", str(port)]
        rc, so, se = run(mod, head + args)
        out.append((rc, mask(so, d.tmp), mask(se, d.tmp)))
    assert out[0] == out[1]
    return out[1]


VERBS = {
    "status": (["status", "s000001"], 0),
    "status_all": (["status"], 0),
    "result": (["result", "s000001"], 0),
    "result_wait": (["result", "s000001", "--wait", "30"], 0),
    "result_failed": (["result", "s000002"], 5),
    "cancel_terminal": (["cancel", "s000001"], 0),
    "watch": (["watch", "s000001"], 0),
    "watch_failed": (["watch", "s000002"], 5),
    "unknown": (["status", "s999999"], 3),
    "slo": (["slo"], 0),
    "cache": (["cache"], 0),
    "cache_json": (["cache", "--json"], 0),
    "stats": (["stats"], 0),
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_read_verbs_match_mrctl(d, verb):
    args, code = VERBS[verb]
    rc, out, err = both(d, args)
    assert rc == code, (out, err)


def test_profile_matches_mrctl(d):
    """The per-request profile: the same exit code and the same keys (its
    dispatch counts and per-op times differ between the packages by
    design)."""
    got = []
    for mod, port in ((mrctl, d.j.port), (ctl, d.t.port)):
        rc, so, se = run(mod, ["--port", str(port), "profile", "s000001"])
        doc = json.loads(so)
        got.append((rc, sorted(doc), sorted(doc["profile"])))
    assert got[0] == got[1] and got[1][0] == 0


def test_submit_wait_and_failed_submit_match_mrctl(d):
    rc, out, _ = both(d, ["submit", d.script, "--wait"])
    assert rc == 0 and json.loads(out)["status"] == "done"
    rc, out, _ = both(d, ["submit", d.bad, "--wait"])
    assert rc == 5
    rc, out, _ = both(d, ["submit", d.script])
    assert rc == 0 and json.loads(out)["state"] in ("queued", "running")


def test_usage_and_unreachable_exit_codes(d, monkeypatch):
    monkeypatch.delenv("MRTPU_SERVE_STATE", raising=False)
    rc, _, err = both(d, ["stats"], pre=[])
    assert rc == 2 and "need --port or --state" in err
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    rc, _, err = both(d, ["stats"], pre=["--port", str(dead), "--retries",
                                          "0"])
    assert rc == 3 and "daemon unreachable" in err
    rc, _, err = both(d, ["stats"], pre=["--state", os.path.join(
        d.tmp, "nowhere")])
    assert rc == 3 and "cannot discover daemon" in err


def test_state_discovery_matches_mrctl(d, monkeypatch):
    """``--state DIR`` and ``MRTPU_SERVE_STATE`` read serve.json; a fleet
    directory discovers its router first."""
    out = []
    for mod, srv, fleet in ((mrctl, d.j, "jax"), (ctl, d.t, "port")):
        rc1, so1, _ = run(mod, ["--state", srv.state_dir, "status",
                                "s000001"])
        monkeypatch.setenv("MRTPU_SERVE_STATE", srv.state_dir)
        rc2, so2, _ = run(mod, ["status", "s000001"])
        monkeypatch.delenv("MRTPU_SERVE_STATE")
        rc3, so3, _ = run(mod, ["--state", os.path.join(d.tmp, fleet,
                                                        "fleet"), "stats"])
        out.append((rc1, mask(so1, d.tmp), rc2, mask(so2, d.tmp), rc3,
                    sorted(json.loads(so3))))
    assert out[0] == out[1]
    assert out[1][4] == 0
    assert out[1][5] == ["fleet_dir", "healthy", "replicas"]


def test_paused_queue_cancel_full_and_timeout_codes(d):
    """On a paused replica: a queued session cancelled (then ``result``
    exits 7), a full queue refused (exit 4, Retry-After on stderr), a
    ``--wait`` past its deadline (exit 6)."""
    rc, out, _ = both(d, ["submit", d.script], where="paused")
    assert rc == 0
    sid = json.loads(out)["id"]
    rc, out, _ = both(d, ["cancel", sid], where="paused")
    assert rc == 0
    wait_until(lambda: d.tp.sessions[sid].state == "cancelled",
               msg="the cancel")
    wait_until(lambda: d.jp.sessions[sid].state == "cancelled",
               msg="the cancel")
    rc, out, _ = both(d, ["result", sid], where="paused")
    assert rc == 7
    rc, out, _ = both(d, ["submit", d.script, "--wait", "--timeout", "0.3"],
                      where="paused")
    assert rc == 6
    # the timed-out session holds its slot: the queue of 2 is full now
    assert d.tp.queue.depth() == d.jp.queue.depth() == 2
    rc, out, err = both(d, ["submit", d.script], where="paused")
    assert rc == 4 and "Retry-After:" in err


def test_stream_verbs_match_mrctl(d):
    rc, out, _ = both(d, ["stream", "open", "--tenant", "acme"])
    assert rc == 0
    stid = json.loads(out)["id"]
    assert both(d, ["stream", "feed", stid, d.feed])[0] == 0
    for srv in (d.j, d.t):
        wait_until(lambda: srv.streams.get(stid).engine is not None
                   and srv.streams.get(stid).engine.seq >= 1,
                   msg="the first micro-batch")
    assert both(d, ["stream", "status", stid])[0] == 0
    assert both(d, ["stream", "status"])[0] == 0
    rc, out, _ = both(d, ["stream", "close", stid])
    assert rc == 0 and json.loads(out)["state"] == "closed"
    assert both(d, ["stream", "watch", stid, "--timeout", "30"])[0] == 0


def test_top_through_the_router_matches_mrctl(d):
    for who in (d.jr, d.tr):
        wait_until(lambda: who.fleet.healthy() == ["a"], msg="the ring")
    rc, out, _ = both(d, ["top", "--json"], where="router")
    assert rc == 0
    members = json.loads(out)["members"]
    assert [(m["replica"], m["up"], m["stale"], m["state"])
            for m in members] == [("a", True, False, "ready")]
    got = []
    for mod, port in ((mrctl, d.jr.port), (ctl, d.tr.port)):
        rc, so, _ = run(mod, ["--port", str(port), "top"])
        # the series column counts each package's own metric families
        got.append((rc, [ln.split()[:4] for ln in so.splitlines()]))
    assert got[0] == got[1] and got[1][0] == 0


def test_top_table_equal_on_one_doc():
    doc = {"members": [
        {"replica": "r1", "state": "ready", "up": True, "stale": False,
         "age_s": 0.25, "metrics": {
             "mrtpu_dist_sync_spread_seconds": {"samples": [
                 {"sum": 1.5, "count": 3}, {"sum": 0.5, "count": 1}]},
             "mrtpu_sessions_active": {"samples": []}}},
        {"rank": "2", "state": "done", "up": False, "stale": True,
         "age_s": 12.0, "metrics": None},
        {"replica": "r2", "state": "expired", "up": False, "stale": True,
         "age_s": 3.0}]}
    assert ctl._top_table(doc) == mrctl._top_table(doc)
    assert ctl._top_table({}) == mrctl._top_table({})
    assert "(no federation members)" in ctl._top_table({})
    cache = {"cache": {"cas": {"enabled": 1, "chunks": 3, "bytes": 10},
                       "memo": {"hits": 2, "misses": 1},
                       "gc": {"swept": 1}},
             "plan": {"persistent": {"entries": 4, "hits": 0,
                                     "misses": 0}}}
    assert ctl._cache_table(cache) == mrctl._cache_table(cache)
    for r in ({"status": "done"}, {"state": "failed"},
              {"status": "cancelled"}, {}):
        assert ctl._terminal_code(r) == mrctl._terminal_code(r)


def test_drain_and_shutdown_match_mrctl(d):
    """Last in this file: the module's main daemons drain, then stop."""
    rc, out, _ = both(d, ["drain"])
    assert rc == 0
    rc, out, err = both(d, ["submit", d.script])
    assert rc == 4 and "Retry-After:" in err
    rc, out, _ = both(d, ["shutdown"])
    assert rc == 0
    for srv in (d.j, d.t):
        wait_until(lambda: srv._stopped.is_set(), msg="the shutdown")
