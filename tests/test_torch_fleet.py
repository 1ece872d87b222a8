"""The port's serve fleet (``gpu_mapreduce_tpu_torch/serve/fleet.py`` and
the daemon's fleet mode) against the JAX package's, on the CPU.

Lease, epoch and claim units and the consistent-hash ring, each held
against the JAX package on the same inputs; lease and claim files
written by one package and read by the other; journal recovery under a
completed and an unfinished claim replaying the same sessions as the JAX
daemon; lease-fenced failover between in-process ``Server(device="cpu")``
replicas (a dead replica is one whose heartbeat is suspended and whose
listener is stopped, as a kill -9 leaves it); the fleet memo and the
takeover of a dead replica's streams; and the kill -9 golden: three port
replicas run as ``python -m gpu_mapreduce_tpu_torch.serve --device cpu``,
one SIGKILLed with a mid-run and two queued sessions, whose files equal
a JAX single daemon's byte for byte, each session run exactly once.  No
case sleeps a fixed time: each polls with a deadline."""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gpu_mapreduce_tpu.ft.journal import Journal as JJournal
from gpu_mapreduce_tpu.ft.journal import read_journal as j_read_journal
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.serve import FleetMember as JFleetMember
from gpu_mapreduce_tpu.serve import ServeClient as JServeClient
from gpu_mapreduce_tpu.serve import Server as JServer
from gpu_mapreduce_tpu.serve import owner_of as j_owner_of
from gpu_mapreduce_tpu.serve import ring_route as j_ring_route
from gpu_mapreduce_tpu.serve.fleet import ring_hash as j_ring_hash
from gpu_mapreduce_tpu_torch import MRError
from gpu_mapreduce_tpu_torch.ft.journal import Journal, read_journal
from gpu_mapreduce_tpu_torch.obs.metrics import get_registry
from gpu_mapreduce_tpu_torch.oink.script import OinkScript
from gpu_mapreduce_tpu_torch.serve import (FleetMember, ServeClient,
                                           ServeError, Server, memo,
                                           owner_of, ring_route)
from gpu_mapreduce_tpu_torch.serve.fleet import ring_hash
from gpu_mapreduce_tpu_torch.utils.cas import reset_store

from test_torch_serve import (ROOT, WAIT, fresh, no_flight_left,  # noqa: F401
                              record, wait_until, wf_script, write_corpus)


def replica(root, rid, *, workers=1, paused=False, lease_s=0.6,
            heartbeat_s=0.1, **kw):
    return Server(port=0, workers=workers, queue_cap=8,
                  fleet_dir=str(root), replica_id=rid, paused=paused,
                  lease_s=lease_s, heartbeat_s=heartbeat_s, device="cpu",
                  **kw)


def j_replica(root, rid, *, workers=1, paused=False, lease_s=0.6,
              heartbeat_s=0.1):
    return JServer(port=0, workers=workers, queue_cap=8,
                   fleet_dir=str(root), replica_id=rid, paused=paused,
                   lease_s=lease_s, heartbeat_s=heartbeat_s,
                   comm=j_make_mesh(1))


def store_result(root, sid):
    """A terminal session read straight from the fleet's shared result
    store (what takeover dedupe and the router's fallback read)."""
    try:
        with open(os.path.join(str(root), "results", sid + ".json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def die(srv):
    """A kill -9 of an in-process replica: the lease stays on disk (no
    graceful leave), the listener stops answering, the heartbeat
    stalls."""
    srv._fleet_suspended = True
    if srv._listener is not None:
        srv._listener.stop()


def golden(tmp_path, scripts):
    """The JAX single daemon's uninterrupted results."""
    srv = JServer(port=0, workers=1, state_dir=str(tmp_path / "golden"),
                  comm=j_make_mesh(1))
    srv.start()
    try:
        c = JServeClient.local(srv.port)
        return [c.wait(c.submit(script=s)["id"], WAIT) for s in scripts]
    finally:
        srv.shutdown()


def shas(res):
    return {k: v["sha256"] for k, v in res["files"].items()}


# ---------------------------------------------------------------------------
# lease / epoch / claim units, each beside the JAX package
# ---------------------------------------------------------------------------

def test_lease_roundtrip_expiry_and_clock_skew(tmp_path):
    m = FleetMember(str(tmp_path), "a", heartbeat_s=0.05, lease_s=0.5,
                    skew_s=0.3)
    m.join(1234, str(tmp_path / "sa"))
    lease = m.lease("a")
    assert lease["rid"] == "a" and lease["port"] == 1234
    assert lease["pid"] == os.getpid()
    assert lease["epoch"] == m.epoch >= 1
    assert not m.expired(lease)
    # dead only past expires + skew
    assert not m.expired(lease, now=lease["expires"] + 0.2)
    assert m.expired(lease, now=lease["expires"] + 0.31)
    assert m.replica_state("a") == "ready"
    m.renew(state="draining")
    assert m.replica_state("a") == "draining"
    assert m.healthy() == []
    m.leave()
    assert m.lease("a") is None
    assert m.replica_state("a") == "expired"


def test_join_epochs_strictly_increase(tmp_path):
    a = FleetMember(str(tmp_path), "a")
    b = FleetMember(str(tmp_path), "b")
    ea = a.join(1, "sa")
    eb = b.join(2, "sb")
    assert eb > ea
    claim = b.claim("a")
    assert claim["epoch"] > eb
    ea2 = a.join(1, "sa")
    assert ea2 > claim["epoch"]
    assert not a.fenced()           # the claim covers only the old epoch


def test_bad_replica_ids_rejected(tmp_path):
    for bad in ("a.b", "a/b", "", "a b"):
        with pytest.raises(MRError):
            FleetMember(str(tmp_path), bad)


def test_claim_race_exactly_one_winner(tmp_path):
    dead = FleetMember(str(tmp_path), "dead")
    dead.join(1, "sd")
    members = [FleetMember(str(tmp_path), f"s{i}") for i in range(4)]
    for i, m in enumerate(members):
        m.join(10 + i, f"s{i}")
    barrier = threading.Barrier(len(members))
    wins = [None] * len(members)

    def race(i):
        barrier.wait()
        wins[i] = members[i].claim("dead")

    threads = [threading.Thread(target=race, args=(i,))
               for i in range(len(members))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(1 for w in wins if w is not None) == 1
    assert len(dead.claims("dead")) == 1
    assert dead.fenced()


def test_claim_supersede_only_past_claimant_death(tmp_path):
    dead = FleetMember(str(tmp_path), "dead")
    dead.join(1, "sd")
    b = FleetMember(str(tmp_path), "b", lease_s=0.2, skew_s=0.05)
    b.join(2, "sb")
    c = FleetMember(str(tmp_path), "c", lease_s=0.2, skew_s=0.05)
    c.join(3, "sc")
    claim_b = b.claim("dead")
    assert claim_b is not None and claim_b["gen"] == 0
    assert c.claim("dead") is None           # b is live, mid-takeover
    assert b.claim("dead")["gen"] == 0       # b resumes its own claim
    wait_until(lambda: c.expired(c.lease("b") or {}), timeout=10,
               msg="claimant lease expiry")
    claim_c = c.claim("dead")
    assert claim_c is not None and claim_c["gen"] == 1
    c.claim_done("dead", 1)
    assert c.lease("dead") is None           # the dead lease retires
    assert "dead" not in c.peers()
    assert c.current_claim("dead")[1].get("done") is True


def test_ring_route_stable_and_minimal_remap():
    rids = ["r1", "r2", "r3"]
    keys = [f"k{i}" for i in range(200)]
    placed = {k: ring_route(k, rids) for k in keys}
    assert placed == {k: ring_route(k, rids) for k in keys}
    assert {placed[k] for k in keys} == set(rids)
    for k in keys:
        if placed[k] != "r2":
            assert ring_route(k, ["r1", "r3"]) == placed[k]
    assert ring_route("x", []) is None


def test_owner_of_sid():
    assert owner_of("r1.s000001") == "r1"
    assert owner_of("r1.st000002") == "r1"
    assert owner_of("s000001") is None


@pytest.mark.parametrize("vnodes", [1, 7, 64])
def test_ring_hash_route_and_owner_equal_jax(vnodes):
    rng = np.random.default_rng(20261018 + vnodes)
    keys = [f"k{int(x)}" for x in rng.integers(0, 1 << 40, 300)] + \
        ["", "x", "é", "a.b.s000001"]
    for key in keys:
        assert ring_hash(key) == j_ring_hash(key)
    for n in (1, 2, 3, 5, 8):
        rids = sorted({f"r{int(x)}" for x in rng.integers(0, 1000, n)})
        for key in keys:
            assert ring_route(key, rids, vnodes=vnodes) == \
                j_ring_route(key, rids, vnodes=vnodes)
    for sid in ("r1.s000001", "s000001", "a.b.s000002", "r9.st000003"):
        assert owner_of(sid) == j_owner_of(sid)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lease_and_claim_files_read_across_packages(tmp_path, writer):
    """Leases and claims written by one package read the same through
    either package's FleetMember: epochs, expiry, the current claim,
    fencing, replica states and the healthy ring."""
    W = JFleetMember if writer == "jax" else FleetMember
    root = str(tmp_path)
    a = W(root, "a", lease_s=30.0, skew_s=1.0)
    b = W(root, "b", lease_s=30.0, skew_s=1.0)
    v = W(root, "v", lease_s=30.0, skew_s=1.0)
    a.join(11, os.path.join(root, "sa"))
    v.join(13, os.path.join(root, "sv"))
    b.join(12, os.path.join(root, "sb"), state="draining")
    claim = a.claim("v")
    assert claim is not None
    readers = {"jax": JFleetMember(root, "probe"),
               "port": FleetMember(root, "probe")}

    def view(m):
        now = time.time()
        return {"peers": {rid: {k: lease[k] for k in
                                ("rid", "epoch", "state", "port", "pid",
                                 "state_dir", "ttl")}
                          for rid, lease in m.peers().items()},
                "expired": {rid: m.expired(lease, now)
                            for rid, lease in m.peers().items()},
                "dead_later": {rid: m.expired(lease, lease["expires"] + 5)
                               for rid, lease in m.peers().items()},
                "states": {rid: m.replica_state(rid, lease, now)
                           for rid, lease in m.peers().items()},
                "healthy": m.healthy(now),
                "claim": m.current_claim("v"),
                "claims": m.claims("v"),
                "next_epoch": m._next_epoch()}

    got = {k: view(m) for k, m in readers.items()}
    assert got["jax"] == got["port"]
    assert got["port"]["states"] == {"a": "ready", "b": "draining",
                                     "v": "fenced"}
    assert got["port"]["claim"][1]["epoch"] > got["port"]["peers"]["v"][
        "epoch"]
    # the victim's own view: fenced in both packages
    for P in (JFleetMember, FleetMember):
        me = P(root, "v")
        me.epoch = v.epoch
        assert me.fenced()
    # the claim completed by the OTHER package reads done in both
    R = FleetMember if writer == "jax" else JFleetMember
    R(root, "a").claim_done("v", claim["gen"])
    for m in readers.values():
        assert m.current_claim("v")[1]["done"] is True
        assert m.lease("v") is None
    # the files hold the same fields whichever package wrote them
    lease_keys = set(json.load(open(a.lease_path("a"))))
    assert lease_keys == {"rid", "epoch", "state", "ts", "ttl", "expires",
                          "port", "pid", "state_dir"}
    assert set(json.load(open(a.claim_path("v", 0)))) == \
        {"claimed", "by", "epoch", "gen", "utc", "done"}


# ---------------------------------------------------------------------------
# the serve plane's satellites: Retry-After floor, healthz, client retries
# ---------------------------------------------------------------------------

def test_retry_after_floor_with_zero_workers(tmp_path):
    srv = Server(port=0, workers=0, paused=True, device="cpu",
                 state_dir=str(tmp_path / "state"))
    srv._ewma_wall = 0.0
    assert srv.retry_after() == Server._RETRY_AFTER_IDLE
    live = Server(port=0, workers=1, device="cpu",
                  state_dir=str(tmp_path / "live"))
    live.start()
    try:
        live._ewma_wall = 0.0
        assert live.retry_after() >= 1
    finally:
        live.shutdown()


def test_shutdown_leaves_no_lease_behind_a_heartbeat(tmp_path):
    """A graceful shutdown stops the heartbeat before it drops the lease:
    a renew in flight when the shutdown begins must not write the lease
    again after the leave (a ``ready`` lease left behind would count in
    every later ``mrtpu_fleet_replicas`` scrape of the process)."""
    root = tmp_path / "fleet"
    srv = replica(root, "a", heartbeat_s=0.02)
    srv.start()
    real_renew = srv._fleet.renew
    entered, release = threading.Event(), threading.Event()

    def slow_renew(**kw):
        entered.set()
        release.wait(timeout=WAIT)
        return real_renew(**kw)
    srv._fleet.renew = slow_renew
    assert entered.wait(timeout=WAIT)
    stopper = threading.Thread(target=srv.shutdown)
    stopper.start()
    wait_until(lambda: srv._stopped.is_set(), msg="the shutdown's start")
    release.set()
    stopper.join(timeout=WAIT)
    assert not stopper.is_alive()
    assert not os.path.exists(srv._fleet.lease_path("a"))


def healthz(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=5) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_healthz_of_fleet_replicas_matches_jax(tmp_path):
    """A fleet replica answers its own /healthz on its private listener:
    ready, draining after /v1/drain, draining while paused — the same
    codes and bodies as the JAX package's replicas."""
    out = {}
    for name, mk in (("jax", j_replica), ("port", replica)):
        root = tmp_path / name
        srv = mk(root, "a")
        paused = mk(root, "p", workers=0, paused=True)
        srv.start()
        paused.start()
        try:
            seen = [healthz(srv.port), healthz(paused.port)]
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/drain", method="POST"),
                timeout=5)
            seen.append(healthz(srv.port))
            out[name] = seen
        finally:
            srv.shutdown()
            paused.shutdown()
    assert out["jax"] == out["port"] == [
        (200, {"status": "ok"}), (503, {"status": "draining"}),
        (503, {"status": "draining"})]


def test_client_retries_connection_refused(monkeypatch):
    from gpu_mapreduce_tpu_torch.ft import retry as ft_retry
    monkeypatch.setattr(ft_retry, "_backoff", lambda a: 0.0)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    calls = {"n": 0}
    c = ServeClient.local(port, retries=2, timeout=2.0)
    orig = c._req_once

    def counting(method, path, obj=None, hops=0):
        calls["n"] += 1
        return orig(method, path, obj, hops)

    c._req_once = counting
    with pytest.raises(OSError):
        c.stats()
    assert calls["n"] == 3          # 1 try + 2 retries
    with pytest.raises(OSError):
        ServeClient.local(port, retries=0, timeout=2.0).stats()


# ---------------------------------------------------------------------------
# lease-fenced failover between in-process replicas
# ---------------------------------------------------------------------------

def test_failover_claims_and_replays_dead_replica(tmp_path):
    root = tmp_path / "fleet"
    corpus = write_corpus(tmp_path / "w.txt", ["p", "q", "p"], 25)
    script = wf_script(corpus, top=2, out="tmp.wf")
    want = golden(tmp_path, [script])[0]
    victim = replica(root, "v", workers=0, paused=True)
    victim.start()
    c = ServeClient.local(victim.port)
    sids = [c.submit(script=script)["id"] for _ in range(2)]
    assert all(s.startswith("v.") for s in sids)
    die(victim)
    survivor = replica(root, "s", workers=1)
    survivor.start()
    try:
        wait_until(lambda: all(store_result(root, s) for s in sids),
                   msg="failed-over results")
        for sid in sids:
            res = store_result(root, sid)
            assert record(res) == record(want)
            assert res["meta"]["failed_over"] is True
        claims = [r for r in read_journal(victim.state_dir)
                  if r.get("kind") == "fleet_claimed"]
        assert claims and claims[0]["by"] == "s"
        assert claims[0]["epoch"] > victim._fleet.epoch
        assert survivor._fleet.current_claim("v")[1].get("done") is True
        reg = get_registry()
        assert reg.counter("mrtpu_fleet_failovers_total", "").value() >= 1
        assert reg.histogram("mrtpu_fleet_failover_seconds",
                             "").samples()[0]["count"] >= 1
    finally:
        survivor.shutdown()
        victim.shutdown()


def test_revived_replica_is_fenced_never_double_executes(tmp_path):
    root = tmp_path / "fleet"
    corpus = write_corpus(tmp_path / "w.txt", ["f", "en", "ce"], 20)
    victim = replica(root, "v", workers=1, paused=True)
    victim.start()
    c = ServeClient.local(victim.port)
    sid = c.submit(script=wf_script(corpus, top=2))["id"]
    victim._fleet_suspended = True       # stalls, but the process lives
    survivor = replica(root, "s", workers=1)
    survivor.start()
    try:
        wait_until(lambda: store_result(root, sid) is not None,
                   msg="failed-over result")
        assert store_result(root, sid)["status"] == "done"
        victim._fleet_suspended = False  # revival
        victim._start_workers()
        wait_until(lambda: victim.fenced_drops >= 1, msg="fenced drop")
        assert victim._fence_ok() is False
        wait_until(lambda: victim._fenced, msg="fence flag via heartbeat")
        assert victim.stats()["fleet"]["fenced"] is True
        assert healthz(victim.port) == (503, {"status": "fenced"})
        with pytest.raises(ServeError) as ei:
            c.submit(script="mr x\n")
        assert ei.value.code == 503
        with pytest.raises(ServeError) as ei:
            c.stream_open()
        assert ei.value.code == 503
        assert survivor.sessions[sid].state == "done"
        assert get_registry().counter(
            "mrtpu_fleet_fenced_total", "", ("rid",)).value(rid="v") >= 1
        done = [r["sid"] for st in (victim.state_dir, survivor.state_dir)
                for r in read_journal(st) if r.get("kind") == "serve_done"]
        assert done.count(sid) == 1
    finally:
        survivor.shutdown()
        victim.shutdown()


def test_two_survivors_race_one_claim_one_execution(tmp_path):
    root = tmp_path / "fleet"
    corpus = write_corpus(tmp_path / "w.txt", ["ra", "ce"], 15)
    victim = replica(root, "v", workers=0, paused=True)
    victim.start()
    c = ServeClient.local(victim.port)
    sid = c.submit(script=wf_script(corpus, top=2))["id"]
    die(victim)
    s1 = replica(root, "s1", workers=1)
    s2 = replica(root, "s2", workers=1)
    s1.start()
    s2.start()
    try:
        wait_until(lambda: store_result(root, sid) is not None,
                   msg="failed-over result")
        assert len(s1._fleet.claims("v")) == 1
        owners = [s for s in (s1, s2) if sid in s.sessions]
        assert len(owners) == 1
        res = ServeClient.local(owners[0].port).wait(sid, timeout=WAIT)
        assert res["status"] == "done" and res["meta"]["failed_over"]
    finally:
        s1.shutdown()
        s2.shutdown()
        victim.shutdown()


def _fence_by_dead_claimant(root, victim, lease_s):
    """A claimant that wins the claim, writes the fence record into the
    victim's journal and dies before re-journaling anything."""
    s1 = FleetMember(str(root), "s1", lease_s=lease_s, skew_s=0.05)
    s1.join(1, os.path.join(str(root), "replicas", "s1"))
    claim1 = s1.claim("v")
    assert claim1 is not None and claim1["gen"] == 0
    fj = Journal(victim.state_dir, script_mode=True)
    try:
        fj.append({"kind": "fleet_claimed", "dead": "v", "by": "s1",
                   "epoch": claim1["epoch"], "gen": 0})
    finally:
        fj.close()
    return s1


def test_supersede_after_claimant_death_completes_sessions(tmp_path):
    root = tmp_path / "fleet"
    corpus = write_corpus(tmp_path / "w.txt", ["su", "per"], 15)
    victim = replica(root, "v", workers=0, paused=True)
    victim.start()
    c = ServeClient.local(victim.port)
    sid = c.submit(script=wf_script(corpus, top=2))["id"]
    die(victim)
    _fence_by_dead_claimant(root, victim, 0.3)
    survivor = replica(root, "s2", workers=1)
    survivor.start()
    try:
        wait_until(lambda: store_result(root, sid) is not None,
                   msg="superseded-takeover result")
        res = store_result(root, sid)
        assert res["status"] == "done" and res["meta"]["failed_over"]
        gens = dict(survivor._fleet.claims("v"))
        assert set(gens) == {0, 1}
        assert not gens[0].get("done")
        assert gens[1]["by"] == "s2" and gens[1]["done"] is True
    finally:
        survivor.shutdown()
        victim.shutdown()


def test_restart_under_unfinished_claim_reclaims_own_sessions(tmp_path):
    root = tmp_path / "fleet"
    corpus = write_corpus(tmp_path / "w.txt", ["re", "cl"], 15)
    victim = replica(root, "v", workers=0, paused=True)
    victim.start()
    c = ServeClient.local(victim.port)
    sid = c.submit(script=wf_script(corpus, top=2))["id"]
    die(victim)
    _fence_by_dead_claimant(root, victim, 0.2)
    probe = FleetMember(str(root), "probe")
    wait_until(lambda: probe.expired(probe.lease("s1") or {}),
               msg="claimant death")
    v2 = replica(root, "v", workers=1)
    v2.start()
    try:
        wait_until(lambda: store_result(root, sid) is not None,
                   msg="reclaimed result")
        assert store_result(root, sid)["status"] == "done"
        gens = dict(v2._fleet.claims("v"))
        assert set(gens) == {0, 1}
        assert gens[1]["by"] == "v" and gens[1]["done"] is True
        assert not v2._fenced and not v2._fleet.fenced()
    finally:
        v2.shutdown()
        victim.shutdown()


def _recovery_case(pkg, root, case):
    """One package's replica ``v`` accepts two sessions, dies, is claimed
    (``case``), rejoins, accepts a third and stops; then ``v`` restarts
    paused.  Returns the sessions its recovery replays and the claim
    generations (by, done)."""
    mk = j_replica if pkg == "jax" else replica
    M = JFleetMember if pkg == "jax" else FleetMember
    Jn = JJournal if pkg == "jax" else Journal
    C = JServeClient if pkg == "jax" else ServeClient
    v = mk(root, "v", workers=0, paused=True)
    v.start()
    c = C.local(v.port)
    for _ in range(2):
        c.submit(ops=["mr x"])
    v._fleet_suspended = True
    v._listener.stop()
    s1 = M(str(root), "s1", lease_s=30.0 if case != "dead" else 0.2,
           skew_s=0.05)
    s1.join(1, os.path.join(str(root), "replicas", "s1"))
    claim = s1.claim("v")
    fj = Jn(v.state_dir, script_mode=True)
    try:
        fj.append({"kind": "fleet_claimed", "dead": "v", "by": "s1",
                   "epoch": claim["epoch"], "gen": claim["gen"]})
    finally:
        fj.close()
    if case == "completed":
        s1.claim_done("v", claim["gen"])
    v.shutdown()
    if case == "dead":
        probe = M(str(root), "probe")       # the restart's skew view
        wait_until(lambda: probe.expired(probe.lease("s1") or {}),
                   msg="claimant death")
    v2 = mk(root, "v", workers=0, paused=True)
    v2.start()
    try:
        if case == "completed":
            # post-rejoin work at a newer epoch, then a crash
            C.local(v2.port).submit(ops=["mr y"])
    finally:
        v2._fleet_suspended = True
        v2._listener.stop()
        v2.shutdown()
    v3 = mk(root, "v", workers=0, paused=True)
    v3.start()
    try:
        replayed = sorted(v3.sessions)
        depth = v3.queue.depth()
    finally:
        v3.shutdown()
    gens = [(g, r.get("by"), bool(r.get("done")))
            for g, r in M(str(root), "probe").claims("v")]
    return replayed, depth, gens


@pytest.mark.parametrize("case", ["completed", "dead", "live"])
def test_recovery_under_claims_replays_the_same_sids_as_jax(tmp_path, case):
    """Journal recovery under a completed claim (its submits belong to
    the claimant; post-rejoin submits replay), an unfinished claim whose
    claimant died (the replica re-claims its own journal and replays
    everything) and an unfinished claim whose claimant lives (the
    claimant keeps it): the same sessions and claim chains as JAX's."""
    got = {pkg: _recovery_case(pkg, tmp_path / pkg, case)
           for pkg in ("jax", "port")}
    assert got["jax"] == got["port"]
    replayed, depth, gens = got["port"]
    if case == "completed":
        assert replayed == ["v.s000003"] and gens == [(0, "s1", True)]
    elif case == "dead":
        assert replayed == ["v.s000001", "v.s000002"]
        assert gens == [(0, "s1", False), (1, "v", True)]
    else:
        assert replayed == [] and gens == [(0, "s1", False)]
    assert depth == len(replayed)


def test_session_meta_counts_its_kernel_launches(tmp_path):
    """A replica's card is its own process's, so each result carries its
    session's launches of the hand-written kernels (``meta.kernels``),
    charged through the session's request account; the account's
    ``profile()`` keeps the JAX package's keys."""
    from gpu_mapreduce_tpu_torch.obs import context as obs_context
    from gpu_mapreduce_tpu_torch.ops.cuda import note_kernel_launch

    def fake():
        pass
    fake.launches = 0
    acct = obs_context.RequestAccount(label="t")
    with obs_context.use(acct):
        note_kernel_launch(fake)
        note_kernel_launch(fake)
    note_kernel_launch(fake)          # outside a request: the wrapper's only
    assert acct.kernels == {"fake": 2} and fake.launches == 3
    assert acct.profile()["dispatches"] == 2
    assert "kernels" not in acct.profile()
    srv = replica(tmp_path / "fleet", "a")
    srv.start()
    try:
        c = ServeClient.local(srv.port)
        corpus = write_corpus(tmp_path / "w.txt", ["k", "l"], 10)
        res = c.wait(c.submit(script=wf_script(corpus))["id"], WAIT)
        assert res["status"] == "done"
        assert res["meta"]["kernels"] == {}    # the CPU runs plain versions
    finally:
        srv.shutdown()


def test_kernel_launches_on_worker_threads_charge_the_request():
    """A launch on a worker thread that re-installs the request's context
    (``bind``, as the ingest pool; ``capture``/``use``, as exec/'s
    prefetch producer and spill writer) is charged to that request; a
    thread started without the context charges no request."""
    import threading
    from gpu_mapreduce_tpu_torch.obs import context as obs_context
    from gpu_mapreduce_tpu_torch.ops.cuda import note_kernel_launch

    def fake():
        pass
    fake.launches = 0

    def on_thread(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=WAIT)
        assert not t.is_alive()

    acct = obs_context.RequestAccount(label="t")
    with obs_context.use(acct):
        on_thread(obs_context.bind(lambda: note_kernel_launch(fake)))
        captured = obs_context.capture()

        def producer():
            with obs_context.use(captured):
                note_kernel_launch(fake)
        on_thread(producer)
        on_thread(lambda: note_kernel_launch(fake))
    assert acct.kernels == {"fake": 2} and fake.launches == 3


# ---------------------------------------------------------------------------
# the fleet memo and the takeover of streams
# ---------------------------------------------------------------------------

def test_fleet_peer_serves_hit_after_replica_death(tmp_path, monkeypatch):
    from gpu_mapreduce_tpu_torch.plan.cache import plan_cache
    root = tmp_path / "fleet"
    monkeypatch.setenv("MRTPU_FLEET_DIR", str(root))
    reset_store()
    memo.reset_counts()
    try:
        corpus = write_corpus(tmp_path / "w.txt", ["p", "q", "r"], 30)
        script = wf_script(corpus, fuse=True)
        a = replica(root, "a")
        a.start()
        try:
            ca = ServeClient.local(a.port)
            cold = ca.wait(ca.submit(script=script)["id"], WAIT)
            assert cold["status"] == "done"
        finally:
            a.shutdown()
        plan_cache().clear()
        b = replica(root, "b")
        b.start()
        try:
            cb = ServeClient.local(b.port)
            warm = cb.wait(cb.submit(script=script)["id"], WAIT)
            assert warm["status"] == "done"
            assert warm["meta"]["memo"]["hit"]
            assert warm["meta"]["dispatches"] == 0
            assert warm["output"] == cold["output"]
            assert warm["files"] == cold["files"]
        finally:
            b.shutdown()
    finally:
        reset_store()


def test_fleet_takeover_adopts_streams(tmp_path):
    root = tmp_path / "fleet"
    a = replica(root, "a")
    b = replica(root, "b")
    a.start()
    b.start()
    try:
        ca = ServeClient.local(a.port)
        stid = ca.stream_open(tenant="acme")["id"]
        assert stid.startswith("a.st")
        ca.stream_feed(stid, b"apple banana apple\ncherry\n")
        wait_until(lambda: ca.stream_status(stid)["stream"]["batches"] >= 1,
                   msg="batch on the original replica")
        a._fleet_suspended = True
        a.streams.suspend_all()
        a._listener.stop()
        wait_until(lambda: b.streams.get(stid) is not None,
                   msg="survivor adopting the stream")
        ss = b.streams.get(stid)
        assert ss.failed_over and ss.tenant == "acme"
        wait_until(lambda: ss.engine is not None
                   and ss.engine.status()["resumed"], msg="resume")
        assert ss.engine.seq == 1
        recs = [r for r in read_journal(b.state_dir)
                if r.get("kind") == "stream_open"]
        assert [r["fo"] for r in recs] == ["a"]
        cb = ServeClient.local(b.port)
        cb.stream_feed(stid, b"banana date\n")
        wait_until(lambda: cb.stream_status(stid)["stream"]["batches"] >= 2,
                   msg="post-takeover batch")
        assert cb.stream_close(stid)["state"] == "closed"
        assert b.streams.get(stid).engine.snapshot() == \
            "apple 2\nbanana 2\ncherry 1\ndate 1\n"
    finally:
        b.shutdown()
        a.shutdown()


# ---------------------------------------------------------------------------
# the kill -9 golden: three port replicas as processes
# ---------------------------------------------------------------------------

def spawn_replica(root, rid, extra=()):
    """``python -m gpu_mapreduce_tpu_torch.serve --device cpu --fleet``
    in a fresh interpreter: (process, port)."""
    env = {**os.environ, "PYTHONPATH": ROOT, "MRTPU_FLEET_SKEW": "0.3"}
    p = subprocess.Popen(
        [sys.executable, "-m", "gpu_mapreduce_tpu_torch.serve", "--device",
         "cpu", "--port", "0", "--fleet", str(root), "--replica-id", rid,
         "--lease", "1.0", "--heartbeat", "0.25", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    line = json.loads(p.stdout.readline())
    assert line["fleet"] == str(root) and line["rid"] == rid
    return p, int(line["serving"])


def kill_by_lease(root, rid, p):
    """SIGKILL a replica by the pid its lease file names."""
    with open(os.path.join(str(root), "fleet", f"{rid}.lease.json")) as f:
        pid = json.load(f)["pid"]
    assert pid == p.pid
    os.kill(pid, signal.SIGKILL)
    p.wait(timeout=60)


def test_fleet_kill9_failover_byte_identical(tmp_path):
    corpus = write_corpus(tmp_path / "w.txt", ["p", "q", "p", "r"], 25)
    midrun = (f"variable files index {corpus}\n"
              f"wordfreq 3 -i v_files -o tmp.wf wf\n"
              f"print \"after-ckpt marker\"\n")
    queued = [wf_script(corpus, top=k, out=f"tmp.q{k}") for k in (2, 3)]
    want = golden(tmp_path, [midrun] + queued)
    assert all(g["status"] == "done" for g in want)
    # the victim's mid-run session as run_session leaves it at death:
    # journal + checkpoint after the wordfreq, the print not yet run
    root = tmp_path / "fleet"
    vstate = os.path.join(str(root), "replicas", "v")
    sdir = os.path.join(vstate, "sessions", "v.s000001")
    outdir = os.path.join(sdir, "out")
    os.makedirs(outdir, exist_ok=True)
    crash = OinkScript(device="cpu", screen=io.StringIO())
    crash._ft_journal = Journal(sdir, script_mode=True, every=1)
    crash._path_prepend = outdir
    lines = midrun.splitlines()
    crash._ft_pending_begin = (lines, "<serve>")
    for ln in lines[:2]:
        crash.one(ln)
    crash._ft_journal.close()
    pv, vport = spawn_replica(root, "v", ["--paused"])
    try:
        vc = ServeClient.local(vport)
        sids = [vc.submit(script=midrun)["id"]]
        sids += [vc.submit(script=s)["id"] for s in queued]
        assert sids[0] == "v.s000001"
    finally:
        kill_by_lease(root, "v", pv)
    p1, _ = spawn_replica(root, "s1", ["--workers", "2"])
    p2, _ = spawn_replica(root, "s2", ["--workers", "2"])
    try:
        wait_until(lambda: all(store_result(root, s) for s in sids),
                   msg="fleet failover results")
        for sid, w in zip(sids, want):
            got = store_result(root, sid)
            assert got["status"] == "done", got.get("error")
            assert got["meta"]["failed_over"] is True
            assert shas(got) == shas(w)
        mid = store_result(root, sids[0])
        assert mid["meta"]["resumed"] is True
        assert mid["output"] == "after-ckpt marker \n"
        # fencing on disk: the claim record, one claim generation, and
        # each sid adopted by exactly one survivor and done exactly once
        vrecs = read_journal(vstate)
        assert [r for r in vrecs if r.get("kind") == "fleet_claimed"]
        assert len(FleetMember(str(root), "probe").claims("v")) == 1

        def by_kind(kind):
            out = {sid: [] for sid in sids}
            for rid in ("v", "s1", "s2"):
                st = os.path.join(str(root), "replicas", rid)
                for r in read_journal(st):
                    if r.get("kind") == kind and r.get("sid") in out:
                        out[r["sid"]].append(rid)
            return out

        adopters = by_kind("serve_submit")
        assert all(v.count("v") == 1 and len(v) == 2
                   for v in adopters.values()), adopters
        wait_until(lambda: all(len(v) == 1 for v in
                               by_kind("serve_done").values()),
                   msg="one serve_done a session")
        # the JAX package reads the same journals the same way
        assert [r.get("kind") for r in j_read_journal(vstate)] == \
            [r.get("kind") for r in vrecs]
        # a restarted victim is fenced off its claimed work
        pv2, vport2 = spawn_replica(root, "v", ["--paused"])
        try:
            st = ServeClient.local(vport2).stats()
            assert st["sessions"]["total"] == 0
            assert st["queue"]["depth"] == 0
        finally:
            kill_by_lease(root, "v", pv2)
    finally:
        for p in (p1, p2):
            if p.poll() is None:
                p.kill()
                p.wait()
