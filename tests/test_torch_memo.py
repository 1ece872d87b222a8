"""The port's result memoization (``serve/memo.py`` and the daemon's
wiring) against the JAX package's, on the CPU: ``memo_key`` is the JAX
package's byte for byte on the same payloads and files (the key holds no
backend), the same scripts cannot be memoized, a corrupt record reads as
a miss, a restarted daemon serves a hit with 0 ops and a ``cache_hit``
record, the TTL sweep journals its intent, an interrupted content-store
GC finishes on restart, and a memo record written by either package's
daemon is served as a hit by the other's."""

import os
import time

import pytest

from gpu_mapreduce_tpu.ft.journal import read_journal as j_read_journal
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.plan.cache import plan_cache as j_plan_cache
from gpu_mapreduce_tpu.serve import ServeClient as JServeClient
from gpu_mapreduce_tpu.serve import Server as JServer
from gpu_mapreduce_tpu.serve import memo as jmemo
from gpu_mapreduce_tpu.utils import cas as jcas
from gpu_mapreduce_tpu_torch.ft.journal import Journal, read_journal
from gpu_mapreduce_tpu_torch.obs.metrics import get_registry
from gpu_mapreduce_tpu_torch.plan.cache import plan_cache
from gpu_mapreduce_tpu_torch.serve import ServeClient, Server, memo
from gpu_mapreduce_tpu_torch.utils import cas as tcas

from test_torch_serve import (WAIT, fresh, kinds,  # noqa: F401
                              no_flight_left, record, wf_script,
                              write_corpus)


@pytest.fixture
def cas_env(tmp_path, monkeypatch):
    """One content store for both packages, each package's singleton
    re-rooted, counts zeroed, plan caches cold."""
    monkeypatch.setenv("MRTPU_CAS_DIR", str(tmp_path / "cas"))
    monkeypatch.setenv("MRTPU_JIT_PERSIST", "0")
    for fn in (tcas.reset_store, jcas.reset_store, memo.reset_counts,
               jmemo.reset_counts, plan_cache().clear, j_plan_cache().clear):
        fn()
    yield str(tmp_path / "cas")
    for fn in (tcas.reset_store, jcas.reset_store, plan_cache().clear,
               j_plan_cache().clear):
        fn()


def _integrity_count(artifact):
    return get_registry().counter("mrtpu_integrity_failures_total", "",
                                  ("artifact",)).value(artifact=artifact)


def serve_one(tmp_path, name, script, jax=False, **kw):
    """One submission through a fresh daemon of either package."""
    if jax:
        srv = JServer(port=0, workers=1, state_dir=str(tmp_path / name),
                      comm=j_make_mesh(1), **kw)
    else:
        srv = Server(port=0, workers=1, state_dir=str(tmp_path / name),
                     device="cpu", **kw)
    srv.start()
    try:
        c = (JServeClient if jax else ServeClient).local(srv.port)
        return c.wait(c.submit(script=script)["id"], WAIT)
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the key
# ---------------------------------------------------------------------------

def test_memo_key_equals_jax(tmp_path, cas_env, monkeypatch):
    c1 = write_corpus(tmp_path / "c.txt", ["a", "b"], 10)
    c2 = write_corpus(tmp_path / "d.txt", ["x"], 3)
    payloads = [wf_script(c1), wf_script(c1, top=5), wf_script(c1, fuse=True),
                f"variable files index {c1} {c2}\ninvertedindex -i v_files\n",
                f"variable files index {tmp_path}/*.txt\n"
                f"wordfreq 3 -i v_files\n",
                "mr x\n", f"'{c1}', {c2};\n"]
    keys = [memo.memo_key(p) for p in payloads]
    assert keys == [jmemo.memo_key(p) for p in payloads]
    assert None not in keys and len(set(keys)) == len(keys)
    for p in payloads:
        assert memo.input_manifest(p) == jmemo.input_manifest(p)
        assert memo.stat_manifest(p) == jmemo.stat_manifest(p)
    for knob in ("MRTPU_FUSE", "MRTPU_WIRE", "MRTPU_MEGAFUSE"):
        monkeypatch.setenv(knob, "0")
        assert memo.memo_key(payloads[0]) == keys[0]
    with open(c1, "a") as f:
        f.write("extra ")
    assert memo.memo_key(payloads[0]) == jmemo.memo_key(payloads[0]) \
        != keys[0]


def test_non_memoizable_scripts_match_jax(tmp_path, cas_env):
    corpus = write_corpus(tmp_path / "c.txt", ["a"], 5)
    for p in (f"set timer 1\n{wf_script(corpus)}",
              f"set verbosity 2\n{wf_script(corpus)}",
              "save foo /tmp/x\n", "load foo /tmp/x\n",
              f"variable files index {tmp_path}\nwordfreq 3 -i v_files\n",
              "stream open /tmp/st in.txt\n", "mr x\nstream poll /tmp/st\n"):
        assert memo.memo_key(p) is None and jmemo.memo_key(p) is None


def test_store_lookup_corrupt_and_grown_inputs(tmp_path, cas_env):
    result = {"status": "done", "output": "x\n", "files": {}, "mrs": {},
              "meta": {"wall_s": 0.1}}
    key = "a" * 64
    assert not memo.store(key, {**result, "status": "failed"})
    assert memo.store(key, result, writer="r1")
    assert memo.lookup(key) == result == jmemo.lookup(key)
    # a corrupt record reads as a miss, is counted and removed
    key2 = "b" * 64
    memo.store(key2, result)
    path = memo._memo_path(key2)
    with open(path) as f:
        raw = f.read().replace("x\\n", "y\\n", 1)
    with open(path, "w") as f:
        f.write(raw)
    before = _integrity_count("cas")
    assert memo.lookup(key2) is None
    assert _integrity_count("cas") == before + 1
    assert not os.path.exists(path) and memo.memo_stats()["corrupt"] == 1
    # an input that grew since the store reads as a miss, not corruption
    corpus = write_corpus(tmp_path / "g.txt", ["a", "b"], 3)
    payload = wf_script(corpus)
    k3 = memo.memo_key(payload)
    assert memo.store(k3, result, payload=payload)
    assert memo.lookup(k3) is not None
    with open(corpus, "a") as f:
        f.write("more\n")
    assert memo.lookup(k3) is None and jmemo.lookup(k3) is None
    st = memo.memo_stats()
    assert (st["corrupt"], st["entries"], st["stores"]) == (1, 2, 3)


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------

def test_warm_restart_serves_a_hit_with_zero_ops(tmp_path, cas_env):
    corpus = write_corpus(tmp_path / "w.txt", ["to", "be", "or"], 40)
    script = wf_script(corpus, fuse=True, out="tmp.wf")
    cold = serve_one(tmp_path, "a", script)
    assert cold["status"] == "done"
    assert cold["meta"]["memo"] == {"hit": False,
                                    "key": memo.memo_key(script)}
    plan_cache().clear()
    srv = Server(port=0, workers=1, state_dir=str(tmp_path / "b"),
                 device="cpu")
    srv.start()
    try:
        c = ServeClient.local(srv.port)
        warm = c.wait(c.submit(script=script)["id"], WAIT)
        assert srv.stats()["cache"]["memo"]["hits"] == 1
    finally:
        srv.shutdown()
    recs = read_journal(srv.state_dir)
    m = warm["meta"]["memo"]
    assert m["hit"] and m["key"] == cold["meta"]["memo"]["key"]
    assert m["source_wall_s"] == cold["meta"]["wall_s"]
    assert warm["meta"]["dispatches"] == 0
    assert warm["meta"]["plan_cache"]["plan"] == {"hits": 0, "misses": 0}
    assert record(warm) == record(cold)
    assert kinds(recs) == ["serve_submit", "cache_hit", "serve_done"]
    assert recs[1]["key"] == m["key"]
    # opting out recomputes
    os.environ["MRTPU_MEMOIZE"] = "0"
    try:
        again = serve_one(tmp_path, "c", script)
    finally:
        del os.environ["MRTPU_MEMOIZE"]
    assert not again["meta"]["memo"]["hit"]
    assert record(again) == record(cold)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_memo_records_read_across_the_packages(tmp_path, cas_env, writer):
    """A record one package's daemon stored is the other's hit: the same
    key, the same files, 0 dispatches, a ``cache_hit`` record."""
    corpus = write_corpus(tmp_path / "w.txt", ["u", "v", "u"], 20)
    script = wf_script(corpus, out="tmp.wf")
    first = serve_one(tmp_path, "a", script, jax=writer == "jax")
    assert first["status"] == "done" and not first["meta"]["memo"]["hit"]
    second = serve_one(tmp_path, "b", script, jax=writer != "jax")
    assert second["meta"]["memo"]["hit"]
    assert second["meta"]["memo"]["key"] == first["meta"]["memo"]["key"]
    assert second["meta"]["dispatches"] == 0
    assert record(second) == record(first)
    reader = j_read_journal if writer == "port" else read_journal
    assert kinds(reader(str(tmp_path / "b"))) == \
        ["serve_submit", "cache_hit", "serve_done"]


def test_memo_ttl_sweep_journals_intent(tmp_path, cas_env, monkeypatch):
    monkeypatch.setenv("MRTPU_MEMO_TTL", "1")
    monkeypatch.setenv("MRTPU_CAS_GRACE", "1")
    corpus = write_corpus(tmp_path / "w.txt", ["s", "t"], 20)
    srv = Server(port=0, workers=1, state_dir=str(tmp_path / "st"),
                 device="cpu")
    srv.start()
    try:
        c = ServeClient.local(srv.port)
        res = c.wait(c.submit(script=wf_script(corpus))["id"], WAIT)
        path = memo._memo_path(res["meta"]["memo"]["key"])
        assert os.path.exists(path)
        os.utime(path, (time.time() - 3600, time.time() - 3600))
        assert srv._gc_once() >= 1
        assert not os.path.exists(path)
        assert "memo_gc" in kinds(read_journal(srv.state_dir))
        doc = srv.stats()["cache"]
        assert doc["gc"]["swept"] >= 1 and doc["cas"]["enabled"] == 1
        assert set(doc["gc"]) == {"memo_ttl_s", "cas_grace_s", "swept"}
    finally:
        srv.shutdown()


def test_restart_finishes_an_interrupted_cache_gc(tmp_path, cas_env):
    """The intents (``memo_gc``, ``cas_gc``) journaled before a kill -9
    finish on restart, idempotently: a chunk that gained a reference
    after the intent survives, twice over."""
    state = str(tmp_path / "st")
    memo.store("c" * 64, {"status": "done", "output": "old\n",
                          "files": {}, "mrs": {}})
    store = tcas.cas_store()
    orphan = store.put_bytes(b"orphaned chunk")
    keep = store.put_bytes(b"kept chunk")
    assert store.materialize(keep, str(tmp_path / "ref.bin"))
    j = Journal(state, script_mode=True)
    j.append({"kind": "memo_gc", "keys": ["c" * 64]})
    j.append({"kind": "cas_gc", "digests": [orphan, keep]})
    j.close()
    for _ in range(2):
        srv = Server(port=0, workers=1, state_dir=state, device="cpu")
        srv.start()
        srv.shutdown()
        assert memo.lookup("c" * 64) is None
        assert not store.contains(orphan)
        assert store.contains(keep) and store.refcount(keep) == 1
    assert kinds(j_read_journal(state)) == ["memo_gc", "cas_gc"]
