"""The content store and the persistent plan tier of the port
(``utils/cas.py``, ``plan/cache.py``, the fuser's hooks, the checkpoint
and spill dedup) against the JAX package's, on the CPU.

The same operations run on both packages' stores over the same bytes:
object names, refcounts, GC candidates and stats agree exactly, and each
package reads the objects and plan entries the other wrote.  The
persistent tier is held by its own goldens: a fresh process's first
fused IntCount run goes warm from disk with the cold run's result, a
doctored entry costs one re-run and never a wrong result, and a P = 3
wire plan survives the round trip as tuples.  Every comparison is
exact."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import gpu_mapreduce_tpu.plan.cache as jcache
import gpu_mapreduce_tpu.utils.cas as jcas
from gpu_mapreduce_tpu.apps.intcount import intcount as j_intcount
from gpu_mapreduce_tpu.core.mapreduce import MapReduce as JMapReduce
from gpu_mapreduce_tpu.exec.spill import atomic_save as j_atomic_save
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu_torch import MapReduce, intcount
from gpu_mapreduce_tpu_torch.exec.spill import atomic_save
from gpu_mapreduce_tpu_torch.obs.metrics import get_registry
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.plan import cache as tcache
from gpu_mapreduce_tpu_torch.plan import fuser, plan_cache, plan_history
from gpu_mapreduce_tpu_torch.utils import cas as tcas
from gpu_mapreduce_tpu_torch.utils.integrity import integrity_failures

from test_torch_parallel import tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"port": tcas, "jax": jcas}


@pytest.fixture(autouse=True)
def cas_env(monkeypatch):
    """No store armed unless a test arms one; both singletons and the
    port's plan cache cold around every test."""
    for k in ("MRTPU_CAS_DIR", "MRTPU_FLEET_DIR", "MRTPU_CAS",
              "MRTPU_PLAN_PERSIST", "MRTPU_PLAN_PERSIST_CAP", "MRTPU_FUSE"):
        monkeypatch.delenv(k, raising=False)
    tcas.reset_store()
    jcas.reset_store()
    plan_cache().clear()
    monkeypatch.setattr(tshuffle, "_SPEC_CACHE", {})
    yield
    tcas.reset_store()
    jcas.reset_store()
    plan_cache().clear()


def _integrity_count() -> int:
    return get_registry().counter(
        "mrtpu_integrity_failures_total", "", ("artifact",)
    ).value(artifact="cas") or 0


# ---------------------------------------------------------------------------
# the chunk store, both packages over the same bytes
# ---------------------------------------------------------------------------

def _chunks(seed=5, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, 4096)),
                         dtype=np.uint8).tobytes() for _ in range(n)] + [b""]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_objects_named_alike_and_read_across(tmp_path, writer):
    """The same bytes get the same object name in both packages, and an
    object one package wrote is read (verified) by the other."""
    reader = "jax" if writer == "port" else "port"
    w = SIDES[writer].CASStore(str(tmp_path / "cas"))
    r = SIDES[reader].CASStore(str(tmp_path / "cas"))
    for data in _chunks():
        d = w.put_bytes(data)
        assert d == tcas.sha256_bytes(data) == jcas.sha256_bytes(data)
        assert os.path.exists(os.path.join(str(tmp_path / "cas"), "objects",
                                           d[:2], d))
        assert r.contains(d) and r.get_bytes(d) == data
        assert r.put_bytes(data) == d            # a dedup hit there
    assert r.dedup_hits == len(_chunks())
    assert w.stats()["chunks"] == r.stats()["chunks"] == len(_chunks())


def test_put_get_dedup_and_missing_match_jax(tmp_path):
    data = b"the quick brown fox" * 100
    out = {}
    for side, mod in SIDES.items():
        st = mod.CASStore(str(tmp_path / side))
        d = st.put_bytes(data)
        t0 = os.path.getmtime(st._opath(d))
        d2 = st.put_bytes(data)                  # not rewritten
        out[side] = (d, d2, os.path.getmtime(st._opath(d)) == t0,
                     st.get_bytes(d) == data, st.get_bytes("0" * 64),
                     st.contains("0" * 64), st.refcount("0" * 64),
                     st.dedup_hits, st.stores, st.reads)
    assert out["port"] == out["jax"]


def test_corrupt_chunk_quarantined_and_counted(tmp_path):
    """A flipped byte reads as a miss, counts ``cas`` and moves the
    object to the quarantine directory, as in the JAX package."""
    out = {}
    for side, mod in SIDES.items():
        st = mod.CASStore(str(tmp_path / side))
        d = st.put_bytes(b"payload bytes")
        path = st._opath(d)
        raw = bytearray(open(path, "rb").read())
        raw[0] ^= 0xFF
        with open(path, "wb") as f:
            f.write(raw)
        before = _integrity_count(), integrity_failures().get("cas", 0)
        got = st.get_bytes(d)
        after = _integrity_count(), integrity_failures().get("cas", 0)
        out[side] = (got, st.contains(d), st.quarantined,
                     sorted(os.listdir(st.quarantine_dir)) == [d])
        if side == "port":
            assert after == (before[0] + 1, before[1] + 1)
    assert out["port"] == out["jax"] == (None, False, 1, True)


def test_dedup_materialize_refcounts_match_jax(tmp_path):
    out = {}
    for side, mod in SIDES.items():
        base = tmp_path / side
        base.mkdir()
        st = mod.CASStore(str(base / "cas"))
        a, b = base / "a.bin", base / "b.bin"
        a.write_bytes(b"same chunk content")
        b.write_bytes(b"same chunk content")
        da, db = st.dedup_file(str(a)), st.dedup_file(str(b))
        shared = os.stat(a).st_ino == os.stat(b).st_ino \
            == os.stat(st._opath(da)).st_ino
        rc = st.refcount(da)
        dm = st.put_bytes(b"spill page")
        dest = base / "restored.bin"
        ok = st.materialize(dm, str(dest))
        rc2 = st.refcount(dm)
        os.remove(dest)
        out[side] = (da, db, shared, rc, a.read_bytes(), ok,
                     dest.exists(), rc2, st.refcount(dm),
                     st.materialize("f" * 64, str(base / "nope")),
                     st.dedup_file(str(base / "missing.bin")))
    assert out["port"] == out["jax"]
    assert out["port"][2] and out["port"][3] == 2


def test_gc_grace_rereference_and_idempotent_finish_match_jax(tmp_path):
    out = {}
    for side, mod in SIDES.items():
        base = tmp_path / side
        base.mkdir()
        st = mod.CASStore(str(base / "cas"))
        ref = base / "kept.bin"
        ref.write_bytes(b"referenced")
        dref = st.dedup_file(str(ref))
        dorp = st.put_bytes(b"orphan")
        now = os.path.getmtime(st._opath(dorp)) + 10.0
        inside = st.gc_candidates(grace_s=3600.0, now=now)
        cands = st.gc_candidates(grace_s=1.0, now=now)
        taken = base / "taken.bin"
        st.materialize(dorp, str(taken))         # re-referenced after
        kept = st.gc_finish(cands)               # the intent: survives
        os.remove(taken)
        removed = st.gc_finish(cands)
        replay = st.gc_finish(cands)             # a replayed intent
        s = st.stats()
        out[side] = (inside, cands == [dorp], kept, removed, replay,
                     st.contains(dorp), st.contains(dref),
                     st.gc_removed, s["chunks"], sorted(s))
    assert out["port"] == out["jax"]
    assert out["port"][1:5] == (True, 0, 1, 0)


def test_cas_root_resolution_and_singleton_match_jax(tmp_path, monkeypatch):
    def probe():
        return [(m.cas_root(), m.cas_enabled(),
                 getattr(m.cas_store(), "root", None))
                for m in (tcas, jcas)]

    seen = [probe()]
    monkeypatch.setenv("MRTPU_FLEET_DIR", str(tmp_path / "fleet"))
    seen.append(probe())
    s1 = tcas.cas_store()
    assert s1 is tcas.cas_store()
    monkeypatch.setenv("MRTPU_CAS_DIR", str(tmp_path / "cas"))
    seen.append(probe())                         # an explicit dir wins
    assert tcas.cas_store() is not s1            # re-rooted
    monkeypatch.setenv("MRTPU_CAS", "0")
    seen.append(probe())                         # the kill switch
    for (p, j) in seen:
        assert p == j
    assert seen[0][0] == (None, False, None)
    assert seen[1][0][0] == str(tmp_path / "fleet" / "cas")
    assert seen[3][0] == (str(tmp_path / "cas"), False, None)


# ---------------------------------------------------------------------------
# stable digests, payloads and the on-disk plan entries
# ---------------------------------------------------------------------------

def test_stable_plan_digest_renders_the_port_key():
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    from gpu_mapreduce_tpu_torch.parallel.mesh import Mesh
    import torch
    plain = ("fp123", ("sig", 4), ("serial",), "xla", False, True)
    # plain components render as the JAX package renders them
    assert tcache.stable_plan_digest(plain) \
        == jcache.stable_plan_digest(plain)
    assert len(tcache.stable_plan_digest(plain)) == 64
    assert tcache.stable_plan_digest(("fp124",) + plain[1:]) \
        != tcache.stable_plan_digest(plain)
    fn = (("fn", count),)
    assert tcache.stable_plan_digest(fn) == tcache.stable_plan_digest(fn)
    assert tcache.stable_plan_digest((object(),)) is None
    # devices render by type: no ordinal, no id
    d = tcache.stable_plan_digest
    assert d((("device", "cuda:0"),)) == d((("device", "cuda:3"),))
    assert d((("device", "cuda:0"),)) != d((("device", "cpu"),))
    m = lambda *devs: ("mesh", Mesh(tuple(torch.device(x) for x in devs)))
    assert d((m("cuda:0", "cuda:1"),)) == d((m("cuda:2", "cuda:2"),))
    assert d((m("cpu", "cpu"),)) != d((m("cuda:0", "cuda:0"),))
    assert d((m("cpu", "cpu"),)) != d((m("cpu", "cpu", "cpu"),))


_DIGEST_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import numpy as np
    from gpu_mapreduce_tpu_torch.plan.cache import stable_plan_digest
    from gpu_mapreduce_tpu_torch.plan.fuser import _backend_signature
    from gpu_mapreduce_tpu_torch.plan.ir import Plan, PlanStage, frame_signature
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.core.frame import KVFrame
    plan = Plan((PlanStage("aggregate", (None,)), PlanStage("convert"),
                 PlanStage("reduce", (count,), {{"batch": True}})))
    fr = KVFrame(np.arange(10, dtype=np.uint64), np.ones(10, np.uint32))
    for comm in (None, make_mesh(3, devices=["cpu"] * 3)):
        mr = MapReduce(device="cpu", comm=comm)
        key = (plan.fingerprint(), frame_signature(fr),
               _backend_signature(mr), 1, 0, True)
        print(stable_plan_digest(key))
""")


def test_stable_plan_digest_equal_across_fresh_processes(tmp_path):
    """The port's full key (a function, a frame, the device or a mesh)
    digests alike in two fresh processes, and differently at P = 1 and
    P = 3."""
    child = tmp_path / "child.py"
    child.write_text(_DIGEST_CHILD.format(root=ROOT))
    outs = [subprocess.run([sys.executable, str(child)], capture_output=True,
                           text=True, timeout=120, cwd=ROOT)
            for _ in range(2)]
    for r in outs:
        assert r.returncode == 0, r.stderr
    a, b = (r.stdout.split() for r in outs)
    assert a == b and len(a) == 2 and a[0] != a[1]
    assert all(len(x) == 64 for x in a)


def test_payload_jsonable_roundtrip_matches_jax():
    val = ("wire", (1, 2, (3, "uint32")), np.int32(7), 2.5, None,
           np.dtype(np.uint16), {"a": (1, 2)})
    for enc in (tcache.to_jsonable, jcache.to_jsonable):
        text = json.dumps(enc(val))
        assert tcache.from_jsonable(json.loads(text)) \
            == jcache.from_jsonable(json.loads(text))
    back = tcache.from_jsonable(json.loads(json.dumps(
        tcache.to_jsonable(val))))
    assert back == ("wire", (1, 2, (3, "uint32")), 7, 2.5, None,
                    "uint16", {"a": (1, 2)})
    assert isinstance(back[1], tuple) and isinstance(back[1][2], tuple)
    for enc in (tcache.to_jsonable, jcache.to_jsonable):
        with pytest.raises(TypeError):
            enc(object())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_persistent_entries_read_across(tmp_path, writer):
    """An entry written by one package's ``PersistentPlanCache`` is the
    same file the other writes, loads there, and a second store of it
    is a no-op in either."""
    payload = {"caps": {"0": ["wire", [[1, 2]], 64, "uint16", None]},
               "mega": {"1": ["x", ["raw", 8, 1, 64], 16]}}
    mods = {"port": tcache, "jax": jcache}
    w = mods[writer].PersistentPlanCache(str(tmp_path / "w"))
    r = mods["jax" if writer == "port" else "port"].PersistentPlanCache(
        str(tmp_path / "w"))
    other = mods["jax" if writer == "port" else "port"].PersistentPlanCache(
        str(tmp_path / "o"))
    assert w.store("d" * 64, payload)
    assert other.store("d" * 64, payload)
    assert open(w._path("d" * 64)).read() \
        == open(other._path("d" * 64)).read()
    assert r.load("d" * 64) == payload
    assert not r.store("d" * 64, payload)        # unchanged: no write
    assert r.load("e" * 64) is None
    assert r.stats() == {"enabled": 1, "entries": 1,
                         "bytes": os.path.getsize(w._path("d" * 64)),
                         "hits": 1, "misses": 1, "evictions": 0}


def test_persistent_corruption_degrades_to_a_miss(tmp_path):
    out = {}
    for side, mod in (("port", tcache), ("jax", jcache)):
        pp = mod.PersistentPlanCache(str(tmp_path / side))
        pp.store("a" * 64, {"caps": {}, "mega": {}})
        path = pp._path("a" * 64)
        raw = open(path).read().replace('"caps"', '"craps"', 1)
        with open(path, "w") as f:
            f.write(raw)
        before = _integrity_count()
        got = pp.load("a" * 64)
        counted = _integrity_count() - before
        out[side] = (got, os.path.exists(path), pp.stats()["misses"])
        if side == "port":
            assert counted == 1
    assert out["port"] == out["jax"] == (None, False, 1)


def test_persistent_cap_evicts_oldest(tmp_path, monkeypatch):
    monkeypatch.setenv("MRTPU_PLAN_PERSIST_CAP", "2")
    out = {}
    for side, mod in (("port", tcache), ("jax", jcache)):
        pp = mod.PersistentPlanCache(str(tmp_path / side))
        for i, d in enumerate(("a" * 64, "b" * 64, "c" * 64)):
            pp.store(d, {"caps": {}, "mega": {}, "n": i})
            os.utime(pp._path(d), (1000.0 + i, 1000.0 + i))
        pp.store("d" * 64, {"caps": {}, "mega": {}, "n": 3})
        out[side] = (pp.stats()["entries"], pp.evictions,
                     sorted(n[0] for n in os.listdir(pp.dir)),
                     pp.load("a" * 64))
    assert out["port"] == out["jax"]
    assert out["port"][0] == 2 and out["port"][3] is None


def test_persistent_cache_singleton_and_stats_keys(tmp_path, monkeypatch):
    assert tcache.persistent_cache() is None
    assert MapReduce(device="cpu").stats()["plan"]["persistent"] \
        == jcache.cache_stats()["persistent"]      # both disarmed: zeros
    monkeypatch.setenv("MRTPU_CAS_DIR", str(tmp_path / "one"))
    p1 = tcache.persistent_cache()
    assert p1 is tcache.persistent_cache()
    assert p1.dir == str(tmp_path / "one" / "plan")
    got = MapReduce(device="cpu").stats()["plan"]["persistent"]
    assert sorted(got) == sorted(jcache.cache_stats()["persistent"])
    assert got["enabled"] == 1
    monkeypatch.setenv("MRTPU_CAS_DIR", str(tmp_path / "two"))
    assert tcache.persistent_cache().dir == str(tmp_path / "two" / "plan")
    monkeypatch.setenv("MRTPU_PLAN_PERSIST", "0")
    assert tcache.persistent_cache() is None


# ---------------------------------------------------------------------------
# the fuser over the persistent tier
# ---------------------------------------------------------------------------

def _keys(tmp_path, nfiles=3, n=3000, hi=700, seed=3):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(nfiles):
        p = str(tmp_path / f"k{i}.bin")
        rng.integers(0, hi, n).astype(np.uint32).tofile(p)
        paths.append(p)
    return paths


_RESTART_CHILD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    from gpu_mapreduce_tpu_torch import intcount
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.plan import plan_history
    from gpu_mapreduce_tpu_torch.plan.cache import cache_stats
    P = int(sys.argv[1])
    comm = make_mesh(P, devices=["cpu"] * P) if P > 1 else None
    res = intcount(sys.argv[2:], ntop=10, device="cpu", comm=comm)
    modes = [g["mode"] for h in plan_history() for g in h["groups"]
             if g["fused"]]
    print(json.dumps({{"res": res, "modes": modes,
                      "persistent": cache_stats()["persistent"]}}))
""")


@pytest.mark.parametrize("P", [1, 3])
def test_restart_first_run_goes_warm_from_disk(tmp_path, P):
    """Two fresh processes under one store: the first fused IntCount run
    of the first is cold, the first of the second warm (``local1`` /
    ``exchange1``) from the on-disk entry, with the cold run's result,
    which is the JAX package's."""
    paths = _keys(tmp_path)
    child = tmp_path / "child.py"
    child.write_text(_RESTART_CHILD.format(root=ROOT))
    env = dict(os.environ, MRTPU_CAS_DIR=str(tmp_path / "cas"),
               MRTPU_FUSE="1")
    runs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, str(child), str(P), *paths],
                           capture_output=True, text=True, timeout=180,
                           env=env, cwd=ROOT)
        assert r.returncode == 0, r.stderr
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    fused = "local" if P == 1 else "exchange"
    assert cold["modes"] == [fused] and warm["modes"] == [fused + "1"]
    assert cold["persistent"]["hits"] == 0
    assert warm["persistent"]["hits"] >= 1
    assert warm["persistent"]["entries"] == cold["persistent"]["entries"]
    assert warm["res"] == cold["res"]
    want = j_intcount(paths, ntop=10, comm=j_make_mesh(P))
    assert tuple(cold["res"][:2]) == want[:2]
    assert [tuple(t) for t in cold["res"][2]] == list(want[2])


def _only_entry(pp) -> str:
    names = [n for n in os.listdir(pp.dir) if n.endswith(".json")]
    for n in names:
        payload = pp.load(n[:-5])
        if payload["mega"]:
            return n[:-5]
    raise AssertionError(names)


def test_doctored_small_gcap_costs_one_rerun(tmp_path, monkeypatch):
    """An entry whose gcap is far too small: the warm run overflows, the
    group runs again cold with the right result, and the entry is
    right-sized on disk."""
    paths = _keys(tmp_path)
    monkeypatch.setenv("MRTPU_CAS_DIR", str(tmp_path / "cas"))
    monkeypatch.setenv("MRTPU_FUSE", "1")
    want = intcount(paths, ntop=10, device="cpu")
    pp = tcache.persistent_cache()
    digest = _only_entry(pp)
    good = pp.load(digest)
    (gidx, entry), = good["mega"].items()
    assert entry[0] == "l" and entry[1] >= 512
    pp.store(digest, {"caps": good["caps"], "mega": {gidx: ["l", 8]}})
    plan_cache().clear()                         # a restart
    assert intcount(paths, ntop=10, device="cpu") == want
    group = [g for h in plan_history() for g in h["groups"]
             if g["fused"]][-1]
    assert group["mode"] == "local"              # the miss ran cold
    assert pp.load(digest) == good               # right-sized again
    # an entry of another shape is dropped: the group simply runs cold
    pp.store(digest, {"caps": {}, "mega": {gidx: ["q", 1, 2, 3]}})
    plan_cache().clear()
    assert intcount(paths, ntop=10, device="cpu") == want
    assert pp.load(digest) == good


def test_mesh_wire_plan_survives_the_round_trip(tmp_path, monkeypatch):
    """At P = 3 the exchange group's plan tuple and gcap, stored and
    loaded again, equal the in-memory plan, tuples and all."""
    paths = _keys(tmp_path, hi=300)
    monkeypatch.setenv("MRTPU_CAS_DIR", str(tmp_path / "cas"))
    monkeypatch.setenv("MRTPU_FUSE", "1")
    intcount(paths, ntop=5, comm=tmesh(3))
    compiled = [v for v in plan_cache()._d.values() if v.mega]
    assert len(compiled) == 1
    cp = compiled[0]
    (gidx, entry), = cp.mega.items()
    assert entry[0] == "x" and isinstance(entry[1], tuple)
    pp = tcache.persistent_cache()
    back = fuser._plan_from_payload(pp.load(_only_entry(pp)))
    assert back.mega == cp.mega and back.caps == cp.caps
    assert isinstance(back.mega[gidx][1], tuple)
    assert isinstance(back.caps[gidx], tuple)
    assert hash(back.caps[gidx]) == hash(cp.caps[gidx])


# ---------------------------------------------------------------------------
# chunk dedup at the two write sites
# ---------------------------------------------------------------------------

def _kv_mr(cls, **kw):
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 2 ** 40, 5000).astype(np.uint64)
    vals = rng.integers(0, 1000, 5000).astype(np.uint32)
    mr = cls(**kw)
    mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
    return mr


def _rows(mr):
    out = []
    mr.scan_kv(lambda k, v, p: out.append((int(k), int(v))))
    return out


def test_checkpoint_saves_share_one_store_object(tmp_path, monkeypatch):
    """Two saves of one KV (and the JAX package's save of the same KV)
    hardlink one store object; both load equal; a byte flipped in the
    object is refused on load.  Without a store nothing changes."""
    from gpu_mapreduce_tpu_torch.core.runtime import MRError
    mr = _kv_mr(MapReduce, device="cpu")
    mr.save(str(tmp_path / "plain"))
    monkeypatch.setenv("MRTPU_CAS_DIR", str(tmp_path / "cas"))
    store = tcas.cas_store()
    assert os.stat(tmp_path / "plain" / "frame-00000.npz").st_nlink == 1
    for d in ("a", "b"):
        mr.save(str(tmp_path / d))
    _kv_mr(JMapReduce).save(str(tmp_path / "j"))
    frames = [tmp_path / d / "frame-00000.npz" for d in ("a", "b", "j")]
    inodes = {os.stat(f).st_ino for f in frames}
    st = store.stats()
    assert len(inodes) == 1 and st["chunks"] == 1
    digest = tcas.sha256_file(str(frames[0]))
    assert os.stat(store._opath(digest)).st_ino == inodes.pop()
    assert store.refcount(digest) == 3
    assert open(frames[0], "rb").read() \
        == open(tmp_path / "plain" / "frame-00000.npz", "rb").read()
    want = _rows(mr)
    for d in ("a", "b"):
        back = MapReduce(device="cpu")
        back.load(str(tmp_path / d))
        assert _rows(back) == want
    raw = bytearray(open(store._opath(digest), "rb").read())
    raw[len(raw) // 2] ^= 0x40
    with open(store._opath(digest), "r+b") as f:
        f.write(raw)
    with pytest.raises((MRError, OSError)):
        MapReduce(device="cpu").load(str(tmp_path / "b"))


def test_spill_runs_share_one_store_object(tmp_path, monkeypatch):
    """``exec/spill.atomic_save`` re-homes each run file through the
    store: equal runs (and the JAX package's) share one object, stamps
    unchanged."""
    arr = np.arange(4096, dtype=np.uint64)
    plain = atomic_save(str(tmp_path / "plain.npy"), arr)
    monkeypatch.setenv("MRTPU_CAS_DIR", str(tmp_path / "cas"))
    stamps = [atomic_save(str(tmp_path / f"r{i}.npy"), arr)
              for i in range(2)]
    stamps.append(j_atomic_save(str(tmp_path / "j.npy"), arr))
    assert stamps == [plain] * 3
    inodes = {os.stat(tmp_path / f).st_ino
              for f in ("r0.npy", "r1.npy", "j.npy")}
    assert len(inodes) == 1 and tcas.cas_store().stats()["chunks"] == 1
    np.testing.assert_array_equal(np.load(tmp_path / "r1.npy"), arr)


def test_out_of_core_run_under_the_store_matches(tmp_path, monkeypatch):
    """An out-of-core sort whose run files go through the store gives the
    rows it gives without one."""
    def run(fpath):
        mr = _kv_mr(MapReduce, device="cpu", outofcore=1, memsize=1,
                    maxpage=1, fpath=fpath)
        mr.sort_keys(1)
        return _rows(mr)
    os.makedirs(tmp_path / "s0")
    want = run(str(tmp_path / "s0"))
    monkeypatch.setenv("MRTPU_CAS_DIR", str(tmp_path / "cas"))
    os.makedirs(tmp_path / "s1")
    assert run(str(tmp_path / "s1")) == want
