"""Fusion on a mesh of P > 1 against the JAX package's ``make_mesh(P)``:
the exchange group ``[aggregate, convert(, reduce(kernel))]`` and the
local group ``[convert, reduce(kernel)]`` (what ``compress`` records),
cold and warm, for every registered kernel reduce; ``pipeline()``; both
speculation misses (the groups outgrow the cached gcap, the buckets
outgrow the cached plan); ``fuse=1`` with ``outofcore=1`` replaying
eagerly; the group table's launches, one a shard.

The port's cold groups compare with the JAX fuser's first run (its v1
path), its warm groups with the JAX megafused run under its defaults,
``MRTPU_MEGAFUSE=1``, and ``MRTPU_PALLAS_GROUP=1`` on both sides: the
port's table is the plain version of ``csrc/seg_table.cu`` here, the JAX
table its Pallas kernel in interpret mode.  ``MRTPU_WIRE=0`` keeps the
JAX plan raw, the one the port plans."""

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.apps.intcount import intcount as j_intcount
from gpu_mapreduce_tpu.ops import reduces as jr
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.plan import plan_cache as j_plan_cache
from gpu_mapreduce_tpu.plan import plan_history as j_plan_history
from gpu_mapreduce_tpu_torch import MapReduce, intcount
from gpu_mapreduce_tpu_torch.ops import reduces as tr
from gpu_mapreduce_tpu_torch.ops.cuda import group as tgroup
from gpu_mapreduce_tpu_torch.parallel.sharded import MeshKMV, MeshKV
from gpu_mapreduce_tpu_torch.plan import plan_cache, plan_history

from test_torch_parallel import both, one, same_kmv, same_kv, tmesh

KERNELS = ["count", "sum_values", "max_values", "min_values", "cull"]
# the JAX exchange group's modes by the port's names
JAX_MODE = {"v1": "exchange", "mega": "exchange1", "local": "local",
            "local1": "local1"}


@pytest.fixture(autouse=True)
def fresh_plans(monkeypatch):
    monkeypatch.setenv("MRTPU_PALLAS_GROUP", "1")
    monkeypatch.setenv("MRTPU_WIRE", "0")
    monkeypatch.delenv("MRTPU_MEGAFUSE", raising=False)
    monkeypatch.delenv("MRTPU_FUSE", raising=False)
    plan_cache().clear()
    j_plan_cache().clear()
    yield
    plan_cache().clear()
    j_plan_cache().clear()


@pytest.fixture
def launches(monkeypatch):
    """Count the port's group-table calls (on the CPU the wrapper runs the
    plain version, which counts no launch)."""
    calls = []
    real = tgroup.segment_table

    def counting(keys, values, T):
        calls.append((keys.device, keys.numel(), T))
        return real(keys, values, T)
    monkeypatch.setattr(tgroup, "segment_table", counting)
    return calls


def keyed(card, n=3000, skew=False):
    """A map callback: n int64 pairs over ``card`` distinct u64 keys (the
    top bit set on about half), or with ``skew`` every key sent to one
    shard's worth of hash values."""
    base = np.random.default_rng(card).integers(0, 1 << 64, card,
                                                dtype=np.uint64)
    keys = base[(np.arange(n) * 7919) % card]
    if skew:
        keys[:] = base[0]
    vals = np.random.default_rng(1).integers(-(1 << 40), 1 << 40,
                                             n).astype(np.int64)

    def fn(itask, kv, ptr):
        kv.add_batch(keys, vals)
    return fn


def pairs(mr):
    out = []
    mr.scan_kv(lambda k, v, p: out.append((int(k), int(v))))
    return out


def group_of(history):
    groups = [g for g in history()[-1]["groups"] if g["fused"]]
    assert len(groups) == 1, groups
    return groups[0]


def chain(P, fn, kernel, fuse=1, ntasks=1, all2all=1, pipeline=False,
          stages=("aggregate", "convert", "reduce")):
    """(JAX MR, port MR) after the same chain, fused or not."""
    jmr, tmr = both(P, fuse=fuse, all2all=all2all)
    for mr, mod in ((jmr, jr), (tmr, tr)):
        mr.map(ntasks, fn)

        def run(mr=mr, mod=mod):
            for op in stages:
                if op == "reduce":
                    mr.reduce(getattr(mod, kernel), batch=True)
                else:
                    getattr(mr, op)()
        if pipeline:
            with mr.pipeline():
                run()
        else:
            run()
        mr.kv                       # a barrier: the recorded chain runs
    return jmr, tmr


def modes():
    return JAX_MODE[group_of(j_plan_history)["mode"]], \
        group_of(plan_history)


# -- the exchange group --------------------------------------------------------

@pytest.mark.parametrize("P,kernel", [(3, k) for k in KERNELS]
                         + [(8, "count")])
def test_exchange_group_cold_warm_match_jax(P, kernel, launches):
    fn = keyed(97)
    eager = chain(P, fn, kernel, fuse=0)[1]
    table = kernel in ("count", "sum_values")
    for want in ("exchange", "exchange1"):
        del launches[:]
        jmr, tmr = chain(P, fn, kernel)
        same_kv(jmr, tmr)
        assert pairs(tmr) == pairs(eager)
        jmode, group = modes()
        assert jmode == group["mode"] == want
        assert group["kind"] == "exchange"
        assert group["table"] == (table and want == "exchange1")
        assert len(launches) == (P if group["table"] else 0)
        assert isinstance(one(tmr.kv), MeshKV)
        ts, js = vars(tmr.last_exchange), vars(jmr.last_exchange)
        common = set(ts) & set(js)
        assert {"nrounds", "bucket", "cap_out", "rows", "sent_bytes",
                "pad_bytes"} <= common
        assert {k: ts[k] for k in common} == {k: js[k] for k in common}


def test_exchange_group_without_a_reduce_is_a_kmv():
    fn = keyed(97)
    for want in ("exchange", "exchange1"):
        jmr, tmr = chain(3, fn, None, stages=("aggregate", "convert"))
        assert isinstance(one(tmr.kmv), MeshKMV)
        same_kmv(jmr, tmr)
        jmode, group = modes()
        assert jmode == group["mode"] == want and not group["table"]


@pytest.mark.parametrize("all2all", [1, 0])
def test_pipeline_matches_jax(all2all, launches):
    fn = keyed(211)
    for want in ("exchange", "exchange1"):
        jmr, tmr = chain(3, fn, "count", fuse=0, all2all=all2all,
                         pipeline=True)
        same_kv(jmr, tmr)
        jmode, group = modes()
        assert jmode == group["mode"] == want
    assert len(launches) == 3


def test_plan_key_holds_the_mesh_and_all2all():
    fn = keyed(97)
    chain(3, fn, "count")
    for P, all2all in ((3, 0), (8, 1), (3, 1)):
        jmr, tmr = chain(P, fn, "count", all2all=all2all)
        same_kv(jmr, tmr)
        jmode, group = modes()
        assert jmode == group["mode"] == \
            ("exchange1" if (P, all2all) == (3, 1) else "exchange")


# -- the local group -------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_local_group_cold_warm_match_jax(kernel, launches):
    """compress under fuse=1 on an aggregated mesh frame: [convert,
    reduce(kernel)] per shard at the mesh-wide gcap."""
    fn = keyed(97)
    table = kernel in ("count", "sum_values")
    for want in ("local", "local1"):
        del launches[:]
        jmr, tmr = both(3)
        for mr, mod in ((jmr, jr), (tmr, tr)):
            mr.map(1, fn)
            mr.aggregate()
            mr.set(fuse=1)
            mr.compress(getattr(mod, kernel), batch=True)
        same_kv(jmr, tmr)
        jmode, group = modes()
        assert jmode == group["mode"] == want
        assert group["kind"] == "local"
        assert group["table"] == (table and want == "local1")
        # one table a shard, each on its shard's device
        assert [d for d, _, _ in launches] == \
            ([s.device for s in one(tmr.kv).shards] if group["table"]
             else [])


# -- speculation misses ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["exchange", "local"])
def test_warm_run_that_outgrows_gcap_reruns_cold(kind, launches):
    """The cold run arms gcap for 97 groups; a warm run over the same
    frame shape (the same host rows, or the same cap on every shard) with
    3000 distinct keys overflows the tables, is thrown away and runs
    again cold — exact, as the JAX run."""
    caps = set()
    for fn in (keyed(97, n=4000), keyed(3000, n=4000)):
        del launches[:]
        jmr, tmr = both(3)
        for mr, mod in ((jmr, jr), (tmr, tr)):
            mr.map(1, fn)
            if kind == "local":
                mr.aggregate()
                caps.add(one(mr.kv).cap if mr is tmr
                         else mr.kv.one_frame().cap)
            mr.set(fuse=1)
            if kind == "exchange":
                mr.aggregate()
            mr.convert()
            mr.reduce(mod.count, batch=True)
        same_kv(jmr, tmr)
        jmode, group = modes()
        assert jmode == group["mode"] == kind
    assert len(one(tmr.kv)) == 3000
    if kind == "local":
        assert len(caps) == 1
        # the discarded warm run launched its tables, one a shard
        assert len(launches) == 3


def test_warm_run_whose_buckets_outgrow_the_plan_reruns_cold(launches):
    """A batch whose keys all go to one shard: the cached plan's cap_out
    no longer holds that shard's rows, so the warm run is refused before
    phase 2 and the group runs cold at a fresh plan."""
    for fn, want in ((keyed(97), "exchange"), (keyed(97, skew=True),
                                               "exchange"),
                     (keyed(97, skew=True), "exchange1")):
        jmr, tmr = chain(3, fn, "count")
        same_kv(jmr, tmr)
        jmode, group = modes()
        assert jmode == group["mode"] == want
        assert tmr.last_exchange.cap_out == jmr.last_exchange.cap_out
    assert len(launches) == 3


def test_fuse_with_outofcore_replays_eagerly(tmp_path):
    kw = dict(fuse=1, outofcore=1, memsize=1, maxpage=4)
    jmr, tmr = both(3, fpath=str(tmp_path), **kw)
    for mr, mod in ((jmr, jr), (tmr, tr)):
        mr.map(1, keyed(97))
        mr.aggregate()
        mr.convert()
        mr.reduce(mod.count, batch=True)
    same_kv(jmr, tmr)
    assert all(g["mode"] == "eager" and not g["fused"]
               for g in plan_history()[-1]["groups"])
    assert not any(g["fused"] for g in j_plan_history()[-1]["groups"])


# -- IntCount -------------------------------------------------------------------------

def test_intcount_fused_on_a_mesh_matches_jax(tmp_path, monkeypatch,
                                              launches):
    monkeypatch.setenv("MRTPU_FUSE", "1")
    rng = np.random.default_rng(9)
    paths = []
    for i in range(4):
        keys = rng.integers(0, 600, 1500).astype(np.uint32)
        keys[:40] = np.uint32(0xFFFFFFF0) + np.uint32(i)
        p = tmp_path / f"ints{i}.bin"
        keys.tofile(p)
        paths.append(str(p))
    for P in (3, 8):
        want = j_intcount(paths, ntop=20, comm=j_make_mesh(P))
        want = (int(want[0]), int(want[1]), want[2])
        for run in ("exchange", "exchange1"):
            del launches[:]
            assert intcount(paths, ntop=20, comm=tmesh(P)) == want
            group = next(g for e in reversed(plan_history())
                         for g in e["groups"] if g["fused"])
            assert (group["mode"], group["table"]) == \
                (run, run == "exchange1")
            assert len(launches) == (P if run == "exchange1" else 0)
