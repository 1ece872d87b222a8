"""The process group of the port (``parallel/dist.py``, ``ft/inject.py``,
the launcher's helpers) against the JAX package's.

In process: the shrink rule; heartbeat, fence and exit-report files;
the watchdog (passthrough, a lease trip, a deadline trip, a fenced rank,
a transport error converted when a peer died and re-raised when none
did); the fault specs (parsing, the rank selector, the refusals, a
bounded hang); the launcher's dead-rank rules, manifest fallback, word
ids and table merge.  The pure functions are held against the JAX
functions on the same inputs.

Across processes: the exchange across 2 and 3 ranks on the CPU
(``gloo``), under the hash and the range destinations, over seeded u64
keys (``[n]`` and ``[n, 2]``, 2^64 - 1 among them, one rank empty),
equal to JAX ``exchange`` on ``make_mesh(W)`` shard by shard: keys,
values, counts and cap."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu.ft import inject as jinject
from gpu_mapreduce_tpu.parallel import dist as JD
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.parallel.sharded import ShardedKV as JShardedKV
from gpu_mapreduce_tpu_torch import MRError, launch
from gpu_mapreduce_tpu_torch.ft import inject
from gpu_mapreduce_tpu_torch.ops.bits import to_numpy, to_torch
from gpu_mapreduce_tpu_torch.parallel import dist as D
from gpu_mapreduce_tpu_torch.utils.fsio import atomic_write_json, read_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_mrlaunch():
    spec = importlib.util.spec_from_file_location(
        "_mrlaunch_t", os.path.join(ROOT, "scripts", "mrlaunch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the shrink rule and the files --------------------------------------------

def test_shrink_width_matches_jax():
    assert [D.shrink_width(n) for n in range(20)] == \
        [JD.shrink_width(n) for n in range(20)]
    assert (D.shrink_width(3), D.shrink_width(7), D.shrink_width(0)) == \
        (2, 4, 0)


def test_heartbeat_roundtrip_and_expiry(tmp_path):
    run = str(tmp_path)
    D.write_beat(run, 3, lease_s=30.0, gen=0, seq=7)
    beat = D.read_beat(run, 3)
    assert beat["rank"] == 3 and beat["seq"] == 7
    # the same file the JAX package writes, read by either
    assert JD.read_beat(run, 3) == beat
    assert sorted(beat) == ["expires", "gen", "pid", "rank", "seq",
                            "state", "ts", "ttl"]
    now = time.time()
    for b in (beat, None, {"junk": 1}, {"expires": "x"}):
        for t in (now, now + 31.0):
            assert D.beat_expired(b, 0.5, t) == JD.beat_expired(b, 0.5, t)
    assert not D.beat_expired(beat, skew_s=0.5)
    assert D.beat_expired(beat, skew_s=0.5, now=time.time() + 31.0)


def test_paths_match_jax(tmp_path):
    run = str(tmp_path)
    for fn in ("hb_path", "fence_path", "exit_path"):
        assert getattr(D, fn)(run, 2, 5) == getattr(JD, fn)(run, 2, 5)
    assert D.hb_dir(run, 1) == JD.hb_dir(run, 1)
    assert (D.EXIT_PEER_LOST, D.EXIT_FENCED) == \
        (JD.EXIT_PEER_LOST, JD.EXIT_FENCED)


def test_fence_is_exclusive_and_gen_scoped(tmp_path):
    run = str(tmp_path)
    assert D.fence_rank(run, 2, by="launcher", gen=0) is True
    assert D.fence_rank(run, 2, by="other", gen=0) is False
    assert D.is_fenced(run, 2, gen=0) and JD.is_fenced(run, 2, gen=0)
    assert not D.is_fenced(run, 2, gen=1)
    assert read_json(D.fence_path(run, 2, 0))["by"] == "launcher"


def test_heartbeat_thread_latches_fence(tmp_path):
    run = str(tmp_path)
    hb = D.Heartbeat(run, 1, heartbeat_s=0.02, lease_s=1.0)
    hb.start()
    try:
        assert D.read_beat(run, 1) is not None
        assert not hb.fenced
        D.fence_rank(run, 1, by="test", gen=0)
        deadline = time.time() + 2.0
        while not hb.fenced and time.time() < deadline:
            time.sleep(0.01)
        assert hb.fenced
    finally:
        hb.stop()
    assert D.read_beat(run, 1) is None      # a clean leave drops the lease


def test_exit_report_roundtrip(tmp_path):
    run = str(tmp_path)
    os.makedirs(D.hb_dir(run, 1), exist_ok=True)
    D.write_exit_report(run, 0, 1, "peer_lost", dead=[2], site="exchange")
    rec = read_json(D.exit_path(run, 0, 1))
    assert rec["code"] == "peer_lost" and rec["dead"] == [2]
    assert rec["site"] == "exchange" and rec["gen"] == 1


# -- the watchdog -------------------------------------------------------------

def _runtime(tmp_path, world=2, rank=0, **kw):
    kw.setdefault("heartbeat_s", 0.02)
    kw.setdefault("lease_s", 0.2)
    kw.setdefault("skew_s", 0.05)
    kw.setdefault("sync_timeout_s", 30.0)
    return D.DistRuntime(rank, world, str(tmp_path), **kw)


def test_guard_passthrough_result(tmp_path):
    rt = _runtime(tmp_path)
    D.write_beat(str(tmp_path), 1, lease_s=30.0)
    assert rt.guard("exchange", lambda a, b: a + b, 2, 3) == 5


def test_guard_trips_on_expired_peer_lease(tmp_path):
    rt = _runtime(tmp_path)
    D.write_beat(str(tmp_path), 1, lease_s=0.01)
    time.sleep(0.1)
    t0 = time.monotonic()
    with pytest.raises(D.PeerLostError) as ei:
        rt.guard("exchange", time.sleep, 60)
    assert time.monotonic() - t0 < 5.0
    assert ei.value.dead == [1] and ei.value.site == "exchange"
    assert rt.peer_lost is ei.value


def test_guard_trips_on_sync_deadline_with_live_peer(tmp_path):
    rt = _runtime(tmp_path, sync_timeout_s=0.3)
    D.write_beat(str(tmp_path), 1, lease_s=60.0)
    t0 = time.monotonic()
    with pytest.raises(D.PeerLostError) as ei:
        rt.guard("count_sync", time.sleep, 60)
    assert 0.2 < time.monotonic() - t0 < 5.0
    assert "deadline" in str(ei.value) and ei.value.dead == []


def test_guard_raises_fenced_for_zombie(tmp_path):
    rt = _runtime(tmp_path)
    D.write_beat(str(tmp_path), 1, lease_s=60.0)
    D.fence_rank(str(tmp_path), 0, by="launcher", gen=0)
    with pytest.raises(D.RankFencedError):
        rt.guard("ckpt_barrier", lambda: 1)


def test_guard_converts_transport_error_when_peer_died(tmp_path):
    rt = _runtime(tmp_path)
    D.write_beat(str(tmp_path), 1, lease_s=0.15)

    def fail():
        raise RuntimeError("connection reset by peer")
    with pytest.raises(D.PeerLostError) as ei:
        rt.guard("exchange", fail)
    assert ei.value.dead == [1]


def test_guard_converts_when_the_lease_expires_at_the_window_end(tmp_path):
    """A peer killed right after its beat expires just as the window
    closes: the last look after the window still sees it."""
    rt = _runtime(tmp_path, lease_s=0.2, skew_s=0.05)
    D.write_beat(str(tmp_path), 1, lease_s=0.2)

    def fail():
        raise RuntimeError("connection reset by peer")
    with pytest.raises(D.PeerLostError):
        rt.guard("exchange", fail)


def test_guard_reraises_original_error_with_healthy_peers(tmp_path):
    rt = _runtime(tmp_path)
    D.write_beat(str(tmp_path), 1, lease_s=60.0)

    def fail():
        raise ValueError("a real bug, not a dead peer")
    with pytest.raises(ValueError):
        rt.guard("exchange", fail)


def test_guard_call_without_runtime_is_direct():
    assert D.active() is None
    assert D.guard_call("exchange", lambda: 42) == 42
    assert D.surviving_width() is None


def test_lease_table_names_the_dead(tmp_path):
    rt = _runtime(tmp_path, world=3)
    D.write_beat(str(tmp_path), 0, lease_s=60.0)
    D.write_beat(str(tmp_path), 1, lease_s=60.0)
    table = D.lease_table(rt)
    assert table["dead"] == ["2"] and table["peers"]["2"]["missing"]
    assert table["peers"]["1"]["seq"] == 0 and not table["fenced"]


def test_activate_and_surviving_width(tmp_path):
    rt = _runtime(tmp_path, world=3)
    prev = D.activate(rt)
    try:
        assert D.active() is rt and D.surviving_width() == 3
        D.write_beat(str(tmp_path), 1, lease_s=60.0)
        D.write_beat(str(tmp_path), 2, lease_s=60.0)
        assert D.guard_call("exchange", lambda: 7) == 7
    finally:
        D.activate(prev)


# -- the topology and its refusals --------------------------------------------

def test_topology_follows_the_request():
    assert D.topology(1, 4, "cpu") == (torch.device("cpu"), "gloo", "gloo")
    with pytest.raises(MRError):
        D.topology(0, 2, "gpu")


def test_cardless_run_without_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MRError, match="--device cpu"):
        D.topology(0, 2, "")


def test_topology_on_cards(monkeypatch):
    """Every rank owns a card: NCCL, rank r on cuda:r; more ranks than
    cards: gloo, rank r on cuda:(r % cards)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert D.topology(3, 4, "") == (torch.device("cuda", 3), "nccl",
                                    "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.topology(3, 4, "") == (torch.device("cuda", 0), "gloo",
                                    "gloo")


def test_local_topology(monkeypatch):
    """L shards a rank: W·L cards → NCCL, rank r's shards on cards
    r·L + c; fewer → gloo on the shared cards; the CPU on request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert D.local_topology(1, 2, "", 2) == (
        [torch.device("cuda", 2), torch.device("cuda", 3)], "nccl", "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.local_topology(1, 2, "", 2) == (
        [torch.device("cuda", 0)] * 2, "gloo", "gloo")
    assert D.local_topology(0, 2, "cpu", 3) == (
        [torch.device("cpu")] * 3, "gloo", "gloo")


def test_init_from_env_refusals(monkeypatch, tmp_path):
    for k in list(os.environ):
        if k.startswith("MRTPU_DIST_"):
            monkeypatch.delenv(k)
    assert D.init_from_env() is None
    monkeypatch.setenv("MRTPU_DIST_WORLD", "2")
    monkeypatch.setenv("MRTPU_DIST_RUNDIR", str(tmp_path))
    with pytest.raises(MRError, match="COORD"):
        D.init_from_env()
    monkeypatch.setenv("MRTPU_DIST_COORD", "localhost:1")
    monkeypatch.setenv("MRTPU_DIST_LOCAL_DEVICES", "0")
    with pytest.raises(MRError, match="one shard at least"):
        D.init_from_env()
    # a rank holding two shards is accepted and goes on to the topology,
    # which finds no card here (and no --device cpu)
    monkeypatch.setenv("MRTPU_DIST_LOCAL_DEVICES", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MRError, match="no CUDA device"):
        D.init_from_env()
    assert D.active() is None


def test_rank_frame_refusals(tmp_path):
    rt = D.DistRuntime(1, 2, str(tmp_path), device="cpu")
    prev = D.activate(rt)
    try:
        with pytest.raises(MRError, match="not ported yet"):
            D.shard_local_rows((np.array([b"a", b"b"], object),
                                np.ones(2, np.int64)), [0, 2])
        with pytest.raises(MRError, match="count"):
            D.shard_local_rows((np.ones(3, np.uint64),
                                np.ones(3, np.int64)), [0, 2])
        fr = D.shard_local_rows((np.array([5, (1 << 64) - 1], np.uint64),
                                 np.ones(2, np.int64)), [3, 2])
        assert fr.cap == 8 and fr.counts.tolist() == [3, 2] and len(fr) == 5
        assert repr(fr) == "RankKV(rank=1, cap=8, counts=[3, 2], device=cpu)"
        assert fr.device == torch.device("cpu")
        assert fr.shard_to_host(1).key.data.tolist() == [5, (1 << 64) - 1]
        with pytest.raises(MRError, match="rank 0"):
            fr.shard_to_host(0)
    finally:
        D.activate(prev)


# -- fault injection ----------------------------------------------------------

def _fields(s):
    return (s.site, s.rate, s.kind, s.seed, s.max_faults, s.after, s.rank)


@pytest.mark.parametrize("text", [
    "site=dist.exchange;kind=peer_kill;rank=2;after=1;n=1",
    "site=dist.count_sync;kind=peer_hang;rank=1;after=2;n=1",
    "seed=7;site=dist.reshard,dist.ckpt_barrier;rate=0.5;kind=runtime"
    "|site=dist.exchange;kind=delay"])
def test_fault_specs_parse_as_jax(text):
    assert [_fields(s) for s in inject.parse_faults(text)] == \
        [_fields(s) for s in jinject.parse_faults(text)]


def test_peer_kinds_rejected_outside_dist_sites():
    with pytest.raises(ValueError):
        inject.FaultSpec(site="spill.write", kind="peer_kill")
    with pytest.raises(ValueError):
        inject.FaultSpec(site="*", kind="peer_hang")
    # a retry-layer site takes the exception kinds, as in the JAX package
    assert _fields(inject.FaultSpec(site="ingest.read", kind="oserror")) \
        == _fields(jinject.FaultSpec(site="ingest.read", kind="oserror"))
    with pytest.raises(ValueError):
        inject.parse_faults("site=dist.exchange;bogus=1")


def test_rank_selector_filters_other_ranks(monkeypatch):
    monkeypatch.setattr(inject, "_RANK", 1)
    spec = inject.FaultSpec(site="dist.exchange", kind="peer_hang", rank=2)
    assert not spec.matches("dist.exchange")
    monkeypatch.setattr(inject, "_RANK", 2)
    assert spec.matches("dist.exchange")


def test_draws_match_jax():
    """The k-th probe of a site draws the JAX package's verdict."""
    a = inject.FaultSpec(site="dist.exchange", kind="runtime", rate=0.3,
                         seed=5, after=2, max_faults=4)
    b = jinject.FaultSpec(site="dist.exchange", kind="runtime", rate=0.3,
                          seed=5, after=2, max_faults=4)
    assert [a.draw("dist.exchange") for _ in range(40)] == \
        [b.draw("dist.exchange") for _ in range(40)]


def test_injected_exception_and_env_arming(monkeypatch):
    inject.clear_faults()
    try:
        inject.schedule(site="dist.reshard", kind="timeout", max_faults=1)
        with pytest.raises(TimeoutError) as ei:
            inject.fault_point("dist.reshard")
        assert isinstance(ei.value, inject.InjectedFault)
        assert ei.value.ft_site == "dist.reshard"
        inject.fault_point("dist.reshard")            # n=1: spent
        assert inject.counts() == {"dist.reshard": 1}
        inject.clear_faults()
        monkeypatch.setenv("MRTPU_FAULTS", "site=spill.write;kind=oserror")
        inject.configure_from_env()          # a retry-layer site arms
        assert inject.armed_for("spill.write")
        monkeypatch.setenv("MRTPU_FAULTS", "site=spill.wrte;kind=oserror")
        inject.configure_from_env()          # an unknown site: warns
        assert not inject.armed()
        monkeypatch.setenv("MRTPU_FAULTS", "site=dist.exchange;kind=fatal")
        inject.configure_from_env()
        assert inject.armed_for("dist.exchange")
        assert not inject.armed_for("dist.count_sync")
    finally:
        inject.clear_faults()


def test_peer_hang_sleeps_bounded(monkeypatch):
    monkeypatch.setenv("MRTPU_DIST_HANG_S", "0.05")
    inject.clear_faults()
    inject.schedule(site="dist.count_sync", kind="peer_hang", max_faults=1)
    try:
        t0 = time.monotonic()
        inject.fault_point("dist.count_sync")    # sleeps, then returns
        assert time.monotonic() - t0 >= 0.04
    finally:
        inject.clear_faults()


# -- the launcher's rules -----------------------------------------------------

@pytest.mark.parametrize("codes,hung,reports,want", [
    ({0: 75, 1: -6, 2: -9, 3: -6}, [],
     {0: {"code": "peer_lost", "dead": [2]}}, {2}),
    ({0: 75, 1: -9, 2: 75, 3: -6}, [],
     {0: {"code": "peer_lost", "dead": []},
      2: {"code": "peer_lost", "dead": []}}, {1}),
    ({0: -6, 1: -6}, [], {}, {0, 1}),
    ({0: 75, 1: -9}, [1], {0: {"code": "peer_lost", "dead": []}}, {1}),
])
def test_classify_dead_matches_jax(codes, hung, reports, want):
    m = _load_mrlaunch()
    assert launch._classify_dead(codes, hung, reports) == want
    assert m._classify_dead(codes, hung, reports) == want


def test_latest_manifest_skips_damaged_step(tmp_path):
    m = _load_mrlaunch()
    run = str(tmp_path)
    for step, tag in ((1, b"one"), (2, b"two")):
        sdir = launch._step_dir(run, step)
        os.makedirs(sdir, exist_ok=True)
        path = os.path.join(sdir, "rank0.npz")
        with open(path, "wb") as f:
            f.write(tag)
        atomic_write_json(launch._manifest_path(sdir), {
            "step": step, "width": 1, "chunks_done": step,
            "shards": {"0": {"file": "rank0.npz", "nrows": 0,
                             "sha256": launch._sha256(path)}}})
    with open(os.path.join(launch._step_dir(run, 2), "rank0.npz"),
              "wb") as f:
        f.write(b"corrupt")
    man, sdir = launch.latest_manifest(run)
    assert man["step"] == 1 and sdir.endswith("step-00001")
    assert m.latest_manifest(run)[1] == sdir
    assert launch.latest_manifest(str(tmp_path / "none")) == (None, None)


def test_stable_ids_and_merge_table_match_jax():
    m = _load_mrlaunch()
    words = [b"alpha", b"beta", b"alpha", b"", b"\xff" * 40]
    ids = launch._stable_ids(words)
    assert np.array_equal(ids, m._stable_ids(words)) and ids[0] == ids[2]
    rng = np.random.default_rng(3)
    tk = np.unique(rng.integers(0, 1 << 64, 50, dtype=np.uint64,
                                endpoint=False))
    tk = np.concatenate([tk, np.array([(1 << 64) - 1, 1 << 63], np.uint64)])
    tk = np.unique(tk)
    tc = rng.integers(1, 9, len(tk)).astype(np.int64)
    nk = np.concatenate([tk[::3], rng.integers(0, 1 << 64, 40,
                                                dtype=np.uint64),
                         np.array([0, (1 << 64) - 1], np.uint64)])
    nc = rng.integers(1, 9, len(nk)).astype(np.int64)
    wk, wc = m._merge_table(tk, tc, nk, nc)
    gk, gc = launch._merge_table(to_torch(tk, "cpu"), torch.from_numpy(tc),
                                 to_torch(nk, "cpu"), torch.from_numpy(nc))
    assert np.array_equal(to_numpy(gk, np.uint64), wk)
    assert np.array_equal(gc.numpy(), wc)
    assert np.array_equal(launch.even_counts(10, 4),
                          m._even_counts(10, 4))


# -- the range destination ---------------------------------------------------

@pytest.mark.parametrize("sizes,ends,nprocs", [
    ([5, 0, 7, 3], [4, 8, 12, 15], 4),      # an empty source shard
    ([6, 6, 6], [9, 18], 3),                # narrowing: fewer targets
    ([10, 2], [0, 4, 4, 12], 4),            # empty target shards
    ([0, 0], [0, 0], 2),                    # no rows at all
])
def test_range_rows_per_dest_match_searchsorted(sizes, ends, nprocs):
    """The range destination's per-target counts, taken from each shard's
    global range on the host, equal a per-row ``searchsorted(ends, g,
    right=True)`` histogram (the JAX ``_dest_fn``'s rule)."""
    from gpu_mapreduce_tpu_torch.parallel.shuffle import _dest_fn
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    rd = _dest_fn(("range", tuple(offsets), tuple(ends)), nprocs, None)
    for p, c in enumerate(sizes):
        g = offsets[p] + np.arange(c)
        d = np.searchsorted(np.asarray(ends), g, side="right")
        want = np.bincount(d, minlength=nprocs)
        assert rd.rows_per_dest(p, c).tolist() == want.tolist()


# -- the exchange across ranks ------------------------------------------------

RANK = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    from gpu_mapreduce_tpu_torch.ops.bits import to_numpy
    from gpu_mapreduce_tpu_torch.parallel import dist as D
    from gpu_mapreduce_tpu_torch.parallel.shuffle import exchange
    rt = D.init_from_env()
    d = sys.argv[1]
    with np.load(os.path.join(d, "inputs.npz")) as z:
        cases = json.loads(str(z["cases"]))
        arrs = {k: z[k] for k in z.files if k != "cases"}
    out = {}
    for name, case in cases.items():
        counts = np.asarray(case["counts"])
        lo = int(counts[:rt.rank].sum())
        hi = lo + int(counts[rt.rank])
        fr = D.shard_local_rows((arrs[name + "_k"][lo:hi],
                                 arrs[name + "_v"][lo:hi]), counts)
        dest = tuple(case["dest"]) if case["dest"][0] == "range" \\
            else ("hash", None)
        if dest[0] == "range":
            dest = ("range", tuple(dest[1]), tuple(dest[2]))
        res = exchange(fr, dest)
        k, v = res.shard.key, res.shard.value
        out[name + "_k"] = to_numpy(k, res.key_dtype)
        out[name + "_v"] = to_numpy(v, res.value_dtype)
        out[name + "_c"] = res.counts
        out[name + "_st"] = np.array(sorted(res.sync_seconds))
    np.savez(os.path.join(d, f"out{rt.rank}.npz"), **out)
    rt.stop()
    os._exit(0)
""")


def _cases(W: int):
    """Seeded u64 keys, [n] and [n, 2], 2^64 - 1 among them; the last
    rank holds no rows; hash and range destinations."""
    rng = np.random.default_rng(40 + W)
    counts = [int(x) for x in rng.integers(20, 90, W)]
    counts[-1] = 0
    n = sum(counts)
    k1 = rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False)
    k1[::7] = (1 << 64) - 1
    k2 = rng.integers(0, 1 << 64, (n, 2), dtype=np.uint64, endpoint=False)
    k2[::5, 1] = (1 << 64) - 1
    v1 = rng.integers(-50, 50, n).astype(np.int64)
    v2 = rng.random((n, 3)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1].tolist()
    ends = np.cumsum([n // W + (1 if i < n % W else 0)
                      for i in range(W)]).tolist()
    cases, arrs = {}, {}
    for tag, (k, v) in {"flat": (k1, v1), "wide": (k2, v2)}.items():
        for dest in (["hash"], ["range", offs, ends]):
            name = f"{tag}_{dest[0]}"
            cases[name] = {"counts": counts, "dest": dest}
            arrs[name + "_k"], arrs[name + "_v"] = k, v
    return cases, arrs


def _jax_exchange(case, k, v, W):
    mesh = j_make_mesh(W)
    counts = np.asarray(case["counts"], np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    kb = [k[offs[p]:offs[p + 1]] for p in range(W)]
    vb = [v[offs[p]:offs[p + 1]] for p in range(W)]
    gk, _ = JD.shard_local_rows(mesh, kb, counts)
    gv, _ = JD.shard_local_rows(mesh, vb, counts)
    skv = JShardedKV(mesh, gk, gv, counts.astype(np.int32))
    dest = case["dest"]
    dest = ("hash", None) if dest[0] == "hash" else \
        ("range", tuple(dest[1]), tuple(dest[2]))
    out = jshuffle.exchange(skv, dest)
    cap = out.cap
    K, V = np.asarray(out.key), np.asarray(out.value)
    return [(K[p * cap:(p + 1) * cap], V[p * cap:(p + 1) * cap])
            for p in range(W)], out.counts


@pytest.mark.parametrize("W", [2, 3])
def test_rank_exchange_matches_jax_mesh(W, tmp_path, monkeypatch):
    """W CPU processes over gloo: each rank's received block equals the
    JAX make_mesh(W) exchange's shard, byte for byte with its padding."""
    monkeypatch.setenv("MRTPU_WIRE", "0")
    monkeypatch.setattr(jshuffle, "_SPEC_CACHE", {})
    cases, arrs = _cases(W)
    d = str(tmp_path)
    np.savez(os.path.join(d, "inputs.npz"), cases=json.dumps(cases), **arrs)
    port = launch.pick_port()
    procs = []
    for r in range(W):
        env = dict(os.environ, PYTHONPATH=ROOT, MRTPU_DIST_WORLD=str(W),
                   MRTPU_DIST_RANK=str(r),
                   MRTPU_DIST_COORD=f"localhost:{port}",
                   MRTPU_DIST_RUNDIR=os.path.join(d, "run"),
                   MRTPU_DIST_DEVICE="cpu", OMP_NUM_THREADS="1")
        env.pop("MRTPU_FAULTS", None)
        procs.append(subprocess.Popen([sys.executable, "-c", RANK, d],
                                      env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * W, \
        b"\n".join(o[-1500:] for o in outs).decode(errors="replace")
    got = [np.load(os.path.join(d, f"out{r}.npz")) for r in range(W)]
    for name, case in cases.items():
        want, wcounts = _jax_exchange(case, arrs[name + "_k"],
                                      arrs[name + "_v"], W)
        for r in range(W):
            gk, gv = got[r][name + "_k"], got[r][name + "_v"]
            wk, wv = want[r]
            assert got[r][name + "_c"].tolist() == wcounts.tolist(), name
            assert gk.dtype == wk.dtype and gv.dtype == wv.dtype, name
            np.testing.assert_array_equal(gk, wk, err_msg=f"{name} {r}")
            np.testing.assert_array_equal(gv, wv, err_msg=f"{name} {r}")
            assert got[r][name + "_st"].tolist() == ["count_sync",
                                                     "exchange"]
    if W == 2:
        # the range destination keeps the global row order
        rows = np.concatenate([got[r]["flat_range_k"][:int(
            got[r]["flat_range_c"][r])] for r in range(W)])
        np.testing.assert_array_equal(rows, arrs["flat_range_k"])


# -- ranks holding several shards ---------------------------------------------

def test_rank_frame_of_two_shards(tmp_path):
    """One rank of a world of 1 holding two shards: its blocks, repr and
    host rows, and its exchange equal the one-process make_mesh(2)'s,
    shard by shard (the hop inside the rank alone)."""
    from gpu_mapreduce_tpu_torch.core.frame import KVFrame
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.parallel.sharded import \
        shard_frame_with_counts
    from gpu_mapreduce_tpu_torch.parallel.shuffle import exchange
    rt = D.DistRuntime(0, 1, str(tmp_path), devices=["cpu", "cpu"])
    prev = D.activate(rt)
    try:
        k = np.array([5, (1 << 64) - 1, 9, 1 << 63, 3], np.uint64)
        v = np.arange(5, dtype=np.int64) - 2
        with pytest.raises(MRError, match="local blocks"):
            D.shard_local_rows((k, v), [3, 2])
        fr = D.shard_local_rows([(k[:3], v[:3]), (k[3:], v[3:])], [3, 2])
        assert fr.nlocal == 2 and list(fr.shard_ids) == [0, 1]
        assert repr(fr) == ("RankKV(rank=0, shards=[0, 1], cap=8, "
                            "counts=[3, 2], devices=['cpu', 'cpu'])")
        assert fr.shard_to_host(1).key.data.tolist() == [1 << 63, 3]
        with pytest.raises(MRError, match="2 shards"):
            fr.shard
        for wire in ("0", "1"):
            os.environ["MRTPU_WIRE"] = wire
            try:
                got = exchange(fr, ("hash", None))
                want = exchange(shard_frame_with_counts(
                    KVFrame(k, v), make_mesh(2, devices=["cpu"] * 2),
                    [3, 2]), ("hash", None))
            finally:
                del os.environ["MRTPU_WIRE"]
            assert got.counts.tolist() == want.counts.tolist()
            for a, b in zip(got.shards, want.shards):
                assert a.cap == b.cap and a.key.equal(b.key) \
                    and a.value.equal(b.value)
    finally:
        D.activate(prev)


RANK_LOCAL = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    from gpu_mapreduce_tpu_torch.ops.bits import to_numpy
    from gpu_mapreduce_tpu_torch.parallel import dist as D
    from gpu_mapreduce_tpu_torch.parallel.shuffle import exchange
    rt = D.init_from_env()
    d = sys.argv[1]
    L = len(rt.devices)
    with np.load(os.path.join(d, "inputs.npz")) as z:
        cases = json.loads(str(z["cases"]))
        arrs = {k: z[k] for k in z.files if k != "cases"}
    out = {}
    for wire in ("0", "1"):
        os.environ["MRTPU_WIRE"] = wire
        for name, case in cases.items():
            counts = np.asarray(case["counts"])
            offs = np.concatenate([[0], np.cumsum(counts)])
            blocks = [(arrs[name + "_k"][offs[p]:offs[p + 1]],
                       arrs[name + "_v"][offs[p]:offs[p + 1]])
                      for p in range(rt.rank * L, (rt.rank + 1) * L)]
            fr = D.shard_local_rows(blocks, counts)
            dest = case["dest"]
            dest = ("hash", None) if dest[0] == "hash" else \\
                ("range", tuple(dest[1]), tuple(dest[2]))
            res = exchange(fr, dest)
            for l, s in enumerate(res.shards):
                tag = f"{wire}_{name}_{l}"
                out[tag + "_k"] = to_numpy(s.key, res.key_dtype)
                out[tag + "_v"] = to_numpy(s.value, res.value_dtype)
            out[f"{wire}_{name}_c"] = res.counts
            st = res.exchange_stats
            out[f"{wire}_{name}_st"] = np.array(
                [st.nrounds, st.bucket, st.cap_out, st.wire_bytes])
    np.savez(os.path.join(d, f"out{rt.rank}.npz"), **out)
    rt.stop()
    os._exit(0)
""")


def test_two_ranks_of_two_shards_match_jax_mesh(tmp_path, monkeypatch):
    """2 CPU processes over gloo, two shards each: every rank's blocks
    equal the JAX make_mesh(4) exchange's shards r·2 and r·2 + 1, byte
    for byte with their padding, codec off and on (cold caches)."""
    W, L = 2, 2
    cases, arrs = _cases(W * L)                  # the last shard empty
    # values of a range past 255: a uint16 pack (gloo has no int16)
    cases["u16_hash"] = dict(cases["flat_hash"])
    arrs["u16_hash_k"] = arrs["flat_hash_k"]
    arrs["u16_hash_v"] = np.random.default_rng(3).integers(
        0, 5000, len(arrs["flat_hash_v"])).astype(np.int64)
    d = str(tmp_path)
    np.savez(os.path.join(d, "inputs.npz"), cases=json.dumps(cases), **arrs)
    port = launch.pick_port()
    procs = []
    for r in range(W):
        env = dict(os.environ, PYTHONPATH=ROOT, MRTPU_DIST_WORLD=str(W),
                   MRTPU_DIST_RANK=str(r), MRTPU_DIST_LOCAL_DEVICES=str(L),
                   MRTPU_DIST_COORD=f"localhost:{port}",
                   MRTPU_DIST_RUNDIR=os.path.join(d, "run"),
                   MRTPU_DIST_DEVICE="cpu", OMP_NUM_THREADS="1")
        env.pop("MRTPU_FAULTS", None)
        procs.append(subprocess.Popen([sys.executable, "-c", RANK_LOCAL, d],
                                      env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * W, \
        b"\n".join(o[-1500:] for o in outs).decode(errors="replace")
    got = [np.load(os.path.join(d, f"out{r}.npz")) for r in range(W)]
    for wire in ("0", "1"):
        monkeypatch.setenv("MRTPU_WIRE", wire)
        for name, case in cases.items():
            monkeypatch.setattr(jshuffle, "_SPEC_CACHE", {})
            want, wcounts = _jax_exchange(case, arrs[name + "_k"],
                                          arrs[name + "_v"], W * L)
            for r in range(W):
                assert got[r][f"{wire}_{name}_c"].tolist() == \
                    wcounts.tolist(), name
                for l in range(L):
                    tag = f"{wire}_{name}_{l}"
                    wk, wv = want[r * L + l]
                    np.testing.assert_array_equal(got[r][tag + "_k"], wk,
                                                  err_msg=tag)
                    np.testing.assert_array_equal(got[r][tag + "_v"], wv,
                                                  err_msg=tag)
        if wire == "1":
            assert got[0]["1_flat_hash_st"][3] > 0    # the codec ran
            assert got[0]["1_u16_hash_st"][3] > 0


# -- speculation on the rank exchange ----------------------------------------

SPEC_CAP = 64          # rows a shard: every call keeps this frame shape

RANK_SPEC = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    from gpu_mapreduce_tpu_torch.ops.bits import to_numpy
    from gpu_mapreduce_tpu_torch.parallel import dist as D
    from gpu_mapreduce_tpu_torch.parallel import shuffle
    rt = D.init_from_env()
    d = sys.argv[1]
    with np.load(os.path.join(d, "inputs.npz")) as z:
        plan = json.loads(str(z["plan"]))
        arrs = {k: z[k] for k in z.files if k != "plan"}
    cap = plan["cap"]
    out = {}

    def run(tag, call):
        counts = np.asarray(plan["counts"][call])
        lo = rt.rank * cap
        n = int(counts[rt.rank])
        fr = D.shard_local_rows((arrs[call + "_k"][lo:lo + n],
                                 arrs[call + "_v"][lo:lo + n]), counts,
                                cap=cap)
        res = shuffle.exchange(fr, ("hash", None))
        st = res.exchange_stats
        out[tag + "_k"] = to_numpy(res.shard.key, res.key_dtype)
        out[tag + "_v"] = to_numpy(res.shard.value, res.value_dtype)
        out[tag + "_c"] = res.counts
        out[tag + "_st"] = np.array([st.cap_out, int(st.speculative)])

    for wire in ("0", "1"):
        os.environ["MRTPU_WIRE"] = wire
        shuffle._SPEC_CACHE.clear()
        for i, call in enumerate(plan["seq"]):
            run(f"{wire}_{i}", call)
    # one rank's cache cleared mid-sequence: the next exchange is fresh
    # on every rank, then both speculate again
    os.environ["MRTPU_WIRE"] = "0"
    shuffle._SPEC_CACHE.clear()
    for i, call in enumerate(plan["clear_seq"]):
        if i == plan["clear_at"] and rt.rank == 1:
            shuffle._SPEC_CACHE.clear()
        run(f"clear_{i}", call)
    np.savez(os.path.join(d, f"out{rt.rank}.npz"), **out)
    rt.stop()
    os._exit(0)
""")


def _spec_inputs(W: int = 2):
    """Seeded u64 keys chosen by their lookup3 destination: ``full``
    sends half of each shard's 64 rows to each destination, ``quarter``
    keeps the first 16 valid (alternating, so still balanced), ``skew``
    sends every row to destination 0, ``tiny`` is a quarter again.  The
    frame's cap stays 64 throughout, so every call shares one spec key;
    values fit one byte, so the codec packs them."""
    from gpu_mapreduce_tpu_torch.ops.hash import default_hash
    rng = np.random.default_rng(77)
    pool = rng.integers(0, 1 << 64, 4096, dtype=np.uint64, endpoint=False)
    dest = (default_hash(to_torch(pool, "cpu"), np.uint64) % W).numpy()
    to0, to1 = pool[dest == 0], pool[dest == 1]
    n = SPEC_CAP
    bal = np.empty(W * n, np.uint64)
    bal[0::2], bal[1::2] = to0[:W * n // 2], to1[:W * n // 2]
    skew = to0[W * n // 2:W * n // 2 + W * n]
    vals = rng.integers(0, 100, W * n).astype(np.int64)
    arrs = {"full_k": bal, "quarter_k": bal, "skew_k": skew, "tiny_k": bal}
    for c in ("full", "quarter", "skew", "tiny"):
        arrs[c + "_v"] = vals
    counts = {"full": [n] * W, "quarter": [n // 4] * W, "skew": [n] * W,
              "tiny": [n // 4] * W}
    plan = {"cap": n, "counts": counts,
            "seq": ["full", "quarter", "skew", "tiny", "tiny"],
            "clear_seq": ["full", "quarter", "quarter", "quarter"],
            "clear_at": 2}
    return plan, arrs


def _jax_spec_exchange(mesh, plan, arrs, call, W):
    """The JAX make_mesh(W) exchange of one call's frame at the common
    cap: padded blocks, counts, cap_out and speculative."""
    import jax
    from gpu_mapreduce_tpu.parallel.mesh import row_sharding
    cap = plan["cap"]
    counts = np.asarray(plan["counts"][call], np.int64)
    k, v = arrs[call + "_k"].copy(), arrs[call + "_v"].copy()
    for p in range(W):
        k[p * cap + counts[p]:(p + 1) * cap] = 0
        v[p * cap + counts[p]:(p + 1) * cap] = 0
    sh = row_sharding(mesh)
    skv = JShardedKV(mesh, jax.device_put(k, sh), jax.device_put(v, sh),
                     counts.astype(np.int32))
    out = jshuffle.exchange(skv, ("hash", None))
    c = out.cap
    K, V = np.asarray(out.key), np.asarray(out.value)
    st = out.exchange_stats
    return ([(K[p * c:(p + 1) * c], V[p * c:(p + 1) * c]) for p in range(W)],
            out.counts, st.cap_out, bool(st.speculative))


@pytest.fixture(scope="module")
def spec_runs(tmp_path_factory):
    """Both sequences on 2 gloo CPU ranks, one set of processes."""
    W = 2
    plan, arrs = _spec_inputs(W)
    d = str(tmp_path_factory.mktemp("rank_spec"))
    np.savez(os.path.join(d, "inputs.npz"), plan=json.dumps(plan), **arrs)
    port = launch.pick_port()
    procs = []
    for r in range(W):
        env = dict(os.environ, PYTHONPATH=ROOT, MRTPU_DIST_WORLD=str(W),
                   MRTPU_DIST_RANK=str(r),
                   MRTPU_DIST_COORD=f"localhost:{port}",
                   MRTPU_DIST_RUNDIR=os.path.join(d, "run"),
                   MRTPU_DIST_DEVICE="cpu", OMP_NUM_THREADS="1")
        env.pop("MRTPU_FAULTS", None)
        procs.append(subprocess.Popen([sys.executable, "-c", RANK_SPEC, d],
                                      env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * W, \
        b"\n".join(o[-1500:] for o in outs).decode(errors="replace")
    return W, plan, arrs, [dict(np.load(os.path.join(d, f"out{r}.npz")))
                           for r in range(W)]


def _assert_call_equal(got, tag, want, W):
    blocks, wcounts, wcap, wspec = want
    for r in range(W):
        assert got[r][tag + "_c"].tolist() == wcounts.tolist(), tag
        assert got[r][tag + "_st"].tolist() == [wcap, int(wspec)], tag
        wk, wv = blocks[r]
        gk, gv = got[r][tag + "_k"], got[r][tag + "_v"]
        assert gk.dtype == wk.dtype and gv.dtype == wv.dtype, tag
        np.testing.assert_array_equal(gk, wk, err_msg=f"{tag} {r}")
        np.testing.assert_array_equal(gv, wv, err_msg=f"{tag} {r}")


@pytest.mark.parametrize("wire", ["0", "1"])
def test_rank_speculation_matches_jax_mesh(wire, spec_runs, monkeypatch):
    """full → a quarter valid (the cached plan holds: its larger cap is
    kept) → keys skewed onto one destination (it does not hold: fresh)
    → a quarter again (holds, ≥ 4× oversized: right-sized) → the same
    (now at the right-sized plan): every call's padded blocks, counts,
    cap_out and speculative equal JAX make_mesh(2) over the same
    sequence from a fresh cache, codec off and on."""
    W, plan, arrs, got = spec_runs
    monkeypatch.setenv("MRTPU_WIRE", wire)
    monkeypatch.setattr(jshuffle, "_SPEC_CACHE", {})
    mesh = j_make_mesh(W)
    flags = []
    for i, call in enumerate(plan["seq"]):
        want = _jax_spec_exchange(mesh, plan, arrs, call, W)
        _assert_call_equal(got, f"{wire}_{i}", want, W)
        flags.append(want[3])
    caps = [int(got[0][f"{wire}_{i}_st"][0]) for i in range(5)]
    assert flags == [False, True, False, True, True], (wire, flags, caps)
    # the quarter keeps the full call's cap; the oversized call runs at
    # the skewed call's cap and the next at the right-sized one
    assert caps[1] == caps[0] and caps[3] == caps[2] > caps[4], caps


def test_rank_with_a_cleared_cache_goes_fresh(spec_runs, monkeypatch):
    """Rank 1 loses its cache after two calls: the next exchange runs at
    the fresh plan on both ranks (no hang, no divergence), equal to JAX
    from a fresh cache; the one after speculates again on both."""
    W, plan, arrs, got = spec_runs
    monkeypatch.setenv("MRTPU_WIRE", "0")
    mesh = j_make_mesh(W)
    monkeypatch.setattr(jshuffle, "_SPEC_CACHE", {})
    for i, call in enumerate(plan["clear_seq"]):
        if i == plan["clear_at"]:
            monkeypatch.setattr(jshuffle, "_SPEC_CACHE", {})
        want = _jax_spec_exchange(mesh, plan, arrs, call, W)
        _assert_call_equal(got, f"clear_{i}", want, W)
    assert [bool(got[0][f"clear_{i}_st"][1]) for i in range(4)] == \
        [False, True, False, True]
    assert got[0]["clear_3_st"][0] < got[0]["clear_1_st"][0]
