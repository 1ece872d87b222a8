"""Fault tolerance in the port against the JAX package's ``ft/``, on the
CPU: fault specs and the fault decisions call by call at all ten sites,
``classify``, the seeded backoff, the exhaustion message, budget 0; the
chaos goldens (wordfreq with a checkpoint round trip, InvertedIndex-shaped
postings, the external sort's spill sites, the warm fused exchange group)
at P = 1 and P = 3, faulted ≡ clean ≡ the JAX package's clean run, with
``stats()["ft"]`` equal to the JAX package's after the same schedule;
quarantine records at task, discovery and balance time; the journal's
records equal to the JAX package's but for times and pids, kill and
resume, the torn tail, the checkpoint GC, a JAX journal resumed by the
port; a failure of the card fatal under every budget and ``onfault``;
and a ``shuffle.exchange`` fault recovered on both ranks of a two-rank
gloo group.  The JAX run is the reference: its own ``ft`` state is reset
beside the port's around every test."""

import collections
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import gpu_mapreduce_tpu.ft.retry as jftr
from gpu_mapreduce_tpu import ft as jft
from gpu_mapreduce_tpu.core.mapreduce import MapReduce as JMapReduce
from gpu_mapreduce_tpu.core.runtime import MRError as JMRError
from gpu_mapreduce_tpu.oink import OinkScript as JOinkScript
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.plan import plan_cache as j_plan_cache
from gpu_mapreduce_tpu.utils.io import read_words as j_read_words
from gpu_mapreduce_tpu_torch import MapReduce, MRError, OinkScript, ft
from gpu_mapreduce_tpu_torch import launch
from gpu_mapreduce_tpu_torch.core.runtime import DeviceError
from gpu_mapreduce_tpu_torch.ft import inject, journal
from gpu_mapreduce_tpu_torch.ft import retry as ftr
from gpu_mapreduce_tpu_torch.ops.cuda import match
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.plan import plan_cache
from gpu_mapreduce_tpu_torch.utils.io import read_words

from test_torch_parallel import same_kv, tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"port": (ft, ftr, MapReduce, MRError),
         "jax": (jft, jftr, JMapReduce, JMRError)}


@pytest.fixture(autouse=True)
def ft_state(monkeypatch):
    """Both packages' ft state reset around every test; backoff sleeps
    recorded, never slept; plan caches cold."""
    slept = {"port": [], "jax": []}
    monkeypatch.setattr(ftr, "_sleep", slept["port"].append)
    monkeypatch.setattr(jftr, "_sleep", slept["jax"].append)
    for k in ("MRTPU_FAULTS", "MRTPU_RETRY", "MRTPU_JOURNAL",
              "MRTPU_ONFAULT", "MRTPU_CKPT_EVERY", "MRTPU_FUSE"):
        monkeypatch.delenv(k, raising=False)
    ft.reset()
    jft.reset()
    tshuffle._SPEC_CACHE.clear()
    jshuffle._SPEC_CACHE.clear()
    plan_cache().clear()
    j_plan_cache().clear()
    yield slept
    ft.reset()
    jft.reset()


@pytest.fixture
def word_corpus(tmp_path):
    import random
    r = random.Random(41)
    vocab = [f"word{i:03d}".encode() for i in range(120)]
    files, oracle = [], collections.Counter()
    for i in range(6):
        ws = r.choices(vocab, k=300 + 40 * i)
        oracle.update(ws)
        p = tmp_path / f"c{i}.txt"
        p.write_bytes(b" ".join(ws))
        files.append(str(p))
    return files, oracle


def _mr(side, P, **kw):
    if side == "port":
        return MapReduce(device="cpu", comm=None if P == 1 else tmesh(P),
                         **kw)
    return JMapReduce(None if P == 1 else j_make_mesh(P), **kw)


def _arm_all_sites(side, budget=3, max_faults=1):
    f = SIDES[side][0]
    for site in f.SITES:
        f.schedule(site=site, rate=1.0, seed=11, max_faults=max_faults)
        f.set_budget(site, budget)


def _pairs(mr):
    return sorted((bytes(k) if isinstance(k, (bytes, np.bytes_)) else k,
                   int(v)) for fr in mr.kv.frames() for k, v in fr.pairs())


def _ft_view(side):
    """The ``stats()["ft"]`` section of a fresh MR of ``side``."""
    st = (MapReduce(device="cpu") if side == "port"
          else JMapReduce()).stats()["ft"]
    for rec in st["quarantined"]["records"]:
        rec.pop("trace", None)
    return st


# -- injection -----------------------------------------------------------------

def _fields(s):
    return (s.site, s.rate, s.kind, s.seed, s.max_faults, s.after, s.rank)


@pytest.mark.parametrize("text", [
    "seed=7;site=ingest.read;rate=0.05;kind=oserror"
    "|site=spill.read,spill.write;rate=1.0;n=2;after=3",
    "site=shuffle.exchange,checkpoint.save,ingest.tokenize;kind=timeout",
    "site=*;rate=0.3;kind=runtime;seed=5",
    "site=ingest.read;kind=fatal;after=1;n=1"])
def test_parse_faults_matches_jax(text):
    assert [_fields(s) for s in inject.parse_faults(text)] == \
        [_fields(s) for s in jft.parse_faults(text)]


def test_sites_match_jax():
    assert ft.SITES == jft.SITES


@pytest.mark.parametrize("site", jft.SITES)
def test_fault_decisions_match_jax_call_by_call(site):
    """The same seeded spec gives the same verdict at every probe."""
    got = {}
    for side in SIDES:
        f = SIDES[side][0]
        f.schedule(site=site, rate=0.4, seed=7, after=2, max_faults=9)
        seq = []
        for _ in range(48):
            try:
                f.fault_point(site)
                seq.append(0)
            except Exception as e:
                assert isinstance(e, f.InjectedFault) and \
                    e.ft_site == site
                seq.append(1)
        got[side] = (seq, f.fault_counts())
        f.clear_faults()
    assert got["port"] == got["jax"]
    assert 0 < sum(got["port"][0]) <= 9


# -- retry policy --------------------------------------------------------------

def _exceptions(side):
    f, r, _mr_cls, err = SIDES[side]
    mod = __import__(f.__name__ + ".inject", fromlist=["x"])
    named = err("semantic")
    named.ft_site = "ingest.read"
    return [OSError(5, "io"), TimeoutError("t"), ConnectionError("c"),
            PermissionError("p"), FileNotFoundError("f"),
            IsADirectoryError("d"), NotADirectoryError("n"),
            err("x"), named, ValueError("v"), RuntimeError("r"),
            KeyError("k"), MemoryError(),
            mod.InjectedOSError("i"), mod.InjectedTimeout("i"),
            mod.InjectedRuntimeError("i"), mod.InjectedFatal("i")]


@pytest.mark.parametrize("site", ["ingest.read", "shuffle.exchange"])
def test_classify_matches_jax(site):
    got = {side: [SIDES[side][1].classify(site, e)
                  for e in _exceptions(side)] for side in SIDES}
    assert got["port"] == got["jax"]
    assert "transient" in got["port"] and "fatal" in got["port"]


def test_card_failures_are_fatal():
    """A kernel that did not build, load or launch, an OOM on the card
    and a CUDA error torch raised are fatal and never skippable."""
    for e in (DeviceError("seg_table kernel launch failed (CUDA error 2)"),
              torch.cuda.OutOfMemoryError("CUDA out of memory."),
              RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")):
        assert ftr.classify("shuffle.exchange", e) == "fatal"
        assert ftr.device_error(e) and not ftr._skippable(e)
    assert not ftr.device_error(RuntimeError("other"))


def _flaky(n_fail, exc):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_fail:
            raise exc
        return calls["n"]
    return fn, calls


def test_backoff_delays_match_jax(ft_state, monkeypatch):
    import random
    monkeypatch.setenv("MRTPU_RETRY_BACKOFF", "0.01")
    monkeypatch.setenv("MRTPU_RETRY_BACKOFF_MAX", "0.05")
    monkeypatch.setattr(ftr, "_JITTER", random.Random(0xF7A11))
    monkeypatch.setattr(jftr, "_JITTER", random.Random(0xF7A11))
    for side in SIDES:
        f, r = SIDES[side][:2]
        f.set_budget("spill.read", 6)
        fn, calls = _flaky(5, OSError(5, "torn"))
        assert r.retry_call("spill.read", fn) == 6
        assert r.retries_snapshot() == {("spill.read", "retry"): 5,
                                        ("spill.read", "recovered"): 1}
    assert ft_state["port"] == ft_state["jax"]
    assert ft_state["port"][-1] <= 0.05 and len(ft_state["port"]) == 5
    assert ft_state["port"][0] < ft_state["port"][2]


def test_exhaustion_message_matches_jax():
    msgs = {}
    for side in SIDES:
        f, r, _cls, err = SIDES[side]
        f.set_budget("checkpoint.save", 2)
        fn, calls = _flaky(9, OSError(28, "No space left on device"))
        with pytest.raises(err) as ei:
            r.retry_call("checkpoint.save", fn, detail="/ck/a")
        assert calls["n"] == 3 and ei.value.ft_site == "checkpoint.save"
        msgs[side] = (str(ei.value), r.retries_snapshot())
    assert msgs["port"] == msgs["jax"]
    assert "checkpoint.save retry budget exhausted after 3 attempts" in \
        msgs["port"][0]


def test_budget_zero_passes_straight_through(ft_state):
    fn, calls = _flaky(1, OSError(5, "x"))
    with pytest.raises(OSError):
        ftr.retry_call("spill.read", fn)
    assert calls["n"] == 1 and ftr.retries_snapshot() == {}
    assert ft_state["port"] == []


def test_budgets_parse_and_env_respec_match_jax(monkeypatch, capsys):
    for side in SIDES:
        f, r, cls, _err = SIDES[side]
        with pytest.raises(ValueError, match="unknown retry site"):
            f.set_budget("ingest.raed", 3)
        assert r.parse_retry("ingest.read=3, 2") == {"ingest.read": 3,
                                                     "*": 2}
        f.set_budget("spill.read", 3)
        monkeypatch.setenv("MRTPU_RETRY", "ingest.read=2")
        cls() if side == "jax" else cls(device="cpu")
        assert (f.budget("spill.read"), f.budget("ingest.read")) == (3, 2)
        monkeypatch.setenv("MRTPU_RETRY", "")
        cls() if side == "jax" else cls(device="cpu")
        assert (f.budget("spill.read"), f.budget("ingest.read")) == (3, 0)
        monkeypatch.setenv("MRTPU_RETRY", "ingest.raed=3")
        cls() if side == "jax" else cls(device="cpu")
        assert "MRTPU_RETRY ignored" in capsys.readouterr().err
        monkeypatch.delenv("MRTPU_RETRY")
        f.reset()


def test_stats_ft_section_matches_jax():
    assert _ft_view("port") == _ft_view("jax")
    assert _ft_view("port")["journal"] is None
    ft.set_budget("spill.read", 2)
    jft.set_budget("spill.read", 2)
    assert _ft_view("port")["budgets"] == {"spill.read": 2}
    assert _ft_view("port") == _ft_view("jax")


# -- chaos goldens -------------------------------------------------------------

def _wordfreq_pairs(side, files, P, ckpt_dir):
    """map_files → collate → reduce count → save → load (every retry
    site but the spill ones probes); returns (pairs, reloaded pairs)."""
    if side == "port":
        from gpu_mapreduce_tpu_torch.ops.reduces import count
        words = read_words
    else:
        from gpu_mapreduce_tpu.ops.reduces import count
        words = j_read_words
    mr = _mr(side, P)

    def fileread(itask, fname, kv, ptr):
        with open(fname, "rb") as f:
            ws = words(f.read())
        kv.add_batch(ws, np.ones(len(ws), np.int64))

    mr.map_files(list(files), fileread)
    mr.collate()
    mr.reduce(count, batch=True)
    pairs = _pairs(mr)
    mr.save(ckpt_dir)
    mr2 = _mr(side, P)
    mr2.load(ckpt_dir)
    return pairs, _pairs(mr2)


@pytest.mark.parametrize("P", [1, 3])
def test_chaos_golden_wordfreq(word_corpus, tmp_path, P):
    files, oracle = word_corpus
    runs = {}
    for side in SIDES:
        clean = _wordfreq_pairs(side, files, P, str(tmp_path / f"{side}c"))
        _arm_all_sites(side)
        chaos = _wordfreq_pairs(side, files, P, str(tmp_path / f"{side}x"))
        runs[side] = (clean, chaos, _ft_view(side))
    clean, chaos, st = runs["port"]
    assert collections.Counter(dict(clean[0])) == oracle
    assert clean == chaos == runs["jax"][0]
    assert clean[0] == clean[1]
    for site in ("ingest.read", "ingest.tokenize", "checkpoint.save") + \
            (("shuffle.exchange",) if P > 1 else ()):
        assert st["faults_injected"].get(site, 0) >= 1, (site, st)
    assert st["faults_injected"] == ft.fault_counts()
    assert st == runs["jax"][2]


@pytest.mark.parametrize("P", [1, 3])
def test_chaos_golden_invertedindex_postings(word_corpus, P):
    files, _ = word_corpus

    def postings(side):
        words = read_words if side == "port" else j_read_words
        mr = _mr(side, P)

        def emit(itask, fname, kv, ptr):
            with open(fname, "rb") as f:
                ws = list(dict.fromkeys(words(f.read())))
            kv.add_batch(ws, np.full(len(ws), itask, np.int64))

        mr.map_files(list(files), emit)
        mr.collate()
        mr.reduce(lambda key, vals, kv, ptr: kv.add(key, len(vals)))
        return _pairs(mr)

    got = {}
    for side in SIDES:
        clean = postings(side)
        _arm_all_sites(side)
        got[side] = (clean, postings(side), SIDES[side][0].fault_counts())
    assert got["port"][0] == got["port"][1] == got["jax"][0]
    assert got["port"][2] == got["jax"][2]
    if P > 1:
        assert got["port"][2]["shuffle.exchange"] == 1


N_SPILL_ROWS = 3 * (1 << 20) // 16      # about 3 pages of 16 B rows


def test_chaos_golden_external_sort_spill_sites(tmp_path):
    """spill.write and spill.read faults under a budget: the external
    sort's rows equal the clean run's and the JAX package's."""
    def sort_rows(side, tag):
        mr = _mr(side, 1, outofcore=1, memsize=1, maxpage=1,
                 fpath=str(tmp_path / f"{side}{tag}"))
        rng = np.random.default_rng(12345)
        keys = rng.integers(0, 1 << 40, N_SPILL_ROWS).astype(np.uint64)
        vals = np.arange(len(keys), dtype=np.uint64)
        step = len(keys) // 5
        mr.map(1, lambda i, kv, p: [kv.add_batch(keys[s:s + step],
                                                 vals[s:s + step])
                                    for s in range(0, len(keys), step)])
        mr.sort_keys(1)
        return [(int(k), int(v)) for fr in mr.kv.frames()
                for k, v in fr.to_host().pairs()]

    got = {}
    for side in SIDES:
        f = SIDES[side][0]
        clean = sort_rows(side, "c")
        for site in ("spill.write", "spill.read"):
            f.schedule(site=site, rate=1.0, seed=5, max_faults=2)
            f.set_budget(site, 3)
        got[side] = (clean, sort_rows(side, "x"), f.fault_counts(),
                     SIDES[side][1].retries_snapshot())
    assert got["port"][0] == got["port"][1] == got["jax"][0]
    assert got["port"][2] == got["jax"][2] == {"spill.write": 2,
                                                "spill.read": 2}
    assert got["port"][3] == got["jax"][3]


@pytest.mark.parametrize("P", [1, 3])
def test_chaos_golden_warm_fused_group(monkeypatch, P):
    """The fused exchange group (P = 3) and local group (P = 1), cold then
    warm, a shuffle.exchange fault at the warm run: equal to the clean
    run and to the JAX package's clean run shard by shard, caps
    included, with the fault recovered inside the group."""
    monkeypatch.setenv("MRTPU_PALLAS_GROUP", "1")
    monkeypatch.setenv("MRTPU_WIRE", "0")
    from gpu_mapreduce_tpu.ops import reduces as jr
    from gpu_mapreduce_tpu_torch.ops import reduces as tr
    keys = np.random.default_rng(5).integers(0, 1 << 64, 400,
                                             dtype=np.uint64)[
        (np.arange(3000) * 7919) % 400]
    vals = np.ones(3000, np.int64)

    def run(side, mr):
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        mr.aggregate()
        mr.convert()
        mr.reduce(tr.count if side == "port" else jr.count, batch=True)
        return mr

    def warm(side):
        run(side, _mr(side, P, fuse=1)).kv        # cold
        return run(side, _mr(side, P, fuse=1))

    jclean = warm("jax")
    tclean = warm("port")
    _ = tclean.kv
    plan_cache().clear()
    tshuffle._SPEC_CACHE.clear()
    ft.schedule(site="shuffle.exchange", rate=1.0, seed=11, after=1,
                max_faults=1)
    ft.set_budget("shuffle.exchange", 3)
    tchaos = warm("port")
    assert _pairs(tchaos) == _pairs(tclean) == _pairs(jclean)
    if P > 1:
        same_kv(jclean, tchaos)
        same_kv(jclean, tclean)
        assert ft.fault_counts() == {"shuffle.exchange": 1}
        assert ftr.retries_snapshot()[("shuffle.exchange",
                                       "recovered")] == 1


def test_chaos_exhausted_budget_fails_like_jax(word_corpus):
    files, _ = word_corpus
    msgs = {}
    for side in SIDES:
        f, _r, _cls, err = SIDES[side]
        f.schedule(site="ingest.read", rate=1.0, seed=2, max_faults=10)
        f.set_budget("ingest.read", 1)
        with pytest.raises(err, match="ingest.read retry budget "
                                      "exhausted") as ei:
            _mr(side, 3).map_files(list(files),
                                   lambda i, fn, kv, p: kv.add(b"x", 1))
        msgs[side] = str(ei.value)
    assert msgs["port"] == msgs["jax"]


# -- onfault: retry and skip with quarantine -----------------------------------

@pytest.mark.parametrize("P", [1, 3])
def test_quarantine_skip_records_match_jax(word_corpus, P):
    files, oracle = word_corpus
    poisoned = files[3]
    with open(poisoned, "rb") as f:
        bad = collections.Counter(read_words(f.read()))
    got = {}
    for side in SIDES:
        words = read_words if side == "port" else j_read_words

        def fileread(itask, fname, kv, ptr):
            if fname == poisoned:
                raise ValueError("corrupt encoding")
            with open(fname, "rb") as f:
                ws = words(f.read())
            kv.add_batch(ws, np.ones(len(ws), np.int64))

        mr = _mr(side, P, onfault="skip")
        n = mr.map_files(list(files), fileread)
        counts = collections.Counter()
        for fr in mr.kv.frames():
            for k, _v in fr.pairs():
                counts[bytes(k)] += 1
        got[side] = (n, counts, _ft_view(side)["quarantined"])
    n, counts, q = got["port"]
    assert n == sum((oracle - bad).values()) and counts == oracle - bad
    assert q["count"] == 1 and q["records"][0]["file"] == poisoned
    assert got["port"] == got["jax"]


def test_quarantine_at_discovery_and_balance_time_matches_jax(
        word_corpus, monkeypatch):
    import gpu_mapreduce_tpu.parallel.ingest as jing
    import gpu_mapreduce_tpu_torch.parallel.ingest as ting
    files, oracle = word_corpus
    real = os.path.getsize
    badf = files[1]
    with open(badf, "rb") as f:
        bad = collections.Counter(read_words(f.read()))

    def getsize(p):
        if p == badf:
            raise OSError(5, "I/O error", p)
        return real(p)
    got = {}
    for side, ing in (("port", ting), ("jax", jing)):
        words = read_words if side == "port" else j_read_words

        def fileread(itask, fname, kv, ptr):
            with open(fname, "rb") as f:
                ws = words(f.read())
            kv.add_batch(ws, np.ones(len(ws), np.int64))

        monkeypatch.setattr(ing.os.path, "getsize", getsize)
        n1 = _mr(side, 3, onfault="skip").map_files(list(files), fileread)
        monkeypatch.setattr(ing.os.path, "getsize", real)
        q1 = _ft_view(side)["quarantined"]
        SIDES[side][0].reset()
        n2 = _mr(side, 1, onfault="skip").map_files(
            list(files) + ["/nonexistent/ghost.txt"], fileread)
        got[side] = (n1, q1, n2, _ft_view(side)["quarantined"])
    assert got["port"][0] == sum((oracle - bad).values())
    assert got["port"][1]["records"][0]["file"] == badf
    assert got["port"][2] == sum(oracle.values())
    assert got["port"][3]["records"][0]["file"] == "/nonexistent/ghost.txt"
    assert got["port"] == got["jax"]


def test_missing_input_wraps_mrerror_like_jax(word_corpus):
    files, _ = word_corpus
    for side in SIDES:
        with pytest.raises(SIDES[side][3], match="unreadable"):
            _mr(side, 1).map_files(list(files) + ["/no/such/file"],
                                   lambda i, f, kv, p: None)


def test_onfault_retry_default_budget_and_quarantine_after_retries(
        word_corpus):
    files, _ = word_corpus
    got = {}
    for side in SIDES:
        f, r, _cls, err = SIDES[side]
        f.schedule(site="ingest.read", rate=1.0, seed=1, max_faults=2)
        n1 = _mr(side, 1, onfault="retry").map(
            3, lambda i, kv, p: kv.add(i, i))
        with pytest.raises(err, match="onfault"):
            _mr(side, 1, onfault="explode")
        f.reset()
        words = read_words if side == "port" else j_read_words

        def fileread(itask, fname, kv, ptr):
            with open(fname, "rb") as fh:
                ws = words(fh.read())
            kv.add_batch(ws, np.ones(len(ws), np.int64))
        f.schedule(site="ingest.tokenize", rate=1.0, seed=4)
        f.set_budget("ingest.tokenize", 1)
        n2 = _mr(side, 1, onfault="skip").map_files(list(files), fileread)
        got[side] = (n1, n2, r.retries_snapshot(),
                     _ft_view(side)["quarantined"]["by_site"])
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (3, 0)
    assert got["port"][3] == {"ingest.tokenize": len(files)}


def test_fatal_kills_through_skip_and_unbudgeted_fault_is_no_exhaustion(
        word_corpus):
    files, _ = word_corpus
    for side in SIDES:
        f, r, _cls, err = SIDES[side]
        mod = __import__(f.__name__ + ".inject", fromlist=["x"])
        f.schedule(site="ingest.read", kind="fatal", rate=1.0, max_faults=1)
        with pytest.raises(mod.InjectedFatal):
            _mr(side, 1, onfault="skip").map_files(
                list(files), lambda i, fn, kv, p: kv.add(b"x", 1))
        assert r.quarantine_snapshot()["count"] == 0
        f.reset()
        f.schedule(site="ingest.tokenize", rate=1.0, max_faults=1)
        with pytest.raises(err) as ei:
            _mr(side, 1).map_files(list(files),
                                   lambda i, fn, kv, p: kv.add(b"x", 1))
        assert "exhausted" not in str(ei.value)
        f.reset()
        f.schedule(site="spill.write", rate=0.01)
        assert not r.ingest_active("fail")
        f.schedule(site="ingest.read", rate=0.01)
        assert r.ingest_active("fail")
        f.reset()


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on the card, so the kernel
    wrapper takes its launch path."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _StubLib:
    def mark_words_launch(self, *args):
        return 700           # cudaErrorIllegalAddress


@pytest.mark.parametrize("onfault", ["fail", "retry", "skip"])
def test_kernel_launch_failure_is_fatal_under_every_policy(monkeypatch,
                                                           onfault):
    """A stubbed launcher returning non-zero: DeviceError through any
    budget and onfault, never retried, never quarantined, never answered
    by the plain version."""
    monkeypatch.setattr(match, "library", lambda name, bind: _StubLib())
    monkeypatch.setattr(match, "mark_output",
                        lambda w: torch.empty(w.shape[0], dtype=torch.int8))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(match, "mark_words_ref", lambda *a: pytest.fail(
        "a launch failure fell back to the plain version"))
    ft.set_budget("*", 3)
    words = torch.arange(64, dtype=torch.int32).as_subclass(_FakeCuda)
    calls = []

    def task(itask, kv, ptr):
        calls.append(itask)
        match.mark_words(words, b"href")

    mr = MapReduce(device="cpu", onfault=onfault)
    with pytest.raises(DeviceError, match="launch failed"):
        mr.map(2, task)
    assert calls == [0]
    assert ftr.quarantine_snapshot()["count"] == 0
    snap = ftr.retries_snapshot()
    assert not any(o in ("retry", "recovered", "exhausted")
                   for _s, o in snap)


@pytest.mark.parametrize("exc", [
    DeviceError("seg_table kernel launch failed (CUDA error 2)"),
    torch.cuda.OutOfMemoryError("CUDA out of memory."),
    RuntimeError("CUDA error: an illegal memory access")])
def test_card_failure_in_exchange_is_never_retried(monkeypatch, ft_state,
                                                   exc):
    ft.set_budget("shuffle.exchange", 3)
    monkeypatch.setattr(tshuffle, "_exchange_mesh",
                        lambda *a, **k: (_ for _ in ()).throw(exc))
    mr = MapReduce(comm=tmesh(2))
    mr.map(1, lambda i, kv, p: kv.add_batch(np.arange(8, dtype=np.uint64),
                                            np.arange(8, dtype=np.uint64)))
    with pytest.raises(type(exc)):
        mr.aggregate()
    assert ftr.retries_snapshot() == {("shuffle.exchange", "fatal"): 1}
    assert ft_state["port"] == []


# -- journal and resume --------------------------------------------------------

def _write_script_inputs(tmp_path):
    d1 = tmp_path / "w1.txt"
    d1.write_bytes(b"apple banana apple cherry banana apple " * 30)
    d2 = tmp_path / "w2.txt"
    d2.write_bytes(b"dog cat dog bird cat dog emu " * 25)
    return str(d1), str(d2)


def _script(d1, d2, o1, o2):
    return (f"mr a\n"
            f"wordfreq 3 -i {d1} -o {o1} NULL\n"
            f"wordfreq 3 -i {d2} -o {o2} NULL\n")


def _interp(side):
    """An interpreter of ``side``; the JAX one on its one-device mesh, the
    device tier the port's one device is held against."""
    return OinkScript(device="cpu", screen=False) if side == "port" \
        else JOinkScript(comm=j_make_mesh(1), screen=False)


def _strip(recs, root):
    """Records without times, pids, crcs and the JAX package's trace
    ids, paths relative to root."""
    out = []
    for r in recs:
        r = {k: v for k, v in r.items()
             if k not in ("utc", "pid", "c", "trace")}
        out.append(json.loads(json.dumps(r).replace(root, "<d>")))
    return out


def test_journal_records_match_jax(tmp_path, monkeypatch):
    got = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        d1, d2 = _write_script_inputs(d)
        monkeypatch.setenv("MRTPU_JOURNAL", str(d / "j"))
        monkeypatch.setenv("MRTPU_CKPT_EVERY", "1")
        _interp(side).run_string(_script(d1, d2, str(d / "o1"),
                                         str(d / "o2")))
        got[side] = _strip(SIDES[side][0].read_journal(str(d / "j")),
                           str(d))
        assert sorted(os.listdir(d / "j")) == ["ckpt-00001", "ckpt-00002",
                                               "journal.jsonl"]
        SIDES[side][0].reset()
    assert got["port"] == got["jax"]
    kinds = [r["kind"] for r in got["port"] if r["kind"] != "op"]
    assert kinds == ["begin", "cmd", "ckpt", "cmd", "ckpt"]


def test_programmatic_journal_op_records_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MRTPU_CKPT_EVERY", "2")
    got = {}
    for side in SIDES:
        jdir = str(tmp_path / side)
        monkeypatch.setenv("MRTPU_JOURNAL", jdir)
        mr = _mr(side, 1)
        keys = np.arange(100, dtype=np.uint64) % 7
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, keys))
        mr.collate()
        mr.reduce(lambda k, vs, kv, p: kv.add(k, len(vs)))
        mr.sort_keys(1)
        f = SIDES[side][0]
        ck = f.latest_checkpoint(jdir)
        got[side] = (_strip(f.read_journal(jdir), jdir),
                     os.path.relpath(ck, jdir))
        mr2 = _mr(side, 1)
        mr2.load(ck)
        f.reset()
    assert got["port"] == got["jax"]
    ops = [r["op"] for r in got["port"][0] if r["kind"] == "op"]
    assert "map" in ops and "convert" in ops and "sort_keys" in ops


@pytest.mark.parametrize("P", [1, 3])
def test_kill_and_resume_reproduces_output(tmp_path, monkeypatch, P):
    """A fatal injected fault kills the script in command 2 after
    command 1 checkpointed; the resume on a fresh interpreter (of any
    width) re-runs only the tail, and the files equal the clean run's
    and the JAX package's (at P = 3 the tail writes a file a shard,
    whose lines together are the clean file's)."""
    d1, d2 = _write_script_inputs(tmp_path)
    jdir = str(tmp_path / "journal")
    c1, c2 = str(tmp_path / "o1.clean"), str(tmp_path / "o2.clean")
    OinkScript(device="cpu", screen=False).run_string(
        _script(d1, d2, c1, c2))
    x1, x2 = str(tmp_path / "o1.jax"), str(tmp_path / "o2.jax")
    _interp("jax").run_string(_script(d1, d2, x1, x2))
    monkeypatch.setenv("MRTPU_JOURNAL", jdir)
    monkeypatch.setenv("MRTPU_CKPT_EVERY", "1")
    ft.schedule(site="ingest.read", kind="fatal", rate=1.0, after=1,
                max_faults=1)
    k1, k2 = str(tmp_path / "o1.kill"), str(tmp_path / "o2.kill")
    with pytest.raises(inject.InjectedFatal):
        OinkScript(device="cpu", screen=False).run_string(
            _script(d1, d2, k1, k2))
    assert os.path.exists(k1) and not os.path.exists(k2)
    ft.reset()
    monkeypatch.delenv("MRTPU_JOURNAL")
    s = ft.resume(jdir, device="cpu",
                  comm=None if P == 1 else tmesh(P))
    assert open(k1).read() == open(c1).read() == open(x1).read()
    assert open(c2).read() == open(x2).read()
    if P == 1:
        assert open(k2).read() == open(c2).read()
    else:
        lines = [ln for p in range(P) for ln in open(f"{k2}.{p}")]
        assert sorted(lines) == sorted(open(c2).readlines())
    assert "a" in s.obj.named and s._ft_resharded == (P != 1)
    recs = ft.read_journal(jdir)
    kinds = [r["kind"] for r in recs]
    assert "resume" in kinds and kinds.count("ckpt") >= 2
    res = recs[kinds.index("resume")]
    assert (res["from_seq"], res["cmds_done_before_crash"]) == (1, 1)
    # only the tail re-ran: one cmd record after the resume, seq 2
    after = [r for r in recs[kinds.index("resume"):] if r["kind"] == "cmd"]
    assert [r["seq"] for r in after] == [2]


def test_resume_without_checkpoint_and_resume_builtin(tmp_path,
                                                      monkeypatch):
    d1, d2 = _write_script_inputs(tmp_path)
    monkeypatch.setenv("MRTPU_CKPT_EVERY", "5")
    jdir = str(tmp_path / "j0")
    monkeypatch.setenv("MRTPU_JOURNAL", jdir)
    ft.schedule(site="ingest.read", kind="fatal", rate=1.0, max_faults=1)
    o1, o2 = str(tmp_path / "p1"), str(tmp_path / "p2")
    with pytest.raises(inject.InjectedFatal):
        OinkScript(device="cpu", screen=False).run_string(
            _script(d1, d2, o1, o2))
    ft.clear_faults()
    # the runbook's footgun: MRTPU_JOURNAL still set to the same dir
    s = OinkScript(device="cpu", screen=False)
    s.run_string(f"resume {jdir}\n")
    c1, c2 = str(tmp_path / "q1"), str(tmp_path / "q2")
    monkeypatch.delenv("MRTPU_JOURNAL")
    OinkScript(device="cpu", screen=False).run_string(
        _script(d1, d2, c1, c2))
    assert open(o1).read() == open(c1).read()
    assert open(o2).read() == open(c2).read()
    begins = [r for r in ft.read_journal(jdir) if r["kind"] == "begin"]
    assert len(begins) == 1 and not begins[0]["lines"][0].startswith(
        "resume")
    with pytest.raises(MRError, match="Illegal resume"):
        s.one("resume")
    with pytest.raises(MRError, match="no journal"):
        ft.resume(str(tmp_path / "nothing"), device="cpu")


def test_resume_restores_named_mr_and_skips_shell(tmp_path, monkeypatch):
    d1, d2 = _write_script_inputs(tmp_path)
    jdir = str(tmp_path / "jn")
    script = (f"wordfreq 3 -i {d1} -o NULL freq\n"
              f"shell mkdir {tmp_path}/mkd\n"
              f"freq stats 0\n"
              f"wordfreq 3 -i {d2} -o {tmp_path}/n2 NULL\n")
    monkeypatch.setenv("MRTPU_JOURNAL", jdir)
    monkeypatch.setenv("MRTPU_CKPT_EVERY", "1")
    ft.schedule(site="ingest.read", kind="fatal", rate=1.0, after=1,
                max_faults=1)
    with pytest.raises(inject.InjectedFatal):
        OinkScript(device="cpu", screen=False).run_string(script)
    ft.reset()
    monkeypatch.delenv("MRTPU_JOURNAL")
    os.rmdir(tmp_path / "mkd")
    s = ft.resume(jdir, device="cpu")
    assert "freq" in s.obj.named
    assert os.path.exists(str(tmp_path / "n2"))
    # a skipped stretch's shell line is not replayed
    assert not os.path.exists(tmp_path / "mkd")


def test_failed_checkpoint_rounds_never_kill_the_run(tmp_path, monkeypatch):
    """An OSError in one auto-checkpoint and an injected fault at
    checkpoint.save with no budget each skip a round; the run goes on."""
    import gpu_mapreduce_tpu_torch.core.checkpoint as ckpt
    d1, d2 = _write_script_inputs(tmp_path)
    monkeypatch.setenv("MRTPU_CKPT_EVERY", "1")
    real = ckpt.save
    calls = {"n": 0}

    def flaky(mr, path):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(28, "No space left on device")
        return real(mr, path)
    monkeypatch.setattr(ckpt, "save", flaky)
    for tag in ("enospc", "inject"):
        jdir = str(tmp_path / tag)
        monkeypatch.setenv("MRTPU_JOURNAL", jdir)
        if tag == "inject":
            monkeypatch.setattr(ckpt, "save", real)
            ft.schedule(site="checkpoint.save", kind="runtime", rate=1.0,
                        max_faults=1)
        o1, o2 = str(tmp_path / f"{tag}1"), str(tmp_path / f"{tag}2")
        OinkScript(device="cpu", screen=False).run_string(
            _script(d1, d2, o1, o2))
        assert os.path.exists(o2)
        kinds = [r["kind"] for r in ft.read_journal(jdir)]
        assert kinds.count("ckpt") == 1
        assert not os.path.exists(os.path.join(jdir, "ckpt-00001"))


def test_checkpoint_gc_and_per_script_numbering(tmp_path, monkeypatch):
    """A second script in the same directory restarts the numbering; the
    GC keeps its fresh low-numbered set over the first script's stale
    ones, and the resume loads it."""
    d1, d2 = _write_script_inputs(tmp_path)
    jdir = str(tmp_path / "jgc")
    monkeypatch.setenv("MRTPU_JOURNAL", jdir)
    monkeypatch.setenv("MRTPU_CKPT_EVERY", "1")
    o = str(tmp_path / "gc")
    s = OinkScript(device="cpu", screen=False)
    s.run_string(f"mr a\nwordfreq 3 -i {d1} -o {o}.a NULL\n"
                 f"wordfreq 3 -i {d2} -o {o}.b NULL\n"
                 f"wordfreq 3 -i {d1} -o {o}.c NULL\n")
    assert sorted(d for d in os.listdir(jdir) if d.startswith("ckpt")) \
        == ["ckpt-00002", "ckpt-00003"]
    ft.schedule(site="ingest.read", kind="fatal", rate=1.0, after=1,
                max_faults=1)
    with pytest.raises(inject.InjectedFatal):
        s.run_string(f"mr b\nwordfreq 3 -i {d1} -o {o}.d NULL\n"
                     f"wordfreq 3 -i {d2} -o {o}.e NULL\n"
                     f"wordfreq 3 -i {d1} -o {o}.f NULL\n")
    ft.reset()
    monkeypatch.delenv("MRTPU_JOURNAL")
    r = ft.resume(jdir, device="cpu")
    assert os.path.exists(f"{o}.f") and "b" in r.obj.named
    assert open(f"{o}.f").read() == open(f"{o}.c").read()


class _EnospcFile:
    """Writes a partial line, then raises ENOSPC (a full disk's torn
    tail)."""

    def __init__(self, f):
        self._f = f
        self.fired = False

    def write(self, s):
        if not self.fired:
            self.fired = True
            self._f.write(s[: max(3, len(s) // 3)])
            raise OSError(28, "No space left on device")
        return self._f.write(s)

    def __getattr__(self, name):
        return getattr(self._f, name)


def test_torn_tail_is_skipped_and_sealed(tmp_path):
    jdir = str(tmp_path / "jd")
    j = journal.Journal(jdir, script_mode=True)
    j.begin(["cmd a", "cmd b", "cmd c"], "t")
    j.cmd_done("cmd a")
    j._f = _EnospcFile(j._f)
    with pytest.raises(OSError):
        j.cmd_done("cmd b")
    j.close()
    kinds = [(r.get("kind"), r.get("seq")) for r in
             journal.read_journal(jdir)]
    assert ("cmd", 1) in kinds and ("cmd", 2) not in kinds
    j2 = journal.Journal(jdir, script_mode=True)
    j2.cmd_seq = 1
    j2.cmd_done("cmd b")
    j2.close()
    kinds = [(r.get("kind"), r.get("seq")) for r in
             journal.read_journal(jdir)]
    assert kinds.count(("cmd", 2)) == 1
    plan = journal.plan_resume(jdir)
    assert plan == {**plan, "cmds_done": 2, "skip": 0}
    # the JAX reader sees the same records
    assert [r["kind"] for r in jft.read_journal(jdir)] == \
        [r["kind"] for r in journal.read_journal(jdir)]


def test_jax_journal_resumes_in_the_port(tmp_path, monkeypatch):
    """A directory left by a killed JAX run, resumed by the port: the
    files equal the JAX package's clean run."""
    from gpu_mapreduce_tpu.ft.inject import InjectedFatal as JFatal
    d1, d2 = _write_script_inputs(tmp_path)
    c1, c2 = str(tmp_path / "c1"), str(tmp_path / "c2")
    _interp("jax").run_string(_script(d1, d2, c1, c2))
    jdir = str(tmp_path / "jj")
    monkeypatch.setenv("MRTPU_JOURNAL", jdir)
    monkeypatch.setenv("MRTPU_CKPT_EVERY", "1")
    jft.schedule(site="ingest.read", kind="fatal", rate=1.0, after=1,
                 max_faults=1)
    k1, k2 = str(tmp_path / "k1"), str(tmp_path / "k2")
    with pytest.raises(JFatal):
        _interp("jax").run_string(_script(d1, d2, k1, k2))
    jft.reset()
    monkeypatch.delenv("MRTPU_JOURNAL")
    assert not os.path.exists(k2)
    s = ft.resume(jdir, device="cpu")
    assert open(k1).read() == open(c1).read()
    assert open(k2).read() == open(c2).read()
    assert "a" in s.obj.named
    assert [r["kind"] for r in ft.read_journal(jdir)].count("resume") == 1


# -- two ranks over gloo -------------------------------------------------------

RANK = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    from gpu_mapreduce_tpu_torch import ft
    from gpu_mapreduce_tpu_torch.ops.bits import to_numpy
    from gpu_mapreduce_tpu_torch.parallel import dist as D
    from gpu_mapreduce_tpu_torch.parallel.shuffle import exchange
    rt = D.init_from_env()
    ft.configure_from_env()
    d = sys.argv[1]
    rng = np.random.default_rng(3)
    counts = [57, 41]
    k = rng.integers(0, 1 << 64, sum(counts), dtype=np.uint64)
    v = np.arange(sum(counts), dtype=np.int64)
    lo = sum(counts[:rt.rank])
    fr = D.shard_local_rows((k[lo:lo + counts[rt.rank]],
                             v[lo:lo + counts[rt.rank]]), counts)
    outs = [exchange(fr, ("hash", None)) for _ in range(2)]
    res = {"same": all(
        np.array_equal(to_numpy(o.shard.key, o.key_dtype),
                       to_numpy(outs[1].shard.key, o.key_dtype))
        and np.array_equal(to_numpy(o.shard.value, o.value_dtype),
                           to_numpy(outs[1].shard.value, o.value_dtype))
        for o in outs), "counts": outs[0].counts.tolist(),
        "faults": ft.fault_counts(),
        "retries": sorted(map(list, ft.retries_snapshot().items()))}
    with open(os.path.join(d, f"rank{rt.rank}.json"), "w") as f:
        json.dump(res, f)
    rt.stop()
    os._exit(0)
""")


def test_rank_exchange_fault_recovered_on_both_ranks(tmp_path):
    """The seeded schedule fires at the same exchange call on both ranks,
    before the first collective; both retry into the same collectives
    and the output equals the unfaulted exchange's."""
    d = str(tmp_path)
    port = launch.pick_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, MRTPU_DIST_WORLD="2",
                   MRTPU_DIST_RANK=str(r),
                   MRTPU_DIST_COORD=f"localhost:{port}",
                   MRTPU_DIST_RUNDIR=os.path.join(d, "run"),
                   MRTPU_DIST_DEVICE="cpu", OMP_NUM_THREADS="1",
                   MRTPU_WIRE="0",
                   MRTPU_FAULTS="site=shuffle.exchange;rate=1;n=1;seed=11",
                   MRTPU_RETRY="shuffle.exchange=2",
                   MRTPU_RETRY_BACKOFF="0.001")
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
    assert [p.returncode for p in procs] == [0, 0], \
        b"\n".join(o[-1500:] for o in outs).decode(errors="replace")
    got = [json.load(open(os.path.join(d, f"rank{r}.json")))
           for r in range(2)]
    for g in got:
        assert g["same"] and sum(g["counts"]) == 98
        assert g["faults"] == {"shuffle.exchange": 1}
        assert g["retries"] == [[["shuffle.exchange", "recovered"], 1],
                                [["shuffle.exchange", "retry"], 1]]
