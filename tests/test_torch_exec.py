"""The port's exec/ layer (ingest prefetch, background spill writer and
its durability barrier) against the JAX package's: the same mechanics
tests, and the same sorted streams and chunk-map pairs with each knob on
and off, on the CPU."""

import os
import threading
import time

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu import exec as jexec
from gpu_mapreduce_tpu_torch import MapReduce
from gpu_mapreduce_tpu_torch import exec as mrexec
from gpu_mapreduce_tpu_torch.utils.io import read_words


@pytest.fixture(autouse=True)
def _fresh_exec_stats():
    mrexec.reset_stats()
    yield
    mrexec.reset_stats()


# -- prefetch_iter mechanics --------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_preserves_order_and_bounds_lookahead(depth):
    produced, consumed, ahead = [], [], [0]

    def src():
        for i in range(40):
            produced.append(i)
            ahead[0] = max(ahead[0], len(produced) - len(consumed))
            yield i

    for item in mrexec.prefetch_iter(src(), depth=depth, path="t.order"):
        time.sleep(0.002)                 # a slow consumer
        consumed.append(item)
    assert consumed == list(range(40))
    # depth queue slots + one in the producer's hand + one consumed
    assert ahead[0] <= depth + 2, ahead[0]


def test_prefetch_runs_on_its_own_thread():
    tids = set()

    def src():
        for i in range(5):
            tids.add(threading.get_ident())
            yield i

    assert list(mrexec.prefetch_iter(src(), depth=1, path="t.thread")) \
        == list(range(5))
    assert threading.get_ident() not in tids
    assert mrexec.exec_stats()["overlap"]["t.thread"]["items"] == 5


def test_prefetch_zero_depth_is_passthrough():
    tids = set()

    def src():
        for i in range(5):
            tids.add(threading.get_ident())
            yield i

    assert list(mrexec.prefetch_iter(src(), depth=0, path="t.zero")) \
        == list(range(5))
    assert tids == {threading.get_ident()}
    assert "t.zero" not in mrexec.exec_stats()["overlap"]


def test_prefetch_reraises_producer_error():
    def src():
        yield 1
        yield 2
        raise RuntimeError("reader died")

    got = []
    with pytest.raises(RuntimeError, match="reader died"):
        for x in mrexec.prefetch_iter(src(), depth=2, path="t.err"):
            got.append(x)
    assert got == [1, 2]


def test_prefetch_early_exit_stops_producer():
    state = {"produced": 0}

    def src():
        for i in range(10_000):
            state["produced"] += 1
            yield i

    it = mrexec.prefetch_iter(src(), depth=1, path="t.break")
    for x in it:
        if x == 3:
            break
    it.close()
    assert state["produced"] < 100


def test_knobs_and_exec_stats_match_jax(monkeypatch):
    for prefetch, bg in (("0", "0"), ("3", "1"), ("", "")):
        monkeypatch.setenv("MRTPU_PREFETCH", prefetch)
        monkeypatch.setenv("MRTPU_SPILL_BG", bg)
        assert mrexec.prefetch_depth() == jexec.prefetch_depth()
        assert mrexec.spill_bg_enabled() == jexec.spill_bg_enabled()
    mrexec.note_overlap("p", busy_s=2.0, wait_s=0.5, items=3)
    jexec.reset_stats()
    jexec.note_overlap("p", busy_s=2.0, wait_s=0.5, items=3)
    assert mrexec.exec_stats()["overlap"] == jexec.exec_stats()["overlap"]
    jexec.reset_stats()


# -- golden: the chunk map with prefetch on and off ---------------------------

@pytest.fixture
def word_files(tmp_path):
    import random
    r = random.Random(31)
    vocab = [f"tok{i:04d}".encode() for i in range(300)]
    files = []
    for i in range(9):
        p = tmp_path / f"c{i}.txt"
        p.write_bytes(b" ".join(r.choices(vocab, k=700 + 90 * i)))
        files.append(str(p))
    return files


@pytest.mark.parametrize("prefetch", [0, 2])
def test_chunk_map_prefetch_on_off_matches_jax(word_files, monkeypatch,
                                               prefetch):
    monkeypatch.setenv("MRTPU_PREFETCH", str(prefetch))
    got = {}
    for side, mr in (("port", MapReduce(device="cpu")),
                     ("jax", JMapReduce())):
        out = []

        def tokenize(itask, chunk, kv, ptr):
            for w in read_words(chunk):
                kv.add(w, 1)
                out.append((itask, w))

        n = mr.map_file_str(16, word_files, 0, 0, b" ", 32, tokenize)
        got[side] = (n, out, [p for fr in mr.kv.frames()
                              for p in fr.pairs()])
    assert got["port"] == got["jax"]
    if prefetch:
        assert mrexec.exec_stats()["overlap"]["ingest.serial"]["items"] > 8


# -- background spill: golden, barrier, crash safety ---------------------------

N_SPILL_ROWS = 5 * (1 << 20) // 16


def _external_sort(side, tmp_path, monkeypatch, bg: int):
    monkeypatch.setenv("MRTPU_SPILL_BG", str(bg))
    kw = dict(outofcore=1, memsize=1, maxpage=1,
              fpath=str(tmp_path / f"spill-{side}{bg}"))
    mr = MapReduce(device="cpu", **kw) if side == "port" \
        else JMapReduce(**kw)
    rng = np.random.default_rng(12345)
    keys = rng.integers(0, 1 << 40, N_SPILL_ROWS).astype(np.uint64)
    keys[::11] = (1 << 64) - 1
    vals = np.arange(len(keys), dtype=np.uint64)
    step = len(keys) // 6
    mr.map(1, lambda i, kv, p: [kv.add_batch(keys[s:s + step],
                                             vals[s:s + step])
                                for s in range(0, len(keys), step)])
    mr.sort_keys(1)
    return [(np.asarray(f.key.data).tolist(), np.asarray(f.value.data)
             .tolist()) for f in mr.kv.frames()]


def test_background_spill_on_off_matches_jax(tmp_path, monkeypatch):
    eager = _external_sort("port", tmp_path, monkeypatch, 0)
    overlapped = _external_sort("port", tmp_path, monkeypatch, 1)
    assert eager == overlapped
    assert eager == _external_sort("jax", tmp_path, monkeypatch, 1)
    keys = [k for ks, _ in eager for k in ks]
    assert keys == sorted(keys)
    assert mrexec.exec_stats()["overlap"]["spill"]["items"] >= 2


def test_spill_barrier_holds_a_slow_writer(tmp_path, monkeypatch):
    from gpu_mapreduce_tpu_torch.core import external
    orig = external._save_col

    def slow_save(col, path):
        time.sleep(0.05)
        return orig(col, path)

    monkeypatch.setattr(external, "_save_col", slow_save)
    out = _external_sort("port", tmp_path, monkeypatch, 1)
    keys = [k for ks, _ in out for k in ks]
    assert keys == sorted(keys)
    assert mrexec.exec_stats()["overlap"]["spill"]["wait_s"] > 0


def test_crash_in_background_spill_surfaces_and_leaves_no_torn_run(
        tmp_path, monkeypatch):
    from gpu_mapreduce_tpu_torch.core import external
    calls = {"n": 0}
    orig = external._save_col

    def dying_save(col, path):
        calls["n"] += 1
        if calls["n"] == 4:        # mid-write of the second run's file
            with open(path + ".tmp", "wb") as f:
                f.write(b"\x93NUMPY-half-a-header")
            raise OSError("disk gone")
        return orig(col, path)

    monkeypatch.setattr(external, "_save_col", dying_save)
    monkeypatch.setenv("MRTPU_SPILL_BG", "1")
    d = tmp_path / "crash"
    mr = MapReduce(device="cpu", outofcore=1, memsize=1, maxpage=1,
                   fpath=str(d))
    keys = np.random.default_rng(3).integers(0, 1 << 40, N_SPILL_ROWS)
    step = len(keys) // 6
    mr.map(1, lambda i, kv, p: [kv.add_batch(keys[s:s + step],
                                             keys[s:s + step])
                                for s in range(0, len(keys), step)])
    with pytest.raises(OSError, match="disk gone"):
        mr.sort_keys(1)
    for name in os.listdir(d):
        if "sortrun" in name and name.endswith(".npy"):
            np.load(os.path.join(d, name), allow_pickle=True)


def test_corrupt_run_is_caught_before_the_merge(tmp_path, monkeypatch):
    """A run whose bytes change after its writer stamped them raises
    IntegrityError at the merge's first read."""
    from gpu_mapreduce_tpu_torch.core import external
    from gpu_mapreduce_tpu_torch.utils.integrity import IntegrityError
    orig = external._save_col

    def flip_after(col, path):
        stamp = orig(col, path)
        if path.endswith(".k.npy"):
            data = bytearray(open(path, "rb").read())
            data[-1] ^= 0x01
            open(path, "wb").write(bytes(data))
        return stamp

    monkeypatch.setattr(external, "_save_col", flip_after)
    with pytest.raises(IntegrityError, match="spill"):
        _external_sort("port", tmp_path, monkeypatch, 0)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_atomic_save_contract(tmp_path, side):
    if side == "port":
        from gpu_mapreduce_tpu_torch.exec.spill import atomic_save
    else:
        from gpu_mapreduce_tpu.exec.spill import atomic_save
    path = str(tmp_path / "run.k.npy")
    arr = np.arange(1000)
    stamp = atomic_save(path, arr)
    np.testing.assert_array_equal(np.load(path), arr)
    from gpu_mapreduce_tpu_torch.utils.integrity import file_digest
    assert stamp == file_digest(path)
    path2 = str(tmp_path / "run.v.npy")
    with pytest.raises(ValueError):
        atomic_save(path2, np.array([b"a", 1], object), allow_pickle=False)
    assert not os.path.exists(path2)
    assert os.path.exists(path2 + ".tmp")


def test_spill_writer_order_errors_and_close():
    from gpu_mapreduce_tpu_torch.exec.spill import SpillWriter
    w = SpillWriter(max_pending=1, path="t.writer")
    done = []
    pend = [w.submit(lambda i=i: done.append(i)) for i in range(5)]

    def boom():
        raise OSError("write failed")

    bad = w.submit(boom)
    w.close()
    w.close()                                  # idempotent
    for p in pend:
        assert p.wait() >= 0
    assert done == list(range(5))
    with pytest.raises(OSError, match="write failed"):
        bad.wait()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(lambda: None)
    assert mrexec.exec_stats()["overlap"]["t.writer"]["items"] == 6


def test_counters_and_mapstyle2_under_thread_stress():
    """More threads than cores with a short switch interval: no counter
    update is lost, and a mapstyle-2 map of many uneven tasks still
    gives mapstyle 0's KV."""
    import sys
    from gpu_mapreduce_tpu_torch.core.runtime import Counters
    c = Counters()

    def bump():
        for _ in range(5_000):
            c.add(rsize=1)
            c.mem(1)
            c.mem(-1)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=bump)
              for _ in range(2 * (os.cpu_count() or 4))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert c.rsize == 5_000 * len(ts) and c.msize == 0

        def task(itask, kv, ptr):
            for i in range(itask % 7):
                kv.add(itask, i)
            kv.add_batch(np.full(3, itask, np.int64), np.arange(3))

        got = []
        for style in (0, 2):
            mr = MapReduce(device="cpu", mapstyle=style)
            mr.map(200, task)
            got.append([p for fr in mr.kv.frames() for p in fr.pairs()])
        assert got[0] == got[1]
    finally:
        sys.setswitchinterval(saved)
