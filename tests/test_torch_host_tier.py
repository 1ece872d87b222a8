"""The port's host tier vs the JAX package's, on the CPU, byte for byte:
memsize pages, spill files and counters, collapse/scrunch/broadcast,
file_chunks, the chunk maps under mapstyle 0/1/2, block_rows reduces,
and the timer/verbosity/cummulative_stats lines.  Each case runs the
same seeded input through the JAX package's serial MapReduce and the
port's ``MapReduce(device="cpu")``."""

import os
import re

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.core.runtime import global_counters as j_counters
from gpu_mapreduce_tpu.utils.io import file_chunks as j_file_chunks
from gpu_mapreduce_tpu_torch import MapReduce, MRError
from gpu_mapreduce_tpu_torch.core.runtime import global_counters
from gpu_mapreduce_tpu_torch.utils.io import file_chunks

SIDES = ("port", "jax")


def _mr(side, **settings):
    return MapReduce(device="cpu", **settings) if side == "port" \
        else JMapReduce(**settings)


def _counters(side):
    return global_counters() if side == "port" else j_counters()


def col_view(col):
    """A column as (kind, dtype, rows): what byte equality compares."""
    dtype = None
    if hasattr(col, "data") and isinstance(col.data, np.ndarray) \
            and col.data.dtype != object:
        dtype = str(col.data.dtype)
    kind = type(col).__name__
    return kind, dtype, col.tolist()


def kv_view(mr):
    return [(len(f), col_view(f.key), col_view(f.value))
            for f in (fr.to_host() for fr in mr.kv.frames())]


def kmv_view(mr):
    out = []
    for fr in mr.kmv.frames():
        fr = fr.to_host()
        out.append((col_view(fr.key), np.asarray(fr.nvalues).tolist(),
                    np.asarray(fr.offsets).tolist(), col_view(fr.values)))
    return out


def _data(kind, n, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "i64":
        k = np.arange(n, dtype=np.int64)
        return k, k * 7
    if kind == "u64":
        k = rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False)
        k[:3] = [0, 1 << 63, (1 << 64) - 1]
        return k, rng.integers(0, 1 << 31, n).astype(np.uint32)
    if kind == "pairs":
        return (rng.integers(0, 50, (n, 2)).astype(np.uint64),
                np.arange(n, dtype=np.int64))
    if kind == "bytes":
        words = [b"w%d" % i for i in rng.integers(0, 500, n)]
        return words, np.arange(n, dtype=np.int64)
    raise ValueError(kind)


# -- memsize pages (the frames a batch callback sees) -------------------------

@pytest.mark.parametrize("n, kind", [(300_000, "i64"), (300_000, "u64"),
                                     (70_000, "pairs"), (1000, "u64"),
                                     (90_000, "bytes")])
def test_host_frames_split_into_memsize_pages(n, kind):
    keys, vals = _data(kind, n)
    seen = {}
    for side in SIDES:
        mr = _mr(side, memsize=1)
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        sizes = []
        mr.map_mr(mr, lambda fr, kv, p: (sizes.append(len(fr)),
                                         kv.add_frame(fr)), batch=True)
        seen[side] = (sizes, kv_view(mr))
    assert seen["port"] == seen["jax"]
    if kind == "i64":
        assert seen["port"][0] == [65536] * 4 + [37856]


# -- spill files and counters -------------------------------------------------

def _spill_names(d):
    """Spill file names with the per-package file id taken out."""
    return sorted(re.sub(r"\.\d+\.(\d+)\.npz$", r".<id>.\1.npz", f)
                  for f in os.listdir(d))


@pytest.mark.parametrize("kind", ["u64", "bytes"])
def test_spill_files_and_counters_match_jax(tmp_path, kind):
    keys, vals = _data(kind, 200_000)
    got = {}
    for side in SIDES:
        d = tmp_path / side
        c = _counters(side)
        c.msize = 0
        w0, r0 = c.wsize, c.rsize
        mr = _mr(side, outofcore=1, maxpage=1, memsize=1, fpath=str(d))
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        after_map = (_spill_names(d), mr.kv.nframes, c.wsize - w0,
                     c.msize)
        fields = sorted(np.load(os.path.join(d, os.listdir(d)[0])).files)
        pages = kv_view(mr)
        mid = (c.wsize - w0, c.rsize - r0)
        mr.convert()
        groups = kmv_view(mr)
        after_convert = (mr.kmv.nframes, c.wsize - w0, c.rsize - r0)
        mr.kmv.free()
        left = [f for f in os.listdir(d) if f.startswith("mrtpu.kmv")]
        got[side] = (after_map, fields, pages, mid, groups, after_convert,
                     left)
    assert got["port"] == got["jax"]
    assert got["port"][0][2] > 0 and got["port"][5][2] > 0
    assert got["port"][6] == []          # free() deletes the spill files


# -- collapse / scrunch / broadcast ------------------------------------------

COLLAPSE_CASES = {
    "dense": (np.arange(20, dtype=np.uint64), np.arange(20, dtype=np.uint64)
              * 3),
    "mixed_exact": (np.array([(1 << 60) + 1, 3], np.uint64),
                    np.array([-1, 5], np.int64)),
    "pairs": (np.arange(12, dtype=np.int64).reshape(6, 2),
              np.arange(12, dtype=np.int64).reshape(6, 2)),
    "bytes": ([b"a", b"bb", b""], [b"x", b"yy", b"zzz"]),
    "empty": (np.zeros(0, np.uint64), np.zeros(0, np.uint64)),
}


@pytest.mark.parametrize("case", sorted(COLLAPSE_CASES))
@pytest.mark.parametrize("key", [7, "k"])
def test_collapse_matches_jax(case, key):
    keys, vals = COLLAPSE_CASES[case]
    got = {}
    for side in SIDES:
        mr = _mr(side)
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        n = mr.collapse(key)
        got[side] = (n, kmv_view(mr))
    assert got["port"] == got["jax"]


def test_collapse_mixed_u64_int64_stays_exact():
    keys, vals = COLLAPSE_CASES["mixed_exact"]
    mr = _mr("port")
    mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
    mr.collapse(0)
    groups = []
    mr.scan_kmv(lambda k, vs, p: groups.append(vs))
    assert groups[0][0] == (1 << 60) + 1 and groups[0][1] == -1


@pytest.mark.parametrize("keys, match", [
    ([b"a", b"b"], "common type"), ([{"a": 1}, {"b": 2}], "common shape")])
def test_collapse_refuses_mixed_types_with_jax_text(keys, match):
    from gpu_mapreduce_tpu.core.runtime import MRError as JMRError
    vals = [1, 2]
    for side, err in (("port", MRError), ("jax", JMRError)):
        mr = _mr(side)
        mr.map(1, lambda i, kv, p: [kv.add(k, v) for k, v in
                                    zip(keys, vals)])
        with pytest.raises(err, match=match):
            mr.collapse(1)


def test_collapse_spilled_multiframe_matches_in_core(tmp_path):
    keys = np.arange(50_000, dtype=np.uint64)
    got = {}
    for side in SIDES:
        for spill in (0, 1):
            kw = dict(outofcore=1, memsize=1, maxpage=1,
                      fpath=str(tmp_path / f"{side}{spill}")) if spill \
                else {}
            mr = _mr(side, **kw)
            mr.map(1, lambda i, kv, p: kv.add_batch(keys, keys * 3))
            mr.collapse(7)
            got[side, spill] = kmv_view(mr)
    assert got["port", 0] == got["port", 1] == got["jax", 0] \
        == got["jax", 1]


def test_scrunch_and_broadcast_match_jax():
    keys, vals = _data("u64", 200)
    got = {}
    for side in SIDES:
        mr = _mr(side)
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        b = mr.broadcast(0)
        s = mr.scrunch(1, 42)
        got[side] = (b, s, kmv_view(mr))
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (200, 1)


def test_broadcast_and_collapse_on_a_device_frame():
    """A port device frame (after aggregate) against the JAX package's
    one-device mesh frame."""
    from gpu_mapreduce_tpu.parallel.mesh import make_mesh
    keys, vals = _data("u64", 300)
    got = {}
    for side, mr in (("port", MapReduce(device="cpu")),
                     ("jax", JMapReduce(make_mesh(1)))):
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        mr.aggregate()
        got[side] = (mr.broadcast(0), mr.collapse(np.uint64(9)),
                     kmv_view(mr))
    assert got["port"] == got["jax"]


# -- file_chunks and the chunk maps ------------------------------------------

def _seeded_file(path, seed, nlines, sep=b"\n"):
    rng = np.random.default_rng(seed)
    parts = [b"x" * int(m) for m in rng.integers(0, 60, nlines)]
    data = sep.join(parts)
    path.write_bytes(data)
    return data


@pytest.mark.parametrize("sep", [b"\n", b"\n\n", b"ab"])
@pytest.mark.parametrize("nchunks, delta", [(1, 80), (3, 1), (7, 80),
                                            (64, 2)])
def test_file_chunks_match_jax(tmp_path, sep, nchunks, delta):
    p = tmp_path / "f.txt"
    data = _seeded_file(p, nchunks * 7 + len(sep), 400, sep)
    got = list(file_chunks(str(p), nchunks, sep, delta))
    assert got == list(j_file_chunks(str(p), nchunks, sep, delta))
    assert b"".join(got) == data


def test_file_chunks_edge_files_match_jax(tmp_path):
    """No separator at all (the search runs to the end of the file), an
    empty file, and a separator-only file."""
    for name, data in (("none", b"y" * 5000), ("empty", b""),
                       ("seps", b"\n" * 300)):
        p = tmp_path / name
        p.write_bytes(data)
        for nchunks in (1, 4, 50):
            got = list(file_chunks(str(p), nchunks, b"\n", 1))
            assert got == list(j_file_chunks(str(p), nchunks, b"\n", 1))
            assert b"".join(got) == data


@pytest.mark.parametrize("method, sep", [("map_file_char", "\n"),
                                         ("map_file_str", "\n\n")])
@pytest.mark.parametrize("mapstyle", [0, 1, 2])
def test_chunk_maps_match_jax(tmp_path, method, sep, mapstyle):
    files = [tmp_path / f"c{i}.txt" for i in range(3)]
    datas = [_seeded_file(f, i, 300, sep.encode()) for i, f in
             enumerate(files)]

    def per_chunk(itask, chunk, kv, ptr):
        kv.add(itask, chunk)

    got = {}
    for side in SIDES:
        mr = _mr(side, mapstyle=mapstyle)
        n = getattr(mr, method)(12, [str(f) for f in files], 0, 0, sep, 8,
                                per_chunk)
        got[side] = (n, kv_view(mr))
    assert got["port"] == got["jax"]
    chunks = [c for _, _, (_, _, vs) in got["port"][1] for c in vs]
    assert b"".join(chunks) == b"".join(datas)


def test_chunk_map_without_files_raises(tmp_path):
    with pytest.raises(MRError, match="No files found"):
        _mr("port").map_file_char(4, str(tmp_path), 0, 0, "\n", 8,
                                  lambda *a: None)


# -- mapstyle 2 ----------------------------------------------------------------

def test_mapstyle2_map_matches_mapstyle0():
    import time

    def slow_uneven(itask, kv, ptr):
        time.sleep(0.002 * (itask % 3))
        for i in range(5):
            kv.add(itask, itask * 10 + i)

    got = {}
    for side in SIDES:
        for style in (0, 1, 2):
            mr = _mr(side, mapstyle=style)
            assert mr.map(12, slow_uneven) == 60
            got[side, style] = kv_view(mr)
    assert len({repr(v) for v in got.values()}) == 1


def test_mapstyle2_map_files_and_exception(tmp_path):
    paths = []
    for i in range(6):
        p = tmp_path / f"f{i}.txt"
        p.write_text(f"file {i}")
        paths.append(str(p))

    def per_file(itask, fname, kv, ptr):
        kv.add(itask, open(fname).read())

    got = {}
    for side in SIDES:
        mr = _mr(side, mapstyle=2)
        assert mr.map_files(paths, per_file) == 6
        got[side] = kv_view(mr)
    assert got["port"] == got["jax"]

    def boom(itask, kv, ptr):
        if itask == 3:
            raise ValueError("task 3 failed")
        kv.add(itask, itask)

    with pytest.raises(ValueError, match="task 3"):
        _mr("port", mapstyle=2).map(8, boom)


def test_mapstyle2_outofcore_spills(tmp_path):
    def emit_bulk(itask, kv, ptr):
        kv.add_batch(np.arange(200_000, dtype=np.uint64) + itask,
                     np.arange(200_000, dtype=np.uint64))

    got = {}
    for side in SIDES:
        d = tmp_path / side
        mr = _mr(side, mapstyle=2, outofcore=1, memsize=1, maxpage=1,
                 fpath=str(d))
        assert mr.map(8, emit_bulk) == 8 * 200_000
        got[side] = (_spill_names(d), mr.kv.nframes)
    assert got["port"] == got["jax"] and got["port"][0]


# -- block_rows reduce ---------------------------------------------------------

def _kmv_of(fr):
    from gpu_mapreduce_tpu_torch.core.frame import KMVFrame
    n = len(fr)
    return KMVFrame(fr.key.slice(0, 1), [n], [0, n], fr.value)


@pytest.mark.parametrize("block_rows", [1, 8, 1000])
def test_block_rows_reduce_matches_jax_and_plain(block_rows):
    rng = np.random.default_rng(block_rows)
    keys = rng.integers(0, 6, 400).astype(np.uint64)
    keys[:100] = 2                                   # one large group
    vals = np.arange(400, dtype=np.int64)

    def summer(k, mv, kv, ptr):
        blocks = list(mv) if hasattr(mv, "block_rows") else [mv]
        kv.add(k, (sum(map(sum, blocks)), len(blocks),
                   type(mv).__name__))

    def plain(k, vs, kv, ptr):
        kv.add(k, sum(vs))

    got = {}
    for side in SIDES:
        mr = _mr(side)
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        cp = mr.copy()
        if side == "port":        # the port's own block loop, once
            from gpu_mapreduce_tpu_torch.core.frame import (
                BlockedMultivalue, iter_blocks)
            fr = cp.kv.one_frame()
            assert [len(b) for b in iter_blocks(BlockedMultivalue(
                _kmv_of(fr), 0, 3))][:2] == [3, 3]
        mr.compress(summer, block_rows=block_rows)
        cp.compress(plain)
        got[side] = (kv_view(mr), kv_view(cp))
    assert got["port"] == got["jax"]
    sums = {k: v[0] for k, v in zip(got["port"][0][0][1][2],
                                    got["port"][0][0][2][2])}
    assert sums == dict(zip(got["port"][1][0][1][2],
                            got["port"][1][0][2][2]))


# -- timer / verbosity / cummulative_stats lines -------------------------------

def _mask(text):
    """Printed lines with the seconds masked (they differ run to run)."""
    text = re.sub(r"time \(secs\) = \S+", "time (secs) = T", text)
    return re.sub(r"Mb padding, \S+ secs", "Mb padding, T secs", text)


def test_timer_verbosity_and_cummulative_lines_match_jax(tmp_path, capsys):
    keys, vals = _data("u64", 150_000)
    out = {}
    for side in SIDES:
        mr = _mr(side, timer=2, verbosity=2, outofcore=1, memsize=1,
                 maxpage=1, fpath=str(tmp_path / side))
        mr.cummulative_stats(0, reset=1)
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        mr.sort_keys(1)
        mr.convert()
        mr.reduce(lambda k, vs, kv, p: kv.add(k, len(vs)))
        mr.kv_stats(2)
        mr.cummulative_stats(1)
        stats = mr.stats()
        out[side] = (_mask(capsys.readouterr().out),
                     {k: stats[k] for k in ("msize", "msizemax", "rsize",
                                            "wsize", "cssize", "crsize",
                                            "cspad")},
                     sorted(stats["plan"]["plan"]), sorted(stats["exec"]))
    assert out["port"] == out["jax"]
    assert "sort time (secs) = T" in out["port"][0]
    assert "I/O:" in out["port"][0] and out["port"][1]["wsize"] > 0


# -- settings, env knobs and the script's set/mr lines --------------------------

@pytest.mark.parametrize("env", [{}, {"MRTPU_MEMSIZE": "8",
                                      "MRTPU_FPATH": "/spill/here",
                                      "MRTPU_ONFAULT": "fail"}])
def test_settings_defaults_and_env_knobs_match_jax(monkeypatch, env):
    import dataclasses
    from gpu_mapreduce_tpu.core.runtime import Settings as JSettings
    from gpu_mapreduce_tpu_torch.core.runtime import Settings
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = dataclasses.asdict(Settings())
    jax_ = dataclasses.asdict(JSettings())
    assert port == jax_


@pytest.mark.parametrize("kw, match", [
    ({"onfault": "retry"}, "not ported yet"),
    ({"onfault": "skip"}, "not ported yet"),
    ({"onfault": "later"}, "Invalid onfault"),
    ({"keyalign": 3}, "power of 2"),
    ({"mapstyle": 3}, "Invalid mapstyle"),
    ({"nosuch": 1}, "unknown setting")])
def test_settings_refusals(kw, match):
    with pytest.raises(MRError, match=match):
        MapReduce(device="cpu").set(**kw)


@pytest.mark.parametrize("lines", [
    ["mr z 0 1", "mr w 1 2 8 1"],
    ["set timer 1 outofcore 1 maxpage 3 memsize 2", "mr z"],
    ["set scratch spilldir onfault fail", "mr z"],
    ["set verbosity 1 minpage 1 freepage 0 zeropage 1", "mr z"]])
def test_set_and_mr_builtins_match_jax(tmp_path, monkeypatch, lines):
    import dataclasses
    from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
    from gpu_mapreduce_tpu_torch import OinkScript
    monkeypatch.chdir(tmp_path)
    got = {}
    for side, s in (("port", OinkScript(device="cpu", screen=False)),
                    ("jax", JOinkScript(screen=False))):
        for line in lines:
            s.one(line)
        got[side] = (dict(s.obj.defaults), {
            name: {k: v for k, v in dataclasses.asdict(mr.settings).items()
                   if k != "all2all"}
            for name, mr in s.obj.named.items()})
    assert got["port"] == got["jax"]


def test_onfault_retry_is_refused_until_ported():
    from gpu_mapreduce_tpu_torch import OinkScript
    s = OinkScript(device="cpu", screen=False)
    s.one("set onfault retry")
    with pytest.raises(MRError, match="not ported yet"):
        s.one("mr z")
    with pytest.raises(MRError, match="unknown set parameter"):
        s.one("set nosuch 1")


def test_interop_carries_paged_and_spilled_host_datasets(tmp_path):
    from gpu_mapreduce_tpu_torch.interop import (mapreduce_from_numpy,
                                                 mapreduce_to_numpy)
    keys = np.arange(300_000, dtype=np.uint64) * 3 + (1 << 63)
    vals = np.arange(300_000, dtype=np.int64)
    kw = dict(outofcore=1, memsize=1, maxpage=1)
    mr = mapreduce_from_numpy(keys, vals, device="cpu", host=True,
                              fpath=str(tmp_path / "port"), **kw)
    jmr = JMapReduce(fpath=str(tmp_path / "jax"), **kw)
    jmr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
    assert kv_view(mr) == kv_view(jmr)
    assert mr.kv.nframes == 5 and _spill_names(tmp_path / "port") == \
        _spill_names(tmp_path / "jax")
    k, v = mapreduce_to_numpy(mr)
    assert k.dtype == np.uint64 and np.array_equal(k, keys)
    assert np.array_equal(v, vals)
    dev = mapreduce_from_numpy(keys, vals, device="cpu")
    assert dev.kv.nframes == 1 and not dev.kv.is_host_dataset()
    assert np.array_equal(mapreduce_to_numpy(dev)[0], keys)


@pytest.mark.parametrize("kind", ["u64", "pairs", "i64"])
def test_paged_kv_places_like_one_frame(kind):
    """Host pages of dense columns go onto the device page by page (no
    host concatenation), as the merged frame would."""
    from gpu_mapreduce_tpu_torch.core.dataset import one_frame_of
    from gpu_mapreduce_tpu_torch.interop import to_numpy
    keys, vals = _data(kind, 200_000)
    mr = _mr("port", memsize=1)
    mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
    assert mr.kv.nframes > 1
    got = to_numpy(mr.backend.place_kv(mr.kv))
    want = to_numpy(mr.backend.place(one_frame_of(list(mr.kv.frames()))))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


def test_batch_on_a_device_stays_one_frame():
    """A byte column split on the device is device-resident data: it is
    not cut into host pages."""
    from gpu_mapreduce_tpu_torch.utils.io import split_words
    text = b" ".join(b"w%d" % i for i in range(200_000))
    mr = _mr("port", memsize=1)
    mr.map(1, lambda i, kv, p: kv.add_batch(
        split_words(text, "cpu"), np.zeros(200_000, np.uint8)))
    assert mr.kv.nframes == 1 and mr.kv.nkv == 200_000
