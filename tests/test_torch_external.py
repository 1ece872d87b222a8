"""The port's out-of-core external sort and convert vs the JAX package's,
on the CPU, byte for byte: multi-page host datasets under
``outofcore=1, maxpage=1, memsize=1`` (u64 keys at and above 2^63 and
2^64-1, byte, object and ``[n, 2]`` keys, one giant key group,
descending order), and device KVs over the page budget, which demote to
host pages first (the JAX package's one-device mesh against the port's
device frame).  The run sort's torch path is held against numpy's
stable order."""

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.core.runtime import global_counters as j_counters
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch import MapReduce
from gpu_mapreduce_tpu_torch.core.column import DenseColumn
from gpu_mapreduce_tpu_torch.core.external import sort_order
from gpu_mapreduce_tpu_torch.core.runtime import global_counters

BUDGET = 1 << 20


def _settings(tmp_path, side):
    return dict(outofcore=1, memsize=1, maxpage=1,
                fpath=str(tmp_path / side))


def _mr(side, tmp_path, mesh=False):
    kw = _settings(tmp_path, side)
    if side == "port":
        return MapReduce(device="cpu", **kw)
    return JMapReduce(make_mesh(1), **kw) if mesh else JMapReduce(**kw)


def _col(col):
    dtype = str(col.data.dtype) if hasattr(col, "data") and \
        isinstance(col.data, np.ndarray) and col.data.dtype != object \
        else None
    return type(col).__name__, dtype, col.tolist()


def kv_frames(mr):
    return [(_col(f.key), _col(f.value))
            for f in (fr.to_host() for fr in mr.kv.frames())]


def kmv_frames(mr):
    return [(_col(f.key), np.asarray(f.nvalues).tolist(), _col(f.values))
            for f in (fr.to_host() for fr in mr.kmv.frames())]


def _reset(side):
    c = global_counters() if side == "port" else j_counters()
    c.msize = c.msizemax = 0
    return c


def _keys(kind, n, rng):
    if kind == "u64":
        k = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        k[rng.integers(0, n, n // 4)] = (1 << 64) - 1     # ties at the top
        k[rng.integers(0, n, n // 8)] = 1 << 63
        k[rng.integers(0, n, n // 8)] = 0
        return k
    if kind == "u64_small":
        return rng.integers(0, 3000, n).astype(np.uint64)
    if kind == "pairs":
        k = rng.integers(0, 40, (n, 2)).astype(np.uint64)
        k[: n // 10, 0] = (1 << 64) - 1
        return k
    if kind == "bytes":
        return [b"k%05d" % i for i in rng.integers(0, 4000, n)]
    if kind == "objects":
        return [("t", int(i) % 300, None if i % 7 else b"x")
                for i in rng.integers(0, 4000, n)]
    raise ValueError(kind)


NROWS = {"u64": 5 * BUDGET // 16, "u64_small": 5 * BUDGET // 16,
         "pairs": 5 * BUDGET // 48, "bytes": 2 * BUDGET // 14,
         "objects": 40_000}


def _fill(mr, keys, vals, nbatch=6):
    n = len(vals)
    step = max(1, n // nbatch)
    if any(isinstance(c, list) and isinstance(c[0], tuple)
           for c in (keys, vals)):          # objects: the scalar add path
        keys = keys.tolist() if isinstance(keys, np.ndarray) else keys
        vals = vals.tolist() if isinstance(vals, np.ndarray) else vals
        mr.map(1, lambda i, kv, p: [kv.add(k, v)
                                    for k, v in zip(keys, vals)])
        return
    mr.map(1, lambda i, kv, p: [kv.add_batch(keys[s:s + step],
                                             vals[s:s + step])
                                for s in range(0, n, step)])


@pytest.mark.parametrize("kind", sorted(NROWS))
@pytest.mark.parametrize("by, flag", [("key", 1), ("key", -1),
                                      ("value", 1), ("value", -1)])
def test_external_sort_matches_jax(tmp_path, kind, by, flag):
    rng = np.random.default_rng(len(kind) * 10 + flag + (by == "key"))
    n = NROWS[kind]
    keys = _keys(kind, n, rng)
    vals = np.arange(n, dtype=np.uint64)
    if by == "value":              # the same rows, sorted as values
        keys, vals = rng.integers(0, 50, n).astype(np.uint64), keys
    got = {}
    for side in ("port", "jax"):
        mr = _mr(side, tmp_path)
        _fill(mr, keys, vals)
        assert mr.kv.nframes > 1
        c = _reset(side)
        getattr(mr, f"sort_{by}s")(flag)
        got[side] = (kv_frames(mr), mr.kv.nframes, c.msizemax)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("kind", ["u64", "u64_small", "pairs", "bytes",
                                  "objects"])
def test_external_convert_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(7 + len(kind))
    n = NROWS[kind]
    keys = _keys(kind, n, rng)
    vals = np.arange(n, dtype=np.int64)
    got = {}
    for side in ("port", "jax"):
        mr = _mr(side, tmp_path)
        _fill(mr, keys, vals)
        c = _reset(side)
        ngroups = mr.convert()
        groups = kmv_frames(mr)
        nframes = mr.kmv.nframes
        got[side] = (ngroups, groups, nframes, c.msizemax)
    assert got["port"] == got["jax"]
    # groups are never split across frames
    seen = [repr(k) for (_, _, ks), _, _ in got["port"][1] for k in ks]
    assert len(seen) == len(set(seen)) == got["port"][0]


def test_external_convert_one_giant_group(tmp_path):
    n = 3 * BUDGET // 16
    vals = np.arange(n, dtype=np.uint64)
    got = {}
    for side in ("port", "jax"):
        mr = _mr(side, tmp_path)
        _fill(mr, np.full(n, 7, np.uint64), vals, nbatch=4)
        mr.convert()
        got[side] = kmv_frames(mr)
    assert got["port"] == got["jax"]
    assert [k for (_, _, ks), _, _ in got["port"] for k in ks] == [7]


def test_external_convert_reduce_bounded_and_counts(tmp_path):
    """The JAX package's bounded-memory check, on both: the hi-water
    stays within 2.5 pages, and the counts equal a Counter."""
    import collections
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 5000, 10 * BUDGET // 16).astype(np.uint64)
    vals = rng.integers(0, 1 << 30, len(keys)).astype(np.uint64)
    got = {}
    for side in ("port", "jax"):
        mr = _mr(side, tmp_path)
        _fill(mr, keys, vals, nbatch=8)
        c = _reset(side)
        mr.convert()
        assert c.msizemax <= 2.5 * BUDGET
        assert mr.kmv.nframes > 1
        out = {}
        mr.reduce(lambda k, vl, kv, p: out.__setitem__(int(k), len(vl)))
        got[side] = (out, c.msizemax)
    assert got["port"] == got["jax"]
    assert got["port"][0] == dict(collections.Counter(keys.tolist()))


@pytest.mark.parametrize("op", ["convert", "sort_keys", "sort_values_desc"])
def test_device_kv_over_budget_demotes_like_jax(tmp_path, op):
    """A device KV past maxpage × memsize streams to host pages and takes
    the external path, on the port's device frame as on the JAX
    package's one-device mesh frame."""
    rng = np.random.default_rng(11)
    n = 6 * BUDGET // 16
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys[:1000] = (1 << 64) - 1
    vals = rng.integers(0, 5000, n).astype(np.uint64)
    got = {}
    for side in ("port", "jax"):
        mr = _mr(side, tmp_path, mesh=True)
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
        mr.aggregate()
        assert not mr.kv.is_host_dataset()
        assert mr._mesh_over_budget(mr.kv)
        if op == "convert":
            mr.convert()
            got[side] = (kmv_frames(mr), mr.kmv.nframes)
        elif op == "sort_keys":
            mr.sort_keys(1)
            got[side] = (kv_frames(mr), mr.kv.nframes)
        else:
            mr.sort_values(-1)
            got[side] = (kv_frames(mr), mr.kv.nframes)
        assert mr.kv is None or mr.kv.is_host_dataset()
    assert got["port"] == got["jax"]
    assert got["port"][1] > 1


def test_interned_sort_over_budget_demotes_like_jax(tmp_path):
    """An interned (byte-key) device KV over the budget demotes before
    its sort (JAX mapreduce.py:1078-1093)."""
    rng = np.random.default_rng(2)
    nrows = 3 * BUDGET // 16
    words = [b"w%06d" % i for i in rng.integers(0, 40000, nrows)]
    vals = rng.integers(0, 1 << 30, nrows).astype(np.uint64)
    got = {}
    for side in ("port", "jax"):
        mr = _mr(side, tmp_path, mesh=True)
        mr.map(1, lambda i, kv, p: kv.add_batch(words, vals))
        mr.aggregate()
        fr = mr.kv.one_frame()
        assert fr.key_decode is not None and fr.nbytes() > BUDGET
        mr.sort_keys(5)
        got[side] = kv_frames(mr)
    assert got["port"] == got["jax"]
    assert [k for (_, _, ks), _ in got["port"] for k in ks] == sorted(words)


@pytest.mark.parametrize("dtype", ["uint64", "int64", "uint32", "int32",
                                   "uint8", "float64", "pairs_u64",
                                   "pairs_i32"])
def test_run_sort_on_device_path_matches_numpy(dtype):
    """sort_order's torch path (u64 through order_key, [n, 2] as a
    lexsort) is numpy's stable order, ties in row order."""
    rng = np.random.default_rng(1)
    n = 5000
    if dtype.startswith("pairs"):
        dt = np.uint64 if dtype.endswith("u64") else np.int32
        data = rng.integers(0, 30, (n, 2)).astype(dt)
        if dt == np.uint64:
            data[::5, 0] = (1 << 64) - 1
            data[::7, 1] = 1 << 63
        want = np.lexsort((data[:, 1], data[:, 0]))
    else:
        dt = np.dtype(dtype)
        if dt.kind == "f":
            data = rng.standard_normal(n)
            data[::9] = 0.0
        else:
            info = np.iinfo(dt)
            data = rng.integers(info.min, info.max, n, dtype=dt,
                                endpoint=True)
            data[::3] = data[0]                       # ties
            if dt == np.uint64:
                data[::4] = (1 << 64) - 1
                data[::6] = 1 << 63
        want = np.argsort(data, kind="stable")
    got = sort_order(DenseColumn(data), "cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sort_order(DenseColumn(data)), want)
