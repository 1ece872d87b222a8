"""The text tier of the port's op algebra against the JAX package on
``make_mesh(1)``: int-flag sorts of interned keys and values (in byte
order, never id order, objects by pickle), comparator sorts,
``sort_multivalues``, ``print``, the ``scan_kv``/``scan_kmv`` script
lines, the refusal of arithmetic on interned values, ``add`` across the
bytes and object intern domains, the device-map decode guard, and the
byte counts of ``kv_stats``/``kmv_stats`` on device frames."""

import io

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
from gpu_mapreduce_tpu.ops import reduces as jr
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch import MapReduce, OinkScript
from gpu_mapreduce_tpu_torch.ops import reduces as tr
from gpu_mapreduce_tpu_torch.parallel import devkernels as dk


def _words(n=300, seed=4):
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(0x61, 0x67, rng.integers(0, 6))
                   .astype(np.uint8)) for _ in range(40)]
    vocab += [b"\xff\xfe", b"\x80", b"Z" * 30]
    return [vocab[i] for i in rng.integers(0, len(vocab), n)], rng


def _objects(words):
    """Object rows: the words as bytes, tuples and ints mixed (an
    ObjectColumn), so they order by pickle."""
    return [w if i % 3 else (len(w), w) if i % 2 else len(w)
            for i, w in enumerate(words)]


def _mrs(keys, values, aggregate: bool, fuse: int = 0):
    """A port and a JAX MR holding the same pairs (added one by one, so
    text rows coerce the same way), on the device after ``aggregate``."""
    out = []
    for mr in (MapReduce(device="cpu", fuse=fuse),
               JMapReduce(make_mesh(1), fuse=fuse)):
        mr.map(1, lambda i, kv, p: [kv.add(k, v)
                                    for k, v in zip(keys, values)])
        if aggregate:
            mr.aggregate()
        out.append(mr)
    return out


def _pairs(mr):
    out = []
    mr.scan_kv(lambda k, v, p: out.append((k, v if not isinstance(
        v, np.integer) else int(v))))
    return out


def _groups(mr):
    out = []
    mr.scan_kmv(lambda k, vs, p: out.append((k, list(vs))))
    return out


@pytest.mark.parametrize("aggregate", [False, True])
@pytest.mark.parametrize("rows", ["bytes", "objects"])
@pytest.mark.parametrize("by", ["keys", "values"])
def test_int_flag_sorts_match_jax(by, rows, aggregate):
    """sort_keys/sort_values ±1 and ±5 on a text column, from a host
    frame (JAX's host sort: equal rows keep their order descending) and
    from a device frame (its interned sort: equal rows reversed)."""
    words, rng = _words()
    text = words if rows == "bytes" else _objects(words)
    nums = rng.integers(0, 5, len(words)).tolist()
    keys, values = (text, nums) if by == "keys" else (nums, text)
    for flag in (1, -1, 5, -5):
        t, j = _mrs(keys, values, aggregate, fuse=int(flag == -5))
        assert getattr(t, f"sort_{by}")(flag) == \
            getattr(j, f"sort_{by}")(flag)
        got, want = _pairs(t), _pairs(j)
        assert got == want, (flag, got[:5], want[:5])
    col = [k for k, _ in got] if by == "keys" else [v for _, v in got]
    if rows == "bytes":
        assert col == sorted(col, reverse=True)     # byte order, not ids


def _by_length_then_reversed(a, b):
    ka, kb = (len(a), a[::-1]), (len(b), b[::-1])
    return (ka > kb) - (ka < kb)


@pytest.mark.parametrize("aggregate", [False, True])
def test_comparator_sorts_match_jax(aggregate):
    words, rng = _words(seed=6)
    nums = rng.integers(0, 50, len(words)).tolist()
    t, j = _mrs(words, nums, aggregate)
    assert t.sort_keys(_by_length_then_reversed) == \
        j.sort_keys(_by_length_then_reversed)
    assert _pairs(t) == _pairs(j)
    cmp = lambda a, b: (a % 7 > b % 7) - (a % 7 < b % 7)   # noqa: E731
    assert t.sort_values(cmp) == j.sort_values(cmp)
    assert _pairs(t) == _pairs(j)


@pytest.mark.parametrize("values", ["dense", "bytes"])
def test_sort_multivalues_matches_jax(values):
    words, rng = _words(seed=8)
    keys = rng.integers(0, 9, len(words)).astype(np.uint64).tolist()
    vals = words if values == "bytes" else \
        rng.integers(0, 1 << 40, len(words)).tolist()
    for flag in (1, -1, _by_length_then_reversed if values == "bytes"
                 else (lambda a, b: (a % 5 > b % 5) - (a % 5 < b % 5))):
        t, j = _mrs(keys, vals, True)
        t.convert()
        j.convert()
        assert t.sort_multivalues(flag) == j.sort_multivalues(flag)
        assert _groups(t) == _groups(j)


def test_print_to_file_matches_jax(tmp_path):
    words, rng = _words(seed=10)
    floats = (rng.random(len(words)) * 100).tolist()
    t, j = _mrs(words, floats, True)
    t.print(file=str(tmp_path / "t.kv"), nstride=3)
    j.print(file=str(tmp_path / "j.kv"), nstride=3)
    t.print(file=str(tmp_path / "t.kv"), fflag=1, vflag=3)
    j.print(file=str(tmp_path / "j.kv"), fflag=1, vflag=3)
    t.convert()
    j.convert()
    t.print(file=str(tmp_path / "t.kmv"))
    j.print(file=str(tmp_path / "j.kmv"))
    for name in ("kv", "kmv"):
        got = (tmp_path / f"t.{name}").read_bytes()
        assert got == (tmp_path / f"j.{name}").read_bytes() and got


SCAN_SCRIPT = """\
mr x
x map/file {f} read_words
x print
x sort_keys -5
x scan_kv
x collate NULL
x sort_multivalues 1
x scan_kmv
x print 0 2 -1 -1
"""


def test_scan_and_print_lines_match_jax(tmp_path, capsys):
    """The script lines print the dataset to stdout, decoded."""
    f = tmp_path / "w.txt"
    f.write_bytes(b"b a\tc\n a  b \x0bzz\x0c\xc3\xa9 a\r\n")
    out = []
    for cls, kw in ((OinkScript, {"device": "cpu"}),
                    (JOinkScript, {"comm": make_mesh(1)})):
        s = cls(screen=io.StringIO(), **kw)
        capsys.readouterr()
        s.run_string(SCAN_SCRIPT.format(f=f))
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert "zz 0" in out[0] and "é 0" in out[0]


def test_reduce_sum_of_interned_values_refused():
    words, _ = _words(30)
    t, j = _mrs(list(range(30)), words, True)
    t.convert()
    j.convert()
    with pytest.raises(ValueError) as te:
        t.reduce(tr.sum_values, batch=True)
    with pytest.raises(ValueError) as je:
        j.reduce(jr.sum_values, batch=True)
    assert str(te.value) == str(je.value)
    assert "interned byte/object ids" in str(te.value)


@pytest.mark.parametrize("aggregate", [False, True])
def test_add_across_intern_domains_groups_together(aggregate):
    """An MR of byte keys added to one of object keys (the same bytes
    among them): after the add, equal bytes are one key.  On the device
    the bytes-kind ids re-intern through the pickle domain."""
    words, _ = _words(60, seed=12)
    objs = [w if i % 2 else (i, w) for i, w in enumerate(words)]
    counts = []
    for side in ("t", "j"):
        a, b = [MapReduce(device="cpu"), MapReduce(device="cpu")] \
            if side == "t" else [JMapReduce(make_mesh(1)),
                                 JMapReduce(make_mesh(1))]
        a.map(1, lambda i, kv, p: [kv.add(w, 1) for w in words])
        b.map(1, lambda i, kv, p: [kv.add(o, 1) for o in objs])
        if aggregate:
            a.aggregate()
            b.aggregate()
        a.add(b)
        a.collate()
        a.reduce(tr.count if side == "t" else jr.count, batch=True)
        counts.append(sorted(_pairs(a), key=lambda p: repr(p)))
    assert counts[0] == counts[1]
    got = dict((k, v) for k, v in counts[0] if isinstance(k, bytes))
    want = {}
    for w in words + [o for o in objs if isinstance(o, bytes)]:
        want[w] = want.get(w, 0) + 1
    assert got == want


def test_skv_map_refuses_interned_frames():
    words, _ = _words(20)
    t, _ = _mrs(words, list(range(20)), True)
    fr = next(t.kv.frames())
    with pytest.raises(ValueError, match="skv_map: key entries are "
                       "interned byte/object ids"):
        dk.skv_map(fr, dk.invert_dev)
    out = dk.skv_map(fr, lambda k, v, c: (k[:c], v[:c], None),
                     preserve_decodes=True)
    assert out.key_decode is fr.key_decode
    assert out.to_host().key.tolist() == words


@pytest.mark.parametrize("keys", ["dense", "interned"])
def test_stats_bytes_match_jax(keys):
    """3,000 rows, 1,503 distinct keys, u8 values: (pairs, bytes) after
    map, (groups, values, bytes) after collate, then after reduce count
    and sort_values — a device frame counts its padded tensors."""
    rng = np.random.default_rng(0)
    uniq = rng.integers(0, 1 << 64, 1503, dtype=np.uint64, endpoint=False)
    if keys == "interned":
        uniq = [b"w%d" % i for i in range(1503)]
    pick = np.concatenate([np.arange(1503), rng.integers(0, 1503, 1497)])
    k = [uniq[i] for i in pick] if keys == "interned" else uniq[pick]
    v = np.zeros(3000, np.uint8)
    stats = []
    for mr, count in ((MapReduce(device="cpu"), tr.count),
                      (JMapReduce(make_mesh(1)), jr.count)):
        mr.map(1, lambda i, kv, p: kv.add_batch(k, v))
        row = [mr.kv_stats()]
        mr.collate()
        row.append(mr.kmv_stats())
        mr.reduce(count, batch=True)
        row.append(mr.kv_stats())
        mr.sort_values(-1)
        row.append(mr.kv_stats())
        stats.append(row)
    assert stats[0] == stats[1]
    if keys == "dense":
        assert stats[0][:3] == [(3000, 27000), (1503, 3000, 36864),
                                (1503, 32768)]
