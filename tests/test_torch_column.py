"""The port's byte and object columns (``core/column.py``) and its
on-device interning (``ops/hash.intern_packed``) against the JAX
package's ``core/column.py`` on the same seeded rows: equal ids, equal
decode tables (their kind too), concat promotion and its refusals,
``_coerce_rows``, and the device word split against ``bytes.split``."""

import pickle

import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu.core import column as jcol
from gpu_mapreduce_tpu.core.dataset import _coerce_rows as j_coerce
from gpu_mapreduce_tpu_torch.core import column as tcol
from gpu_mapreduce_tpu_torch.core.dataset import _coerce_rows as t_coerce
from gpu_mapreduce_tpu_torch.ops import hash as thash
from gpu_mapreduce_tpu_torch.utils.io import WHITESPACE, split_words

LENGTHS = (0, 1, 11, 12, 13, 23, 24, 25, 300, 100_000)


def _rows(seed=11):
    """Rows of every length in LENGTHS, from bytes 0x80-0xff, the
    non-separators 0x1c-0x1f and 0x85, and ASCII; each of the short ones
    repeated so ids repeat."""
    rng = np.random.default_rng(seed)
    pools = [np.arange(0x80, 0x100), np.array([0x1c, 0x1d, 0x1e, 0x1f,
                                               0x85, 0xa0]),
             np.arange(0x61, 0x7b)]
    rows = []
    for i, n in enumerate(LENGTHS):
        pool = pools[i % len(pools)]
        rows.append(bytes(rng.choice(pool, n).astype(np.uint8)))
    rows += [rows[i] for i in rng.permutation(len(LENGTHS) - 1)]
    rows += [b"a", b"a", b"\xff" * 12, b"\xff" * 12]
    return rows


def _ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        return ids.numpy().view(np.uint64)
    return np.asarray(ids.data)


@pytest.mark.parametrize("kind", ["bytes", "object"])
def test_intern_matches_jax(kind):
    rows = _rows()
    if kind == "object":
        rows = rows[:-4] + [(1, b"x"), {"k": [1, 2]}, None, (1, b"x"), 7,
                            b"a"]
        jids, jtab = jcol.ObjectColumn(rows).intern()
        tids, ttab = tcol.ObjectColumn(rows).intern("cpu")
    else:
        jids, jtab = jcol.BytesColumn(rows).intern()
        tids, ttab = tcol.BytesColumn(rows).intern("cpu")
    assert np.array_equal(_ids(tids), _ids(jids))
    assert ttab.kind == jtab.kind == kind
    assert list(ttab.items()) == list(jtab.items())
    assert (_ids(tids) >= np.uint64(1 << 63)).any()     # ids past 2^63


def test_intern_packed_returns_jax_core():
    """(ids, unique ids, first rows) equal to JAX's _intern_core, on a
    host buffer and on a column sliced out of a longer buffer."""
    rows = _rows(3)
    want = jcol._intern_core(rows)
    buf, off = tcol.pack_rows([b"pad"] + rows + [b"tail"])
    col = tcol.BytesColumn.packed(buf, off).slice(1, len(rows) + 1)
    got = thash.intern_packed(torch.from_numpy(col.buf),
                              torch.from_numpy(col.offsets))
    assert np.array_equal(_ids(got[0]), want[0])
    assert np.array_equal(_ids(got[1]), want[1])
    assert np.array_equal(got[2].numpy(), want[2])
    empty = thash.intern_packed(torch.zeros(0, dtype=torch.uint8),
                                torch.zeros(1, dtype=torch.int64))
    assert [t.numel() for t in empty] == [0, 0, 0]
    # rows that are all empty: every id is lookup3's init
    got = thash.intern_packed(torch.zeros(0, dtype=torch.uint8),
                              torch.zeros(3, dtype=torch.int64))
    want = jcol._intern_core([b"", b""])
    assert [_ids(t).tolist() for t in got[:2]] == \
        [w.tolist() for w in want[:2]]


def test_forced_collision_raises_jax_text(monkeypatch):
    """Two rows of one length share an id under a hash that returns the
    length; their alternate ids differ, so interning refuses with the
    JAX package's message."""
    real = thash.hash_rows

    def colliding(buf, starts, lengths, seed_hi=0, seed_lo=0xDEADBEEF):
        if (seed_hi, seed_lo) == (0, 0xDEADBEEF):
            return lengths.clone()
        return real(buf, starts, lengths, seed_hi, seed_lo)

    monkeypatch.setattr(thash, "hash_rows", colliding)
    rows = [b"ab", b"xyz", b"ab", b"cd"]
    want = "64-bit intern collision between %r and %r" % (b"ab", b"cd")
    with pytest.raises(ValueError) as err:
        tcol.BytesColumn(rows).intern("cpu")
    assert str(err.value) == want
    # equal rows under the colliding hash are not a collision
    ids, table = tcol.BytesColumn([b"ab", b"ab", b"xyz"]).intern("cpu")
    assert ids.tolist() == [2, 2, 3] and table == {2: b"ab", 3: b"xyz"}


def test_concat_promotion_and_refusals():
    b = [b"a", b"bc"]
    o = [(1, 2), b"a"]
    for mod in (jcol, tcol):
        out = mod.concat([mod.BytesColumn(b), mod.ObjectColumn(o)])
        assert isinstance(out, mod.ObjectColumn)
        assert out.tolist() == b + o
        out = mod.concat([mod.BytesColumn(b), mod.BytesColumn([]),
                          mod.BytesColumn([b"zz"])])
        assert isinstance(out, mod.BytesColumn)
        assert out.tolist() == b + [b"zz"]
        with pytest.raises(TypeError, match="object rows with numeric"):
            mod.concat([mod.ObjectColumn(o), mod.DenseColumn(np.arange(2))])
        with pytest.raises(TypeError, match="byte rows with numeric"):
            mod.concat([mod.BytesColumn(b), mod.DenseColumn(np.arange(2))])
    with pytest.raises(TypeError):
        tcol.concat([tcol.DenseColumn(np.arange(2)), tcol.BytesColumn(b)])


def test_packed_column_ops_match_jax():
    """take, slice, nbytes, tolist and empty_like of a packed column
    (host and device-split) equal the JAX object-array column's."""
    rows = _rows(5)[:-1]
    j = jcol.BytesColumn(rows)
    text = b" ".join(rows[:9] + [b"x", b"yy"])
    for t in (tcol.BytesColumn(rows),
              tcol.BytesColumn(rows).to("cpu")):
        idx = [5, 0, 0, 3, len(rows) - 1]
        assert t.take(idx).tolist() == j.take(idx).tolist()
        assert t.slice(2, 9).tolist() == j.slice(2, 9).tolist()
        assert t.slice(2, 9).nbytes() == j.slice(2, 9).nbytes()
        assert t.nbytes() == j.nbytes() and len(t) == len(j)
        assert len(tcol.empty_like(t)) == 0
    assert tcol.as_column([b"a", "b"]).tolist() == \
        jcol.as_column([b"a", "b"]).tolist() == [b"a", b"b"]
    assert tcol.as_column("s").tolist() == [b"s"]
    ob = tcol.ObjectColumn([{"a": 1}, (2,)])
    assert ob.nbytes() == jcol.ObjectColumn([{"a": 1}, (2,)]).nbytes() == \
        sum(len(pickle.dumps(r, protocol=4)) for r in ob.tolist())
    col = split_words(text, "cpu")
    assert col.tolist() == text.split()


ROWS = {
    "bytes": [b"ab", b"", b"\xff\x00"],
    "str": ["ab", "é"],
    "bytes_and_str": [b"a", "b", bytearray(b"c")],
    "none": [None, None, None],
    "ints": [1, 2, (1 << 64) - 1],
    "floats": [1.5, 2.0],
    "tuples": [(1, 2), (3, 4)],
    "ragged_tuples": [(1, 2), (3,)],
    "mixed_tuples": [("a", 1), ("b", 2)],
    "dicts": [{"a": 1}, {"b": [2]}],
    "bytes_then_int": [b"a", 3],
    "int_then_bytes": [3, b"a"],
}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_coerce_rows_matches_jax(name):
    rows = ROWS[name]
    j, t = j_coerce(list(rows)), t_coerce(list(rows))
    assert type(t).__name__ == type(j).__name__
    assert t.tolist() == j.tolist()
    if isinstance(t, tcol.DenseColumn):
        assert t.data.dtype == np.asarray(j.data).dtype
    assert t.nbytes() == j.nbytes()


def test_split_words_is_bytes_split():
    """The six ASCII whitespace bytes split words and nothing else: not
    0x1c-0x1f, 0x85 or 0xa0; runs of separators, leading and trailing
    ones and empty input too."""
    assert WHITESPACE == b" \t\n\r\x0b\x0c"
    rng = np.random.default_rng(2)
    alphabet = np.frombuffer(WHITESPACE + b"\x1c\x1d\x1e\x1f\x85\xa0ab\x00\xff",
                             np.uint8)
    for n in [0, 1, 2, 3] + list(rng.integers(4, 400, 60)):
        data = alphabet[rng.integers(0, len(alphabet), n)].tobytes()
        col = split_words(data, "cpu")
        assert col.tolist() == data.split()
        assert col.nbytes() == sum(len(w) for w in data.split())
        assert len(col) == len(data.split())
