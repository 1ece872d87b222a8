"""The port's native C++ host runtime (``native/``) against the JAX
package's, on the CPU: every wrapper on the same seeded inputs, exactly;
``InvertedIndex(engine="native")`` against the port's default engine
and the JAX package's native engine (hits, unique URLs, ``part-00000``
bytes); ``oink/kernels._parse_cols``' native route against its numpy
route; and the library the port loads is its own, built under its
``_build/``."""

import filecmp
import os
import random
import re

import numpy as np
import pytest

from gpu_mapreduce_tpu import native as jnative
from gpu_mapreduce_tpu.apps.invertedindex import InvertedIndex as JInvertedIndex
from gpu_mapreduce_tpu.ops.hash import hash_bytes64, hashlittle
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu_torch import MRError, native
from gpu_mapreduce_tpu_torch.apps import invertedindex as tii
from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
from gpu_mapreduce_tpu_torch.apps.invertedindex import InvertedIndex
from gpu_mapreduce_tpu_torch.oink import kernels

from test_torch_parallel import tmesh

PKG = os.path.dirname(os.path.abspath(native.__file__))
U64, F64 = np.uint64, np.float64

pytestmark = pytest.mark.skipif(
    not (native.available() and jnative.available()),
    reason=f"native library unavailable: {native.build_error()}")


def test_library_is_the_ports_own():
    """The loaded library lies under the port's ``_build/``, never under
    the JAX package, and nothing was written beside the source."""
    path = native.library_path()
    assert path == native.LIB
    assert os.path.dirname(path) == os.path.join(os.path.dirname(PKG),
                                                 "_build")
    assert os.path.exists(path) and "gpu_mapreduce_tpu" + os.sep not in path
    assert set(os.listdir(PKG)) - {"__pycache__"} \
        == {"__init__.py", "mrnative.cpp"}


def test_build_failure_is_reported(tmp_path, monkeypatch):
    """A compiler that fails leaves ``available()`` False with the reason,
    and the native engine raises ``MRError``."""
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "LIB", str(tmp_path / "libmrnative.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    assert not native.available()
    assert native.build_error()
    with pytest.raises(RuntimeError):
        native.hashlittle(b"x")
    with pytest.raises(MRError):
        InvertedIndex(device="cpu", engine="native")
    assert not os.listdir(tmp_path)


def test_hashlittle_random_matches_jax():
    rnd = random.Random(7)
    for _ in range(300):
        data = bytes(rnd.randrange(256) for _ in range(rnd.randrange(50)))
        iv = rnd.randrange(2 ** 32)
        assert native.hashlittle(data, iv) == jnative.hashlittle(data, iv) \
            == hashlittle(data, iv)


def test_batch_and_intern64_match_jax():
    words = [b"alpha", b"", b"x" * 13, b"mixed bytes\x00\xff", b"q"]
    rng = np.random.default_rng(2)
    words += [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(0, 70, 40)]
    buf = b"".join(words)
    offs = np.cumsum([0] + [len(w) for w in words]).astype(np.int64)
    for iv in (0, 9, 0xDEADBEEF):
        np.testing.assert_array_equal(native.hashlittle_batch(buf, offs, iv),
                                      jnative.hashlittle_batch(buf, offs, iv))
    got = native.intern64_batch(buf, offs)
    np.testing.assert_array_equal(got, jnative.intern64_batch(buf, offs))
    assert got.tolist() == [hash_bytes64(w) for w in words]


def test_intern_ranges_and_ranges2_match_jax():
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 256, 4096, dtype=np.uint8)
    starts = np.sort(rng.choice(3800, 40, replace=False)).astype(np.int64)
    lens = rng.integers(0, 200, 40, dtype=np.int64)    # 0, ≤12 and >12
    ah, al = 0x9E3779B9, 0x85EBCA6B
    for args in ((), (ah, al)):
        np.testing.assert_array_equal(
            native.intern_ranges(buf, starts, lens, *args),
            jnative.intern_ranges(buf, starts, lens, *args))
    ids, alts = native.intern_ranges2(buf, starts, lens, ah, al)
    jids, jalts = jnative.intern_ranges2(buf, starts, lens, ah, al)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(alts, jalts)
    np.testing.assert_array_equal(ids, native.intern_ranges(buf, starts,
                                                            lens))
    assert not np.array_equal(ids, alts)
    # bytes in place of an array, the same ids
    np.testing.assert_array_equal(
        native.intern_ranges(buf.tobytes(), starts, lens), ids)


PARSE_OK = [
    (b"1 2 3.5\n18446744073709551615 7 0.25\n 0 0 1e3 ", (U64, U64, F64)),
    (b"+5 inf\n007 -nan\n1 -infinity\n", (U64, F64)),
    (b"0000000000000000000000042\n", (U64,)),
    (b"5 6 1.5\n18446744073709551615 2 0.25\n", (U64, U64, F64)),
    (b"", (U64, U64)),
    (b"\n".join(b"%d %d" % (i, 2 * i) for i in range(5000)), (U64, U64)),
]
PARSE_BAD = [
    (b"99999999999999999999999 1\n", (U64, U64)),
    (b"1 1.5abc\n", (U64, F64)),
    (b"1 0x10\n", (U64, F64)),
    (b"1 2\n3\n", (U64, U64)),
    (b"1 x\n", (U64, U64)),
    (b"-1 2\n", (U64, U64)),
]


@pytest.mark.parametrize("i", range(len(PARSE_OK)))
def test_parse_table_matches_jax(i):
    """u64 exact (2^64-1), f64, inf/nan/+ and zero padding as the numpy
    route takes them, and the capacity retry (5000 rows)."""
    buf, dts = PARSE_OK[i]
    got, want = native.parse_table(buf, dts), jnative.parse_table(buf, dts)
    assert len(got) == len(want) == len(dts)
    for g, w, dt in zip(got, want, dts):
        assert g.dtype == w.dtype == dt
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("i", range(len(PARSE_BAD)))
def test_parse_table_rejects_like_jax(i):
    """Overflow, partial tokens, hex, a ragged table: ValueError in
    both."""
    buf, dts = PARSE_BAD[i]
    for mod in (native, jnative):
        with pytest.raises(ValueError):
            mod.parse_table(buf, dts)


def _href_oracle(html):
    return [m.group(1) for m in re.finditer(rb'(?=<a href="([^"]*)")', html)]


HREF_CASES = [
    b'<a href="aaa<a href="bar">x</a>',                 # overlapping
    b'<a href="x"' + b"<<<<" + b'<a href="yy"',         # flush at both ends
    b'<a href="',                                       # no quote
    b"",
    b"<" * 64,
    b'<a href="a"<a href="b',                           # unterminated tail
]


def test_find_hrefs_matches_jax_and_regex():
    rnd = random.Random(11)
    parts = [b'<p>junk<a href="http://site%d/p%d">t</a>'
             % (i, rnd.randrange(1000)) for i in range(100)]
    cases = HREF_CASES + [b"<html>" + b"".join(parts) + b'<a href="noquote']
    for html in cases:
        s, n = native.find_hrefs(html)
        js, jn = jnative.find_hrefs(html)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(n, jn)
        assert [html[a:a + b] for a, b in zip(s, n)] == _href_oracle(html)
        arr = np.frombuffer(html, np.uint8)
        s2, n2 = native.find_hrefs(arr)
        np.testing.assert_array_equal(s2, s)
        np.testing.assert_array_equal(n2, n)


def test_tokenize_matches_jax_and_split():
    rng = np.random.default_rng(4)
    alphabet = np.frombuffer(b"ab \t\n\r\x0b\x0cxyz", np.uint8)
    for n in (0, 1, 7, 5000):
        buf = alphabet[rng.integers(0, len(alphabet), n)].tobytes()
        s, ln = native.tokenize(buf)
        js, jln = jnative.tokenize(buf)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(ln, jln)
        assert [buf[a:a + b] for a, b in zip(s, ln)] == buf.split()


# ---------------------------------------------------------------------------
# the callers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    paths, _, _ = make_corpus(str(d), 1, 3, skew=True)
    return paths


def test_invertedindex_native_engine_matches(corpus, tmp_path):
    """The native engine's hits, unique URLs and part file equal the
    port's default engine's and the JAX package's native engine's."""
    dflt = InvertedIndex(device="cpu")
    nat = InvertedIndex(device="cpu", engine="native")
    assert nat.engine == "native" and nat.mapstyle == 2
    a = dflt.run(corpus, outdir=str(tmp_path / "a"))
    b = nat.run(corpus, outdir=str(tmp_path / "b"))
    j = JInvertedIndex(engine="native", comm=j_make_mesh(1)).run(
        corpus, outdir=str(tmp_path / "j"))
    assert a == b == j
    assert nat.stats["nbatches"] == len(corpus)
    for d in ("b", "j"):
        assert filecmp.cmp(str(tmp_path / "a" / "part-00000"),
                           str(tmp_path / d / "part-00000"), shallow=False)
    assert nat.urls == dflt.urls
    assert set(nat.timer.times) >= {"map", "native_scan", "host_add",
                                    "aggregate", "convert", "reduce"}


def test_invertedindex_native_without_url_dict(corpus, monkeypatch):
    """Past ``URL_DICT_MAX`` the ids' alternate family is folded into the
    sorted check runs (compacted through a low floor here); a forged
    collision raises."""
    monkeypatch.setattr(tii, "URL_DICT_MAX", 0)
    monkeypatch.setattr(InvertedIndex, "_CHK_MIN_COMPACT", 64)
    want = InvertedIndex(device="cpu").run(corpus)
    nat = InvertedIndex(device="cpu", engine="native")
    assert nat.run(corpus) == want
    assert nat.urls == {}
    real = native.intern_ranges2

    def forged(buf, starts, lens, hi, lo):
        ids, alts = real(buf, starts, lens, hi, lo)
        ids[:] = ids[0]                  # one id, many alt ids
        return ids, alts

    monkeypatch.setattr(native, "intern_ranges2", forged)
    with pytest.raises(ValueError, match="collision"):
        InvertedIndex(device="cpu", engine="native").run(corpus)


def test_invertedindex_native_on_a_mesh(corpus, tmp_path):
    """At P = 3 the native engine writes the default engine's per-shard
    part files."""
    a = InvertedIndex(comm=tmesh(3)).run(corpus, outdir=str(tmp_path / "a"))
    b = InvertedIndex(comm=tmesh(3), engine="native").run(
        corpus, outdir=str(tmp_path / "b"))
    assert a == b
    for p in range(3):
        assert filecmp.cmp(str(tmp_path / "a" / f"part-{p:05d}"),
                           str(tmp_path / "b" / f"part-{p:05d}"),
                           shallow=False)


def test_unknown_engine_raises():
    with pytest.raises(MRError):
        InvertedIndex(device="cpu", engine="pallas")


def test_parse_cols_native_route_matches_numpy(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    vi = rng.integers(0, 2 ** 63, 3000, dtype=np.uint64) * 2 + 1
    vj = rng.integers(0, 2 ** 20, 3000).astype(np.uint64)
    w = rng.random(3000)
    p = tmp_path / "e.txt"
    p.write_text("".join(f"{a} {b} {c!r}\n" for a, b, c in zip(
        vi.tolist(), vj.tolist(), w.tolist()))
        + "18446744073709551615 0 0.25\n")
    calls = []
    real = native.parse_table
    monkeypatch.setattr(native, "parse_table",
                        lambda *a: calls.append(1) or real(*a))
    dts = (U64, U64, F64)
    nat = kernels._parse_cols(str(p), dts)
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        ref = kernels._parse_cols(str(p), dts)
    for g, r in zip(nat, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert nat[0][-1] == np.uint64(2 ** 64 - 1)
    assert calls == [1]
    # a label column (int64) takes the numpy route
    q = tmp_path / "l.txt"
    q.write_text("1 2 -3\n4 5 6\n")
    calls.clear()
    got = kernels._parse_cols(str(q), (U64, U64, np.int64))
    assert calls == [] and got[2].tolist() == [-3, 6]
    bad = tmp_path / "bad.txt"
    bad.write_text("1 x\n")
    with pytest.raises(ValueError, match="bad.txt"):
        kernels._parse_cols(str(bad), (U64, U64))
