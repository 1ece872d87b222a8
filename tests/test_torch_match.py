"""The port's word-packed and byte marks, compaction and
URL-window helpers vs the JAX package (Pallas kernels in interpret mode
and their XLA twins), exactly.

The CUDA kernels themselves run only on a card: ``test_mark_words_kernel``
and ``test_mark_bytes_kernel`` carry the ``cuda`` marker and skip where
there is none."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gpu_mapreduce_tpu.ops.pallas import match as jm
from gpu_mapreduce_tpu_torch.ops.cuda import match as tm

PATTERN = b'<a href="'
WORDS_PER_BLOCK = jm.WORD_BLOCK_ROWS * jm.LANES      # 65536 words


def _planted(rng, n, offsets, pattern=PATTERN):
    buf = rng.integers(0, 256, n, dtype=np.uint8)
    for off in offsets:
        buf[off:off + len(pattern)] = np.frombuffer(pattern, np.uint8)
    return buf


def _words(buf):
    return jm.bytes_view_u32(buf)


def _t(words_u32):
    return torch.from_numpy(np.array(words_u32).view(np.int32))


@pytest.mark.parametrize("nbytes,offsets,page_words", [
    # every word alignment, and matches across the 128-lane row seam
    (2000, (0, 13, 26, 39, 506, 1021), None),
    # across the [512, 128] block seam
    (4 * WORDS_PER_BLOCK + 64, (4 * WORDS_PER_BLOCK - 7,
                                4 * WORDS_PER_BLOCK + 5), None),
    # across the reference's page seams (pages of 1000 words)
    (12000, (3995, 3998 + 20, 7997), 1000),
])
def test_mark_words_ref_matches_pallas_and_xla(nbytes, offsets, page_words):
    rng = np.random.default_rng(nbytes)
    words = _words(_planted(rng, nbytes, offsets))
    got = tm.mark_words_ref(_t(words), PATTERN).numpy()
    want_k = np.asarray(jm.mark_words_pallas(jnp.asarray(words), PATTERN,
                                             interpret=True,
                                             page_words=page_words))
    want_x = np.asarray(jm.mark_words_xla(jnp.asarray(words), PATTERN))
    np.testing.assert_array_equal(got, want_k)
    np.testing.assert_array_equal(got, want_x)
    hits = np.nonzero(got)[0]
    assert sorted(4 * hits + got[hits] - 1) == sorted(offsets)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(tm.mark_words(_t(words), PATTERN).numpy(),
                                  got)


@pytest.mark.parametrize("nbytes", [0, 4, 8, 12, 16])
def test_mark_words_tiny_buffers(nbytes):
    """m = 0..4 words: m < nw reads zeros past the end."""
    buf = np.frombuffer((b'<a href="' + b"x" * 16)[:nbytes], np.uint8)
    words = _words(buf)
    got = tm.mark_words_ref(_t(words), PATTERN).numpy()
    assert got.shape == (len(words),)
    if len(words):
        want = np.asarray(jm.mark_words_pallas(jnp.asarray(words), PATTERN,
                                               interpret=True))
        np.testing.assert_array_equal(got, want)
    expect_hit = nbytes >= len(PATTERN)
    assert (got[:1] == 1).tolist() == ([expect_hit] if len(words) else [])


def test_mark_words_rejects_bad_input():
    with pytest.raises(ValueError):
        tm.mark_words(torch.zeros(8, dtype=torch.int64), PATTERN)
    with pytest.raises(ValueError):
        tm.mark_words(torch.zeros((2, 4), dtype=torch.int32), PATTERN)
    with pytest.raises(ValueError):
        tm.mark_words(torch.zeros(8, dtype=torch.int32), b"abab")  # period 2
    with pytest.raises(ValueError):
        tm.mark_words(torch.zeros(8, dtype=torch.int32), b"q" + b"z" * 30)


@pytest.mark.parametrize("start", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [0, 1, 3, 16, 17, 1001])
def test_mark_output_is_placed_for_16_byte_stores(start, m):
    """The kernel stores 16 codes at once from the first 16-byte boundary
    of ``words``: the wrapper's output puts that word's code on a 16-byte
    boundary too, for views that start off one."""
    base = torch.zeros(m + 8, dtype=torch.int32)
    assert base.data_ptr() % 16 == 0          # the allocator's alignment
    words = base[start:start + m]
    out = tm.mark_output(words)
    assert out.shape == (m,) and out.dtype == torch.int8
    assert out.is_contiguous()
    head = min(m, (4 - start) % 4)            # words before the boundary
    assert (out.data_ptr() + head) % 16 == 0


@pytest.mark.parametrize("mode", ["scatter", "searchsorted", "blocked"])
@pytest.mark.parametrize("max_hits", [4, 64])
def test_compact_word_matches_matches_jax(mode, max_hits):
    rng = np.random.default_rng(11)
    n = 70_000
    offs = sorted(rng.choice(n - 20, 40, replace=False).tolist())
    offs = [o for i, o in enumerate(offs) if i == 0 or o - offs[i - 1] > 9]
    words = _words(_planted(rng, n, offs))
    wm = tm.mark_words_ref(_t(words), PATTERN)
    nbytes = 4 * len(words)
    got, total = tm.compact_word_matches(wm, nbytes, max_hits)
    want, wtotal = jm.compact_word_matches(jnp.asarray(wm.numpy()), nbytes,
                                           max_hits, mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and total == int(wtotal) == len(offs)


@pytest.fixture
def windows_input():
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, 4001, dtype=np.uint8)
    buf[rng.integers(0, 4001, 200)] = ord('"')
    words = _words(buf)
    starts = np.concatenate([rng.integers(0, 4 * len(words), 300),
                             [0, 1, 2, 3, 4 * len(words) - 3,
                              4 * len(words), 4 * len(words) + 9]])
    return words, starts.astype(np.int32)


@pytest.mark.parametrize("nwords", [1, 16, 64])
def test_url_windows_match_jax(windows_input, nwords):
    words, starts = windows_input
    win = tm.unaligned_words(_t(words), torch.from_numpy(starts), nwords)
    jwin = jm.unaligned_words(jnp.asarray(words), jnp.asarray(starts),
                              nwords)
    np.testing.assert_array_equal(win.numpy().astype(np.uint32),
                                  np.asarray(jwin))
    pos = tm.first_byte_pos(win, ord('"'))
    jpos = jm.first_byte_pos(jwin, ord('"'))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    lengths = np.random.default_rng(nwords).integers(
        -2, 4 * nwords + 3, len(starts)).astype(np.int32)
    got = tm.mask_words_to_length(win, torch.from_numpy(lengths))
    want = jm.mask_words_to_length(jwin, jnp.asarray(lengths))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 15, 16, 17, 33, 16 * 4099 + 7,
                               1_000_003])
def test_mark_words_kernel(cuda_device, m, start):
    """Ragged tails (m mod 16) and views words[start:] that do not start
    on a 16-byte boundary (the kernel's scalar head)."""
    rng = np.random.default_rng(m)
    n = 4 * (m + start)
    offs = [a for a in (0, 1, 2, 3, 61, 62, 2045, n - 40, n - 9)
            if 0 <= a <= n - 9]
    words = _t(_words(_planted(rng, n, offs))).to(cuda_device)[start:]
    before = tm.mark_words.launches
    got = tm.mark_words(words, PATTERN)
    torch.cuda.synchronize()
    assert tm.mark_words.launches == before + 1
    assert torch.equal(got, tm.mark_words_ref(words, PATTERN))


# ---------------------------------------------------------------------------
# byte mark (csrc/mark_bytes.cu and its plain version)
# ---------------------------------------------------------------------------

HTML = (b'<html><body><a href="http://a.com/x">x</a>'
        b'<p>no link</p><a href="http://b.org/long/path?q=1">y</a>'
        b'<A HREF="http://case.sensitive/">skip</A>'
        b'<a href="http://a.com/x">dup</a></body></html>')


def _bytes_t(data: bytes):
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


def _jax_marks(data: bytes, pattern: bytes):
    buf = jnp.asarray(np.frombuffer(data, np.uint8))
    return (np.asarray(jm.mark_xla(buf, pattern)).astype(np.int8),
            np.asarray(jm.mark_pallas(buf, pattern, interpret=True)))


@pytest.mark.parametrize("pattern", [PATTERN, b"ab", b"aaa", b"\x00",
                                     b"a\x00", b"<"])
def test_mark_ref_matches_pallas_and_xla(pattern):
    noise = np.random.default_rng(len(pattern)).integers(
        0, 256, 70_000, dtype=np.uint8).tobytes()
    data = noise + HTML * 7 + b"abababaaaa" + noise + b"a"
    got = tm.mark_ref(_bytes_t(data), pattern).numpy()
    want_x, want_k = _jax_marks(data, pattern)
    np.testing.assert_array_equal(got, want_x)
    np.testing.assert_array_equal(got, want_k)
    # the wrapper takes the plain version for a CPU tensor
    before = tm.mark.launches
    np.testing.assert_array_equal(
        tm.mark(_bytes_t(data), pattern).numpy(), got)
    assert tm.mark.launches == before


# nw = (length + 6) // 4 words: the kernel's two-word prefilter decides
# alone up to 5 bytes and checks words 2..nw-1 from 6 on; the lengths past
# the former 64-byte cap run up to the TPU kernel's reach
PATTERN_LENGTHS = [1, 4, 5, 6, 16, 17, 63, 64, 65, 100, 128]


def _pattern_of(length: int) -> bytes:
    """A pattern of ``length`` bytes from a seed; its first byte is '<' so
    that one-byte patterns still mean something on text."""
    rng = np.random.default_rng(1000 + length)
    return b"<" + rng.integers(0, 256, length - 1, dtype=np.uint8).tobytes()


def _length_offsets(n: int, length: int):
    """Planted starts, at least ``length`` apart: across the 128-lane row
    and the 32 KB Pallas block, across the kernel's 512-byte rows and a
    warp's 2 KB span, and one ending at the last byte."""
    offs = []
    for o in (0, 1, 127 - length // 2, 128 - length // 2, 2048 - 3,
              32768 - length // 2, n - length):
        if 0 <= o <= n - length and (not offs or o - offs[-1] >= length):
            offs.append(o)
    return offs


@pytest.mark.parametrize("length", PATTERN_LENGTHS)
def test_mark_ref_matches_pallas_and_xla_at_pattern_lengths(length):
    """40 KB crosses one 32 KB Pallas block; the planted starts are all
    found, and a planted prefix one byte short is not."""
    pattern = _pattern_of(length)
    n = 40 * 1024
    rng = np.random.default_rng(length)
    offs = _length_offsets(n, length)
    buf = _planted(rng, n, offs, pattern)
    if length > 1:
        short = 20_000
        buf[short:short + length - 1] = np.frombuffer(pattern[:-1], np.uint8)
        buf[short + length - 1] = pattern[-1] ^ 1
    data = buf.tobytes()
    got = tm.mark_ref(_bytes_t(data), pattern).numpy()
    want_x, want_k = _jax_marks(data, pattern)
    np.testing.assert_array_equal(got, want_x)
    np.testing.assert_array_equal(got, want_k)
    hits = set(np.nonzero(got)[0].tolist())
    assert set(offs) <= hits
    if length >= 4:
        assert hits == set(offs)
    np.testing.assert_array_equal(
        tm.mark(_bytes_t(data), pattern).numpy(), got)


@pytest.mark.parametrize("off", [0, 1, 119, 120, 126, 127, 128, 255, 256,
                                 1000, 32767, 32768])
def test_mark_ref_cross_lane_boundaries(off):
    data = b"x" * off + b'<a href="u">' + b"y" * 300
    got = tm.mark_ref(_bytes_t(data), PATTERN).numpy()
    np.testing.assert_array_equal(got, _jax_marks(data, PATTERN)[1])
    assert got.sum() == 1 and got[off] == 1


@pytest.mark.parametrize("n", [1, 2, 3])
def test_mark_ref_tiny_buffers_and_zero_tail(n):
    """Bytes past the end read as 0: ``a\\0`` matches at the last byte."""
    data = b"a" * n
    got = tm.mark_ref(_bytes_t(data), b"a\x00").numpy()
    want_x, want_k = _jax_marks(data, b"a\x00")
    np.testing.assert_array_equal(got, want_x)
    np.testing.assert_array_equal(got, want_k)
    assert got.tolist() == [0] * (n - 1) + [1]


def test_mark_rejects_bad_input():
    with pytest.raises(ValueError):
        tm.mark(torch.zeros(8, dtype=torch.int8), b"a")
    with pytest.raises(ValueError):
        tm.mark(torch.zeros(8, dtype=torch.uint8), b"")
    with pytest.raises(ValueError):
        tm.mark(torch.zeros(8, dtype=torch.uint8), b"z" * (tm.MAX_PAT + 1))
    with pytest.raises(ValueError):
        tm.mark(torch.zeros((2, 4), dtype=torch.uint8), b"a")


@pytest.mark.parametrize("start", range(16))
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 64, 1001])
def test_byte_mark_output_is_placed_for_16_byte_stores(start, n):
    """The byte kernel stores 16 codes at once from the first 16-byte
    boundary of ``buf``: the wrapper's output puts that byte's code on a
    16-byte boundary too, for views buf[1:]..buf[15:]."""
    base = torch.zeros(n + 16, dtype=torch.uint8)
    assert base.data_ptr() % 16 == 0          # the allocator's alignment
    buf = base[start:start + n]
    out = tm.mark_output(buf)
    assert out.shape == (n,) and out.dtype == torch.int8
    assert out.is_contiguous()
    head = min(n, (16 - start) % 16)          # bytes before the boundary
    assert (out.data_ptr() + head) % 16 == 0


@pytest.mark.parametrize("max_hits", [2, 3, 16])
def test_compact_matches_and_url_lengths_match_jax(max_hits):
    data = HTML + b'<a href="unterminated'
    buf = np.frombuffer(data, np.uint8)
    mask = tm.mark_ref(_bytes_t(data), PATTERN)
    starts, total = tm.compact_matches(mask, max_hits)
    jstarts, jtotal = jm.compact_matches(jnp.asarray(mask.numpy()), max_hits)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    assert total == int(jtotal) == 4
    for max_len in (4, 64):
        lens, wins = tm.url_lengths(_bytes_t(data), starts + len(PATTERN),
                                    ord('"'), max_len)
        jlens, jwins = jm.url_lengths(jnp.asarray(buf),
                                      jstarts + len(PATTERN), ord('"'),
                                      max_len)
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
        np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
        assert lens.dtype == torch.int32 and wins.dtype == torch.uint8


def _kernel_cases():
    """(n, start, pattern): the tiny buffers and the \\0 tail; views
    buf[k:] off a 16-byte boundary (the scalar head); n = 1..80 (head, a
    few 16-byte chunks and the scalar tail); a ragged tail of every n mod
    64; the pattern lengths, 128 included."""
    cases = [(1, 0, b"a\x00"), (2, 0, b"a\x00"), (3, 0, b"ab"),
             (1_000_003, 0, PATTERN)]
    cases += [(100_003, k, PATTERN) for k in range(1, 16)]
    cases += [(n, 0, b"a\x00") for n in range(1, 81)]
    cases += [(64 * 1000 + r, 5, PATTERN) for r in range(64)]
    cases += [(300_001, 3, _pattern_of(L)) for L in PATTERN_LENGTHS]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("n,start,pattern", _kernel_cases())
def test_mark_bytes_kernel(cuda_device, n, start, pattern):
    rng = np.random.default_rng(n + start)
    L = len(pattern)
    offs = [start + o for o in (0, 1, 13, 512 - L // 2, 2048 - 3, n - 40,
                                n - L) if 0 <= o <= n - L]
    buf = _planted(rng, n + start, offs, pattern)
    buf[-1] = ord("a")
    t = torch.from_numpy(buf).to(cuda_device)[start:]
    before = tm.mark.launches
    got = tm.mark(t, pattern)
    torch.cuda.synchronize()
    assert tm.mark.launches == before + 1
    assert torch.equal(got, tm.mark_ref(t, pattern))


@pytest.mark.cuda
def test_mark_bytes_launch_refuses_misaligned_output(cuda_device):
    """The launch returns cudaErrorMisalignedAddress (716) for an output
    that its 16-byte stores cannot use; the wrapper never passes one."""
    from gpu_mapreduce_tpu_torch.ops.cuda import library
    lib = library("mark_bytes", tm._bind_bytes)
    buf = torch.zeros(4096, dtype=torch.uint8, device=cuda_device)
    out = torch.empty(4096 + 16, dtype=torch.int8, device=cuda_device)
    cm, cv, _ = tm._c_tables(b"abc")
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    rc = lib.mark_bytes_launch(buf.data_ptr(), out.data_ptr() + 1, 4096, cm,
                               cv, 3, buf.device.index or 0, stream)
    assert rc == 716
