"""The port's word-packed mark, compaction and URL-window helpers vs the
JAX package (Pallas kernel in interpret mode and its XLA twin), exactly.

The CUDA kernel itself runs only on a card: ``test_mark_words_kernel``
carries the ``cuda`` marker and skips where there is none."""

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
@pytest.mark.parametrize("m", [1, 2, 3, 4, 1_000_003])
def test_mark_words_kernel(cuda_device, m):
    rng = np.random.default_rng(m)
    n = 4 * m
    offs = [a for a in (0, 1, 2, 3, n - 40, n - 9) if 0 <= a <= n - 9]
    words = _t(_words(_planted(rng, n, offs))).to(cuda_device)
    before = tm.mark_words.launches
    got = tm.mark_words(words, PATTERN)
    torch.cuda.synchronize()
    assert tm.mark_words.launches == before + 1
    assert torch.equal(got, tm.mark_words_ref(words, PATTERN))
