"""lookup3 in the PyTorch port vs the JAX package, bit for bit.

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gpu_mapreduce_tpu.ops import hash as jhash
from gpu_mapreduce_tpu_torch.ops import hash as thash

SEEDS = [(0, 0xDEADBEEF), (0x9E3779B9, 0x85EBCA6B)]


def _keys(rng, n, max_len):
    """Random byte keys zeroed beyond random lengths 0..max_len, as u32
    word rows [n, max_len/4], plus the lengths and the raw bytes."""
    lengths = rng.integers(0, max_len + 1, n).astype(np.int32)
    lengths[:4] = [0, 1, 12, max_len]          # tails at the edges
    buf = rng.integers(0, 256, (n, max_len), dtype=np.uint8)
    buf[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
    words = np.ascontiguousarray(buf).view("<u4").reshape(n, max_len // 4)
    return words, lengths, buf


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(
        {4: np.int32, 8: np.int64}.get(x.dtype.itemsize, x.dtype))
        if x.dtype.kind == "u" else x)


@pytest.mark.parametrize("max_len", [16, 64, 256])
@pytest.mark.parametrize("seed", [0, 0xDEADBEEF, 0x85EBCA6B])
def test_hashlittle_masked_matches_jax(max_len, seed):
    """max_len 256 is 22 blocks: the JAX side takes its fori_loop path."""
    rng = np.random.default_rng(max_len + seed % 1000)
    words, lengths, _ = _keys(rng, 300, max_len)
    want = np.asarray(jhash.hashlittle_masked(jnp.asarray(words),
                                              jnp.asarray(lengths), seed))
    got = thash.hashlittle_masked(_t(words), _t(lengths), seed).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("seeds", SEEDS)
@pytest.mark.parametrize("max_len", [64, 256])
def test_hash_bytes64_masked_matches_jax(seeds, max_len):
    rng = np.random.default_rng(max_len)
    words, lengths, buf = _keys(rng, 200, max_len)
    want = np.asarray(jhash.hash_bytes64_masked(
        jnp.asarray(words), jnp.asarray(lengths), *seeds))
    got = thash.hash_bytes64_masked(_t(words), _t(lengths), *seeds)
    got = got.numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    if seeds == SEEDS[0]:
        # and the host scalar version on the exact bytes
        for i in range(20):
            key = buf[i, :lengths[i]].tobytes()
            assert int(got[i]) == thash.hash_bytes64(key) \
                == jhash.hash_bytes64(key)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 6, 7])
def test_hash_words32_matches_jax(width):
    rng = np.random.default_rng(width)
    words = rng.integers(0, 1 << 32, (100, width), dtype=np.uint64) \
        .astype(np.uint32)
    for init in (0, 7):
        want = np.asarray(jhash.hash_words32(jnp.asarray(words), init))
        got = thash.hash_words32(_t(words), init).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_hash_u64_matches_jax():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, np.iinfo(np.uint64).max, 500, dtype=np.uint64)
    keys[:2] = [0, np.iinfo(np.uint64).max]
    want = np.asarray(jhash.hash_u64(jnp.asarray(keys)))
    got = thash.hash_u64(_t(keys)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_host_hashlittle_matches_jax():
    rng = np.random.default_rng(4)
    for n in list(range(0, 30)) + [100, 255, 256]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for init in (0, 0xDEADBEEF):
            assert thash.hashlittle(data, init) == \
                jhash.hashlittle(data, init)
