"""The port's threefry PRNG (``ops/prng.py``) against ``jax.random``:
keys, splits and uniform draws must be bit-identical (x64 on, the
partitionable threefry layout jax uses by default)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_mapreduce_tpu_torch.ops import prng


def test_jax_uses_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", [0, 1, 12345, -3, (1 << 40) | 7,
                                  -(1 << 63), (1 << 63) - 1])
def test_prng_key(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          prng.PRNGKey(seed).numpy())


def test_prng_key_refuses_seeds_past_int64():
    with pytest.raises(OverflowError):
        prng.PRNGKey(1 << 63)


@pytest.mark.parametrize("seed", [0, 12345])
def test_split_in_two(seed):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed)))
    got = prng.split(prng.PRNGKey(seed)).numpy()
    assert got.shape == (2, 2)
    assert np.array_equal(want, got)


def test_split_n_and_chains():
    jk, tk = jax.random.PRNGKey(777), prng.PRNGKey(777)
    for n in range(1, 33):
        want = np.asarray(jax.random.split(jk, n))
        got = prng.split(tk, n).numpy()
        assert got.shape == (n, 2) and np.array_equal(want, got), n
        jk, tk = jax.random.split(jk)[1], prng.split(tk)[1]   # walk a chain


@pytest.mark.parametrize("shape", [(1,), (7,), (1000,), (3, 4), (257, 4),
                                   (1 << 14, 4)])
@pytest.mark.parametrize("bounds", [None, (-0.5, 0.5), (2.0, 5.0),
                                    (-1.7, 3.3)])
def test_uniform_bit_identical(shape, bounds):
    jk = jax.random.split(jax.random.PRNGKey(31), 3)[2]
    tk = prng.split(prng.PRNGKey(31), 3)[2]
    kw = {} if bounds is None else dict(minval=bounds[0], maxval=bounds[1])
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, **kw))
    got = prng.uniform(tk, shape, **kw).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


def test_random_bits32():
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    want = np.asarray(jax.random.bits(jk, (33, 3), jnp.uint32))
    got = prng.random_bits32(tk, (33, 3)).numpy()
    assert np.array_equal(want.astype(np.int64), got)
