"""Threefry-2x32 random numbers, bit-identical to ``jax.random``.

The JAX package draws its R-MAT graphs from ``jax.random`` (threefry).
The port has no JAX, so it computes the same stream itself: with these
functions the same seed gives the same graph.  The layout is jax 0.9's
with ``jax_threefry_partitionable`` on (its default) and x64 enabled:

* :func:`PRNGKey` — ``[hi32(seed), lo32(seed)]``;
* :func:`split` — key i of n is ``threefry(key, (hi32(i), lo32(i)))``, the
  two output words as the new key;
* :func:`random_bits32` — element i (row-major) is ``x0 ^ x1`` of
  ``threefry(key, (hi32(i), lo32(i)))``;
* :func:`uniform` — the top 23 bits of a draw as the mantissa of a float
  in [1, 2), minus 1, scaled into [minval, maxval) in float32.  XLA on
  the CPU contracts that scaling ``f * (maxval - minval) + minval`` into
  one fused multiply-add, so it is computed here in float64 (the product
  of two float32 is exact there) and rounded once to float32; for the
  ranges R-MAT draws, [0, 1) and [-0.5, 0.5), both forms are exact.

Keys are int64 tensors ``[..., 2]`` of u32 values on the host; draws come
out on the device the caller names.  Arithmetic runs on int64 lanes
holding u32 values (``ops/bits``), masked back to 32 bits after each add,
so right shifts are logical.  No global state: every draw takes its key.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .bits import M32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the count pairs ``(x0, x1)`` (u32 in
    int64 lanes) under the key ``(k1, k2)``; returns the two output
    words, u32 in int64 lanes."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(M32)
    x1 = (x1 + ks[1]).bitwise_and_(M32)
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0.add_(x1).bitwise_and_(M32)
            hi = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_and_(M32).bitwise_or_(hi)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(g + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(g + 2) % 3] + g + 1).bitwise_and_(M32)
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 on: the 64-bit seed's two
    halves, high first."""
    if not -(1 << 63) <= int(seed) < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in int64")
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64)


def _key_words(key: torch.Tensor) -> Tuple[int, int]:
    k1, k2 = key.reshape(2).tolist()
    return int(k1), int(k2)


def _hashed_iota(key: torch.Tensor, n: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(*_key_words(key), idx >> 32, idx & M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` → keys ``[num, 2]``."""
    x0, x1 = _hashed_iota(key, num, "cpu")
    return torch.stack([x0, x1], 1)


def random_bits32(key: torch.Tensor, shape: Sequence[int],
                  device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: u32 values in int64 lanes
    of ``shape`` on ``device``."""
    x0, x1 = _hashed_iota(key, int(np.prod(shape, dtype=np.int64)), device)
    return x0.bitwise_xor_(x1).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int],
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device``."""
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32 only, got {dtype}")
    bits = random_bits32(key, shape, device)
    ones = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    floats = ones.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    if (lo, hi) == (0.0, 1.0):
        return floats
    scaled = (floats.double() * float(hi - lo) + float(lo)).float()
    return scaled.clamp_(min=float(lo))
