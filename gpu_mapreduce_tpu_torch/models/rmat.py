"""R-MAT graph generation on the device.

The counterpart of ``gpu_mapreduce_tpu/models/rmat.py``: per level, one
uniform per edge picks a quadrant with probabilities (a, b, c, d) and
shifts one bit into each vertex id, MSB first; with noise the per-edge
probabilities are perturbed each level and renormalised.  The draws come
from ``ops/prng`` (threefry, bit-identical to ``jax.random``), so a seed
gives the JAX package's graph.

Float32 order matters: the quadrant tests compare against running sums of
the probabilities with exact ``>=``, so the sums are written out left to
right, the order XLA's CPU ``cumsum`` and ``sum`` over four take, and the
noise factor ``1 + frac * nz`` is one rounding of the exact value, as
XLA's fused multiply-add gives it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import prng
from ..ops.bits import order_key


def _running_sums(p: torch.Tensor):
    """p[:, 0], p0 + p1, (p0 + p1) + p2 — the first three of a cumsum."""
    t0 = p[:, 0]
    t1 = t0 + p[:, 1]
    return t0, t1, t1 + p[:, 2]


def rmat_edges(key: torch.Tensor, m: int, nlevels: int, abcd: Sequence[float],
               frac: float, noisy: bool, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate m R-MAT edges in a 2^nlevels-vertex graph on ``device``.
    Returns (vi [m], vj [m]): u64 ids in int64 tensors.  ``noisy`` gates
    the per-level ``frac`` perturbation (frac == 0 ⇒ noisy=False)."""
    abcd = torch.tensor(np.asarray(abcd, np.float32), device=device)
    probs = abcd.expand(m, 4) if noisy else abcd[None, :]
    frac64 = float(np.float32(frac))
    vi = torch.zeros(m, dtype=torch.int64, device=device)
    vj = torch.zeros(m, dtype=torch.int64, device=device)
    for lkey in prng.split(key, nlevels):
        ku, kn = prng.split(lkey)
        u = prng.uniform(ku, (m,), device=device)
        t0, t1, t2 = _running_sums(probs)
        # quadrant: 0=a (i0,j0)  1=b (j1)  2=c (i1)  3=d (i1,j1)
        jbit = ((u >= t0) & (u < t1)) | (u >= t2)
        ibit = u >= t1
        del u, t0, t1, t2
        vi.bitwise_left_shift_(1).bitwise_or_(ibit)
        vj.bitwise_left_shift_(1).bitwise_or_(jbit)
        if noisy:
            nz = prng.uniform(kn, (m, 4), minval=-0.5, maxval=0.5,
                              device=device)
            factor = (nz.double().mul_(frac64).add_(1.0)).float()
            probs = probs * factor
            total = ((probs[:, 0] + probs[:, 1]) + probs[:, 2]) + probs[:, 3]
            probs = probs / total[:, None]
    return vi, vj


def generate_unique(seed: int, nlevels: int, nnonzero: int,
                    abcd=(0.25, 0.25, 0.25, 0.25), frac: float = 0.0,
                    add_edges: Optional[Callable] = None, device=None
                    ) -> Tuple[torch.Tensor, int]:
    """Regenerate until 2^nlevels * nnonzero unique edges exist (the
    reference RMAT command's cull loop, ``oink/rmat.cpp:46-60``), on the
    device.  Each round takes the first occurrence of every new edge of a
    full-size batch, in batch order, up to the number still missing.
    Returns (edges [n, 2] sorted by packed key, iterations)."""
    if nlevels > 32:
        raise ValueError("RMAT scale above 32 exceeds the u64 edge key")
    order = 1 << nlevels
    ntotal = order * nnonzero
    m = max(8, 1 << (ntotal - 1).bit_length())
    mask = order - 1
    root = prng.PRNGKey(seed)
    accepted = []
    naccepted = niterate = 0
    seen = torch.zeros(0, dtype=torch.int64, device=device)   # order keys
    while naccepted < ntotal:
        niterate += 1
        root, sub = prng.split(root)
        vi, vj = rmat_edges(sub, m, nlevels, abcd, frac, frac > 0.0, device)
        ok = order_key(vi.bitwise_left_shift_(nlevels).bitwise_or_(vj),
                       np.uint64)
        del vi, vj
        sok, perm = torch.sort(ok, stable=True)
        first = torch.ones_like(sok, dtype=torch.bool)
        first[1:] = sok[1:] != sok[:-1]
        uniq, first_idx = sok[first], perm[first]
        if seen.numel():
            pos = torch.searchsorted(seen, uniq).clamp_(max=seen.numel() - 1)
            fresh = seen[pos] != uniq
            uniq, first_idx = uniq[fresh], first_idx[fresh]
        take = uniq[torch.argsort(first_idx)][:ntotal - naccepted]
        accepted.append(take)
        naccepted += int(take.numel())
        seen = torch.sort(torch.cat([seen, take])).values
        if add_edges is not None:
            add_edges(_unpack(order_key(take, np.uint64), nlevels, mask))
    return _unpack(order_key(seen, np.uint64), nlevels, mask), niterate


def _unpack(keys: torch.Tensor, nlevels: int, mask: int) -> torch.Tensor:
    """Packed ``vi << nlevels | vj`` bit patterns → [n, 2] ids (masked
    after the shift: the sign bit of a packed key is a bit of vi)."""
    return torch.stack([(keys >> nlevels) & mask, keys & mask], 1)
