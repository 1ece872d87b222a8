"""The exact wire codec of the exchange (JAX ``parallel/wire.py``).

The two-phase exchange (``shuffle.py``) would move full-width keys and
values.  The codec narrows them and stays byte-exact:

* **delta-packed columns** — phase 1 records each per-destination
  bucket's key and value minimum and maximum (:func:`bucket_stats`,
  pulled with the count matrix: one sync); phase 2 sends ``col -
  base[dest]`` at the narrowest unsigned width holding the largest
  bucket range mesh-wide, and the destination adds the source's base
  back (:func:`encode`, :func:`decode`).  Integer subtract and add
  round-trip exactly mod 2^width, so the decoded block is the raw
  path's byte for byte;
* **tiered bucket caps** (:func:`plan_tiers`) — a descending ladder of
  power-of-two round caps hugging the largest bucket.  The port's phase
  2 copies exact per-(source, destination) slices, so the ladder pads
  no round here; it still decides the plan tuple, :func:`plan_holds`,
  the pad accounting and the telemetry, exactly as JAX.

Everything is decided on the host from the pulled count and stats
matrices (:func:`plan_from_pull`, one copy shared by the eager exchange
and the fuser).  A plan is JAX's hashable tagged tuple: ``("wire",
tiers, cap_out, kpack, vpack)`` or ``("raw", B, nrounds, cap_out)``;
the planner bypasses the codec (a raw plan) when it would not undercut
the raw program's bytes.  ``MRTPU_WIRE=0`` gives the raw path.

Torch has no unsigned 16/32/64-bit arithmetic: a column is handled as
int64 lanes (``ops/bits.widen64``), unsigned u64 compares through
``ops/bits.unsigned_order_key``, and a pack travels in the signed
storage type of its width (``uint16`` as int16 bits).  The planning
functions take column *specs* (:func:`col_spec`: an empty numpy array
with the column's row shape and logical dtype), so they read the same
``ndim``/``dtype``/``itemsize`` the JAX functions read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.bits import narrow64, storage_dtype, unsigned_order_key, widen64
from .sharded import narrowest_uint, round_cap

_META_COLS = 3             # count, kbase, vbase exchanged per bucket
_MAX_ROUNDS = 16           # the JAX schedule's round bound
_MAX_TIERS = 16            # same bound as _MAX_ROUNDS

_BLOCK = 1024              # rows a block of the bucket min/max reduction
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def wire_enabled() -> bool:
    """``MRTPU_WIRE`` (default on; ``0`` = raw exchange), read at call
    time."""
    from ..utils.env import env_flag
    return env_flag("MRTPU_WIRE", True)


def col_spec(t: torch.Tensor, dtype) -> np.ndarray:
    """A column's row shape and logical dtype, as an empty numpy array
    (what the planning functions read)."""
    return np.empty((0,) + tuple(t.shape[1:]), np.dtype(dtype))


def col_eligible(arr) -> bool:
    """A column the codec can delta-pack: 1-D integer rows wider than a
    byte.  Multi-word keys, floats and 1-byte riders ship raw (the
    tiered caps still apply to them)."""
    return (arr.ndim == 1 and arr.dtype.kind in "iu"
            and arr.dtype.itemsize >= 2)


def columns_eligible(key, value) -> Tuple[bool, bool]:
    return (col_eligible(key), col_eligible(value))


# ---------------------------------------------------------------------------
# phase-1 side: per-destination bucket stats, on the shard's device
# ---------------------------------------------------------------------------

def _order_native(col: torch.Tensor, dtype) -> torch.Tensor:
    """The column in its own storage width, mapped so that its signed
    order is the logical order: a signed column as it is, an unsigned
    one with its top bit flipped."""
    if np.dtype(dtype).kind != "u":
        return col
    return col ^ -(1 << (8 * col.element_size() - 1))


def _bits64(r: torch.Tensor, dtype) -> torch.Tensor:
    """Reduced values in :func:`_order_native`'s domain → the 64-bit bit
    patterns of their logical values (JAX ``_widen`` then a bitcast)."""
    return widen64(_order_native(r, dtype), dtype)


def _minmax(col: torch.Tensor, dtype, dest: torch.Tensor, row: torch.Tensor,
            nprocs: int):
    """Per-destination (min, max) of rows sorted by destination, as
    64-bit bit patterns; an empty bucket (``row[d] == 0``) keeps JAX's
    sentinels (the widened dtype's max and min).  The rows reduce in
    their own width: each full block of ``_BLOCK`` rows inside one
    bucket to its min and max; the rows of the blocks where a bucket
    starts, and of the last partial block, go in row by row.  Both
    scatter into P slots (min and max do not mind a row seen twice): a
    few thousand updates, never one a row on P hot addresses."""
    x = _order_native(col, dtype)
    n = x.shape[0]
    mn = torch.full((nprocs + 1,), _I64_MAX, dtype=torch.int64,
                    device=x.device)
    mx = torch.full((nprocs + 1,), _I64_MIN, dtype=torch.int64,
                    device=x.device)
    if n:
        B = _BLOCK
        nb = n // B
        if nb:
            blk = x[:nb * B].view(nb, B)
            first, last = dest[0:nb * B:B], dest[B - 1:nb * B:B]
            tgt = torch.where(first == last, first, nprocs)
            mn.scatter_reduce_(0, tgt, blk.amin(1).to(torch.int64), "amin")
            mx.scatter_reduce_(0, tgt, blk.amax(1).to(torch.int64), "amax")
        starts = torch.searchsorted(
            dest, torch.arange(1, nprocs, device=dest.device))
        edge = torch.cat([starts // B, starts.new_full((1,), nb)])
        rows = (edge[:, None] * B + torch.arange(B, device=dest.device)
                ).clamp_(max=n - 1).reshape(-1)
        xr = x[rows].to(torch.int64)
        mn.scatter_reduce_(0, dest[rows], xr, "amin")
        mx.scatter_reduce_(0, dest[rows], xr, "amax")
    # back to the column's width (every reduced value is one of its
    # values), then to 64-bit bit patterns
    mn = _bits64(mn[:nprocs].to(x.dtype), dtype)
    mx = _bits64(mx[:nprocs].to(x.dtype), dtype)
    unsigned = np.dtype(dtype).kind == "u"
    empty = row == 0
    mn = torch.where(empty, -1 if unsigned else _I64_MAX, mn)
    mx = torch.where(empty, 0 if unsigned else _I64_MIN, mx)
    return mn, mx


def bucket_stats(nprocs: int, key, value, dest, row, key_dtype,
                 value_dtype, elig) -> torch.Tensor:
    """Per-destination (kmin, kmax, vmin, vmax) of one shard's valid rows,
    sorted by destination (``dest``, int64; ``row`` the rows per
    destination), as ``[P, 4]`` int64 bit patterns (JAX
    ``bucket_stats``); columns not eligible give zeros."""
    zero = torch.zeros(nprocs, dtype=torch.int64, device=key.device)
    kmn, kmx = _minmax(key, key_dtype, dest, row, nprocs) if elig[0] \
        else (zero, zero)
    vmn, vmx = _minmax(value, value_dtype, dest, row, nprocs) if elig[1] \
        else (zero, zero)
    return torch.stack([kmn, kmx, vmn, vmx], dim=1)


# ---------------------------------------------------------------------------
# encode / decode, on int64 lanes
# ---------------------------------------------------------------------------

def pack_dtype(pack: str) -> torch.dtype:
    """The torch dtype a pack travels in (``uint16``/``uint32`` as the
    signed type of their width).  A pack name the codec does not know
    raises."""
    if pack not in ("uint8", "uint16", "uint32"):
        raise ValueError(f"unknown wire pack {pack!r}")
    return storage_dtype(np.dtype(pack))


def encode(col: torch.Tensor, dtype, base: torch.Tensor, dest: torch.Tensor,
           pack: str) -> torch.Tensor:
    """``col - base[dest]`` in the pack's width (exact mod 2^width).
    ``base`` holds a 64-bit bit pattern a destination; rows whose range
    the plan did not cover carry garbage the caller never keeps."""
    out = pack_dtype(pack)
    if np.dtype(pack).itemsize < 4:
        # mod 2^w in the pack's own width: a narrowing cast wraps, and a
        # uint8/int16 difference is taken in int before it is stored
        return col.to(out) - base.to(out)[dest]
    return (widen64(col, dtype) - base[dest]).to(out)


def decode(packed: torch.Tensor, dtype, base: torch.Tensor,
           src: torch.Tensor, pack: str) -> torch.Tensor:
    """``base[src] + delta`` back in the column's storage dtype.  ``base``
    holds P + 1 bit patterns, the last 0: rows past the valid prefix
    carry ``src == P`` and a zero delta, so they decode to 0 and the
    block equals the raw path's output."""
    if np.dtype(dtype).itemsize == 2:
        # a 16-bit column's pack is uint8: its sum is taken in int (no
        # overflow) and wraps as it is stored
        return packed.to(storage_dtype(dtype)) + narrow64(base, dtype)[src]
    full = packed.to(torch.int64)
    if packed.dtype != torch.uint8:       # undo the sign extension
        full &= (1 << (8 * np.dtype(pack).itemsize)) - 1
    full += base[src]
    return narrow64(full, dtype)


def with_zero(base: torch.Tensor) -> torch.Tensor:
    """A ``[P]`` base vector with a zero appended (``decode``'s base)."""
    return torch.cat([base, base.new_zeros(1)])


# ---------------------------------------------------------------------------
# host-side planning (from the pulled count + stats matrices)
# ---------------------------------------------------------------------------

def _plan_caps(counts_mat: np.ndarray):
    """(B, nrounds, cap_out, Bmax, new_counts) from the count matrix: the
    JAX exchange pads buckets to about the mean nonzero bucket, in at
    most ``_MAX_ROUNDS`` rounds; the output cap is the power of two over
    the largest destination's rows."""
    Bmax = round_cap(int(counts_mat.max())) if counts_mat.max() else 8
    new_counts = counts_mat.sum(axis=0).astype(np.int32)
    cap_out = round_cap(int(new_counts.max())) if new_counts.max() else 8
    nz = counts_mat[counts_mat > 0]
    B = round_cap(int(np.ceil(nz.mean()))) if len(nz) else 8
    nrounds = -(-Bmax // B)
    if nrounds > _MAX_ROUNDS:
        nrounds = _MAX_ROUNDS
        B = round_cap(-(-Bmax // nrounds))
        nrounds = -(-Bmax // B)
    return B, nrounds, cap_out, Bmax, new_counts


def plan_tiers(counts_mat: np.ndarray, B: int, nrounds: int
               ) -> Tuple[int, ...]:
    """The round-cap schedule: a descending power-of-two ladder whose
    sum covers the max bucket with ≲6% overshoot plus one quantization
    unit of headroom (JAX :120-160), or the uniform ``(B,) * nrounds``
    when the ladder would not strictly reduce slots or would balloon
    the round count (tiny exchanges)."""
    uniform = (B,) * nrounds
    bmax = int(counts_mat.max()) if counts_mat.size else 0
    if bmax < 64:
        return uniform
    unit = 1 << max(0, bmax.bit_length() - 4)
    q = -(-bmax // unit) * unit + unit
    bbuf = round_cap(max(-(-q // 4), 8))
    tiers = []
    remaining = q
    while remaining > 0 and len(tiers) < _MAX_TIERS - 1:
        step = min(bbuf, round_cap(remaining))
        tiers.append(step)
        remaining -= step
    if remaining > 0:
        tiers.append(round_cap(remaining))
    tiers = tuple(tiers)
    if sum(tiers) >= B * nrounds or len(tiers) > max(nrounds + 2, 6):
        return uniform
    return tiers


def _bucket_ranges(counts_mat: np.ndarray, stats_mat: np.ndarray,
                   lo_col: int, hi_col: int, signed: bool
                   ) -> Optional[int]:
    """Largest (max - min) over nonempty buckets, as a python int, or
    None when every bucket is empty."""
    mask = counts_mat > 0
    if not mask.any():
        return None
    view = stats_mat.view(np.int64) if signed else \
        stats_mat.view(np.uint64)
    lo = view[:, :, lo_col][mask]
    hi = view[:, :, hi_col][mask]
    return max(int(h) - int(lo_) for lo_, h in zip(lo.tolist(),
                                                   hi.tolist()))


def _pack_for(rng: Optional[int], itemsize: int) -> Optional[str]:
    """Narrowest unsigned dtype (strictly narrower than the column)
    whose capacity holds ``rng``; None = ship raw."""
    if rng is None:
        return None
    name, width = narrowest_uint(rng)
    return name if width < itemsize else None


def plan_packs(key, value, counts_mat: np.ndarray,
               stats_mat: Optional[np.ndarray], elig):
    """(kpack, vpack, kvrange): wire dtypes per column (None = raw) and
    the observed max bucket ranges (speculation-validity evidence)."""
    kpack = vpack = None
    krange = vrange = None
    if stats_mat is not None:
        if elig[0]:
            krange = _bucket_ranges(counts_mat, stats_mat, 0, 1,
                                    key.dtype.kind == "i")
            kpack = _pack_for(krange, key.dtype.itemsize)
        if elig[1]:
            vrange = _bucket_ranges(counts_mat, stats_mat, 2, 3,
                                    value.dtype.kind == "i")
            vpack = _pack_for(vrange, value.dtype.itemsize)
    return kpack, vpack, (krange, vrange)


def make_plan(key, value, counts_mat: np.ndarray,
              stats_mat: Optional[np.ndarray], elig, B: int,
              nrounds: int, cap_out: int):
    """``(plan, kvrange)``: ``("wire", tiers, cap_out, kpack, vpack)``,
    or the auto-bypass ``("raw", B, nrounds, cap_out)`` when the codec's
    total per-pair bytes (tier slots at packed width + the [P, 3] u64
    metadata block) would not undercut the raw program's (uniform slots
    at full width + its int32 counts block)."""
    tiers = plan_tiers(counts_mat, B, nrounds)
    kpack, vpack, kvrange = plan_packs(key, value, counts_mat,
                                       stats_mat, elig)
    rb_full = _col_rowbytes(key, None) + _col_rowbytes(value, None)
    rb_packed = _col_rowbytes(key, kpack) + _col_rowbytes(value, vpack)
    wire_per_pair = sum(tiers) * rb_packed + _META_COLS * 8
    raw_per_pair = B * nrounds * rb_full + 4
    if wire_per_pair >= raw_per_pair:
        return ("raw", B, nrounds, cap_out), kvrange
    return ("wire", tiers, cap_out, kpack, vpack), kvrange


def _pack_capacity(pack: Optional[str]) -> Optional[int]:
    if pack is None:
        return None
    return (1 << (8 * np.dtype(pack).itemsize)) - 1


def _pack_covers(spec_pack: Optional[str], rng: Optional[int]) -> bool:
    """A cached plan's pack still round-trips the fresh data: raw always
    does; a narrow pack needs the fresh range to fit."""
    if spec_pack is None or rng is None:
        return True
    return rng <= _pack_capacity(spec_pack)


def plan_slots(plan) -> int:
    """Per-bucket slots the plan's schedule exchanges (the pad
    accounting input)."""
    if plan[0] == "wire":
        return int(sum(plan[1]))
    return int(plan[1] * plan[2])


def plan_rounds(plan) -> Tuple[int, int]:
    """(bucket_cap, nrounds) for telemetry: the largest tier stands in
    for the uniform B under a wire plan."""
    if plan[0] == "wire":
        return int(max(plan[1])), len(plan[1])
    return int(plan[1]), int(plan[2])


def plan_cap_out(plan) -> int:
    return int(plan[2] if plan[0] == "wire" else plan[3])


def plan_holds(plan, bmax: int, nmax_out: int, kvrange) -> bool:
    """A cached plan still delivers every row exactly: its slots cover
    the largest bucket, its cap the largest destination, and (wire
    plans) its pack widths the fresh bucket ranges."""
    if plan_slots(plan) < bmax or plan_cap_out(plan) < nmax_out:
        return False
    if plan[0] == "wire":
        return (_pack_covers(plan[3], kvrange[0])
                and _pack_covers(plan[4], kvrange[1]))
    return True


def plan_oversized(plan, bmax: int, nmax_out: int) -> bool:
    """Whether a cached plan is ≥ 4× too large for this count matrix
    (the right-sizing rule of the speculative caps and the fuser)."""
    return (plan_slots(plan) > 4 * max(bmax, 8)
            or plan_cap_out(plan) > 4 * round_cap(nmax_out))


def plan_from_pull(key, value, counts_mat: np.ndarray,
                   stats_mat: Optional[np.ndarray], wire_on: bool, elig):
    """The one host planning step of the eager exchange and the fuser:
    the pulled matrices → ``(plan, kvrange, bmax_raw, nmax_out,
    new_counts)``.  ``key``/``value`` are column specs
    (:func:`col_spec`); ``bmax_raw`` and ``nmax_out`` are the bounds a
    cached plan is held against."""
    B, nrounds, cap_out, _bmax, new_counts = _plan_caps(counts_mat)
    bmax_raw = int(counts_mat.max())
    nmax_out = max(int(new_counts.max()), 8)
    if wire_on:
        plan, kvrange = make_plan(key, value, counts_mat, stats_mat,
                                  elig, B, nrounds, cap_out)
    else:
        plan, kvrange = ("raw", B, nrounds, cap_out), (None, None)
    return plan, kvrange, bmax_raw, nmax_out, new_counts


def wire_ratio(moved: int, pad: int, wire_bytes: int) -> float:
    """The logical/actual compression ratio (0.0 = the codec did not
    run)."""
    return round((moved + pad) / wire_bytes, 4) if wire_bytes else 0.0


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------

def _col_rowbytes(arr, pack: Optional[str]) -> int:
    if pack is not None:
        return np.dtype(pack).itemsize
    return arr.dtype.itemsize * (arr.shape[-1] if arr.ndim > 1 else 1)


def wire_volume(key, value, counts_mat: np.ndarray, plan) -> int:
    """Bytes a ``("wire", ...)`` plan's schedule puts between shards:
    every slot (useful + pad, the diagonal excluded) at the packed row
    width, plus the ``[P, 3]`` u64 per-bucket metadata block."""
    nprocs = counts_mat.shape[0]
    _tag, tiers, _cap_out, kpack, vpack = plan
    rowbytes = _col_rowbytes(key, kpack) + _col_rowbytes(value, vpack)
    slots = nprocs * (nprocs - 1) * int(sum(tiers))
    meta = nprocs * (nprocs - 1) * _META_COLS * 8
    return slots * rowbytes + meta
