"""The port's group table (``ops/cuda/group.py``: the plain version of the
hand-written ``csrc/seg_table.cu``, and its epilogue) against the JAX
package's Pallas table kernel in interpret mode, on the same numpy
inputs.  Everything is integer: the outputs must be equal, and the
overflow count equal as a predicate (``> 0``), which is all the fuser
reads.

The CUDA kernel itself runs only on a card: ``test_seg_table_kernel``
carries the ``cuda`` marker and skips where there is none."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gpu_mapreduce_tpu.ops.pallas import group as jg
from gpu_mapreduce_tpu_torch.ops.bits import to_numpy, to_torch
from gpu_mapreduce_tpu_torch.ops.cuda import group as tg
from gpu_mapreduce_tpu_torch.ops.segment import table_to_groups

U64_MAX = np.iinfo(np.uint64).max


def _case(name, rng):
    """(keys, values, nvalid, gcap) for each named shape."""
    cap = 1024
    if name == "u64_top_bit":
        keys = (rng.integers(0, 150, cap).astype(np.uint64)
                * np.uint64(0x9E3779B97F4A7C15))
        vals = rng.integers(-(1 << 40), 1 << 40, cap).astype(np.int64)
        return keys, vals, 900, 256
    if name == "i32_wrapping":
        keys = rng.integers(-30, 30, cap).astype(np.int32)
        vals = rng.integers(-(1 << 30), 1 << 30, cap).astype(np.int32)
        vals[:40] = np.iinfo(np.int32).max           # sums wrap mod 2^32
        return keys, vals, cap, 64
    if name == "u32_as_int32":
        keys = rng.integers(0, 1 << 32, 40, dtype=np.uint64)[
            rng.integers(0, 40, cap)].astype(np.uint32)
        keys[:4] = [0, 1 << 31, (1 << 32) - 1, 7]
        vals = rng.integers(0, 1 << 32, cap, dtype=np.uint64).astype(
            np.uint32)
        return keys, vals, 700, 64
    if name == "zero_and_max":
        keys = rng.integers(1, 20, cap).astype(np.uint64)
        keys[::7] = 0
        keys[3::11] = U64_MAX
        vals = rng.integers(0, 1 << 62, cap, dtype=np.uint64)
        vals[::5] = U64_MAX                          # sums wrap mod 2^64
        return keys, vals, cap - 3, 32
    if name == "one_key":                            # every row one key
        keys = np.full(cap, 0xDEADBEEF12345678, np.uint64)
        vals = rng.integers(0, 1 << 64, cap, dtype=np.uint64)
        return keys, vals, cap, 8
    if name == "all_max":                  # every row the sentinel's value
        keys = np.full(cap, U64_MAX, np.uint64)
        vals = rng.integers(-(1 << 62), 1 << 62, cap).astype(np.int64)
        return keys, vals, cap - 5, 8
    if name == "half_max":
        keys = rng.integers(0, 300, cap).astype(np.uint64)
        keys[::2] = U64_MAX
        vals = rng.integers(0, 1 << 64, cap, dtype=np.uint64)
        return keys, vals, cap - 1, 512
    if name == "warp_runs":                 # runs of 32 equal keys (a warp)
        keys = np.repeat(rng.integers(0, 1 << 40, cap // 32,
                                      dtype=np.uint64), 32)
        vals = rng.integers(-(1 << 40), 1 << 40, cap).astype(np.int64)
        return keys, vals, cap - 7, 64
    if name == "beyond_front":   # more distinct keys than a front table
        pool = rng.integers(0, 1 << 64, 5000, dtype=np.uint64)
        pick = rng.permutation(np.concatenate(
            [np.arange(5000), rng.integers(0, 5000, 1000)]))
        vals = rng.integers(0, 1 << 32, 6000, dtype=np.uint64).astype(
            np.uint32)
        return pool[pick], vals, 6000, 8192
    if name == "u64_near_top":  # order keys near 2^63-1: 32-bit sort base
        keys = U64_MAX - rng.integers(1, 3000, cap).astype(np.uint64)
        vals = rng.integers(0, 1 << 64, cap, dtype=np.uint64)
        return keys, vals, cap, 1024
    if name == "i64_signed":              # negative int64 keys, 32-bit sort
        keys = rng.integers(-(1 << 30), 1 << 30, 300)[
            rng.integers(0, 300, cap)].astype(np.int64)
        vals = rng.integers(-(1 << 62), 1 << 62, cap).astype(np.int64)
        return keys, vals, cap - 2, 512
    raise KeyError(name)


def _jax(keys, vals, nvalid, gcap, op, T):
    out = jg.segment_group_reduce(jnp.asarray(keys), jnp.asarray(vals),
                                  jnp.int32(nvalid), gcap, op,
                                  ("tbl", T, 1024, True))
    return [np.asarray(x) for x in out]


def _port(keys, vals, nvalid, gcap, op, T):
    ukey, uval, g, overflow = tg.segment_group_reduce(
        to_torch(keys, "cpu"), to_torch(vals, "cpu"), nvalid, gcap, op,
        ("tbl", T), keys.dtype, vals.dtype)
    vdt = np.int64 if op == "count" else vals.dtype
    return to_numpy(ukey, keys.dtype), to_numpy(uval, vdt), g, overflow


CASES = ["u64_top_bit", "i32_wrapping", "u32_as_int32", "zero_and_max",
         "one_key", "all_max", "half_max", "warp_runs", "beyond_front",
         "u64_near_top", "i64_signed"]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("op", ["count", "sum"])
def test_segment_group_reduce_matches_jax(name, op):
    rng = np.random.default_rng(sum(map(ord, name)))
    keys, vals, nvalid, gcap = _case(name, rng)
    T = tg.table_slots(gcap)
    assert T == jg.table_slots(gcap)
    jk, jv, jgrp, jover = _jax(keys, vals, nvalid, gcap, op, T)
    pk, pv, pgrp, pover = _port(keys, vals, nvalid, gcap, op, T)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv, jv)
    assert pgrp == int(jgrp) == len(np.unique(keys[:nvalid]))
    assert pover == int(jover) == 0
    assert pk.dtype == jk.dtype and pv.dtype == jv.dtype


def test_overflow_is_the_same_predicate():
    """More distinct keys than slots: both count overflow (> 0); a table
    with room for every key counts none."""
    keys = np.arange(512, dtype=np.uint64) * np.uint64(7919)
    vals = np.ones(512, np.int64)
    for T, gcap in ((64, 64), (1024, 512)):
        jover = _jax(keys, vals, 512, gcap, "count", T)[3]
        pover = _port(keys, vals, 512, gcap, "count", T)[3]
        assert (pover > 0) == (int(jover) > 0) == (T < 512)


@pytest.mark.parametrize("dtype,values", [
    (np.uint32, [0, 1, 1 << 31, (1 << 32) - 1]),
    (np.int32, [0, -1, -(1 << 31), (1 << 31) - 1]),
    (np.uint64, [0, 1 << 63, U64_MAX, 12345]),
    (np.int64, [0, -1, -(1 << 63), (1 << 63) - 1]),
    (np.uint16, [0, 1, 1 << 15, (1 << 16) - 1]),
])
def test_split_and_join_limbs_match_jax(dtype, values):
    col = np.array(values, dtype=dtype)
    hi, lo = tg.split_limbs(to_torch(col, "cpu"), dtype)
    jhi, jlo = jg.split_limbs(jnp.asarray(col))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    back = tg.join_limbs(hi, lo, dtype)
    np.testing.assert_array_equal(to_numpy(back, dtype), col)
    np.testing.assert_array_equal(
        to_numpy(back, dtype), np.asarray(jg.join_limbs(jhi, jlo, dtype)))


@pytest.mark.parametrize("gcap", [0, 1, 8, 9, 1000, 1 << 25])
def test_table_slots_matches_jax(gcap):
    assert tg.table_slots(gcap) == jg.table_slots(gcap)


@pytest.mark.parametrize("raw,cpu_on", [(None, False), ("auto", False),
                                        ("1", True), ("0", False)])
def test_switch_reads_the_jax_variable(monkeypatch, raw, cpu_on):
    if raw is None:
        monkeypatch.delenv("MRTPU_PALLAS_GROUP", raising=False)
    else:
        monkeypatch.setenv("MRTPU_PALLAS_GROUP", raw)
    assert tg.table_group_enabled(torch.device("cpu")) is cpu_on
    assert jg.pallas_group_enabled() is cpu_on     # JAX on the CPU too
    assert tg.table_group_enabled(torch.device("cuda")) is (raw != "0")


def test_group_supported_matches_jax():
    from gpu_mapreduce_tpu_torch.interop import kv_from_numpy
    cases = [(np.uint64, np.int64, "kv", "count"),
             (np.int32, np.uint32, "kv", "sum"),
             (np.uint64, np.float32, "kv", "sum"),
             (np.uint64, np.int64, "kv", "max"),
             (np.uint64, np.int64, "kmv", None),
             (np.float64, np.int64, "kv", "count")]
    for kd, vd, kind, op in cases:
        k, v = np.zeros(8, kd), np.zeros(8, vd)
        got = tg.group_supported(kv_from_numpy(k, v, [8], "cpu"), kind, op)
        assert got == jg.group_supported(jnp.asarray(k), jnp.asarray(v),
                                         kind, op)


def test_plain_version_counts_no_launch_and_checks_inputs():
    """The plain version builds the kernel's layout (sentinel, side slot,
    meta slot, claimed list) without a launch; its groups read through
    the epilogue."""
    keys = torch.arange(10, dtype=torch.int64) % 3
    keys[0] = -1                                # key 2^64-1: the side slot
    before = tg.segment_table.launches
    table = tg.segment_table(keys, keys.clone(), 16)
    assert tg.segment_table.launches == before
    assert table.slots.shape == (18, 4) and table.sums.shape == (18,)
    skeys = tg.slot_keys(table.slots)
    assert int((skeys[:16] == tg.EMPTY).sum()) == 16 - 3
    assert table.slots[16].tolist() == [-1, -1, 1, 0]   # side: key, count 1
    assert table.slots[17, 2:].tolist() == [0, 4]       # no overflow, 4 groups
    assert sorted(table.claimed[:4].tolist())[-1] == 16
    for op, want in (("count", [3, 3, 3, 1]), ("sum", [0, 3, 6, -1])):
        ukey, uval, g, overflow = table_to_groups(table, 16, 8, op,
                                                  np.uint64, np.uint64)
        assert (g, overflow) == (4, 0)
        assert to_numpy(ukey, np.uint64).tolist() == [0, 1, 2, U64_MAX] \
            + [0] * 4
        assert uval.tolist() == want + [0] * 4
    with pytest.raises(ValueError):
        tg.segment_table(keys.to(torch.int32), None, 16)
    with pytest.raises(ValueError):
        tg.segment_table(keys, None, 12)              # not a power of two
    with pytest.raises(ValueError):
        tg.segment_table(keys, keys[:5].clone(), 16)  # shapes differ


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("op", ["count", "sum"])
def test_seg_table_kernel(cuda_device, name, op):
    rng = np.random.default_rng(5)
    keys, vals, nvalid, gcap = _case(name, rng)
    T = tg.table_slots(gcap)
    dev = [tg.segment_group_reduce(to_torch(keys, d), to_torch(vals, d),
                                   nvalid, gcap, op, ("tbl", T), keys.dtype,
                                   vals.dtype) for d in ("cpu", cuda_device)]
    torch.cuda.synchronize()
    for a, b in zip(dev[0][:2], dev[1][:2]):
        assert torch.equal(a, b.cpu())
    assert dev[0][2:] == dev[1][2:]
