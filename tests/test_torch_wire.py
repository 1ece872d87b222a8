"""The exchange as the JAX package runs it by default — the wire codec
(``parallel/wire.py``) and the speculative plan cache — against the
port's, with ``MRTPU_WIRE`` unset in both packages and both caches live.

Every planning function is held against JAX's on seeded count and stats
matrices (hypothesis where it fits); ``bucket_stats`` and the
encode/decode pair against JAX's on seeded columns.  Then the eager
exchange on ``make_mesh(3)`` and ``make_mesh(8)`` for u64 keys holding
2^63+3 and 2^64-1, int32 keys with negative int64 values, ``[n, 2]``
keys (not eligible: the tiers only), empty and 2-row frames: the same
padded blocks, caps, counts and ``exchange_stats`` (nrounds, bucket,
cap_out, rows, speculative, sent/pad/wire bytes, wire_ratio).  A
sequence of exchanges of one shape speculates as JAX's does, a wider
distribution fails ``plan_holds`` and re-runs; the fused exchange group
cold and warm and ``mr.reshard`` 3 → 2 → 5 run under the codec as
JAX's.  Both caches are cleared at the start of each test."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.core.column import DenseColumn as JDense
from gpu_mapreduce_tpu.core.frame import KVFrame as JKVFrame
from gpu_mapreduce_tpu.ops import reduces as jr
from gpu_mapreduce_tpu.parallel import shuffle as jshuffle
from gpu_mapreduce_tpu.parallel import wire as jwire
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.parallel.sharded import narrowest_uint as j_narrowest
from gpu_mapreduce_tpu.parallel.sharded import shard_frame as j_shard
from gpu_mapreduce_tpu.plan import plan_cache as j_plan_cache
from gpu_mapreduce_tpu.plan import plan_history as j_plan_history
from gpu_mapreduce_tpu_torch import MapReduce
from gpu_mapreduce_tpu_torch.core.frame import KVFrame
from gpu_mapreduce_tpu_torch.ops import reduces as tr
from gpu_mapreduce_tpu_torch.ops.bits import to_numpy, to_torch
from gpu_mapreduce_tpu_torch.parallel import shuffle as tshuffle
from gpu_mapreduce_tpu_torch.parallel import wire as twire
from gpu_mapreduce_tpu_torch.parallel.sharded import (narrowest_uint,
                                                      shard_frame_mesh)
from gpu_mapreduce_tpu_torch.plan import plan_cache, plan_history

from test_torch_parallel import one, same_kv, tmesh

STATS_FIELDS = ("nrounds", "bucket", "cap_out", "rows", "speculative",
                "sent_bytes", "pad_bytes", "wire_bytes", "wire_ratio")


@pytest.fixture(autouse=True)
def codec_on(monkeypatch):
    """The packages' defaults: the codec on, both caches live and
    empty."""
    monkeypatch.delenv("MRTPU_WIRE", raising=False)
    monkeypatch.delenv("MRTPU_FUSE", raising=False)
    monkeypatch.setattr(jshuffle, "_SPEC_CACHE", {})
    monkeypatch.setattr(tshuffle, "_SPEC_CACHE", {})


def _stats(s):
    return tuple(getattr(s, f) for f in STATS_FIELDS)


def _jax_blocks(fr):
    P, cap = fr.nprocs, fr.cap
    return (np.asarray(fr.key).reshape((P, cap) + fr.key.shape[1:]),
            np.asarray(fr.value).reshape((P, cap) + fr.value.shape[1:]))


def same_exchange(jout, tout):
    """Blocks (padding included), caps, counts and telemetry equal."""
    assert tout.cap == jout.cap
    assert tout.counts.tolist() == jout.counts.tolist()
    assert _stats(tout.exchange_stats) == _stats(jout.exchange_stats)
    jk, jv = _jax_blocks(jout)
    for p, s in enumerate(tout.shards):
        k = to_numpy(s.key, tout.key_dtype)
        v = to_numpy(s.value, tout.value_dtype)
        assert k.dtype == jk.dtype and v.dtype == jv.dtype
        np.testing.assert_array_equal(k, jk[p], err_msg=f"keys {p}")
        np.testing.assert_array_equal(v, jv[p], err_msg=f"values {p}")


def run_both(keys, vals, P, dest=("hash", None), tdest=None, transport=1):
    jout = jshuffle.exchange(
        j_shard(JKVFrame(JDense(keys), JDense(vals)), j_make_mesh(P)),
        dest, transport=transport)
    tout = tshuffle.exchange(
        shard_frame_mesh(KVFrame(keys, vals), tmesh(P)), tdest or dest,
        transport=transport)
    return jout, tout


# -- the planning functions ---------------------------------------------------

def _matrices(rng, P, scale, signed):
    """A count matrix (some buckets empty) and its stats, u64 bit
    patterns in JAX's dtype and int64 in the port's."""
    counts = rng.integers(0, scale + 1, (P, P)).astype(np.int32)
    counts[rng.random((P, P)) < 0.2] = 0
    lo = rng.integers(-(1 << 40) if signed else 0, 1 << 40, (P, P, 2))
    width = rng.integers(0, 1 << rng.integers(1, 40), (P, P, 2))
    stats = np.stack([lo[..., 0], lo[..., 0] + width[..., 0],
                      lo[..., 1], lo[..., 1] + width[..., 1]],
                     axis=-1).astype(np.int64)
    return counts, stats


@settings(max_examples=60, deadline=None)
@given(P=st.integers(1, 8), scale=st.sampled_from([0, 5, 63, 64, 700,
                                                    1 << 16]),
       seed=st.integers(0, 1 << 30), signed=st.booleans())
def test_planning_matches_jax(P, scale, seed, signed):
    """_plan_caps, plan_tiers, the bucket ranges and packs, make_plan,
    plan_from_pull (codec on and off), the slot, round and cap readers,
    plan_holds against fresh matrices, plan_oversized and wire_volume:
    equal to JAX's."""
    rng = np.random.default_rng(seed)
    counts, stats = _matrices(rng, P, scale, signed)
    counts2, stats2 = _matrices(rng, P, scale, signed)
    kdt = np.int64 if signed else np.uint64
    key = np.zeros(0, kdt)
    for value in (np.zeros(0, np.int32), np.zeros((0, 2), np.uint64),
                  np.zeros(0, np.uint8)):
        jel = jwire.columns_eligible(key, value)
        assert twire.columns_eligible(key, value) == jel
        for on in (True, False):
            j = jwire.plan_from_pull(key, value, counts, stats.view(
                np.uint64), on, jel)
            t = twire.plan_from_pull(key, value, counts, stats, on, jel)
            assert t[:4] == j[:4]
            np.testing.assert_array_equal(t[4], j[4])
            plan = t[0]
            assert twire.plan_slots(plan) == jwire.plan_slots(plan)
            assert twire.plan_rounds(plan) == jwire.plan_rounds(plan)
            assert twire.plan_cap_out(plan) == jwire.plan_cap_out(plan)
            fresh = twire.plan_from_pull(key, value, counts2, stats2, on,
                                         jel)
            assert twire.plan_holds(plan, *fresh[2:4], fresh[1]) == \
                jwire.plan_holds(plan, *fresh[2:4], fresh[1])
            assert twire.plan_oversized(plan, *fresh[2:4]) == \
                jwire.plan_oversized(plan, *fresh[2:4])
            if plan[0] == "wire":
                class _Skv:
                    pass
                skv = _Skv()
                skv.key, skv.value = key, value
                assert twire.wire_volume(key, value, counts, plan) == \
                    jwire.wire_volume(skv, counts, plan)
        B, nr, cap_out, bm, _ = twire._plan_caps(counts)
        assert (B, nr, cap_out, bm) == jshuffle._plan_caps(counts)[:4]
        assert twire.plan_tiers(counts, B, nr) == \
            jwire.plan_tiers(counts, B, nr)


def test_small_helpers_match_jax(monkeypatch):
    for m in (0, 1, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
              (1 << 64) - 1):
        assert narrowest_uint(m) == j_narrowest(m)
        for size in (1, 2, 4, 8):
            assert twire._pack_for(m, size) == jwire._pack_for(m, size)
    assert twire._pack_for(None, 8) is None
    for moved, pad, wb in ((0, 0, 0), (100, 28, 40), (7, 0, 3)):
        assert twire.wire_ratio(moved, pad, wb) == \
            jwire.wire_ratio(moved, pad, wb)
    for arr in (np.zeros(0, np.uint8), np.zeros(0, np.int16),
                np.zeros(0, np.float64), np.zeros((0, 2), np.uint64),
                np.zeros(0, np.uint64)):
        assert twire.col_eligible(arr) == jwire.col_eligible(arr)
    monkeypatch.setenv("MRTPU_WIRE", "0")
    assert twire.wire_enabled() is jwire.wire_enabled() is False
    monkeypatch.setenv("MRTPU_WIRE", "1")
    assert twire.wire_enabled() is jwire.wire_enabled() is True


@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.uint32,
                                   np.int32, np.uint16, np.int16])
def test_bucket_stats_and_codec_match_jax(dtype):
    """Per-destination min/max (empty buckets keep JAX's sentinels),
    then the encode/decode round trip at the narrowest pack, equal to
    JAX's bit for bit."""
    P, n = 5, 400
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype)
    col = rng.integers(info.min, info.max, n, dtype=np.int64,
                       endpoint=False).astype(dtype) \
        if info.bits < 64 else rng.integers(info.min, info.max, n,
                                            dtype=dtype, endpoint=True)
    col[::9] = info.max
    col[::11] = info.min
    # sorted by destination, as phase 1 gives them; bucket P-1 stays empty
    dest = np.sort(rng.integers(0, P - 1, n))
    valid = n - 17                              # a padding tail
    jdest = np.where(np.arange(n) < valid, dest, P)
    want = np.asarray(jwire.bucket_stats(P, jnp.asarray(col),
                                         jnp.asarray(col),
                                         jnp.asarray(jdest, jnp.int32),
                                         True, True))
    got = twire.bucket_stats(P, to_torch(col[:valid], "cpu"),
                             to_torch(col[:valid], "cpu"),
                             torch.from_numpy(dest[:valid]),
                             torch.from_numpy(np.bincount(dest[:valid],
                                                          minlength=P)),
                             dtype, dtype, (True, True))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    # a narrow range a bucket: encode against the bucket's min
    small = (col.astype(np.int64) % 3000).astype(dtype) if \
        np.dtype(dtype).kind == "i" else (col % 3000).astype(dtype)
    st_small = twire.bucket_stats(P, to_torch(small, "cpu"),
                                  to_torch(small, "cpu"),
                                  torch.from_numpy(dest),
                                  torch.from_numpy(np.bincount(
                                      dest, minlength=P)),
                                  dtype, dtype, (True, True))
    base = st_small[:, 0]
    pack = "uint16"
    enc = twire.encode(to_torch(small, "cpu"), dtype, base,
                       torch.from_numpy(dest), pack)
    jenc = np.asarray(jwire._encode_col(
        jnp.asarray(small), jnp.asarray(base.numpy().view(np.uint64)),
        jnp.asarray(dest), pack))
    np.testing.assert_array_equal(enc.numpy().view(np.uint16), jenc)
    valid_m = torch.arange(n) < valid
    # rows past the valid prefix: source P (a zero base) and no delta
    enc[valid:] = 0
    dec = twire.decode(enc, dtype, twire.with_zero(base),
                       torch.from_numpy(np.where(np.arange(n) < valid, dest,
                                                 P)), pack)
    jdec = np.asarray(jwire._decode_col(
        jnp.asarray(jenc), jnp.asarray(base.numpy().view(np.uint64)),
        jnp.asarray(dest), jnp.asarray(valid_m.numpy()), dtype))
    np.testing.assert_array_equal(to_numpy(dec, dtype), jdec)
    np.testing.assert_array_equal(to_numpy(dec, dtype)[:valid],
                                  small[:valid])
    assert not to_numpy(dec, dtype)[valid:].any()
    with pytest.raises(ValueError, match="pack"):
        twire.encode(to_torch(small, "cpu"), dtype, base,
                     torch.from_numpy(dest), "uint64")


@pytest.mark.parametrize("sizes", [[1024, 1024, 0, 2100], [5, 0, 0, 3],
                                   [0, 3000, 1, 2047], [4096], [0, 0, 0, 0],
                                   [1023, 1, 1025, 2]])
def test_bucket_minmax_blocks(sizes):
    """The block-wise bucket min/max over rows sorted by destination
    (buckets starting on, before and after a block edge, empty buckets,
    a partial last block) against numpy, u64 and int64."""
    P = len(sizes)
    rng = np.random.default_rng(sum(sizes))
    dest = np.repeat(np.arange(P), sizes)
    for dtype in (np.uint64, np.int64, np.uint32, np.int16):
        info = np.iinfo(dtype)
        col = rng.integers(info.min, info.max, len(dest), dtype=dtype,
                           endpoint=True)
        st = twire.bucket_stats(P, to_torch(col, "cpu"), to_torch(col, "cpu"),
                                torch.from_numpy(dest),
                                torch.tensor(sizes), dtype, dtype,
                                (True, False)).numpy().view(np.uint64)
        for d in range(P):
            rows = col[dest == d]
            # JAX widens to 64 bits (unsigned zero-, signed sign-extended);
            # an empty bucket keeps the 64-bit kind's max and min
            wide = np.uint64 if info.kind == "u" else np.int64
            want = np.array((rows.min(), rows.max()), dtype).astype(wide) \
                if len(rows) else np.array((np.iinfo(wide).max,
                                            np.iinfo(wide).min), wide)
            want = want.view(np.uint64)
            assert st[d, :2].tolist() == want.tolist(), (dtype, d)
        assert not st[:, 2:].any()


# -- the eager exchange under the codec ---------------------------------------

def _case(name, rng):
    n = 3000
    if name == "u64":
        k = rng.integers(0, 1 << 20, n).astype(np.uint64)
        k[::5] = (1 << 64) - 1
        k[::7] = (1 << 63) + 3
        return k, rng.integers(0, 1 << 12, n).astype(np.int64)
    if name == "i32_neg":
        return (rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32),
                rng.integers(-5000, 0, n).astype(np.int64))
    if name == "i16_small":          # 16-bit keys in a uint8 pack
        return (rng.integers(-100, 100, n).astype(np.int16),
                rng.integers(0, 60000, n).astype(np.uint16))
    if name == "wide_keys":
        return (rng.integers(0, 1 << 64, (n, 2), dtype=np.uint64),
                rng.integers(0, 1000, n).astype(np.uint32))
    if name == "empty":
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return (np.array([(1 << 64) - 1, 5], np.uint64),
            np.array([-3, 7], np.int64))


@pytest.mark.parametrize("P", [3, 8])
@pytest.mark.parametrize("case", ["u64", "i32_neg", "i16_small",
                                  "wide_keys", "empty", "two_rows"])
def test_exchange_under_codec_matches_jax(case, P):
    keys, vals = _case(case, np.random.default_rng(P))
    jout, tout = run_both(keys, vals, P)
    same_exchange(jout, tout)
    s = tout.exchange_stats
    if case in ("u64", "i32_neg", "i16_small"):
        assert s.wire_ratio > 1 and s.wire_bytes > 0
    if case == "wide_keys":
        # keys ship raw; the u32 values narrow
        assert s.wire_bytes == 0 or s.wire_ratio > 0


@pytest.mark.parametrize("P,transport", [(3, 1), (8, 0)])
def test_speculation_sequence_matches_jax(P, transport):
    """Three exchanges of one shape (the second and third keep the
    speculative result), then a wider key range of the same shape: the
    cached pack no longer holds it, so phase 2 re-runs — every step
    equal to JAX's, ``speculative`` and ``cap_out`` included."""
    rng = np.random.default_rng(21)
    n = 4000
    flags = []
    for step in range(4):
        span = 1 << (12 if step < 3 else 40)
        keys = rng.integers(0, span, n).astype(np.uint64)
        vals = rng.integers(0, 100, n).astype(np.uint32)
        jout, tout = run_both(keys, vals, P, transport=transport)
        same_exchange(jout, tout)
        flags.append(tout.exchange_stats.speculative)
    assert flags == [False, True, True, False]


def _jax_low32(k):
    return k.astype(np.uint32)


def _port_low32(k):
    return k & 0xFFFFFFFF


def test_speculation_keeps_the_larger_cap():
    """Every row to shard 0, then spread rows of the same shape: the
    cached plan still holds, so both packages keep its larger cap_out
    (the same rows, another cap) and no phase 2 re-runs."""
    n, P = 3000, 3
    runs = []
    for keys in (3 * np.arange(n, dtype=np.uint64),
                 np.arange(n, dtype=np.uint64),
                 np.arange(n, dtype=np.uint64)):
        jout, tout = run_both(keys, np.ones(n, np.int64), P,
                              dest=("hash", _jax_low32),
                              tdest=("hash", _port_low32))
        same_exchange(jout, tout)
        runs.append((tout.cap, tout.exchange_stats.speculative))
    assert runs == [(4096, False), (4096, True), (4096, True)]


def test_speculation_past_its_cap_is_rerun():
    """Spread rows, then every row to shard 0 in the same shape: the
    cached cap_out is too small to hold them, so ``plan_holds`` fails and
    phase 2 runs at the fresh plan, as JAX re-runs it."""
    n, P = 3000, 3
    flags = []
    for keys in (np.arange(n, dtype=np.uint64),
                 3 * np.arange(n, dtype=np.uint64)):
        jout, tout = run_both(keys, np.ones(n, np.int64), P,
                              dest=("hash", _jax_low32),
                              tdest=("hash", _port_low32))
        same_exchange(jout, tout)
        flags.append((tout.cap, tout.exchange_stats.speculative))
    assert flags == [(1024, False), (4096, False)]


# -- the fused exchange group and reshard under the codec ---------------------

def test_fused_group_cold_warm_under_codec(monkeypatch):
    """aggregate → convert → reduce(count) under fuse=1, twice: the cold
    group (JAX v1) and the warm one (JAX mega, the table once a shard)
    equal JAX's, wire plan and telemetry included."""
    monkeypatch.setenv("MRTPU_PALLAS_GROUP", "1")
    monkeypatch.delenv("MRTPU_MEGAFUSE", raising=False)
    plan_cache().clear()
    j_plan_cache().clear()
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 200, 3000).astype(np.uint64)
    vals = rng.integers(0, 50, 3000).astype(np.int64)

    def fn(itask, kv, ptr):
        kv.add_batch(keys, vals)
    modes = []
    for _ in range(2):
        jmr = JMapReduce(j_make_mesh(3), fuse=1)
        tmr = MapReduce(comm=tmesh(3), fuse=1)
        for mr, mod in ((jmr, jr), (tmr, tr)):
            mr.map(1, fn)
            mr.aggregate()
            mr.convert()
            mr.reduce(mod.count, batch=True)
            mr.kv
        same_kv(jmr, tmr)
        assert _stats(tmr.last_exchange) == _stats(jmr.last_exchange)
        jg = [g for g in j_plan_history()[-1]["groups"] if g["fused"]][0]
        tg = [g for g in plan_history()[-1]["groups"] if g["fused"]][0]
        modes.append((jg["mode"], tg["mode"], tg["table"]))
        assert tmr.last_exchange.wire_ratio > 1
    assert modes == [("v1", "exchange", False), ("mega", "exchange1", True)]
    plan_cache().clear()
    j_plan_cache().clear()


def test_mr_reshard_under_codec_matches_jax():
    """mr.reshard 3 → 2 → 5 with the codec on: the same frames as JAX's
    at every width."""
    from test_torch_parallel import emit
    jmr, tmr = JMapReduce(j_make_mesh(3)), MapReduce(comm=tmesh(3))
    for mr in (jmr, tmr):
        mr.map(6, emit)
        mr.aggregate()
    same_kv(jmr, tmr)
    for P in (2, 5):
        assert jmr.reshard(j_make_mesh(P)) == tmr.reshard(tmesh(P))
        same_kv(jmr, tmr)
        assert one(tmr.kv).counts.tolist() == \
            one(jmr.kv).counts.tolist()


@pytest.mark.parametrize("width", [2, 5])
def test_range_exchange_speculation_matches_jax(width):
    """reshard_kv of one frame to ``width`` shards three times: the range
    exchange under the codec, its later runs at the cached plan (the
    host's own schedule places the rows), equal to JAX's each time."""
    from gpu_mapreduce_tpu.parallel.reshard import reshard_kv as j_reshard
    from gpu_mapreduce_tpu_torch.parallel.reshard import reshard_kv
    keys = np.random.default_rng(8).integers(0, 1 << 20, 2999
                                             ).astype(np.uint64)
    vals = (keys * 3).astype(np.int64)
    flags = []
    for _ in range(3):
        # a fresh frame of the same shape each time (JAX donates its input)
        jout = j_reshard(j_shard(JKVFrame(JDense(keys), JDense(vals)),
                                 j_make_mesh(3)), j_make_mesh(width))
        tout = reshard_kv(shard_frame_mesh(KVFrame(keys, vals), tmesh(3)),
                          tmesh(width))
        if getattr(jout, "exchange_stats", None) is None:
            # JAX's narrowed frame drops its stats: the blocks, and the
            # schedule its last exchange recorded
            jout.exchange_stats = tout.exchange_stats
            s = tout.exchange_stats
            assert jshuffle.ExchangeStats.last == (s.nrounds, s.bucket)
        same_exchange(jout, tout)
        flags.append(tout.exchange_stats.speculative)
    assert flags == [False, True, True]
