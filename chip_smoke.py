#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (every failure raises and exits
nonzero):

1. device   — the card's name and count, and nvidia-smi's name and power
              limit;
2. build    — compile every kernel under gpu_mapreduce_tpu_torch/csrc/
              with nvcc (ptxas's report included: spill and stack-frame
              bytes per source);
3. kernels  — each kernel against its plain PyTorch version on the card,
              exactly, at the main path's shape and at edge shapes; then
              CUDA-event timings beside the kernel's bound and, where one
              PyTorch call computes the same function, that call's time:
              mark_words (the map stage's word mark; planted matches
              across its 16-word tiles, a warp's span and the grid-stride
              seam, ragged tails, views not 16-byte aligned), seg_table
              (the group table at both IntCount shapes and at 2^20-row
              hot-key and sentinel cases, compared through its epilogue;
              one table + epilogue is profiled with torch.profiler for
              the device time by op: ``group_device_ms``) and mark_bytes
              (the byte mark, off every entry point: the corpus and its
              views buf[1:]..buf[15:], planted matches across its 16-byte
              chunks, 512-byte rows, a warp's 2 KB span and the
              grid-stride seam, periods 1-3, patterns of 64 and 128
              bytes, n = 1..3, a \\0 tail; timed also on buf[1:], at
              other pattern lengths and beside one device copy);
4. main     — InvertedIndex().run() on the benchmark's 256 MB, 4-file
              corpus (warm-up, then one timed run, with every launch
              count set to 0 just before it): pairs and unique URLs must
              equal the generator's, and every kernel must have launched;
5. paths    — a dense corpus (must take a cap retry and the wide
              fallback), a skewed one, and an outdir run whose part file
              must equal a regex oracle and the port's CPU run byte for
              byte;
6. intcount — intcount(paths, ntop=10) on two 128 MB files of u32 keys
              (uniform, and zipf(1.3) capped at 2^22): once eagerly, then
              with MRTPU_FUSE=1 a cold run (sort path) and a warm run
              (group table), each with every launch count set to 0 just
              before it; all three must equal a numpy oracle, and
              seg_table must launch on the warm run and not on the cold.
              Each run is then repeated with every op, the plan and the
              fused group between device synchronises, for the stage
              seconds (``op_seconds``).
7. graph    — the OINK script of ``graph_script``, through the port's
              OinkScript on the card: rmat at Graph500's scale-22,
              edgefactor-16 Kronecker parameters into a named MR,
              degree_stats, pagerank, edge_upper, cc_find and cc_stats,
              every launch count set to 0 just before the script (this
              path runs no hand-written kernel; the counts are reported).
              First one R-MAT round of 2^20 edges (and a noisy one of
              2^16) must be bit-equal on the card and on the CPU; after
              the script, host oracles (numpy, scipy) check the edge set
              (2^26 unique rows, ids < 2^22), the degree histogram
              (np.bincount), PageRank (sum 1 ± 1e-4, L1 ≤ 1e-4 from a
              float64 power iteration with the same damping and step
              count, the same top-100 set) and the components
              (scipy connected_components, each named by its least
              vertex id; cc_stats' sizes).  Seconds per command and per
              engine stage, rounds, edges/s per PageRank step and peak
              memory go into the ``graph`` line.

Then the ``kernels`` line, nvidia-smi's line, and last the result line
``{"ok": true, "device": {...}}``.  Exits nonzero without printing a
result when no CUDA device is present.  Imports nothing of JAX.
"""

import contextlib
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
NONTENSOR_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (data sheet)
L2_BYTES = 50e6              # H100 SXM L2 cache
MAIN_MB = 256                # bench.py's BENCH_MB default
INTCOUNT_KEYS = 1 << 25      # 128 MB of u32 keys: one rank of cpu/IntCount.cpp


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def planted_words(rng, nbytes: int, offsets, pattern: bytes):
    import numpy as np
    from gpu_mapreduce_tpu_torch.ops.cuda.match import bytes_view_u32
    buf = rng.integers(0, 256, nbytes, dtype=np.uint8)
    for off in offsets:
        buf[off:off + len(pattern)] = np.frombuffer(pattern, np.uint8)
    return bytes_view_u32(buf)


def corpus_words(paths, device):
    """The main path's word buffer for ``paths`` (as _map_corpus builds
    it: the corpus bucketed to _bucket_words and zero-padded)."""
    import numpy as np
    from gpu_mapreduce_tpu_torch.apps.invertedindex import (
        _bucket_words, _build_corpus)
    from gpu_mapreduce_tpu_torch.ops.bits import to_torch
    from gpu_mapreduce_tpu_torch.ops.cuda.match import bytes_view_u32
    corpus, _ = _build_corpus(paths)
    w = bytes_view_u32(corpus)
    wp = np.zeros(_bucket_words(len(w)), np.uint32)
    wp[:len(w)] = w
    return to_torch(wp, device)


def check_mark_words(words_main, device) -> dict:
    """mark_words vs mark_words_ref on the card, exactly: the main path's
    buffer; every alignment; planted matches across a thread's 16-word
    tile, a warp's 512-word span and the grid-stride seam; m = 1..17 and
    m = 1..15 mod 16 (the ragged tail); and views words[1:], [2:], [3:]
    whose data is not 16-byte aligned (the scalar head)."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.apps.invertedindex import PATTERN
    from gpu_mapreduce_tpu_torch.ops.bits import to_torch
    from gpu_mapreduce_tpu_torch.ops.cuda.match import (mark_words,
                                                        mark_words_ref)
    rng = np.random.default_rng(0)
    cases = {"main_path": words_main}
    planted = {}
    # every alignment, each at a few places across thread-block seams
    planted["alignments"] = sorted(4 * (k + 10 * a) + a for a in range(4)
                                   for k in (0, 250, 65530, 131070))
    # one grid-stride step of words: 8 blocks of 256 threads a SM, 16
    # words a thread (csrc/mark_words.cu)
    stride = torch.cuda.get_device_properties(device).multi_processor_count \
        * 8 * 256 * 16
    seams = set()
    for w in [16 * k for k in range(1, 40)] + [512 * k for k in range(1, 9)] \
            + [stride * k for k in range(1, 3)]:
        seams |= {4 * w - 9, 4 * w - 6 - (w // 16) % 3, 4 * w + 1}
    planted["seams"] = []                # starts at least 9 bytes apart
    for o in sorted(seams):
        if not planted["seams"] or o - planted["seams"][-1] >= len(PATTERN):
            planted["seams"].append(o)
    for name, nbytes in (("alignments", 4 << 20),
                         ("seams", 4 * (2 * stride + 4096))):
        cases[name] = to_torch(planted_words(rng, nbytes, planted[name],
                                             PATTERN), device)
    sizes = list(range(1, 18)) + [16 * 4099 + r for r in range(1, 16)] \
        + [1_000_003]
    for m in sizes:              # m < nw, tiles and a ragged tail
        cases[f"m={m}"] = to_torch(planted_words(
            rng, 4 * m, [0, 4 * m - 9] if 4 * m >= len(PATTERN) else [],
            PATTERN), device)
    base = to_torch(planted_words(rng, 4 * 70_001, range(0, 280_000, 997),
                                  PATTERN), device)
    for k in (1, 2, 3):          # not 16-byte aligned: the scalar head
        cases[f"words[{k}:]"] = base[k:]
    err = 0
    for name, words in cases.items():
        got = mark_words(words, PATTERN)
        ref = mark_words_ref(words, PATTERN)
        torch.cuda.synchronize()
        diff = int((got.to(torch.int32) - ref.to(torch.int32)).abs().max())
        if diff or got.shape != ref.shape:
            raise AssertionError(f"mark_words differs from its plain "
                                 f"version on case {name} (max |err| "
                                 f"{diff})")
        err = max(err, diff)
        if name in planted:
            hits = torch.nonzero(got).flatten()
            starts = (4 * hits + got[hits].to(torch.int64) - 1).tolist()
            if starts != planted[name]:
                raise AssertionError(f"mark_words missed planted matches "
                                     f"on case {name}")
    return {"cases": len(cases), "max_abs_err": err,
            "grid_stride_words": stride}


def time_mark_words(words) -> dict:
    """The kernel, its plain version and its bound at the main path's m.
    The input (4m bytes) is several times the 50 MB L2, so each launch
    reads it from device memory, as the main path's single launch does."""
    from gpu_mapreduce_tpu_torch.apps.invertedindex import PATTERN
    from gpu_mapreduce_tpu_torch.ops.cuda.match import (
        _alignment_tables, mark_words, mark_words_ref)
    m = int(words.shape[0])
    ms = cuda_ms(lambda: mark_words(words, PATTERN), iters=50)
    plain_ms = cuda_ms(lambda: mark_words_ref(words, PATTERN), iters=3,
                       warmup=1)
    masks, _ = _alignment_tables(PATTERN)
    # per word: an AND, a compare and a combine per masked compare, plus
    # one select per alignment
    ops = m * (3 * int((masks != 0).sum()) + 4)
    nbytes = 4 * m + m                  # read each word once, write int8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return {"m": m, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def intcount_files(d):
    """The two IntCount inputs, 128 MB of u32 keys each, from a fixed
    seed: uniform (about 33.4 M distinct keys) and zipf(1.3) capped at
    2^22 (the shape of bench.py's zipf intcount)."""
    import numpy as np
    rng = np.random.default_rng(7)
    keys = {"uniform": rng.integers(0, 1 << 32, INTCOUNT_KEYS,
                                    dtype=np.uint32),
            "zipf": np.minimum(rng.zipf(1.3, INTCOUNT_KEYS),
                               1 << 22).astype(np.uint32)}
    paths = {}
    for cell, k in keys.items():
        paths[cell] = os.path.join(d, f"intcount-{cell}.bin")
        k.tofile(paths[cell])
    return paths, keys


def table_shape(keys_u32, device):
    """The warm run's table for one IntCount file: its u64 keys on the
    card, and T = table_slots(gcap) with gcap as the cold run arms it."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.ops.bits import to_torch
    from gpu_mapreduce_tpu_torch.ops.cuda.group import table_slots
    from gpu_mapreduce_tpu_torch.parallel.sharded import round_cap
    from gpu_mapreduce_tpu_torch.plan.fuser import _gcap_for
    keys = to_torch(keys_u32.astype(np.uint64), device)
    g = int(torch.unique(keys).numel())
    gcap = _gcap_for(g, round_cap(keys.numel()))
    return keys, table_slots(gcap), gcap


def check_seg_table(shapes, device) -> dict:
    """segment_table vs segment_table_ref on the card, compared through
    table_to_groups: the groups exactly, overflow as a predicate."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.ops.bits import to_torch, widen64
    from gpu_mapreduce_tpu_torch.ops.cuda.group import (segment_table,
                                                        segment_table_ref)
    from gpu_mapreduce_tpu_torch.ops.segment import table_to_groups
    rng = np.random.default_rng(1)
    u64max = np.iinfo(np.uint64).max
    rows = 1 << 20
    cases = []                  # (name, keys, values, T, gcap, dtypes)
    for cell, (keys, T, gcap) in shapes.items():
        vals = rng.integers(0, 1 << 32, keys.numel(), dtype=np.uint32)
        cases.append((f"{cell}_count", keys, None, T, gcap, np.uint64,
                      None))
        cases.append((f"{cell}_sum", keys, to_torch(vals, device), T, gcap,
                      np.uint64, np.uint32))
    k32 = rng.integers(-50_000, 50_000, rows).astype(np.int32)
    v32 = rng.integers(-(1 << 31), 1 << 31, rows).astype(np.int32)
    cases.append(("i32_negative_sum", to_torch(k32, device),
                  to_torch(v32, device), 1 << 18, 1 << 17, np.int32,
                  np.int32))
    k64 = rng.integers(0, 1 << 64, 1000, dtype=np.uint64)[
        rng.integers(0, 1000, rows)]
    k64[::3] = 0
    k64[1::5] = u64max
    v64 = rng.integers(0, 1 << 64, rows, dtype=np.uint64)
    cases.append(("zero_and_max_sum", to_torch(k64, device),
                  to_torch(v64, device), 2048, 1024, np.uint64, np.uint64))
    # nvalid < cap: only the first 700,001 of 2^20 rows
    cases.append(("nvalid_lt_cap_count", to_torch(k64, device)[:700_001],
                  None, 2048, 1024, np.uint64, None))
    # hot keys and the sentinel, each as a count and as a sum
    half = rng.integers(0, 1 << 64, rows, dtype=np.uint64)
    half[::2] = u64max
    new = {"one_key": (np.full(rows, 0x0123456789ABCDEF, np.uint64), 64, 8),
           "all_max": (np.full(rows, u64max, np.uint64), 64, 8),
           "half_max": (half, 1 << 21, 1 << 20),
           "warp_runs": (np.repeat(rng.integers(0, 1 << 64, rows // 32,
                                                dtype=np.uint64), 32),
                         1 << 16, 1 << 15),
           "beyond_front": (rng.integers(0, 300_000, rows).astype(np.uint64),
                            1 << 20, 1 << 19)}
    for name, (keys, T, gcap) in new.items():
        kt = to_torch(keys, device)
        cases.append((f"{name}_count", kt, None, T, gcap, np.uint64, None))
        cases.append((f"{name}_sum", kt, to_torch(v64, device), T, gcap,
                      np.uint64, np.uint64))
    over = (np.arange(50_000, dtype=np.uint64) * np.uint64(7919))
    cases.append(("overflow_count", to_torch(over, device), None, 1 << 14,
                  1 << 14, np.uint64, None))
    done = []
    for name, keys, vals, T, gcap, kd, vd in cases:
        op = "count" if vals is None else "sum"
        k = widen64(keys, kd).contiguous()
        v = None if vals is None else widen64(vals, vd).contiguous()
        ref = table_to_groups(segment_table_ref(k, v, T), T, gcap, op, kd,
                              vd)
        got = table_to_groups(segment_table(k, v, T), T, gcap, op, kd, vd)
        torch.cuda.synchronize()
        if name == "overflow_count":
            # which keys won the full table's slots depends on the race,
            # so only the predicate the fuser reads is compared
            same = got[3] > 0 and ref[3] > 0
        else:
            same = (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])
                    and got[2] == ref[2] and got[3] == ref[3] == 0)
        if not same:
            raise AssertionError(
                f"seg_table differs from its plain version on case {name}: "
                f"g {got[2]} vs {ref[2]}, overflow {got[3]} vs {ref[3]}")
        done.append({"case": name, "rows": int(k.numel()), "T": T,
                     "groups": got[2], "overflow": got[3]})
    return {"cases": done, "max_abs_err": 0}


def table_bound(n: int, T: int, with_sum: bool) -> dict:
    """Least time for the group table: each key (and value) read once,
    the table's least state (8 B key + 4 B count a slot) written once,
    and, when the table (16 B a slot) outgrows the L2, one random 32-byte
    sector per row."""
    nbytes = 8 * n * (2 if with_sum else 1) + 12 * T
    if 16 * T > L2_BYTES:
        nbytes += 32 * n
    ops = 12 * n                        # hash, probe compare, adds a row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_seg_table(keys, T: int, gcap: int) -> dict:
    """The count table at one IntCount shape: the kernel (wrapper, table
    zeroing included), its plain version, one torch.unique call that
    computes the same groups and counts, and the bound; beside them the
    epilogue (table_to_groups) that the warm group runs after it, and the
    device time by op of one table + epilogue (torch.profiler)."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.ops.cuda.group import (segment_table,
                                                        segment_table_ref)
    from gpu_mapreduce_tpu_torch.ops.segment import table_to_groups
    ms = cuda_ms(lambda: segment_table(keys, None, T), iters=10)
    plain_ms = cuda_ms(lambda: segment_table_ref(keys, None, T), iters=2,
                       warmup=1)
    library_ms = cuda_ms(lambda: torch.unique(keys, return_counts=True),
                         iters=10)
    table = segment_table(keys, None, T)
    epilogue_ms = cuda_ms(lambda: table_to_groups(
        table, T, gcap, "count", np.uint64, None), iters=5)
    del table
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        table_to_groups(segment_table(keys, None, T), T, gcap, "count",
                        np.uint64, None)
        torch.cuda.synchronize()
    # device ms by op (aten ops hold the kernels they launch, so the two
    # levels overlap), largest first
    ranked = sorted(prof.key_averages(),
                    key=lambda r: -getattr(r, "device_time_total", 0))
    by_op = {r.key[:90]: r.device_time_total / 1e3 for r in ranked[:12]
             if getattr(r, "device_time_total", 0) > 0}
    return {"n": int(keys.numel()), "T": T, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "epilogue_ms": epilogue_ms,
            "group_device_ms": by_op,
            **table_bound(int(keys.numel()), T, False)}


def byte_stride(device) -> int:
    """One grid-stride step of bytes in csrc/mark_bytes.cu: 4 blocks of 8
    warps a SM, a 2 KB span a warp (4 rows of 32 16-byte chunks)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count \
        * 4 * 8 * 2048


def host_bytes(t) -> bytes:
    return t.cpu().numpy().tobytes()


def spaced(starts, length: int):
    """The sorted starts, dropping any closer than ``length`` to the one
    kept before it (planted matches must not overlap)."""
    kept = []
    for o in sorted(starts):
        if not kept or o - kept[-1] >= length:
            kept.append(o)
    return kept


def check_mark_bytes(corpus_t, device) -> dict:
    """mark vs mark_ref on the card, exactly: the main corpus and its views
    buf[1:]..buf[15:] (off a 16-byte boundary: the scalar head); planted
    matches of `<a href="` and of a 128-byte pattern across the kernel's
    16-byte chunks, its 512-byte rows (lane 31's halo from lane 0 of the
    next row), a warp's 2 KB span and the grid-stride seam; periods 1,
    2 and 3 on `ab` data, where every byte is a candidate; 64- and
    128-byte patterns taken from the corpus; n = 1, 2, 3 and a pattern
    ending in \\0 that matches at the tail."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.apps.invertedindex import PATTERN
    from gpu_mapreduce_tpu_torch.ops.cuda.match import mark, mark_ref
    rng = np.random.default_rng(2)
    stride = byte_stride(device)
    n = 2 * stride + (1 << 20)
    long_pat = rng.integers(0, 256, 128, dtype=np.uint8).tobytes()
    seams = ({16 * k - 4 - k % 5 for k in range(1, 200)}
             | {512 * k - 3 - k % 4 for k in range(1, 40)}
             | {2048 * k - 5 - k % 7 for k in range(1, 40)}
             | {stride * m + d for m in (1, 2) for d in (-70, -5, 0)}
             | {n - 128})
    cases, planted = {}, {}
    for name, pat in (("seams", PATTERN), ("seams_len128", long_pat)):
        offs = spaced(seams, len(pat))
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        for o in offs:
            buf[o:o + len(pat)] = np.frombuffer(pat, np.uint8)
        cases[name] = (torch.from_numpy(buf).to(device), pat)
        planted[name] = offs
    cases["main_path"] = (corpus_t, PATTERN)
    for k in range(1, 16):
        cases[f"main_path[{k}:]"] = (corpus_t[k:], PATTERN)
    s = corpus_t.shape[0] // 2          # a link in the corpus's middle
    s += int(torch.nonzero(mark(corpus_t[s:s + 4096], PATTERN))[0])
    cases["len64_filler"] = (corpus_t, host_bytes(corpus_t[s - 70:s - 6]))
    cases["len128_link"] = (corpus_t, host_bytes(corpus_t[s - 60:s + 68]))
    ab = torch.from_numpy(rng.choice(np.frombuffer(b"ab", np.uint8),
                                     (1 << 20) + 13)).to(device)
    for name, pat in (("period_1", b"aaa"), ("period_2", b"abab"),
                      ("period_3", b"abaaba")):
        cases[name] = (ab[3:], pat)
    tail = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
    tail[-1] = ord("a")
    cases["tail_a0"] = (torch.from_numpy(tail).to(device), b"a\x00")
    for k in (1, 2, 3):
        cases[f"n={k}"] = (torch.full((k,), ord("a"), dtype=torch.uint8,
                                      device=device), b"a\x00")
    hits = {}
    for name, (b, pat) in cases.items():
        got, ref = mark(b, pat), mark_ref(b, pat)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"mark_bytes differs from its plain "
                                 f"version on case {name}")
        hits[name] = int(got.sum())
        if name in planted and \
                torch.nonzero(got).flatten().tolist() != planted[name]:
            raise AssertionError(f"mark_bytes missed planted matches on "
                                 f"case {name}")
        if pat.endswith(b"\x00") and int(got[-1]) != 1:
            raise AssertionError(f"mark_bytes: no tail match on {name}")
    return {"cases": hits, "max_abs_err": 0, "grid_stride_bytes": stride,
            "refusals": check_mark_bytes_refusals(device)}


def check_mark_bytes_refusals(device) -> dict:
    """The launch refuses an output not placed for its 16-byte stores
    (cudaErrorMisalignedAddress, 716) and a pattern past 128 bytes
    (cudaErrorInvalidValue, 1); the wrapper raises on the latter before
    any launch."""
    import torch
    from gpu_mapreduce_tpu_torch.ops.cuda import library
    from gpu_mapreduce_tpu_torch.ops.cuda.match import (
        MAX_PAT, _bind_bytes, _c_tables, mark)
    lib = library("mark_bytes", _bind_bytes)
    buf = torch.zeros(4096, dtype=torch.uint8, device=device)
    out = torch.empty(4096 + 16, dtype=torch.int8, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    cm, cv, _ = _c_tables(b"abc")
    misaligned = lib.mark_bytes_launch(buf.data_ptr(), out.data_ptr() + 1,
                                       4096, cm, cv, 3, device.index, stream)
    cm, cv, _ = _c_tables(b"a" * (MAX_PAT + 1))
    too_long = lib.mark_bytes_launch(buf.data_ptr(), out.data_ptr(), 4096,
                                     cm, cv, MAX_PAT + 1, device.index,
                                     stream)
    try:
        mark(buf, b"a" * (MAX_PAT + 1))
        wrapper_raised = False
    except ValueError:
        wrapper_raised = True
    if (misaligned, too_long, wrapper_raised) != (716, 1, True):
        raise AssertionError(f"mark_bytes refusals: misaligned out rc "
                             f"{misaligned}, {MAX_PAT + 1}-byte pattern rc "
                             f"{too_long}, wrapper raised {wrapper_raised}")
    return {"misaligned_out_rc": misaligned, "too_long_rc": too_long}


def time_mark_bytes(buf) -> dict:
    """The kernel, its plain version and its bound at the main path's n
    (2n bytes, several times the 50 MB L2); beside them the kernel on the
    view buf[1:] and at other pattern lengths, each pattern the corpus's
    bytes from a link on, and one device copy of the n bytes (the same
    bytes moved, no compute: what the memory system gives a kernel)."""
    import torch
    from gpu_mapreduce_tpu_torch.apps.invertedindex import PATTERN
    from gpu_mapreduce_tpu_torch.ops.cuda.match import mark, mark_ref
    n = int(buf.numel())
    ms = cuda_ms(lambda: mark(buf, PATTERN), iters=50)
    plain_ms = cuda_ms(lambda: mark_ref(buf, PATTERN), iters=3, warmup=1)
    view_ms = cuda_ms(lambda: mark(buf[1:], PATTERN), iters=50)
    dst = torch.empty_like(buf)
    copy_ms = cuda_ms(lambda: dst.copy_(buf), iters=50)
    del dst
    s = int(torch.nonzero(mark(buf[:4096], PATTERN))[0])
    by_len = {}
    for length in (1, 4, 17, 64, 128):
        pat = host_bytes(buf[s:s + length])
        by_len[length] = cuda_ms(lambda: mark(buf, pat), iters=20)
    nbytes = 2 * n                       # read each byte, write one int8
    ops = 2 * len(PATTERN) * n           # a compare and an AND a byte
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return {"n": n, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "view1_ms": view_ms,
            "copy_ms": copy_ms, "ms_by_pattern_len": by_len}


def intcount_oracle(keys_u32, ntop: int):
    """(nints, nunique, top) by numpy: count descending, then key
    descending (the tie order of the descending value sort over
    ascending-key groups)."""
    import numpy as np
    uk, c = np.unique(keys_u32, return_counts=True)
    order = np.lexsort((-uk.astype(np.int64), -c))[:ntop]
    return len(keys_u32), len(uk), [(int(uk[i]), int(c[i])) for i in order]


@contextlib.contextmanager
def op_seconds():
    """Wall seconds per MapReduce op, fused group and plan, each between
    two device synchronises, into the dict the block yields.  The smoke
    wraps the library's methods for the block's length; the library never
    waits on the card to time itself.  Spans nest: a barrier op (gather,
    scan_kv) holds the plan it runs, the plan holds the replayed
    aggregate (the H2D) and the fused group; under fuse=1 the recorded
    call of a deferred op takes only microseconds."""
    import torch
    from gpu_mapreduce_tpu_torch.core.mapreduce import MapReduce
    from gpu_mapreduce_tpu_torch.plan import fuser
    times = {}
    spans = [(MapReduce, op, op) for op in
             ("map_files", "aggregate", "convert", "reduce", "gather",
              "sort_values", "scan_kv")]
    spans += [(fuser, "execute_plan", "plan"),
              (fuser, "_exec_local_group", "fused_group")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in spans]

    def timed(fn, label):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[label] = times.get(label, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for (owner, attr, label), (_, _, fn) in zip(spans, saved):
        setattr(owner, attr, timed(fn, label))
    try:
        yield times
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def run_intcount(cell, path, keys_u32, kernels, smi) -> dict:
    """intcount eager, then fused cold (sort path) and fused warm (group
    table), each timed after every launch count is set to 0."""
    import torch
    from gpu_mapreduce_tpu_torch import intcount
    from gpu_mapreduce_tpu_torch.ops.cuda.group import segment_table
    from gpu_mapreduce_tpu_torch.plan import plan_cache, plan_history
    want = intcount_oracle(keys_u32, 10)
    runs = {}
    saved = os.environ.get("MRTPU_FUSE")
    try:
        for run, fuse in (("eager", "0"), ("cold", "1"), ("warm", "1")):
            os.environ["MRTPU_FUSE"] = fuse
            if run == "cold":
                plan_cache().clear()
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = intcount([path], ntop=10)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if got != want:
                raise AssertionError(f"intcount-{cell} {run}: {got[:2]} "
                                     f"top {got[2][:3]}... != oracle "
                                     f"{want[:2]} top {want[2][:3]}...")
            rec = {"end_to_end_s": dt,
                   "launches": {k.__name__: k.launches for k in kernels},
                   "max_memory_allocated":
                       torch.cuda.max_memory_allocated()}
            # a second, untimed-end-to-end run of the same mode with every
            # op between device synchronises: the stage seconds
            if run == "cold":
                plan_cache().clear()
            with op_seconds() as stages:
                if intcount([path], ntop=10) != want:
                    raise AssertionError(f"intcount-{cell} {run}: timed "
                                         f"rerun differs")
            rec["stages_s"] = stages
            if fuse == "1":
                group = next(g for e in reversed(plan_history())
                             for g in e["groups"] if g["fused"])
                rec.update(group_mode=group["mode"], table=group["table"])
            runs[run] = rec
    finally:
        if saved is None:
            os.environ.pop("MRTPU_FUSE", None)
        else:
            os.environ["MRTPU_FUSE"] = saved
    name = segment_table.__name__
    if runs["cold"]["launches"][name] != 0 or \
            runs["warm"]["launches"][name] < 1 or not runs["warm"]["table"]:
        raise AssertionError(f"intcount-{cell}: seg_table launches cold "
                             f"{runs['cold']['launches'][name]}, warm "
                             f"{runs['warm']['launches'][name]}")
    return {"phase": f"intcount-{cell}", "card": smi, "nints": want[0],
            "nunique": want[1], "top3": want[2][:3], **runs}


def oracle_part_file(paths) -> str:
    """part-00000 from a regex over the raw files: one line per distinct
    URL, ascending unsigned u64 id, then the files that reference it."""
    from gpu_mapreduce_tpu_torch.ops.hash import hash_bytes64
    refs = {}
    for p in paths:
        with open(p, "rb") as f:
            for u in re.findall(rb'<a href="([^"]{0,255})"', f.read()):
                refs.setdefault(u, set()).add(p)
    lines = sorted((hash_bytes64(u), u.decode(errors="replace"),
                    " ".join(sorted(fs))) for u, fs in refs.items())
    return "".join(f"{u}\t{fs}\n" for _, u, fs in lines)


GRAPH_SCALE = 22               # BASELINE.json's PageRank scale
GRAPH_EDGEFACTOR = 16          # Graph500 spec, section 3
GRAPH_ABCD = (0.57, 0.19, 0.19, 0.05)   # Graph500 Kronecker initiator
GRAPH_SEED = 20260
GRAPH_TOL = 1e-8               # above the f32 noise floor (PERF.md)
GRAPH_MAXITER = 100
GRAPH_DAMPING = 0.85


def graph_script(scale: int, edgefactor: int) -> list:
    """The graph phase's OINK script, one command a line."""
    a, b, c, d = GRAPH_ABCD
    return [
        f"rmat {scale} {edgefactor} {a} {b} {c} {d} 0.0 {GRAPH_SEED} "
        f"-o NULL mre",
        "degree_stats 0 -i mre",
        f"pagerank {GRAPH_TOL} {GRAPH_MAXITER} {GRAPH_DAMPING} -i mre "
        f"-o NULL mrpr",
        "edge_upper -i mre -o NULL mru",
        "cc_find 0 -i mru -o NULL mrc",
        "cc_stats -i mrc"]


@contextlib.contextmanager
def graph_spans(device):
    """Wall seconds of each call of the graph engines' stages, between two
    device synchronises (the engines read a host scalar every step
    anyway): generation, collate, staging, the two fused loops and each
    of their steps.  Yields {label: [seconds of each call]}."""
    import torch
    from gpu_mapreduce_tpu_torch.core.mapreduce import MapReduce
    from gpu_mapreduce_tpu_torch.models import cc as cc_model
    from gpu_mapreduce_tpu_torch.models import pagerank as pr_model
    from gpu_mapreduce_tpu_torch.oink.commands import cc, pagerank, rmat
    times = {}
    spans = [(rmat, "rmat_edges", "rmat_generate"),
             (MapReduce, "collate", "collate"),
             (pagerank, "stage_graph", "pagerank_stage"),
             (pagerank, "pagerank", "pagerank_loop"),
             (pr_model, "pagerank_step", "pagerank_step"),
             (cc, "stage_graph", "cc_stage"), (cc, "cc", "cc_loop"),
             (cc_model, "_propagate", "cc_round")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in spans]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn, label):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            times.setdefault(label, []).append(time.perf_counter() - t0)
            return out
        return wrapper

    for (owner, attr, label), (_, _, fn) in zip(spans, saved):
        setattr(owner, attr, timed(fn, label))
    try:
        yield times
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _histogram(lines) -> list:
    """``  value count`` lines of degree_stats / cc_stats → pairs."""
    return [tuple(int(w) for w in ln.split()) for ln in lines
            if ln.startswith("  ")]


def _desc_histogram(values) -> list:
    """(value, how many) for each distinct value, value descending."""
    import numpy as np
    h = np.bincount(values)
    nz = np.nonzero(h)[0][::-1]
    return [(int(v), int(h[v])) for v in nz]


def check_rmat_round(device, scale: int) -> dict:
    """One R-MAT round of 2^20 edges (and a noisy round of 2^16) on the
    device and on the CPU through the port: bit-equal."""
    import torch
    from gpu_mapreduce_tpu_torch.models.rmat import rmat_edges
    from gpu_mapreduce_tpu_torch.ops import prng
    key = prng.split(prng.PRNGKey(GRAPH_SEED))[1]
    out = {}
    for m, frac in ((1 << 20, 0.0), (1 << 16, 0.3)):
        got = [torch.stack(rmat_edges(key, m, scale, GRAPH_ABCD, frac,
                                      frac > 0.0, dev), 1).cpu()
               for dev in (device, torch.device("cpu"))]
        if not torch.equal(got[0], got[1]):
            raise AssertionError(f"rmat_edges m={m} frac={frac}: the "
                                 f"device and the CPU differ in "
                                 f"{int((got[0] != got[1]).sum())} ids")
        out[f"m{m}_frac{frac}"] = "bit-equal"
    return out


def _compressed(major, minor, data, n: int, fmt):
    """A scipy CSC/CSR matrix with one entry per (major, minor) pair,
    built straight from its index arrays (scipy's COO conversion sums
    duplicates by sorting every row, far slower at 2^26 entries)."""
    import numpy as np
    if np.any(major[1:] < major[:-1]):
        order = np.argsort(major, kind="stable")
        minor, data = minor[order], data[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(major, minlength=n), out=indptr[1:])
    return fmt((data, minor, indptr), shape=(n, n))


def graph_oracles(scale, edgefactor, edges, screens, pr, cc_out) -> dict:
    """Host oracles independent of the port (numpy, scipy): the R-MAT
    edge set, the degree histogram, PageRank by a float64 power
    iteration (scipy.sparse) with the same damping and step count,
    components by scipy's connected_components.  Raises on any
    disagreement; returns what they found and their seconds by part."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    part_s = {}
    t0 = time.perf_counter()
    ntotal = (1 << scale) * edgefactor
    vi, vj = edges[:, 0], edges[:, 1]
    if edges.shape != (ntotal, 2):
        raise AssertionError(f"rmat: {edges.shape} edges, want {ntotal}")
    if int(edges.max()) >= 1 << scale:
        raise AssertionError(f"rmat: a vertex id >= 2^{scale}")
    packed = (vi << np.uint64(scale)) | vj
    packed.sort()
    if np.any(packed[1:] == packed[:-1]):
        raise AssertionError("rmat: duplicate edges")
    del packed
    part_s["rmat"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    flat = edges.reshape(-1).astype(np.int64)
    deg = np.bincount(flat, minlength=1 << scale)
    deg = deg[deg > 0]
    want = _desc_histogram(deg)
    head = screens["degree_stats"][0]
    if head != f"DegreeStats: {len(deg)} vertices, {ntotal} edges" or \
            _histogram(screens["degree_stats"]) != want:
        raise AssertionError(f"degree_stats differs from np.bincount: "
                             f"{head!r}")
    part_s["degree_stats"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    present = np.zeros(1 << scale, bool)
    present[flat] = True
    del flat
    verts = np.nonzero(present)[0].astype(np.uint64)
    rank_of = np.cumsum(present) - 1
    src, dst = rank_of[vi.astype(np.int64)], rank_of[vj.astype(np.int64)]
    n = len(verts)
    pverts, pranks, iters = pr
    if not np.array_equal(pverts, verts):
        raise AssertionError("pagerank: vertex table differs")
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    dangling = outdeg == 0
    inv = np.where(dangling, 0.0, 1.0 / np.maximum(outdeg, 1.0))
    a = _compressed(src, dst, inv[src], n, sp.csc_matrix)   # a[dst, src]
    del src, dst
    r = np.full(n, 1.0 / n)
    d = GRAPH_DAMPING
    for _ in range(iters):
        r = (1.0 - d) / n + d * (a @ r + r[dangling].sum() / n)
    del a
    l1 = float(np.abs(pranks - r).sum())
    total = float(pranks.sum())
    top_port = set(np.argpartition(-pranks, 100)[:100].tolist())
    top_ref = set(np.argpartition(-r, 100)[:100].tolist())
    if abs(total - 1.0) > 1e-4 or l1 > 1e-4 or top_port != top_ref:
        raise AssertionError(f"pagerank: sum {total}, L1 {l1} vs the "
                             f"float64 iteration, top-100 overlap "
                             f"{len(top_port & top_ref)}")
    part_s["pagerank"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    keep = vi != vj
    lo = np.minimum(vi, vj)[keep].astype(np.int64)
    hi = np.maximum(vi, vj)[keep].astype(np.int64)
    present[:] = False
    present[lo] = True
    present[hi] = True
    verts2 = np.nonzero(present)[0].astype(np.uint64)
    rank2 = np.cumsum(present) - 1
    n2 = len(verts2)
    g = _compressed(rank2[lo], rank2[hi], np.ones(len(lo), np.float64), n2,
                    sp.csr_matrix)
    del lo, hi
    ncomp, labels = connected_components(g, directed=False)
    del g
    _, first = np.unique(labels, return_index=True)   # least rank each
    zones = verts2[first[labels]]
    cverts, czones, cmsg = cc_out
    if not (np.array_equal(cverts, verts2) and np.array_equal(czones, zones)
            and cmsg.startswith(f"CC_find: {ncomp} components in ")):
        raise AssertionError(f"cc_find differs from scipy "
                             f"connected_components ({ncomp}): {cmsg!r}")
    sizes = np.bincount(labels)
    head = screens["cc_stats"][0]
    if head != f"CCStats: {ncomp} components, {n2} vertices" or \
            _histogram(screens["cc_stats"]) != _desc_histogram(sizes):
        raise AssertionError(f"cc_stats differs: {head!r}")
    part_s["cc"] = time.perf_counter() - t0
    return {"vertices": n, "cc_vertices": n2, "components": int(ncomp),
            "largest_component": int(sizes.max()),
            "pagerank_l1_vs_f64": l1, "pagerank_sum": total,
            "top100_equal": True, "seconds_by_part": part_s}


def run_graph(device, smi: str, kernels=(), scale: int = GRAPH_SCALE,
              edgefactor: int = GRAPH_EDGEFACTOR) -> dict:
    """The graph phase: the OINK script of :func:`graph_script` through
    the port's ``OinkScript`` on ``device``, each command timed between
    device synchronises, then the host oracles."""
    import io
    import torch
    from gpu_mapreduce_tpu_torch import OinkScript
    from gpu_mapreduce_tpu_torch.interop import mapreduce_to_numpy
    cuda = device.type == "cuda"
    rmat_round = check_rmat_round(device, scale)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graph_")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        s = OinkScript(device=device, screen=False, logfile=None)
        seconds, screens = {}, {}
        with graph_spans(device) as spans:
            for line in graph_script(scale, edgefactor):
                word = line.split()[0]
                s.screen = buf = io.StringIO()
                t0 = time.perf_counter()
                s.one(line)
                if cuda:
                    torch.cuda.synchronize()
                seconds[word] = time.perf_counter() - t0
                screens[word] = buf.getvalue().splitlines()
        launches = {k.__name__: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated() if cuda else None
        named = s.obj.named
        t0 = time.perf_counter()
        edges, _ = mapreduce_to_numpy(named["mre"])
        pr_verts, pr_ranks = mapreduce_to_numpy(named["mrpr"])
        cverts, czones = mapreduce_to_numpy(named["mrc"])
        pull_s = time.perf_counter() - t0
        msgs = {w: lines[0] for w, lines in screens.items() if lines}
        rounds = int(msgs["rmat"].split()[-2])
        pr_iters = int(msgs["pagerank"].split()[-2])
        cc_rounds = int(msgs["cc_find"].split()[-2])
        del s, named
        t0 = time.perf_counter()
        found = graph_oracles(scale, edgefactor, edges, screens,
                              (pr_verts, pr_ranks, pr_iters),
                              (cverts, czones, msgs["cc_find"]))
        oracle_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    nedges = len(edges)
    step_s = statistics.median(spans["pagerank_step"])
    return {"phase": "graph", "card": smi,
            "config": {"scale": scale, "edgefactor": edgefactor,
                       "abcd": GRAPH_ABCD, "seed": GRAPH_SEED,
                       "pagerank": [GRAPH_TOL, GRAPH_MAXITER,
                                    GRAPH_DAMPING]},
            "script": graph_script(scale, edgefactor),
            "edges": nedges, "edge_key_bytes": edges.nbytes,
            "rmat_rounds": rounds, "pagerank_iterations": pr_iters,
            "cc_rounds": cc_rounds, "command_s": seconds,
            "stage_s": {k: sum(v) for k, v in spans.items()},
            "stage_calls": {k: len(v) for k, v in spans.items()},
            "pagerank_step_s": spans["pagerank_step"],
            "cc_round_s": spans["cc_round"],
            "pagerank_step_median_s": step_s,
            "pagerank_edges_per_s_per_iteration": nedges / step_s,
            "messages": msgs, "launches": launches,
            "max_memory_allocated": peak, "pull_to_host_s": pull_s,
            "oracle_s": oracle_s, "oracles": found,
            "rmat_round_device_vs_cpu": rmat_round}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from gpu_mapreduce_tpu_torch import InvertedIndex
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.apps.invertedindex import _build_corpus
    from gpu_mapreduce_tpu_torch.ops import cuda as kcuda
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match

    # every kernel wrapper: the InvertedIndex path's, the fused count
    # chain's, and the byte mark (off every entry point)
    kernels = [match.mark_words, group.segment_table, match.mark]
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    os.environ["MRTPU_TORCH_PTXAS_VERBOSE"] = "1"
    built = kcuda.build_all()
    # spill bytes (stores + loads) over every kernel of each source, from
    # ptxas's report; None for a source already built before this run
    spills = {n: None for n in kcuda.sources()}
    spills.update({n: sum(map(int, re.findall(r"(\d+) bytes spill", out)))
                   for n, out in built["output"].items()})
    # stack-frame bytes over every kernel of each source, likewise
    frames = {n: None for n in kcuda.sources()}
    frames.update({n: sum(map(int, re.findall(r"(\d+) bytes stack frame",
                                              out)))
                   for n, out in built["output"].items()})
    emit({"phase": "build", "seconds": built["seconds"],
          "sources": kcuda.sources(), "spill_bytes": spills,
          "stack_frame_bytes": frames, "nvcc_output": built["output"]})

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        main_dir = os.path.join(tmp, "main")
        os.makedirs(main_dir)
        paths, nref, nuniq = make_corpus(main_dir, MAIN_MB)
        nbytes = sum(os.path.getsize(p) for p in paths)
        emit({"phase": "corpus", "mb": MAIN_MB, "files": len(paths),
              "bytes": nbytes, "refs": nref, "unique": nuniq,
              "seconds": time.perf_counter() - t0})

        words_main = corpus_words(paths, device)
        checked = check_mark_words(words_main, device)
        timing = time_mark_words(words_main)
        del words_main
        emit({"phase": "kernels", "mark_words": {**checked, **timing}})

        corpus, _ = _build_corpus(paths)
        corpus_t = torch.from_numpy(corpus).to(device)
        bytes_checked = check_mark_bytes(corpus_t, device)
        bytes_timing = time_mark_bytes(corpus_t)
        del corpus, corpus_t
        emit({"phase": "kernels", "mark_bytes": {**bytes_checked,
                                                 **bytes_timing}})

        t0 = time.perf_counter()
        int_dir = os.path.join(tmp, "intcount")
        os.makedirs(int_dir)
        int_paths, int_keys = intcount_files(int_dir)
        emit({"phase": "intcount-files", "keys": INTCOUNT_KEYS,
              "seconds": time.perf_counter() - t0})
        shapes = {cell: table_shape(k, device)
                  for cell, k in int_keys.items()}
        table_checked = check_seg_table(shapes, device)
        table_timing = {cell: time_seg_table(keys, T, gcap)
                        for cell, (keys, T, gcap) in shapes.items()}
        del shapes
        emit({"phase": "kernels", "seg_table": {**table_checked,
                                                **table_timing}})
        warm = InvertedIndex()
        warm.run(paths)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        idx = InvertedIndex()
        t0 = time.perf_counter()
        npairs, nunique = idx.run(paths)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        if (npairs, nunique) != (nref, nuniq):
            raise AssertionError(f"main path gave {(npairs, nunique)}, "
                                 f"the generator {(nref, nuniq)}")
        if launches["mark_words"] <= 0:     # the InvertedIndex path's kernel
            raise AssertionError(f"a kernel never launched on the main "
                                 f"path: {launches}")
        map_s = idx.timer.times["map_device"]
        emit({"phase": "main", "card": smi, "npairs": npairs,
              "nunique": nunique, "bytes": nbytes,
              "map_device_s": map_s,
              "map_device_pairs_per_s": npairs / map_s,
              "map_device_bytes_per_s": nbytes / map_s,
              "end_to_end_s": dt, "stages_s": idx.timer.times,
              "stats": idx.stats, "launches": launches,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        shutil.rmtree(main_dir)

        for kind, mb, flags in (("dense", 16, {"dense": True}),
                                ("skew", 32, {"skew": True})):
            d = os.path.join(tmp, kind)
            os.makedirs(d)
            p, nref_k, nuniq_k = make_corpus(d, mb, **flags)
            ii = InvertedIndex()
            got = ii.run(p)
            if got != (nref_k, nuniq_k):
                raise AssertionError(f"{kind}: {got} != {(nref_k, nuniq_k)}")
            if kind == "dense" and not (ii.stats["cap_retries"] >= 1
                                        and ii.stats["wide_fallbacks"] >= 1):
                raise AssertionError(f"dense corpus skipped the retry "
                                     f"paths: {ii.stats}")
            emit({"phase": kind, "mb": mb, "npairs": got[0],
                  "nunique": got[1], "stats": ii.stats,
                  "stages_s": ii.timer.times})

        d = os.path.join(tmp, "outdir")
        os.makedirs(d)
        p, nref_k, nuniq_k = make_corpus(d, 2, skew=True)
        parts = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, f"out-{dev}")
            got = InvertedIndex(device=dev).run(p, outdir=out)
            if got != (nref_k, nuniq_k):
                raise AssertionError(f"outdir/{dev}: {got}")
            with open(os.path.join(out, "part-00000")) as f:
                parts[dev] = f.read()
        lines = parts["cuda"].count("\n")
        if lines != nuniq_k:
            raise AssertionError(f"part-00000 has {lines} lines, "
                                 f"expected {nuniq_k}")
        if parts["cuda"] != parts["cpu"]:
            raise AssertionError("part-00000 differs between cuda and cpu")
        if parts["cuda"] != oracle_part_file(p):
            raise AssertionError("part-00000 differs from the regex oracle")
        emit({"phase": "outdir", "lines": lines,
              "equals_cpu_and_oracle": True})

        int_runs = {}
        for cell, path in int_paths.items():
            int_runs[cell] = run_intcount(cell, path, int_keys[cell],
                                          kernels, smi)
            emit(int_runs[cell])
        shutil.rmtree(int_dir)

        emit(run_graph(device, smi, kernels))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    uni, zipf = table_timing["uniform"], table_timing["zipf"]
    emit({"kernels": [{
        "name": "mark_words", "route": "cuda",
        "source": "gpu_mapreduce_tpu_torch/csrc/mark_words.cu",
        "replaces": "gpu_mapreduce_tpu/ops/pallas/match.py:176",
        "replaces_fn": "_mark_words_kernel",
        "launches": launches["mark_words"],
        "launches_per_run": launches["mark_words"],
        "max_abs_err": checked["max_abs_err"], "m": timing["m"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "spill_bytes": spills["mark_words"],
        "stack_frame_bytes": frames["mark_words"]}, {
        "name": "seg_table", "route": "cuda",
        "source": "gpu_mapreduce_tpu_torch/csrc/seg_table.cu",
        "replaces": "gpu_mapreduce_tpu/ops/pallas/group.py:175",
        "replaces_fn": "_seg_table_kernel",
        "path": "intcount-uniform, MRTPU_FUSE=1, warm run",
        "launches": int_runs["uniform"]["warm"]["launches"]["segment_table"],
        "launches_zipf": int_runs["zipf"]["warm"]["launches"][
            "segment_table"],
        "max_abs_err": table_checked["max_abs_err"],
        "n": uni["n"], "T": uni["T"],
        "ms": uni["ms"], "plain_ms": uni["plain_ms"],
        "bound_ms": uni["bound_ms"], "bound_by": uni["bound_by"],
        "library_ms": uni["library_ms"],
        "library_call": "torch.unique(keys, return_counts=True)",
        "epilogue_ms": uni["epilogue_ms"],
        "spill_bytes": spills["seg_table"],
        "stack_frame_bytes": frames["seg_table"],
        "zipf": {k: zipf[k] for k in ("T", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "epilogue_ms")}}, {
        "name": "mark_bytes", "route": "cuda",
        "source": "gpu_mapreduce_tpu_torch/csrc/mark_bytes.cu",
        "replaces": "gpu_mapreduce_tpu/ops/pallas/match.py:67",
        "replaces_fn": "_mark_kernel",
        "path": None, "launches": launches["mark"],
        "max_abs_err": bytes_checked["max_abs_err"], "n": bytes_timing["n"],
        "ms": bytes_timing["ms"], "plain_ms": bytes_timing["plain_ms"],
        "bound_ms": bytes_timing["bound_ms"],
        "bound_by": bytes_timing["bound_by"],
        "library_ms": None, "spill_bytes": spills["mark_bytes"],
        "stack_frame_bytes": frames["mark_bytes"],
        "view1_ms": bytes_timing["view1_ms"],
        "copy_ms": bytes_timing["copy_ms"],
        "ms_by_pattern_len": bytes_timing["ms_by_pattern_len"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
