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
7. text     — wordfreq-zipf: 256 MB of text in 4 files generated from
              seed 20261017 (2^20 lowercase words of 2-12 bytes, one in
              1,024 of 64-512, Zipf ranks ∝ 1/r over a seeded permutation,
              the six ASCII whitespace separators and runs of them); the
              OINK ``wordfreq 10 -i v_files -o <out> NULL`` three times on
              the card (fuse 0, fuse 1 cold, fuse 1 warm), each against
              the generator's counts (message lines exactly, the -o file
              as sorted lines), the three identical, seg_table launched
              on the warm run only; stage seconds (read, split, intern,
              the group, top-N, output), tokens/s, peak memory.  Then
              seg_table against its plain version at the zipf cell's
              interned ids with 0, 2^63 and 2^64-1 planted (count and
              sum), timed beside its bound and torch.unique; the same
              three runs on the main cell's HTML corpus against a
              collections.Counter oracle (wordfreq-html); and 2 MB of the
              generator on the card and on the CPU: the wordfreq lines,
              the -o file, ``sort_keys 5`` then ``print``, and a
              comparator sort_keys, byte-identical (text-check).
8. graph    — the OINK script of ``graph_script``, through the port's
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
              vertex id; cc_stats' sizes).  The same script then runs
              the mr builtin and named-MR lines into histo (the
              count-of-counts equal to np.bincount's degree histogram),
              luby_find on the edge_upper'd graph (independent and
              maximal, by numpy) and sssp from two sources after
              add_weight (dist equal to scipy's directed unweighted
              shortest paths, every pred an in-neighbour one step
              closer, each source's labeled count).  Seconds and peak
              memory per command, seconds per engine stage and round,
              rounds and edges/s per PageRank step go into the
              ``graph`` line.
9. tri      — rmat at scale 18 (cut from 22: the [t, 3] u64 triangle
              rows would take tens of GB) → edge_upper → tri_find on the
              card; the triangle count must equal a blockwise scipy
              (L @ L) * L over the degree-oriented graph, the wedge count
              numpy's, every row distinct and every row's three edges
              canonical edges (all rows when that takes under 60 s on the
              host, else 2^20 seeded rows).  Then neighbor → tri_find →
              neigh_tri at scale 12 on the card and on the CPU: tmp.tri
              and every per-vertex file byte-identical.

10. host    — the host tier, its pieces run where their data is: after
              the intcount phase, the intcount-uniform file's 2^25 u32
              keys as (u64, u32) pairs through ``MapReduce(outofcore=1,
              memsize=64, maxpage=2)`` — map_files (host pages, the ones
              past the 128 MB budget spilled), aggregate, convert (the
              device KV over the budget demoted, sorted runs on the card,
              a k-way merge) and reduce(count) — equal to
              np.unique(return_counts=True) in ascending unsigned order,
              beside the same chain in core; then sort_keys(-1) over the
              budget, equal to the keys sorted non-increasing.  In the
              graph script, right after rmat, examples/in.checkpoint's
              lines (save, mr, load, degree on both MRs): the degrees
              equal on the card, save and load GB/s, and a copy with one
              flipped byte refused with IntegrityError.  In the text
              phases, the Zipf corpus through map_file_char(64, ...,
              "\\n", 80) under mapstyle 2, split on the card and
              collated there, against the generator's counts; and in the
              2 MB card-vs-CPU check, collapse / scrunch 1 / broadcast 0,
              the interned KV and its KMV saved on one device and loaded
              on the other, and the chunk maps ("\\n", "\\n\\n") under
              mapstyle 0 and 2.  One ``host`` line holds the seconds,
              bytes, counters (wsize, rsize, msizemax), runs, spill
              files, peaks and launches.

11. mesh    — the data plane over ``make_mesh(4, devices=[cuda:0] * 4)``:
              four shards on the one card, driven by this process.
              main-p4: InvertedIndex(comm=mesh).run() on the main cell's
              corpus (one file a shard; warm-up, then a timed run after
              the launch counts are set to 0): the generator's pairs and
              unique URLs, mark_words launched once a shard a pass.
              intcount-p4: each intcount cell's keys as four files through
              intcount(paths, ntop=10, comm=mesh), equal to numpy's counts
              (ties in the mesh's order), seg_table never launched; the
              aggregate's count matrix, bytes, pad bytes and device
              seconds beside its bytes bound.  wordfreq-p4:
              wordfreq_interned over the zipf cell's four files against
              the generator's counts, beside the one-device call.
              mesh-check: a 2 MB skewed corpus's four part files on the
              card and on CPU shards byte-identical (their lines the
              one-device part file's), and a 2^16-key IntCount at P = 3
              through gather(1), broadcast(0), sort_keys(-1) equal on the
              card and the CPU.  mesh-fuse: each intcount cell at P = 4
              under MRTPU_FUSE=1, cold (the fused exchange group on the
              sort path; seg_table 0 launches) then warm (the cached
              plan and gcap on the group table; seg_table once a shard),
              both equal to numpy's counts, then once inside
              ``mr.pipeline()``; at shard 0's received rows of the warm
              uniform run seg_table against its plain version, timed
              beside its bound and torch.unique.  mesh-ops-check: map_mr
              (per pair, batch), clone, collapse, compress under fuse 0
              and 1, the fused exchange group, open/close and a named-MR
              script (clone, compress, save, load) at P = 3 on the card
              and on CPU shards, equal shard by shard.  mesh-ooc: the
              uniform keys at P = 4 with ``outofcore=1, memsize=64,
              maxpage=2`` (demote in shard order, external convert),
              equal to the in-core P = 4 chain.  mesh-checkpoint: the
              P = 4 KV saved after the aggregate, loaded at P = 1 and
              P = 3 and counted there, equal to the P = 4 counts; a value
              flipped in writer shard 2 refused, naming that shard.  With
              two cards or more, intcount-p4 and the warm mesh-fuse run
              again with one shard a card.  graph-p4 (after the graph
              and tri phases, whose P = 1 MRs it is held against): the
              graph script (checkpoint lines aside) and its composed
              lines on four shards of the card, every named result equal
              to P = 1's as a set of rows (PageRank within rtol 1e-5 and
              one step), every result line too (fused cc's round count
              aside), composed cc and sssp equal to the fused ones;
              tri_find at scale 18 equal to P = 1's, the composed
              tri_find equal to the fused one at scale 12; then every
              OINK command at P = 3 on the card and on CPU shards, file
              by file (its own ``graph-p4`` line).  One ``mesh`` line
              sums it.

12. dist    — the process group (``parallel/dist.py``, ``launch.py``).
              reshard: the intcount-p4-uniform KV (2^25 pairs after the
              aggregate on four shards of the card) through mr.reshard to
              2 shards and back to 4, byte-identical, each direction's
              seconds and the range exchange's rows and bytes; with four
              cards again with one shard a card; a KV and a KMV at 2^16
              keys through the same steps on the card and on CPU shards,
              equal after every step.  exchange: four rank processes
              (``chip_smoke.py --dist-rank``) each hold one of those
              files' keys on their device and run a hash exchange; each
              rank's block equals shard d of the one-controller
              make_mesh(4) exchange (cap, count, sha256 of the padded
              keys and values); count_sync and exchange seconds by rank,
              the backend and transport.  launcher: ``launch --np 4``
              and ``--np 2`` over 32 MB of the zipf generator, both
              equal to a Counter oracle, then ``--np 4`` with rank 2
              killed at its second exchange: width 2 after 2
              generations, dead == [2], output byte-equal to --np 2's;
              recover_seconds, wall times, each rank's device.  One
              ``dist`` line.

13. wire    — the exchange as it runs by default, the wire codec and the
              speculative plan cache, on four shards of the card (one a
              card where four are present).  wire-p4-uniform and -zipf:
              the intcount cells' 2^25 (u64 key, u32 1) rows, the hash
              exchange three times with the codec on (the first cold,
              the next two speculative hits) and three times with
              MRTPU_WIRE=0, every output byte-equal to the first; the
              plan's pack widths and tiers, wire_ratio, wire_bytes
              against sent + pad bytes, the hits, the exchange's ms by
              CUDA events (median of the warm runs); then the mesh
              phase's mesh-fuse runs (cold, and warm with seg_table once
              a shard, against numpy's counts), which must have taken a
              wire plan.  wordfreq-p4: the plans the text phase's mesh
              run took.  mesh2-2x2:
              make_mesh2(2, 2) over the same devices, the exchange
              byte-equal to make_mesh(4)'s, aggregate + gather(1) and a
              per-shard InvertedIndex output equal to make_mesh(4)'s.
              dist-local-2x2: two rank processes (``chip_smoke.py
              --dist-local-rank``) holding two shards each, every block
              equal to the make_mesh(4) exchange's shard.  Then each at
              2^16 rows on the card and on CPU shards, byte-equal.  One
              line a cell and one ``wire`` line.

14. ft      — fault tolerance on the card: each case fault-free, then
              under the JAX golden's schedule (every fault site, rate 1,
              seed 11, one fault a site, budget 3; MRTPU_RETRY_BACKOFF
              2 ms).  ft-main: InvertedIndex over the main corpus
              (make_mesh(1), onfault=retry), npairs, nunique and the
              part file equal.  ft-wordfreq-p4: map_files → collate →
              reduce count → save → load over the zipf files at P = 4,
              rows and reloaded rows byte-equal, faults at ingest.read,
              ingest.tokenize, shuffle.exchange and checkpoint.save,
              stats()["ft"] equal to fault_counts().  ft-fuse-p4: the
              fused IntCount chain cold then warm, equal shard by shard,
              seg_table 0 launches in the faulted warm attempt and 4 in
              the successful one.  ft-ooc: the ooc cell's descending
              external sort with spill.write and spill.read armed, rows
              equal.  ft-quarantine: the wordfreq-p4 job under
              onfault=skip with one file a dangling link, one
              quarantine record naming it, counts equal to the other
              three files'.  ft-resume: the graph script journaled in a
              child (``chip_smoke.py --ft-graph-child``), SIGKILLed after
              the checkpoint that follows pagerank, resumed in a fresh
              child: cc labels, degree_stats and cc_stats lines equal to
              the graph phase's, PageRank at rtol 1e-5 and ±1 step, only
              the tail re-run; seconds a command and a checkpoint set.
              ft-partition: ``-partition 2x2`` through the OINK command
              line, a wordfreq over two zipf files a world and a shell
              line, the counts summed equal the generator's.  One
              ``ft-case`` line a case and one ``ft`` line.

15. obs     — the port's observability on the card, after the intcount
              phase (its line follows the dist line).  The main run
              traced to a JSONL file: pairs and unique URLs as the
              generator's, the same launches as untraced (mark_words 1),
              each ``stage.<name>`` span within 2% or 1 ms of
              StageTimer's seconds; the span tree (names, nesting, byte
              attributes) of the 2 MB skewed corpus on the card equal to
              the CPU's; one traced main run under torch.profiler:
              mark_words launched inside ``stage.map_device``, each
              top-level span's device ms and the run's idle share; traced
              against untraced, interleaved, medians of 9 (main and the
              warm fused IntCount), gated at 1.10x; µs a span for 10^5
              empty spans with NVTX and the profiler range, the range
              only, and neither; the warm fused IntCount (uniform) with
              ``ensure_server(0)`` — seg_table once, /metrics scraped
              during the run and after — and the P = 4 mesh-fuse warm
              run, whose exchange byte counters equal the cumulative
              counters' deltas, every metric name in the catalog; and
              the dist phase's launcher runs' files: one trace id across
              launch.json, the trace shards, the rank dumps and the
              flight dumps, the sync records' spreads, the chaos
              survivors' flight dumps with the lease table naming rank 2.

16. cache   — the caching tier, the native host runtime and a standing
              query, after ft.  native-main: InvertedIndex(engine=
              "native") on the main corpus, the library built under the
              port's _build/, hits, unique URLs and part-00000 equal to
              the default engine's on the card, mark_words never
              launched; _parse_cols' C++ route on the composed-check
              graph as an edge file equal to its numpy route.
              persist-intcount: intcount-uniform under MRTPU_FUSE=1 with
              a content store (MRTPU_CAS_DIR): this process, its plan
              caches cleared, runs P = 1 and P = 4 cold and stores the
              plans; a fresh process (``--cache-persist-child``) runs
              each first warm from disk (seg_table once, once a shard),
              with this process's counts, and a second fresh process
              with the tier off (MRTPU_PLAN_PERSIST=0) runs each first
              cold; each runs each chain twice.  cas-checkpoint: the P = 4 IntCount KV
              after the aggregate saved without a store and twice under
              one: one store object, both loads equal to the KV, a byte
              flipped in the object refused.  stream-zipf: the first
              wordfreq-zipf file appended to a tailed file in 8 writes,
              one micro-batch each (Stream words/count, fuse=1) and a
              window=2 stream beside it: the snapshot equal
              to a Counter and to a one-shot wordfreq on the card, the
              window equal to the last two writes', no plan key missed
              twice, seg_table once for each group whose key ran
              before, stage seconds a batch from the tracer's spans
              under ``stream.batch``; then a child (``--cache-stream-child``) SIGKILLed
              after batch 4's record and another between batch 5's
              checkpoint and its record, each resumed here to the same
              snapshot.  The stream takes the first quarter of the file
              (16.8 MB, a 2 MB cut), cut to keep the smoke's time.  A
              line a cell, then the ``cache`` line.
8. serve    — the serve daemon on the card (``serve/``): serve-main, an
              in-process ``Server(workers=2)`` with tenant tokens armed:
              tenant ta's invertedindex (the main corpus, -o) and tb's
              fused wordfreq (the zipf corpus, -o) at once, against the
              regex oracle and the draws' counts (mark_words launched,
              seg_table not), tb again warm (0 plan misses, seg_table
              once, the same files), each session's dispatches equal to
              its job run directly; serve-control on the same daemon:
              401 with the journal untouched, a tenant's drain 403, a
              foreign id 404, a 1 ms deadline cancelled with tb's pages
              at 0, a DELETE of a running invertedindex cancelled at a
              barrier, /v1/slo and /metrics with MRTPU_SLO armed, then a
              paused daemon's full queue 429 + Retry-After; serve-memo:
              with a content store, one daemon computes tb's job and a
              second serves it as a hit (0 launches, 0 dispatches, a
              cache_hit record); serve-recover: a scale-20 graph script
              (rmat, degree, edge_upper, cc_find, histo, three -o files)
              and two op batches through ``python -m
              gpu_mapreduce_tpu_torch.serve`` on one worker, SIGKILLed
              once the session's journal holds a checkpoint, restarted:
              the session resumed, every file equal to an uninterrupted
              in-process run's, the batches in admission order.  Alone:
              ``--serve-alone``; on the CPU at 2 MB: ``--serve-rehearse``.

              Then a ``total`` line with the smoke's seconds.

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
def op_seconds(extra=()):
    """Wall seconds per MapReduce op, fused group and plan (and each
    ``(owner, attribute, label)`` of ``extra``), each between two device
    synchronises, into the dict the block yields.  The smoke wraps the
    library's methods for the block's length; the library never waits on
    the card to time itself.  Spans nest: a barrier op (gather, scan_kv)
    holds the plan it runs, the plan holds the replayed aggregate (the
    H2D) and the fused group; under fuse=1 the recorded call of a
    deferred op takes only microseconds."""
    import torch
    from gpu_mapreduce_tpu_torch.core.mapreduce import MapReduce
    from gpu_mapreduce_tpu_torch.plan import fuser
    times = {}
    spans = [(MapReduce, op, op) for op in
             ("map_files", "aggregate", "convert", "reduce", "gather",
              "sort_values", "scan_kv")]
    spans += [(fuser, "execute_plan", "plan"),
              (fuser, "_exec_local_group", "fused_group")]
    spans += list(extra)
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


WF_SEED = 20261017
WF_MB = 256                    # the main cell's corpus size
WF_VOCAB = 1 << 20             # distinct words of the zipf cell
WF_LONG_EVERY = 1024           # one vocabulary word in 1,024 is long
WF_CHECK_MB = 2                # the card-vs-CPU check's corpus
WF_NTOP = 10
WF_SEPS = b" \n\t\r\x0b\x0c"
WF_SEP_P = (0.84, 0.12, 0.02, 0.01, 0.005, 0.005)
WF_RUN_P = 0.01                # a run of 2-3 separators instead of one


def zipf_vocab(rng, nvocab: int):
    """``nvocab`` distinct words, packed: (uint8 buffer, int64 offsets
    [nvocab+1]).  One word in WF_LONG_EVERY is 64-512 random lowercase
    bytes, at seeded places; the rest are lowercase words of 2-12 bytes,
    lengths drawn uniformly and duplicates dropped (so the lengths 2 and
    3, which hold only 676 and 17,576 words, end up rarer)."""
    import numpy as np
    nlong = nvocab // WF_LONG_EVERY
    nshort = nvocab - nlong
    keys = np.zeros(0, np.int64)          # base-26 value * 16 + length
    while len(keys) < nshort:
        m = 2 * (nshort - len(keys)) + 1024
        lens = rng.integers(2, 13, m)
        vals = (rng.random(m) * (26.0 ** lens)).astype(np.int64)
        keys = np.concatenate([keys, vals * 16 + lens])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]       # first draws, in draw order
    keys = keys[:nshort]
    lens, vals = keys & 15, keys >> 4
    digits = np.empty((nshort, 12), np.uint8)
    for j in range(12):
        digits[:, j] = 97 + vals % 26
        vals = vals // 26
    short = digits[np.arange(12)[None, :] < lens[:, None]]
    long_lens = rng.integers(64, 513, nlong)
    all_lens = np.concatenate([lens, long_lens])
    src = np.zeros(nvocab + 1, np.int64)
    np.cumsum(all_lens, out=src[1:])
    buf_in = np.concatenate([short, rng.integers(
        97, 123, int(long_lens.sum())).astype(np.uint8)])
    order = rng.permutation(nvocab)       # long words among the short
    lens_out = all_lens[order]
    offs = np.zeros(nvocab + 1, np.int64)
    np.cumsum(lens_out, out=offs[1:])
    idx = np.repeat(src[:-1][order] - offs[:-1], lens_out) \
        + np.arange(int(offs[-1]))
    return buf_in[idx], offs


def zipf_corpus(d: str, total_mb: int, nfiles: int = 4, seed: int = WF_SEED,
                nvocab: int = WF_VOCAB):
    """The wordfreq-zipf corpus: ``nfiles`` files of about ``total_mb``
    MB in all.  Each token is the vocabulary word of Zipf rank r, drawn
    with probability ∝ 1/r (the ranks a seeded permutation of the
    vocabulary, so rank is not tied to length), followed by one
    separator (space 84%, \\n 12%, \\t 2%, \\r 1%, \\x0b and \\x0c 0.5%
    each) or, in 1% of places, by a run of 2-3 of them.  Returns (paths,
    each word's count in the draws, vocabulary buffer, offsets)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vbuf, voffs = zipf_vocab(rng, nvocab)
    vlens = np.diff(voffs)
    word_of_rank = rng.permutation(nvocab)
    p = 1.0 / np.arange(1, nvocab + 1)
    p /= p.sum()
    cdf = np.cumsum(p)
    per_token = float(p @ vlens[word_of_rank]) + 1.0 + 1.5 * WF_RUN_P
    ntok = int(((total_mb << 20) // nfiles) / per_token)
    sep_cdf = np.cumsum(WF_SEP_P)
    seps = np.frombuffer(WF_SEPS, np.uint8)
    counts = np.zeros(nvocab, np.int64)
    paths = []
    for i in range(nfiles):
        rank = np.searchsorted(cdf, rng.random(ntok) * cdf[-1])
        w = word_of_rank[np.minimum(rank, nvocab - 1)]
        del rank
        counts += np.bincount(w, minlength=nvocab)
        nsep = np.where(rng.random(ntok) < WF_RUN_P,
                        rng.integers(2, 4, ntok), 1)
        wl = vlens[w]
        start = np.zeros(ntok + 1, np.int64)
        np.cumsum(wl + nsep, out=start[1:])
        out = np.empty(int(start[-1]), np.uint8)
        before = np.cumsum(wl) - wl            # word bytes before token
        ar = np.arange(int(wl.sum()))
        out[np.repeat(start[:-1] - before, wl) + ar] = \
            vbuf[np.repeat(voffs[:-1][w] - before, wl) + ar]
        del ar, before
        for j in range(3):
            has = nsep > j
            kind = np.searchsorted(sep_cdf, rng.random(int(has.sum()))
                                   * sep_cdf[-1])
            out[(start[:-1] + wl + j)[has]] = \
                seps[np.minimum(kind, len(seps) - 1)]
        path = os.path.join(d, f"zipf-{i:02d}.txt")
        out.tofile(path)
        paths.append(path)
    return paths, counts, vbuf, voffs


def wordfreq_oracle(words, counts, nfiles: int, ntop: int = WF_NTOP):
    """What the wordfreq command must print and write, from the counts of
    the draws (never from the port): the message lines — count
    descending, equal counts by u64 id descending, the id being
    lookup3's hash_bytes64 of the word — and the -o file's lines,
    sorted."""
    import numpy as np
    from gpu_mapreduce_tpu_torch.ops.hash import hash_bytes64
    counts = np.asarray(counts, np.int64)
    nz = np.nonzero(counts)[0]
    nwords, nunique = int(counts.sum()), len(nz)
    k = min(ntop, nunique)
    kth = np.sort(counts[nz])[::-1][k - 1] if k else 0
    cand = [i for i in nz[counts[nz] >= kth]]
    cand.sort(key=lambda i: (-int(counts[i]), -hash_bytes64(words[i])))
    top = [(words[i], int(counts[i])) for i in cand[:k]]
    lines = [f"WordFreq: {nfiles} files, {nwords} words, {nunique} unique"]
    lines += [f"  {c} {w.decode(errors='replace')}" for w, c in top]
    out = sorted(f"{words[i].decode(errors='replace')} {int(counts[i])}"
                 for i in nz)
    return {"nwords": nwords, "nunique": nunique, "top": top,
            "message": lines, "out_lines": out}


def counter_oracle(paths, ntop: int = WF_NTOP):
    """wordfreq_oracle over collections.Counter of bytes.split() of each
    file (the HTML cell's oracle)."""
    from collections import Counter
    c = Counter()
    for p in paths:
        with open(p, "rb") as f:
            c.update(f.read().split())
    words = list(c)
    return wordfreq_oracle(words, [c[w] for w in words], len(paths), ntop)


def text_spans():
    """The stage spans of a wordfreq run beside op_seconds' own: the
    device split, the intern (hash, id sort and collision check on the
    card — ``intern_device`` — then the host's decode table), the top-N
    and the -o file."""
    from gpu_mapreduce_tpu_torch.core.column import BytesColumn
    from gpu_mapreduce_tpu_torch.oink import kernels as okernels
    from gpu_mapreduce_tpu_torch.oink.commands import wordfreq as wcmd
    from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
    from gpu_mapreduce_tpu_torch.ops import hash as ohash
    return [(okernels, "split_words", "split"),
            (BytesColumn, "intern", "intern"),
            (ohash, "intern_packed", "intern_device"),
            (wcmd, "top_n", "top_n"),
            (ObjectManager, "output", "output")]


def wordfreq_script(paths, out: str, fuse: int) -> list:
    return [f"set fuse {fuse}",
            f"variable files index {' '.join(paths)}",
            f"wordfreq {WF_NTOP} -i v_files -o {out} NULL"]


def run_wordfreq_script(device, paths, out: str, fuse: int):
    """One OINK wordfreq run → (message lines, -o file text)."""
    import io
    from gpu_mapreduce_tpu_torch import OinkScript
    screen = io.StringIO()
    script = OinkScript(device=device, screen=screen)
    for line in wordfreq_script(paths, out, fuse):
        script.one(line)
    message = [ln for ln in screen.getvalue().splitlines()
               if ln.startswith(("WordFreq:", "  "))]
    with open(out) as f:
        return message, f.read()


def run_wordfreq(cell: str, paths, oracle: dict, tmp: str, kernels,
                 smi: str, device=None) -> dict:
    """The OINK wordfreq on the card three times — fuse 0, fuse 1 cold,
    fuse 1 warm — each with every launch count set to 0 just before it
    and its stages timed between device synchronises.  Each must equal
    the oracle (message lines, -o file as sorted lines), the three must
    be identical, and seg_table must launch on the warm run only."""
    import torch
    from gpu_mapreduce_tpu_torch.ops.cuda.group import segment_table
    from gpu_mapreduce_tpu_torch.plan import plan_cache, plan_history
    runs, outputs = {}, []
    nbytes = sum(os.path.getsize(p) for p in paths)
    for run, fuse in (("eager", 0), ("cold", 1), ("warm", 1)):
        if run == "cold":
            plan_cache().clear()
        out = os.path.join(tmp, f"{cell}-{run}.out")
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with op_seconds(text_spans()) as stages:
            t0 = time.perf_counter()
            message, text = run_wordfreq_script(device, paths, out, fuse)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if message != oracle["message"]:
            raise AssertionError(f"{cell} {run}: {message[:3]} != oracle "
                                 f"{oracle['message'][:3]}")
        if sorted(text.splitlines()) != oracle["out_lines"]:
            raise AssertionError(f"{cell} {run}: the -o file differs from "
                                 f"the oracle")
        outputs.append((message, text))
        os.remove(out)
        rec = {"end_to_end_s": dt, "tokens_per_s": oracle["nwords"] / dt,
               "bytes_per_s": nbytes / dt,
               "stages_s": {**stages, "read": stages.get("map_files", 0.0)
                            - stages.get("split", 0.0)},
               "launches": {k.__name__: k.launches for k in kernels},
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if fuse:
            group = next(g for e in reversed(plan_history())
                         for g in e["groups"] if g["fused"])
            rec.update(group_mode=group["mode"], table=group["table"])
        runs[run] = rec
    if any(o != outputs[0] for o in outputs):
        raise AssertionError(f"{cell}: the three runs differ")
    name = segment_table.__name__
    if runs["eager"]["launches"][name] or runs["cold"]["launches"][name] \
            or runs["warm"]["launches"][name] < 1 \
            or not runs["warm"]["table"]:
        raise AssertionError(
            f"{cell}: seg_table launches eager "
            f"{runs['eager']['launches'][name]}, cold "
            f"{runs['cold']['launches'][name]}, warm "
            f"{runs['warm']['launches'][name]}")
    return {"phase": cell, "card": smi, "files": len(paths),
            "bytes": nbytes, "nwords": oracle["nwords"],
            "nunique": oracle["nunique"],
            "top3": [(w.decode(errors="replace"), c)
                     for w, c in oracle["top"][:3]], **runs}


def interned_ids(paths, device):
    """The wordfreq path's keys for ``paths``: every word split and
    interned on ``device`` (u64 ids as int64 bits)."""
    import numpy as np
    from gpu_mapreduce_tpu_torch.core.column import concat
    from gpu_mapreduce_tpu_torch.utils.io import split_words
    col = concat([split_words(np.fromfile(p, np.uint8), device)
                  for p in paths])
    return col.intern(device)[0]


def check_seg_table_text(ids, device) -> dict:
    """seg_table against segment_table_ref at interned-id keys: the
    wordfreq-zipf ids with the keys 0, 2^63 and 2^64-1 planted, as a
    count and as a sum, at the T the warm group arms; compared through
    table_to_groups (groups exactly).  Then the count table timed."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.ops.cuda.group import (segment_table,
                                                        segment_table_ref,
                                                        table_slots)
    from gpu_mapreduce_tpu_torch.ops.segment import table_to_groups
    from gpu_mapreduce_tpu_torch.parallel.sharded import round_cap
    from gpu_mapreduce_tpu_torch.plan.fuser import _gcap_for
    planted = torch.tensor([0, -(1 << 63), -1] * 3, dtype=torch.int64,
                           device=device)
    keys = torch.cat([ids, planted]).contiguous()
    g = int(torch.unique(keys).numel())
    gcap = _gcap_for(g, round_cap(keys.numel()))
    T = table_slots(gcap)
    vals = torch.arange(keys.numel(), dtype=torch.int64,
                        device=device) * 2654435761
    cases = []
    for op, v in (("count", None), ("sum", vals)):
        vd = None if v is None else np.uint64
        ref = table_to_groups(segment_table_ref(keys, v, T), T, gcap, op,
                              np.uint64, vd)
        got = table_to_groups(segment_table(keys, v, T), T, gcap, op,
                              np.uint64, vd)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                and got[2] == ref[2] == g and got[3] == ref[3] == 0):
            raise AssertionError(f"seg_table differs from its plain "
                                 f"version at interned ids ({op}): g "
                                 f"{got[2]} vs {ref[2]}, overflow {got[3]} "
                                 f"vs {ref[3]}")
        cases.append({"case": f"interned_{op}", "rows": int(keys.numel()),
                      "T": T, "groups": g})
    return {"cases": cases, "max_abs_err": 0,
            **time_seg_table(keys, T, gcap)}


def _by_length_then_bytes(a, b):
    ka, kb = (len(a), a), (len(b), b)
    return (ka > kb) - (ka < kb)


def text_outputs(device, paths, d: str) -> dict:
    """Everything the card-vs-CPU check compares, from one device: the
    wordfreq message lines and -o file, the script's ``sort_keys 5`` then
    ``print`` of the counted words, and a comparator sort_keys printed
    to a file."""
    import contextlib as ctx
    import io
    from gpu_mapreduce_tpu_torch import MapReduce, OinkScript
    from gpu_mapreduce_tpu_torch.oink.kernels import read_words
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    out = {}
    out["message"], out["o_file"] = run_wordfreq_script(
        device, paths, os.path.join(d, f"wf-{device}.out"), 0)
    script = OinkScript(device=device, screen=io.StringIO())
    printed = io.StringIO()
    with ctx.redirect_stdout(printed):
        for line in (f"variable files index {' '.join(paths)}", "mr x",
                     "x map/file v_files read_words", "x collate NULL",
                     "x reduce count", "x sort_keys 5", "x print"):
            script.one(line)
    out["sort_keys_5_print"] = printed.getvalue()
    mr = MapReduce(device=device)
    mr.map_files(paths, read_words)
    mr.collate()
    mr.reduce(count, batch=True)
    mr.sort_keys(_by_length_then_bytes)
    path = os.path.join(d, f"cmp-{device}.txt")
    mr.print(file=path)
    with open(path) as f:
        out["comparator_sort_print"] = f.read()
    return out


def run_text(html_paths, tmp: str, device, kernels, smi: str):
    """The text phases: wordfreq-zipf (its corpus generated here), the
    same corpus through map_file_char under mapstyle 2, seg_table at its
    interned ids, wordfreq-html on the main cell's corpus, then the
    card-vs-CPU check; wordfreq-p4 (the mesh phase's) runs on the zipf
    corpus.  Returns (the wordfreq phase records by cell, the seg_table
    record, the chunk-map record, the text-check record, the wordfreq-p4
    record, and the zipf files with their oracle, kept for the ft
    phase)."""
    t0 = time.perf_counter()
    zdir = os.path.join(tmp, "zipf")
    os.makedirs(zdir)
    zpaths, counts, vbuf, voffs = zipf_corpus(zdir, WF_MB)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    words = [vbuf[voffs[i]:voffs[i + 1]].tobytes()
             for i in range(len(voffs) - 1)]
    oracle = oracle_z = wordfreq_oracle(words, counts, len(zpaths))
    del words, counts, vbuf, voffs
    emit({"phase": "wordfreq-zipf-corpus", "mb": WF_MB,
          "bytes": sum(os.path.getsize(p) for p in zpaths),
          "vocab": WF_VOCAB, "seed": WF_SEED, "generate_s": gen_s,
          "oracle_s": time.perf_counter() - t0})
    wf = {"wordfreq-zipf": run_wordfreq("wordfreq-zipf", zpaths, oracle,
                                        tmp, kernels, smi)}
    emit(wf["wordfreq-zipf"])
    mesh_wf = run_mesh_wordfreq(zpaths, oracle, kernels, smi)
    emit(mesh_wf)
    chunks = run_chunk_wordfreq(zpaths, oracle, device, kernels)
    ids = interned_ids(zpaths, device)
    text_table = check_seg_table_text(ids, device)
    del ids
    emit({"phase": "kernels", "seg_table_text": text_table})
    t0 = time.perf_counter()
    oracle = counter_oracle(html_paths)
    oracle_s = time.perf_counter() - t0
    wf["wordfreq-html"] = run_wordfreq("wordfreq-html", html_paths, oracle,
                                       tmp, kernels, smi)
    wf["wordfreq-html"]["oracle_s"] = oracle_s
    emit(wf["wordfreq-html"])
    t0 = time.perf_counter()
    check = run_text_check(tmp, smi)
    check["seconds"] = time.perf_counter() - t0
    emit(check)
    # the zipf corpus (its files and oracle) stays for the ft phase
    return wf, text_table, chunks, check, mesh_wf, (zpaths, oracle_z)


def run_text_check(tmp: str, smi: str) -> dict:
    """2 MB of the zipf generator through the port on the card and on the
    CPU: every text output byte-identical."""
    d = os.path.join(tmp, "text-check")
    os.makedirs(d)
    paths, counts, vbuf, voffs = zipf_corpus(d, WF_CHECK_MB, nfiles=2)
    got = {dev: text_outputs(dev, paths, d) for dev in ("cuda", "cpu")}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        got[dev].update(host_text_outputs(dev, paths, d))
    for key in got["cpu"]:
        if got["cuda"][key] != got["cpu"][key]:
            raise AssertionError(f"text-check: {key} differs between "
                                 f"cuda and cpu")
    loads = check_cross_loads(d, got)
    words = [vbuf[voffs[i]:voffs[i + 1]].tobytes()
             for i in range(len(voffs) - 1)]
    oracle = wordfreq_oracle(words, counts, len(paths))
    if got["cuda"]["message"] != oracle["message"]:
        raise AssertionError("text-check: wordfreq differs from the oracle")
    want = sorted((words[i], int(counts[i]))
                  for i in range(len(words)) if counts[i])
    for key in got["cuda"]:
        if "/" in key and got["cuda"][key][2] != want:
            raise AssertionError(f"text-check: {key} word counts differ "
                                 f"from the generator's")
    host_s = time.perf_counter() - t0
    shutil.rmtree(d)
    return {"phase": "text-check", "card": smi, "mb": WF_CHECK_MB,
            "nwords": oracle["nwords"], "nunique": oracle["nunique"],
            "compared": sorted(got["cpu"]), "cuda_equals_cpu": True,
            "cross_loads": loads, "host_s": host_s}


OOC_MEMSIZE = 64               # MB a page: the reference's default
OOC_MAXPAGE = 2                # pages resident: a 128 MB budget
CKPT_DIR = "ckpt.rmat"         # examples/in.checkpoint's directory


@contextlib.contextmanager
def counting(owner, attr: str):
    """Count the calls of ``owner.attr`` (a module function or method)
    for the block's length into the list the block yields."""
    calls = [0]
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    setattr(owner, attr, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, attr, fn)


def read_u32_keys(itask, fname, kv, ptr):
    """A file of u32 keys → (u64 key, u32 value 1) pairs: 12 bytes a
    pair, 384 MiB for the 2^25-key IntCount file."""
    import numpy as np
    keys = np.fromfile(fname, np.uint32)
    kv.add_batch(keys.astype(np.uint64), np.ones(len(keys), np.uint32))


def timed_ops(device, ops) -> dict:
    """Run ``(label, call)`` pairs in order, each between two device
    synchronises: seconds by label."""
    import torch
    secs = {}
    for label, call in ops:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
    return secs


def kv_arrays(mr):
    """A KV's keys and values as host arrays, frames in order (spilled
    pages read back one at a time)."""
    import numpy as np
    ks, vs = [], []
    for fr in mr.kv.frames():
        fr = fr.to_host()
        ks.append(fr.key.data)
        vs.append(fr.value.data)
    return np.concatenate(ks), np.concatenate(vs)


def run_ooc(path, keys_u32, tmp: str, device, kernels) -> dict:
    """The out-of-core chain at real size: the 2^25 u32 keys of the
    intcount-uniform file through ``MapReduce(outofcore=1, memsize=64,
    maxpage=2)`` — map_files (host pages, the ones past the budget
    spilled), aggregate (onto the card), convert (the device KV is over
    the 128 MB budget: demoted to host pages, sorted runs on the card,
    a k-way merge) and reduce(count) — then the same chain in core, then
    sort_keys(-1) over the budget.  The (key, count) pairs must equal
    np.unique's exactly, in ascending unsigned order; the sorted keys
    must be non-increasing and the input's multiset."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.core import dataset, external
    from gpu_mapreduce_tpu_torch.core.runtime import global_counters
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    t_phase = time.perf_counter()
    spill = os.path.join(tmp, "ooc-spill")
    settings = dict(outofcore=1, memsize=OOC_MEMSIZE, maxpage=OOC_MAXPAGE,
                    fpath=spill, fuse=0)
    keys = keys_u32.astype(np.uint64)
    t0 = time.perf_counter()
    want_k, want_c = np.unique(keys, return_counts=True)
    oracle_s = time.perf_counter() - t0
    c = global_counters()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w0, r0 = c.wsize, c.rsize
    base = c.msize
    c.msizemax = c.msize
    mr = MapReduce(device=device, **settings)
    with counting(external, "_write_run") as runs, \
            counting(dataset, "_write_spill") as spills:
        pages = {}

        def map_step():
            mr.map_files([path], read_u32_keys)
            pages["map"] = (mr.kv.nframes, len(os.listdir(spill)))

        ooc_s = timed_ops(device, [
            ("map_files", map_step), ("aggregate", mr.aggregate),
            ("convert", mr.convert),
            ("reduce", lambda: mr.reduce(count, batch=True))])
    counters = {"wsize": c.wsize - w0, "rsize": c.rsize - r0,
                "msizemax": c.msizemax - base}
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in kernels}
    got_k, got_c = kv_arrays(mr)
    if not (np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)):
        raise AssertionError("ooc: (key, count) pairs differ from np.unique")
    result_pages, nunique = mr.kv.nframes, len(want_k)
    mr.kv.free()
    if counters["wsize"] <= 0 or counters["rsize"] <= 0 or runs[0] < 2:
        raise AssertionError(f"ooc: nothing spilled ({counters}, "
                             f"{runs[0]} runs)")
    torch.cuda.reset_peak_memory_stats()
    incore = MapReduce(device=device, fuse=0)
    core_s = timed_ops(device, [
        ("map_files", lambda: incore.map_files([path], read_u32_keys)),
        ("aggregate", incore.aggregate), ("convert", incore.convert),
        ("reduce", lambda: incore.reduce(count, batch=True))])
    core_peak = torch.cuda.max_memory_allocated()
    got_k, got_c = kv_arrays(incore)
    if not (np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)):
        raise AssertionError("ooc: the in-core chain differs from np.unique")
    incore.kv.free()
    del got_k, got_c, want_k, want_c
    srt = MapReduce(device=device, **settings)
    srt.map_files([path], read_u32_keys)
    with counting(external, "_write_run") as sort_runs:
        sort_s = timed_ops(device, [("sort_keys", lambda: srt.sort_keys(-1))])
    got_k, _ = kv_arrays(srt)
    srt.kv.free()
    t0 = time.perf_counter()
    if not np.array_equal(got_k, np.sort(keys)[::-1]):
        raise AssertionError("ooc: sort_keys(-1) is not the input's keys "
                             "in non-increasing unsigned order")
    oracle_s += time.perf_counter() - t0
    shutil.rmtree(spill, ignore_errors=True)
    return {"keys": len(keys), "pair_bytes": len(keys) * 12,
            "settings": {k: v for k, v in settings.items() if k != "fpath"},
            "op_s": ooc_s, "incore_op_s": core_s,
            "sort_keys_desc_s": sort_s["sort_keys"],
            "pages_after_map": pages["map"][0],
            "spill_files_after_map": pages["map"][1],
            "spill_files_written": spills[0], "runs": runs[0],
            "sort_runs": sort_runs[0], "result_pages": result_pages,
            **counters, "max_memory_allocated": peak,
            "incore_max_memory_allocated": core_peak,
            "launches": launches, "unique": nunique,
            "oracle_s": oracle_s, "seconds": time.perf_counter() - t_phase}


def checkpoint_lines() -> list:
    """examples/in.checkpoint's lines on the graph script's edge MR."""
    return [f"mre save {CKPT_DIR}", "mr mrb", f"mrb load {CKPT_DIR}",
            "degree 0 -i mrb -o NULL mrdb", "degree 0 -i mre -o NULL mrde"]


def check_checkpoint(run, device) -> dict:
    """After the graph script's checkpoint lines (cwd: the phase's
    directory): the degrees of the reloaded edges equal those of the
    original, on the card; save and load seconds and GB/s; then a copy
    of the checkpoint with one byte of one frame flipped must refuse to
    load with IntegrityError."""
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.utils.integrity import (IntegrityError,
                                                         verify_enabled)
    named = run["interp"].obj.named
    if not verify_enabled():
        raise AssertionError("checkpoint: MRTPU_VERIFY is off")
    if not same_pairs_on_card(named["mrdb"], named["mrde"]):
        raise AssertionError("checkpoint: the degrees of the reloaded "
                             "edges differ from the original's")
    files = sorted(os.listdir(CKPT_DIR))
    nbytes = sum(os.path.getsize(os.path.join(CKPT_DIR, f)) for f in files)
    save_s = run["seconds"]["mre save"]
    load_s = run["seconds"]["mrb load"]
    bad = CKPT_DIR + ".flipped"
    os.makedirs(bad)
    for f in files:
        if f == "frame-00000.npz":
            shutil.copyfile(os.path.join(CKPT_DIR, f), os.path.join(bad, f))
        else:
            os.link(os.path.join(CKPT_DIR, f), os.path.join(bad, f))
    frame = os.path.join(bad, "frame-00000.npz")
    with open(frame, "r+b") as fh:
        fh.seek(os.path.getsize(frame) // 2)
        b = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([b[0] ^ 0x01]))
    t0 = time.perf_counter()
    try:
        MapReduce(device=device).load(bad)
    except IntegrityError as e:
        refused = str(e)
    else:
        raise AssertionError("checkpoint: a flipped byte loaded")
    refuse_s = time.perf_counter() - t0
    shutil.rmtree(bad)
    shutil.rmtree(CKPT_DIR)
    return {"lines": checkpoint_lines(), "files": len(files),
            "bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "save_gb_per_s": nbytes / save_s / 1e9,
            "load_gb_per_s": nbytes / load_s / 1e9,
            "degree_equal_on_card": True, "digests_verified": True,
            "flipped_byte_refused": refused[:120],
            "flipped_refuse_s": refuse_s}


def kmv_rows(mr) -> list:
    """A KMV's groups on the host: (key, value rows) per frame."""
    import numpy as np
    out = []
    for fr in mr.kmv.frames():
        fr = fr.to_host()
        out.append((fr.key.tolist(), np.asarray(fr.nvalues).tolist(),
                    fr.values.tolist()))
    return out


def kv_rows(mr) -> list:
    return [(fr.key.tolist(), fr.value.tolist())
            for fr in (f.to_host() for f in mr.kv.frames())]


def host_text_outputs(device, paths, d: str) -> dict:
    """The host tier's card-vs-CPU outputs from one device: collapse,
    scrunch 1 and broadcast 0 of the text KV (each word as key and
    value); the interned KV and its
    KMV after collate, saved under ``d``; and the chunk maps ("\n" with
    map_file_char, "\n\n" with map_file_str) under mapstyle 0 and 2,
    their chunks concatenated and their words counted."""
    from collections import Counter
    import numpy as np
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.utils.io import split_words

    def word_pairs(itask, fname, kv, ptr):       # (word, word): text both
        col = split_words(np.fromfile(fname, np.uint8), kv.device)
        kv.add_batch(col, col)

    out = {}
    base = MapReduce(device=device)
    base.map_files(paths, word_pairs)
    for op, call in (("collapse", lambda m: m.collapse(b"all")),
                     ("scrunch", lambda m: m.scrunch(1, b"all"))):
        m = base.copy()
        out[op] = (call(m), kmv_rows(m))
    out["broadcast"] = (base.copy().broadcast(0), kv_rows(base))
    base.aggregate()
    base.save(os.path.join(d, f"kv-{device}"))
    out["interned_kv"] = kv_rows(base)
    base.collate()
    base.save(os.path.join(d, f"kmv-{device}"))
    out["interned_kmv"] = kmv_rows(base)
    data = b"".join(open(p, "rb").read() for p in paths)
    for method, sep in (("map_file_char", "\n"), ("map_file_str", "\n\n")):
        for style in (0, 2):
            m = MapReduce(device=device, mapstyle=style)
            n = getattr(m, method)(16, paths, 0, 0, sep, 80,
                                   lambda i, chunk, kv, p: kv.add(i, chunk))
            chunks = [v for _, vs in kv_rows(m) for v in vs]
            if b"".join(chunks) != data:
                raise AssertionError(f"text-check {device}: {method} "
                                     f"mapstyle {style} chunks differ "
                                     f"from the files' bytes")
            words = Counter(w for ch in chunks for w in ch.split())
            out[f"{method}/{style}"] = (n, kv_rows(m), sorted(words.items()))
    return out


def check_cross_loads(d: str, got: dict) -> list:
    """Each device's saved interned KV and KMV, loaded on the other
    device, must give that device's rows."""
    from gpu_mapreduce_tpu_torch import MapReduce
    done = []
    for writer, reader in (("cuda", "cpu"), ("cpu", "cuda")):
        for kind, rows in (("kv", kv_rows), ("kmv", kmv_rows)):
            m = MapReduce(device=reader)
            m.load(os.path.join(d, f"{kind}-{writer}"))
            if rows(m) != got[reader][f"interned_{kind}"]:
                raise AssertionError(f"text-check: the {kind} saved on "
                                     f"{writer} loads differently on "
                                     f"{reader}")
            done.append(f"{kind} {writer}->{reader}")
    return done


def run_chunk_wordfreq(paths, oracle: dict, device, kernels) -> dict:
    """The wordfreq-zipf corpus through map_file_char(64, files, 0, 0,
    "\n", 80) under mapstyle 2: each chunk split into words on the card
    (utils/io.split_words, no Python object per word) as a packed byte
    column, then one collate on the card (the words intern there once).
    Words and distinct words must equal the generator's."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.utils.io import split_words

    def per_chunk(itask, chunk, kv, ptr):
        col = split_words(chunk, kv.device)
        kv.add_batch(col, np.zeros(len(col), np.uint8))

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mr = MapReduce(device=device, mapstyle=2, fuse=0)
    got = {}
    secs = timed_ops(device, [
        ("map_file_char", lambda: got.__setitem__(
            "nwords", mr.map_file_char(64, paths, 0, 0, "\n", 80,
                                       per_chunk))),
        ("collate", lambda: got.__setitem__("nunique", mr.collate()))])
    if (got["nwords"], got["nunique"]) != (oracle["nwords"],
                                           oracle["nunique"]):
        raise AssertionError(f"wordfreq chunks: {got} != the generator's "
                             f"{oracle['nwords']} words, "
                             f"{oracle['nunique']} unique")
    mr.kmv.free()
    nbytes = sum(os.path.getsize(p) for p in paths)
    total = sum(secs.values())
    return {"files": len(paths), "bytes": nbytes, "mapstyle": 2,
            "nmap": 64, **got, "op_s": secs,
            "bytes_per_s": nbytes / total,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": {k.__name__: k.launches for k in kernels}}


GRAPH_SCALE = 22               # BASELINE.json's PageRank scale
GRAPH_EDGEFACTOR = 16          # Graph500 spec, section 3
GRAPH_ABCD = (0.57, 0.19, 0.19, 0.05)   # Graph500 Kronecker initiator
GRAPH_SEED = 20260
GRAPH_TOL = 1e-8               # above the f32 noise floor (PERF.md)
GRAPH_MAXITER = 100
GRAPH_DAMPING = 0.85
LUBY_SEED = 6789
SSSP_SOURCES = 2
SSSP_SEED = 12345
TRI_SCALE = 18                 # cut from 22: the triangle rows' size
TRI_CHECK_SCALE = 12           # the card-vs-CPU neigh_tri run
TRI_MEMBERSHIP_BUDGET_S = 60.0
COMPOSED_CHECK_SCALE = 12      # the composed engines, card vs CPU
COMPOSED = ("cc_find", "luby_find", "tri_find", "sssp")


def graph_script(scale: int, edgefactor: int) -> list:
    """The graph phase's OINK script, one command a line."""
    a, b, c, d = GRAPH_ABCD
    return [
        f"rmat {scale} {edgefactor} {a} {b} {c} {d} 0.0 {GRAPH_SEED} "
        f"-o NULL mre",
        *checkpoint_lines(), "mrb delete",
        "degree_stats 0 -i mre",
        f"pagerank {GRAPH_TOL} {GRAPH_MAXITER} {GRAPH_DAMPING} -i mre "
        f"-o NULL mrpr",
        "edge_upper -i mre -o NULL mru",
        "cc_find 0 -i mru -o NULL mrc",
        "cc_stats -i mrc",
        "mr mrv",
        "mrv map/mr mre edge_to_vertices",
        "histo -i mrv",
        f"luby_find {LUBY_SEED} -i mru -o NULL mrl",
        "mre map/mr mre add_weight",
        f"sssp {SSSP_SOURCES} {SSSP_SEED} -i mre -o NULL mrs"]


def composed_graph_lines() -> list:
    """The composed engines on the graph script's named MRs, after it:
    (line, engine) pairs."""
    return [("cc_find 0 -i mru -o NULL mrcc", "composed"),
            (f"luby_find {LUBY_SEED} -i mru -o NULL mrlc", "composed"),
            (f"sssp {SSSP_SOURCES} {SSSP_SEED} -i mre -o NULL mrsc",
             "composed")]


def tri_script(scale: int) -> list:
    """The tri phase's OINK script on the graph-rmat parameters."""
    a, b, c, d = GRAPH_ABCD
    return [f"rmat {scale} {GRAPH_EDGEFACTOR} {a} {b} {c} {d} 0.0 "
            f"{GRAPH_SEED} -o NULL mre",
            "edge_upper -i mre -o NULL mru",
            "tri_find -i mru -o NULL mrt"]


def neigh_tri_script(scale: int) -> list:
    """neighbor → tri_find → neigh_tri into files under the cwd."""
    a, b, c, d = GRAPH_ABCD
    return [f"rmat {scale} {GRAPH_EDGEFACTOR} {a} {b} {c} {d} 0.0 "
            f"{GRAPH_SEED} -o NULL mre",
            "edge_upper -i mre -o tmp.upper NULL",
            "neighbor -i tmp.upper -o tmp.nb NULL",
            "tri_find -i tmp.upper -o tmp.tri NULL",
            "neigh_tri tmp.nt -i tmp.nb tmp.tri"]


@contextlib.contextmanager
def graph_spans(device, keep=(), keep_args=()):
    """Wall seconds of each call of the graph engines' stages, between two
    device synchronises (the engines read a host scalar every step
    anyway): generation, collate, each command's staging, the fused
    loops and each of their rounds (the wedge batches for tri_find), and
    the composed engines' callbacks that open each round (cc's
    ``edge_vert_tagged``, luby's ``edge_winner``, sssp's
    ``pick_shortest``) or a stage (tri's).  Yields ({label: [seconds of
    each call]}, {label: [what each call returned, or its positional
    arguments for the labels in ``keep_args``]} for the labels in
    ``keep`` and ``keep_args``, {label: [perf_counter at each call's
    start]})."""
    import torch
    from gpu_mapreduce_tpu_torch.core.mapreduce import MapReduce
    from gpu_mapreduce_tpu_torch.models import cc as cc_model
    from gpu_mapreduce_tpu_torch.models import luby as luby_model
    from gpu_mapreduce_tpu_torch.models import pagerank as pr_model
    from gpu_mapreduce_tpu_torch.models import sssp as sssp_model
    from gpu_mapreduce_tpu_torch.models import tri as tri_model
    from gpu_mapreduce_tpu_torch.oink.commands import (cc, luby, pagerank,
                                                       rmat, sssp, tri)
    times, outputs, starts = {}, {}, {}
    spans = [(rmat, "rmat_edges", "rmat_generate"),
             (MapReduce, "collate", "collate"),
             (pagerank, "stage_graph", "pagerank_stage"),
             (pagerank, "pagerank_sharded", "pagerank_loop"),
             (pr_model, "pagerank_step", "pagerank_step"),
             (cc, "stage_graph", "cc_stage"), (cc, "cc_sharded", "cc_loop"),
             (cc_model, "_round", "cc_round"),
             (luby, "stage_graph", "luby_stage"),
             (luby, "luby_mis_sharded", "luby_loop"),
             (luby_model, "_round", "luby_round"),
             (sssp, "stage_graph", "sssp_stage"),
             (sssp, "bellman_ford_sharded", "sssp_loop"),
             (sssp_model, "_round", "sssp_round"),
             (tri, "stage_graph", "tri_stage"),
             (tri, "triangles_ranked", "tri_loop"),
             (tri_model, "wedge_batch", "tri_batch"),
             (cc, "edge_vert_tagged", "cc_composed_round"),
             (luby, "edge_winner", "luby_composed_round"),
             (sssp, "pick_shortest", "sssp_composed_round"),
             (sssp.SSSPCommand, "_finish_source", "sssp_source"),
             (tri, "first_degree", "tri_composed_first_degree"),
             (tri, "nsq_angles", "tri_composed_angles"),
             (tri, "emit_triangles", "tri_composed_emit")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in spans]

    def sync():
        if device.type == "cuda":
            sync_all()

    def timed(fn, label):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            times.setdefault(label, []).append(time.perf_counter() - t0)
            starts.setdefault(label, []).append(t0)
            if label in keep:
                outputs.setdefault(label, []).append(out)
            if label in keep_args:
                outputs.setdefault(label, []).append(args)
            return out
        return wrapper

    for (owner, attr, label), (_, _, fn) in zip(spans, saved):
        setattr(owner, attr, timed(fn, label))
    try:
        yield times, outputs, starts
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


@contextlib.contextmanager
def engine(name: str, value):
    """Set a graph command's ``engine`` attribute for the block."""
    from gpu_mapreduce_tpu_torch.oink.command import COMMANDS
    cls = COMMANDS[name]
    saved = cls.__dict__.get("engine")
    cls.engine = value
    try:
        yield
    finally:
        cls.engine = saved


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


def graph_oracles(scale, edgefactor, screens, got) -> dict:
    """Host oracles independent of the port (numpy, scipy): the R-MAT
    edge set, the degree histogram (degree_stats and histo), PageRank by
    a float64 power iteration (scipy.sparse) with the same damping and
    step count, sssp by scipy's directed unweighted shortest paths,
    components by scipy's connected_components, and the Luby set's
    independence and maximality; the composed engines' runs too (cc's
    count, luby's set, sssp's distances equal to the fused run's and its
    preds).  ``got``: the result MRs pulled to the host.  Raises on any
    disagreement; returns what they found and their seconds by part."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components, shortest_path
    part_s = {}
    t0 = time.perf_counter()
    edges = got["edges"]
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
    head = screens["histo"][0]
    if head != f"Histo: {2 * ntotal} total keys, {len(deg)} unique" or \
            _histogram(screens["histo"]) != want:
        raise AssertionError(f"histo differs from np.bincount: {head!r}")
    part_s["degree_stats+histo"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    present = np.zeros(1 << scale, bool)
    present[flat] = True
    del flat
    verts = np.nonzero(present)[0].astype(np.uint64)
    rank_of = np.cumsum(present) - 1
    src, dst = rank_of[vi.astype(np.int64)], rank_of[vj.astype(np.int64)]
    n = len(verts)
    pverts, pranks, iters = got["pagerank"]
    if not np.array_equal(pverts, verts):
        raise AssertionError("pagerank: vertex table differs")
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    dangling = outdeg == 0
    inv = np.where(dangling, 0.0, 1.0 / np.maximum(outdeg, 1.0))
    a = _compressed(src, dst, inv[src], n, sp.csc_matrix)   # a[dst, src]
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
    g = _compressed(src, dst, np.ones(len(src), np.float64), n,
                    sp.csr_matrix)
    del src, dst
    runs = [ln.split() for ln in screens["sssp"]]    # SSSP: source S: ...
    sources = [int(w[2].rstrip(":")) for w in runs]
    labeled = [int(w[5]) for w in runs]
    if len(sources) != SSSP_SOURCES or \
            len(got["sssp_runs"]) != SSSP_SOURCES:
        raise AssertionError(f"sssp ran {len(sources)} sources")
    ref = shortest_path(g, directed=True, unweighted=True,
                        indices=rank_of[np.array(sources)])
    del g
    want_labeled = np.isfinite(ref).sum(axis=1).tolist()
    if labeled != want_labeled:
        raise AssertionError(f"sssp: labeled {labeled}, scipy "
                             f"{want_labeled}")
    npreds = 0
    for (dist, pred), want in zip(got["sssp_runs"], ref):
        # dist exactly scipy's; each pred an in-neighbour one step closer
        reach = np.isfinite(dist) & (dist > 0)
        p = pred[reach].astype(np.int64)
        keys = (verts[p] << np.uint64(scale)) | verts[reach]
        pos = np.minimum(np.searchsorted(packed, keys), len(packed) - 1)
        ok = (packed[pos] == keys) & (dist[p] == dist[reach] - 1)
        if not np.array_equal(dist, want) or not ok.all() or \
                np.any(pred[~reach] != -1):
            raise AssertionError(f"sssp differs from scipy: "
                                 f"{int((~ok).sum())} bad preds")
        npreds += int(reach.sum())
    # the composed engine's runs: the same sources and labeled counts,
    # the distances equal to the fused run's, each pred (an id, 0 for
    # none) an in-neighbour one step closer
    cruns = [ln.split() for ln in screens["sssp/composed"]]
    if [int(w[2].rstrip(":")) for w in cruns] != sources or \
            [int(w[5]) for w in cruns] != labeled or \
            len(got["sssp_composed_runs"]) != SSSP_SOURCES:
        raise AssertionError(f"sssp/composed: {screens['sssp/composed']}")
    ncpreds = 0
    for (cverts, cdist, cpred), (dist, _) in zip(got["sssp_composed_runs"],
                                                 got["sssp_runs"]):
        reach = np.isfinite(cdist) & (cdist > 0)
        p = rank_of[cpred[reach].astype(np.int64)]
        keys = (verts[p] << np.uint64(scale)) | verts[reach]
        pos = np.minimum(np.searchsorted(packed, keys), len(packed) - 1)
        ok = (packed[pos] == keys) & (cdist[p] == cdist[reach] - 1)
        if not (np.array_equal(cverts, verts) and np.array_equal(cdist, dist)
                and ok.all()):
            raise AssertionError(f"sssp/composed differs from the fused "
                                 f"run: {int((~ok).sum())} bad preds")
        ncpreds += int(reach.sum())
    sverts, rows = got["sssp"]                # the last source's rows
    last = np.where(pred >= 0, verts[np.maximum(pred, 0)].astype(
        np.float64), -1.0)
    if not (np.array_equal(sverts, verts) and np.array_equal(
            rows[:, 2], dist) and np.array_equal(rows[:, 1], last)):
        raise AssertionError("sssp: the named MR's rows differ from the "
                             "last source's run")
    del packed, keys, pos, ok, p
    part_s["sssp"] = time.perf_counter() - t0

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
    cverts, czones = got["cc"]
    cmsg = screens["cc_find"][0]
    if not (np.array_equal(cverts, verts2) and np.array_equal(czones, zones)
            and cmsg.startswith(f"CC_find: {ncomp} components in ")
            and screens["cc_find/composed"][0].startswith(
                f"CC_find: {ncomp} components in ")):
        raise AssertionError(f"cc_find differs from scipy "
                             f"connected_components ({ncomp}): {cmsg!r}")
    sizes = np.bincount(labels)
    head = screens["cc_stats"][0]
    if head != f"CCStats: {ncomp} components, {n2} vertices" or \
            _histogram(screens["cc_stats"]) != _desc_histogram(sizes):
        raise AssertionError(f"cc_stats differs: {head!r}")
    part_s["cc"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    upper = got["upper"]
    lo, hi = upper[:, 0].astype(np.int64), upper[:, 1].astype(np.int64)
    for label, mis in (("luby_find", got["luby"]),
                       ("luby_find/composed", got["luby_composed"])):
        inset = np.zeros(1 << scale, bool)
        inset[mis.astype(np.int64)] = True
        covered = inset.copy()
        covered[lo[inset[hi]]] = True
        covered[hi[inset[lo]]] = True
        independent = not np.any(inset[lo] & inset[hi])
        maximal = not np.any(present & ~covered)
        lmsg = screens[label][0]
        if not (independent and maximal and not np.any(inset & ~present)
                and lmsg.startswith(f"Luby_find: {len(mis)} MIS vertices")):
            raise AssertionError(f"{label}: independent {independent}, "
                                 f"maximal {maximal}: {lmsg!r}")
    part_s["luby"] = time.perf_counter() - t0
    return {"vertices": n, "cc_vertices": n2, "components": int(ncomp),
            "largest_component": int(sizes.max()),
            "pagerank_l1_vs_f64": l1, "pagerank_sum": total,
            "top100_equal": True, "histo_equals_bincount": True,
            "luby_set": len(got["luby"]),
            "luby_composed_set": len(got["luby_composed"]),
            "luby_independent_and_maximal": True,
            "sssp_sources": sources, "sssp_labeled": labeled,
            "sssp_dist_equal_scipy": True, "sssp_preds_checked": npreds,
            "sssp_composed_dist_equal_fused": True,
            "sssp_composed_preds_checked": ncpreds,
            "seconds_by_part": part_s}


def drive_script(device, lines, kernels, interp=None) -> dict:
    """The OINK ``lines`` through the port's OinkScript on ``device`` from
    the cwd (or through ``interp``, to go on with its named MRs), each
    command between device synchronises, every launch count set to 0
    just before the first: the interpreter, and by command its seconds,
    screen lines, peak device bytes and end time, the launches and the
    engine spans (``graph_spans``) over the run.  A line may be a pair
    (line, engine): the command runs with its ``engine`` attribute set,
    labelled ``<command>/<engine>``."""
    import io
    import torch
    from gpu_mapreduce_tpu_torch import OinkScript
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        sync_all()
    for k in kernels:
        k.launches = 0
    s = interp or OinkScript(device=device, screen=False, logfile=None)
    seconds, screens, peaks, ends = {}, {}, {}, {}
    with graph_spans(device, keep=("sssp_loop",),
                     keep_args=("sssp_source",)) as (spans, outputs,
                                                     starts):
        for line in lines:
            line, eng = (line, None) if isinstance(line, str) else line
            words = line.split()
            # a named-MR line is labelled by its MR and method, a
            # repeated label by its count
            label = " ".join(words[:2]) if len(words) > 1 and (
                words[1].startswith("map/")
                or words[1] in ("save", "load", "delete")) else words[0]
            label += f"/{eng}" if eng else ""
            if label in seconds:
                label += f"#{sum(k.split('#')[0] == label for k in seconds) + 1}"
            s.screen = buf = io.StringIO()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with engine(words[0], eng) if eng else contextlib.nullcontext():
                s.one(line)
            if cuda:
                sync_all()
            ends[label] = time.perf_counter()
            seconds[label] = ends[label] - t0
            if cuda:
                peaks[label] = torch.cuda.max_memory_allocated()
            screens[label] = buf.getvalue().splitlines()
    return {"interp": s, "seconds": seconds, "screens": screens,
            "peak_bytes": peaks if cuda else None, "ends": ends,
            "launches": {k.__name__: k.launches for k in kernels},
            "spans": spans, "outputs": outputs, "starts": starts}


def round_seconds(run, marker: str, label: str) -> list:
    """Seconds from each call of a composed engine's round-opening
    callback ``marker`` to the next, the last to the command's end."""
    marks = run["starts"].get(marker, []) + [run["ends"][label]]
    return [b - a for a, b in zip(marks, marks[1:])]


def composed_record(run, label: str, marker: str) -> dict:
    """Seconds, peak bytes and per-round seconds of one composed
    command."""
    peaks = run["peak_bytes"]
    return {"seconds": run["seconds"][label],
            "peak_bytes": peaks[label] if peaks else None,
            "message": run["screens"][label][0],
            "round_s": round_seconds(run, marker, label)}


def _span_record(spans) -> dict:
    return {"stage_s": {k: sum(v) for k, v in spans.items()},
            "stage_calls": {k: len(v) for k, v in spans.items()}}


def same_pairs_on_card(a, b) -> bool:
    """Whether two MRs hold the same pairs, their keys distinct (cc's
    (v, zone)): each KV sorted by key on its device, then compared."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.ops.bits import order_key
    (ka, va), (kb, vb) = (mr.kv.one_frame().valid_rows() for mr in (a, b))
    if len(ka) != len(kb):
        return False
    sa, sb = (torch.sort(order_key(k, np.uint64)).indices for k in (ka, kb))
    return torch.equal(ka[sa], kb[sb]) and torch.equal(va[sa], vb[sb])


GRAPH_KEEP: dict = {}          # the graph phase's cc, PageRank and lines


def run_graph(device, smi: str, kernels=(), scale: int = GRAPH_SCALE,
              edgefactor: int = GRAPH_EDGEFACTOR, p4: bool = False) -> dict:
    """The graph phase: the OINK script of :func:`graph_script` through
    the port's ``OinkScript`` on ``device``, each command timed between
    device synchronises, then the composed engines on its named MRs
    (:func:`composed_graph_lines`; composed cc's pairs compared with the
    fused run's on the card), then the host oracles.  With ``p4`` the
    same script runs on four shards in between (:func:`run_graph_p4`,
    under the record's ``p4``)."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.interop import mapreduce_to_numpy
    from gpu_mapreduce_tpu_torch.ops.bits import to_numpy
    rmat_round = check_rmat_round(device, scale)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graph_")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        run = drive_script(device, graph_script(scale, edgefactor), kernels)
        ckpt = check_checkpoint(run, device)
        comp = drive_script(device, composed_graph_lines(), kernels,
                            interp=run["interp"])
        named = run["interp"].obj.named
        screens, spans = {**run["screens"], **comp["screens"]}, run["spans"]
        seconds, peaks = run["seconds"], run["peak_bytes"]
        launches, comp_launches = run["launches"], comp["launches"]
        t0 = time.perf_counter()
        if not same_pairs_on_card(named["mrc"], named["mrcc"]):
            raise AssertionError("cc_find/composed: the (v, zone) pairs "
                                 "differ from the fused run's")
        compare_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p4_rec = run_graph_p4(device, run, comp, kernels, scale,
                              edgefactor) if p4 else None
        if p4_rec:
            p4_rec["seconds"] = time.perf_counter() - t0
        if p4_rec and device.type == "cuda" and \
                torch.cuda.device_count() >= 2:
            # one shard a card
            t0 = time.perf_counter()
            p4_rec["several_cards"] = run_graph_p4(
                device, run, comp, kernels, scale, edgefactor,
                devices=[torch.device("cuda", i) for i in range(
                    min(MESH_P, torch.cuda.device_count()))])
            p4_rec["several_cards"]["seconds"] = time.perf_counter() - t0
        composed = {
            name: composed_record(comp, f"{name}/composed", marker)
            for name, marker in (("cc_find", "cc_composed_round"),
                                 ("luby_find", "luby_composed_round"),
                                 ("sssp", "sssp_composed_round"))}
        t0 = time.perf_counter()
        got = {"edges": mapreduce_to_numpy(named["mre"])[0],
               "upper": mapreduce_to_numpy(named["mru"])[0],
               "cc": mapreduce_to_numpy(named["mrc"]),
               "luby": mapreduce_to_numpy(named["mrl"])[0],
               "sssp": mapreduce_to_numpy(named["mrs"]),
               "sssp_runs": [(d.cpu().numpy(), p.cpu().numpy()) for d, p, _
                             in run["outputs"].get("sssp_loop", [])],
               "luby_composed": mapreduce_to_numpy(named["mrlc"])[0],
               "sssp_composed_runs": [
                   (to_numpy(v, np.uint64), d.cpu().numpy(),
                    to_numpy(p, np.uint64)) for _cmd, _cnt, _src, _it, v,
                   d, p in comp["outputs"].get("sssp_source", [])]}
        pr_verts, pr_ranks = mapreduce_to_numpy(named["mrpr"])
        pull_s = time.perf_counter() - t0
        msgs = {w: lines[0] for w, lines in screens.items() if lines}
        rounds = int(msgs["rmat"].split()[-2])
        pr_iters = int(msgs["pagerank"].split()[-2])
        cc_rounds = int(msgs["cc_find"].split()[-2])
        luby_rounds = int(msgs["luby_find"].split()[-2])
        sssp_rounds = [int(ln.split()[3]) for ln in screens["sssp"]]
        got["pagerank"] = (pr_verts, pr_ranks, pr_iters)
        # what ft-resume holds its resumed run against
        GRAPH_KEEP.update(cc=got["cc"], pagerank=got["pagerank"],
                          screens={k: screens[k] for k in (
                              "degree_stats", "cc_stats")})
        del run, comp, named
        t0 = time.perf_counter()
        found = graph_oracles(scale, edgefactor, screens, got)
        oracle_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    nedges = len(got["edges"])
    step_s = statistics.median(spans["pagerank_step"])
    return {"phase": "graph", "card": smi,
            "config": {"scale": scale, "edgefactor": edgefactor,
                       "abcd": GRAPH_ABCD, "seed": GRAPH_SEED,
                       "pagerank": [GRAPH_TOL, GRAPH_MAXITER,
                                    GRAPH_DAMPING],
                       "luby_seed": LUBY_SEED,
                       "sssp": [SSSP_SOURCES, SSSP_SEED]},
            "script": graph_script(scale, edgefactor),
            "edges": nedges, "edge_key_bytes": got["edges"].nbytes,
            "upper_edges": len(got["upper"]),
            "rmat_rounds": rounds, "pagerank_iterations": pr_iters,
            "cc_rounds": cc_rounds, "luby_rounds": luby_rounds,
            "sssp_rounds": sssp_rounds, "command_s": seconds,
            "peak_bytes_by_command": peaks,
            "max_memory_allocated": max(peaks.values()) if peaks else None,
            "launches": launches, **_span_record(spans),
            "pagerank_step_s": spans["pagerank_step"],
            "cc_round_s": spans["cc_round"],
            "luby_round_s": spans["luby_round"],
            "sssp_round_s": spans["sssp_round"],
            "pagerank_step_median_s": step_s,
            "pagerank_edges_per_s_per_iteration": nedges / step_s,
            "messages": msgs, "pull_to_host_s": pull_s,
            "oracle_s": oracle_s, "oracles": found,
            "rmat_round_device_vs_cpu": rmat_round,
            "composed": composed, "launches_composed": comp_launches,
            "composed_cc_equal_fused_on_card": True,
            "composed_cc_compare_s": compare_s, "checkpoint": ckpt,
            "p4": p4_rec}


def tri_oracles(scale: int, upper, rows, message: str, nbatches: int
                ) -> dict:
    """Host oracles for tri_find (numpy, scipy): the triangle count by a
    blockwise (L @ L) * L over the degree-oriented canonical graph, the
    wedge count, every row distinct, every row's three edges canonical
    edges (all rows when the projected time fits the budget, else a
    seeded sample of 2^20 rows)."""
    import numpy as np
    import scipy.sparse as sp
    part_s = {}
    t0 = time.perf_counter()
    nv = 1 << scale
    s = np.uint64(scale)
    lo = np.minimum(upper[:, 0], upper[:, 1])
    hi = np.maximum(upper[:, 0], upper[:, 1])
    canon = np.unique(((lo << s) | hi)[lo != hi])
    lo, hi = (canon >> s).astype(np.int64), (canon & np.uint64(nv - 1)
                                             ).astype(np.int64)
    deg = np.bincount(lo, minlength=nv) + np.bincount(hi, minlength=nv)
    swap = (deg[lo] > deg[hi]) | ((deg[lo] == deg[hi]) & (lo > hi))
    a, b = np.where(swap, hi, lo), np.where(swap, lo, hi)
    k = np.bincount(a, minlength=nv)
    wedges = int((k * (k - 1) // 2).sum())
    L = _compressed(a, b, np.ones(len(a), np.float64), nv, sp.csr_matrix)
    del a, b, swap, deg
    count = 0
    block = 1 << 15
    for r0 in range(0, nv, block):
        part = L[r0:r0 + block]
        count += int(round((part @ L).multiply(part).sum()))
    del L, part
    part_s["count"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    t = len(rows)
    c0, c1, c2 = rows[:, 0], rows[:, 1], rows[:, 2]
    x = np.minimum(np.minimum(c0, c1), c2)
    z = np.maximum(np.maximum(c0, c1), c2)
    y = c0 ^ c1 ^ c2 ^ x ^ z                  # the middle id
    del c0, c1, c2
    key = (x << (s + s)) | (y << s) | z
    key.sort()
    distinct = not np.any(key[1:] == key[:-1])
    del key
    part_s["distinct"] = time.perf_counter() - t0

    def members(idx):
        """Whether the rows ``idx`` have all three edges in ``canon``
        (each edge column's keys sorted first: a search over ascending
        keys walks ``canon`` in order)."""
        for p, q in ((x, y), (x, z), (y, z)):
            key = (p[idx] << s) | q[idx]
            key.sort()
            pos = np.minimum(np.searchsorted(canon, key), len(canon) - 1)
            if not np.array_equal(canon[pos], key):
                return False
        return True

    t0 = time.perf_counter()
    sample = np.random.default_rng(GRAPH_SEED).choice(
        t, min(t, 1 << 20), replace=False)
    in_sample = members(sample)
    sample_s = time.perf_counter() - t0
    projected = sample_s * t / max(len(sample), 1)
    checked = "sample of 2^20 seeded rows"
    ok_edges = in_sample
    if projected <= TRI_MEMBERSHIP_BUDGET_S:
        t0 = time.perf_counter()
        ok_edges = members(np.arange(t))
        checked = "all rows"
        part_s["membership_all"] = time.perf_counter() - t0
    part_s["membership_sample"] = sample_s
    batches = -(-wedges // (1 << 24))
    if not (count == t and distinct and ok_edges
            and message == f"Tri_find: {count} triangles"
            and nbatches == batches):
        raise AssertionError(f"tri_find: {t} rows vs scipy's {count}, "
                             f"distinct {distinct}, edges {ok_edges} "
                             f"({checked}), batches {nbatches} vs "
                             f"{batches}: {message!r}")
    return {"triangles": count, "wedges": wedges, "batches": batches,
            "canonical_edges": len(canon), "rows_distinct": True,
            "edges_checked": checked,
            "membership_projected_s": projected, "seconds_by_part": part_s}


def neigh_tri_files(device, scale: int) -> dict:
    """neighbor → tri_find → neigh_tri on ``device`` in a fresh
    directory: {path: bytes} of tmp.tri and every per-vertex file."""
    from gpu_mapreduce_tpu_torch import OinkScript
    tmp = tempfile.mkdtemp(prefix="chip_smoke_neigh_tri_")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        s = OinkScript(device=device, screen=False, logfile=None)
        for line in neigh_tri_script(scale):
            s.one(line)
        out = {"tmp.tri": open("tmp.tri", "rb").read()}
        for name in os.listdir("tmp.nt"):
            with open(os.path.join("tmp.nt", name), "rb") as f:
                out["tmp.nt/" + name] = f.read()
        return out
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def same_triangles_on_card(a, b, scale: int) -> bool:
    """Whether two MRs of [t, 3] triangle rows (ids < 2^scale) hold the
    same triangles: each row's ids sorted and packed into one int64,
    the packed keys sorted and compared, on the device."""
    fa, fb = a.kv.one_frame(), b.kv.one_frame()
    if len(fa) != len(fb) or 3 * scale > 63:
        return False
    import torch
    keys = []
    for f in (fa, fb):
        r = torch.sort(f.valid_rows()[0], dim=1).values
        keys.append(torch.sort((r[:, 0] << (2 * scale)) | (r[:, 1] << scale)
                               | r[:, 2]).values)
        del r
    return torch.equal(keys[0], keys[1])


def composed_script(scale: int) -> list:
    """The four composed commands on one graph, into files under the
    cwd (each command's engine set by the caller)."""
    a, b, c, d = GRAPH_ABCD
    return [f"rmat {scale} {GRAPH_EDGEFACTOR} {a} {b} {c} {d} 0.0 "
            f"{GRAPH_SEED} -o NULL mre",
            "edge_upper -i mre -o NULL mru",
            "mre map/mr mre add_weight",
            "cc_find 0 -i mru -o tmp.cc NULL",
            f"luby_find {LUBY_SEED} -i mru -o tmp.luby NULL",
            "tri_find -i mru -o tmp.tri NULL",
            f"sssp {SSSP_SOURCES} {SSSP_SEED} -i mre -o tmp.sssp NULL"]


def composed_outputs(device, scale: int) -> dict:
    """:func:`composed_script` on ``device`` with every graph command on
    its composed engine, in a fresh directory: the screen lines and each
    output file's lines, sorted."""
    import io
    from gpu_mapreduce_tpu_torch import OinkScript
    tmp = tempfile.mkdtemp(prefix="chip_smoke_composed_")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with contextlib.ExitStack() as stack:
            for name in COMPOSED:
                stack.enter_context(engine(name, "composed"))
            buf = io.StringIO()
            s = OinkScript(device=device, screen=buf, logfile=None)
            for line in composed_script(scale):
                s.one(line)
        out = {"screen": buf.getvalue().splitlines()}
        for name in sorted(os.listdir(".")):
            with open(name) as f:
                out[name] = sorted(f.read().splitlines())
        return out
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def run_composed_check(device, smi: str,
                       scale: int = COMPOSED_CHECK_SCALE) -> dict:
    """The four composed engines at ``scale`` on the card and on the CPU:
    equal screen lines and equal output lines, sorted."""
    import torch
    got, seconds = {}, {}
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        got[dev.type] = composed_outputs(dev, scale)
        seconds[dev.type] = time.perf_counter() - t0
    card, cpu = got[device.type], got["cpu"]
    if card != cpu or len(card) != 6 or len(card["tmp.tri"]) < 100:
        raise AssertionError(f"composed engines at scale {scale}: the "
                             f"card's {sorted(card)} differ from the "
                             f"CPU's")
    return {"phase": "composed-check", "card": smi, "scale": scale,
            "script": composed_script(scale), "engines": list(COMPOSED),
            "messages": card["screen"],
            "lines": {k: len(v) for k, v in card.items()},
            "card_equals_cpu": True, "seconds": seconds}


def run_tri(device, smi: str, kernels=(), scale: int = TRI_SCALE,
            check_scale: int = TRI_CHECK_SCALE, p4: bool = False) -> dict:
    """The tri phase: :func:`tri_script` on ``device`` with each command
    timed, the composed tri_find on the same edges (its triangles
    compared with the fused rows on the card), the host oracles, then
    the card-vs-CPU neigh_tri files.  With ``p4`` the script also runs
    on four shards (:func:`run_tri_p4`, under the record's ``p4``)."""
    import torch
    from gpu_mapreduce_tpu_torch.interop import mapreduce_to_numpy
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tri_")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        run = drive_script(device, tri_script(scale), kernels)
        comp = drive_script(device, [("tri_find -i mru -o NULL mrtc",
                                      "composed")], kernels,
                            interp=run["interp"])
        named = run["interp"].obj.named
        t0 = time.perf_counter()
        if not same_triangles_on_card(named["mrt"], named["mrtc"], scale):
            raise AssertionError("tri_find/composed: the triangles differ "
                                 "from the fused rows")
        compare_s = time.perf_counter() - t0
        composed = composed_record(comp, "tri_find/composed",
                                   "tri_composed_first_degree")
        composed["stage_s"] = _span_record(comp["spans"])["stage_s"]
        if composed["message"] != run["screens"]["tri_find"][0]:
            raise AssertionError(f"tri_find/composed: "
                                 f"{composed['message']!r}")
        named.pop("mrtc").kv.free()
        comp_launches = comp["launches"]
        del comp
        t0 = time.perf_counter()
        p4_rec = run_tri_p4(device, run, kernels, scale,
                            COMPOSED_CHECK_SCALE) if p4 else None
        if p4_rec:
            p4_rec["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        upper = mapreduce_to_numpy(named["mru"])[0]
        rows = mapreduce_to_numpy(named["mrt"])[0]
        pull_s = time.perf_counter() - t0
        screens, spans = run["screens"], run["spans"]
        seconds, peaks = run["seconds"], run["peak_bytes"]
        launches = run["launches"]
        del run, named
        t0 = time.perf_counter()
        found = tri_oracles(scale, upper, rows, screens["tri_find"][0],
                            len(spans.get("tri_batch", [])))
        oracle_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    files = {dev.type: neigh_tri_files(dev, check_scale)
             for dev in (device, torch.device("cpu"))}
    if files[device.type] != files["cpu"] or len(files["cpu"]) < 100:
        raise AssertionError(f"neigh_tri at scale {check_scale}: the card's "
                             f"{len(files[device.type])} files differ from "
                             f"the CPU's {len(files['cpu'])}")
    check_s = time.perf_counter() - t0
    return {"phase": "tri", "card": smi,
            "config": {"scale": scale, "edgefactor": GRAPH_EDGEFACTOR,
                       "abcd": GRAPH_ABCD, "seed": GRAPH_SEED,
                       "cut": "scale 22 -> 18: the [t, 3] u64 rows"},
            "script": tri_script(scale), "upper_edges": len(upper),
            "triangles": found["triangles"], "wedges": found["wedges"],
            "batches": found["batches"], "messages": {
                w: lines[0] for w, lines in screens.items() if lines},
            "command_s": seconds, "peak_bytes_by_command": peaks,
            "max_memory_allocated": max(peaks.values()) if peaks else None,
            "launches": launches,
            "triangle_bytes": rows.nbytes, "pull_to_host_s": pull_s,
            "oracle_s": oracle_s, "oracles": found,
            "tri_batch_s": spans.get("tri_batch", []),
            **_span_record(spans), "composed": composed,
            "launches_composed": comp_launches,
            "composed_equal_fused_on_card": True,
            "composed_compare_s": compare_s,
            "neigh_tri_check": {"scale": check_scale,
                                "files": len(files["cpu"]),
                                "card_equals_cpu": True,
                                "seconds": check_s}, "p4": p4_rec}


# ---------------------------------------------------------------------------
# graph-p4 — the OINK commands over P shards driven by one process
# ---------------------------------------------------------------------------

GRAPH_CHECK_P = 3              # card vs CPU, every command, file by file
GRAPH_CHECK_SMALL_SCALE = 9    # neigh_tri there: a file a vertex
P4_COMPARED = ("mre", "mru", "mrc", "mrl", "mrs", "mrv", "mrcc", "mrlc",
               "mrsc")         # named MRs held against P = 1 as row sets


def sorted_rows_on_card(mr):
    """An MR's KV rows (its frames joined, shards in order) as one int64
    matrix on the first shard's device, key columns then value columns
    (float64 values as their bits), sorted as rows: the rows as a set."""
    import torch
    cols = []
    for c in mr.kv.one_frame().valid_rows():
        c = c.reshape(c.shape[0], -1)
        cols.append(c.view(torch.int64) if c.dtype == torch.float64
                    else c.to(torch.int64))
    m = torch.cat(cols, 1)
    del cols
    order = torch.arange(m.shape[0], device=m.device)
    for c in reversed(range(m.shape[1])):
        order = order[torch.sort(m[order, c], stable=True).indices]
    return m[order]


def ranks_close_on_card(a, b) -> bool:
    """Two PageRank MRs (vertex, rank): the same vertices, ranks within
    rtol 1e-5 (atol the run's tol: a step more or less moves a rank by at
    most about that)."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.ops.bits import order_key
    (ka, va), (kb, vb) = (mr.kv.one_frame().valid_rows() for mr in (a, b))
    if len(ka) != len(kb):
        return False
    sa, sb = (torch.sort(order_key(k, np.uint64)).indices for k in (ka, kb))
    return torch.equal(ka[sa], kb[sb]) and torch.allclose(
        va[sa], vb[sb], rtol=1e-5, atol=GRAPH_TOL)


def _without_rounds(message: str) -> str:
    """A fused cc_find line without its round count (at P > 1 each shard
    jumps pointers over its own edges first, so the count follows the
    layout, as in the JAX package)."""
    return message.rsplit(" in ", 1)[0]


def run_graph_p4(device, p1_run, p1_comp, kernels, scale: int,
                 edgefactor: int, devices=None) -> dict:
    """graph-p4: the graph phase's script (without its checkpoint lines)
    and composed lines on a mesh of four shards on ``device`` (or one a
    device of ``devices``), each command timed as at P = 1, every launch
    count set to 0 before it.  Each named result MR must equal the P = 1
    run's (``p1_run``/``p1_comp``: the graph phase's runs, still holding
    their MRs) as a set of rows, each result line too (fused cc's round
    count aside), PageRank within rtol 1e-5 and one step; the composed cc
    equals the fused one and the composed sssp's distances the fused
    one's, on the card."""
    import torch
    from gpu_mapreduce_tpu_torch import OinkScript
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(devices=devices or [device] * MESH_P)
    skip = set(checkpoint_lines()) | {"mrb delete"}
    lines = [ln for ln in graph_script(scale, edgefactor) if ln not in skip]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    s = OinkScript(comm=mesh, screen=False, logfile=None)
    reset_peaks()
    run = drive_script(device, lines, kernels, interp=s)
    comp = drive_script(device, composed_graph_lines(), kernels, interp=s)
    peaks = peak_bytes()
    t0 = time.perf_counter()
    p1 = p1_run["interp"].obj.named
    p4 = s.obj.named
    for name in P4_COMPARED:
        if not torch.equal(sorted_rows_on_card(p1[name]),
                           sorted_rows_on_card(p4[name])):
            raise AssertionError(f"graph-p4: {name} differs from P = 1")
    if not ranks_close_on_card(p1["mrpr"], p4["mrpr"]):
        raise AssertionError("graph-p4: PageRank ranks differ from P = 1")
    if not same_pairs_on_card(p4["mrc"], p4["mrcc"]):
        raise AssertionError("graph-p4: composed cc differs from fused")
    dist = [sorted_rows_on_card(p4[n])[:, [0, 3]] for n in ("mrs", "mrsc")]
    if not torch.equal(dist[0], dist[1]):
        raise AssertionError("graph-p4: composed sssp's distances differ "
                             "from the fused run's")
    del dist
    compare_s = time.perf_counter() - t0
    screens = {**run["screens"], **comp["screens"]}
    p1_screens = {**p1_run["screens"], **p1_comp["screens"]}
    for label, got in screens.items():
        want = p1_screens[label]
        if label == "cc_find":
            got, want = ([_without_rounds(m) for m in x]
                         for x in (got, want))
        if label == "pagerank":
            (g, w) = (x[0].split() for x in (got, want))
            if g[:-2] != w[:-2] or abs(int(g[-2]) - int(w[-2])) > 1:
                raise AssertionError(f"graph-p4: {got} vs {want}")
        elif got != want:
            raise AssertionError(f"graph-p4: {label} printed {got}, P = 1 "
                                 f"{want}")
    launches = {k: run["launches"][k] + comp["launches"][k]
                for k in run["launches"]}
    for name in list(p4):
        s.obj.delete_mr(name)
    spans = run["spans"]
    nedges = (1 << scale) * edgefactor
    step_s = statistics.median(spans["pagerank_step"])
    p1_step_s = statistics.median(p1_run["spans"]["pagerank_step"])

    def rounds(scr):
        return {"pagerank": int(scr["pagerank"][0].split()[-2]),
                "cc_find": int(scr["cc_find"][0].split()[-2]),
                "luby_find": int(scr["luby_find"][0].split()[-2]),
                "sssp": [int(ln.split()[3]) for ln in scr["sssp"]],
                **{f"{w}/composed": int(scr[f"{w}/composed"][0].split()[-2])
                   for w in ("cc_find", "luby_find")},
                "sssp/composed": [int(ln.split()[3])
                                  for ln in scr["sssp/composed"]]}
    return {"devices": [str(d) for d in mesh.devices],
            "lines": lines + [ln for ln, _ in composed_graph_lines()],
            "command_s": {**run["seconds"], **comp["seconds"]},
            "p1_command_s": {**p1_run["seconds"], **p1_comp["seconds"]},
            "peak_bytes_by_command": {**(run["peak_bytes"] or {}),
                                      **(comp["peak_bytes"] or {})},
            "max_memory_allocated": peaks, "launches": launches,
            "rounds": rounds(screens), "p1_rounds": rounds(p1_screens),
            "pagerank_step_median_s": step_s,
            "pagerank_edges_per_s_per_iteration": nedges / step_s,
            "p1_pagerank_edges_per_s_per_iteration": nedges / p1_step_s,
            "stage_s": _span_record(spans)["stage_s"],
            "p1_stage_s": _span_record(p1_run["spans"])["stage_s"],
            "composed_stage_s": _span_record(comp["spans"])["stage_s"],
            "p1_composed_stage_s": _span_record(
                p1_comp["spans"])["stage_s"],
            "compared": list(P4_COMPARED) + ["mrpr", "messages"],
            "compare_s": compare_s}


def run_tri_p4(device, p1_run, kernels, scale: int, small: int) -> dict:
    """graph-p4's triangles: tri_script(``scale``) on four shards on the
    card, its rows equal to the P = 1 run's (``p1_run``, the tri phase's)
    as sets; then at ``small`` the fused and the composed tri_find on
    four shards, equal to each other."""
    import torch
    from gpu_mapreduce_tpu_torch import OinkScript
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(MESH_P, devices=[device] * MESH_P)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reset_peaks()
    s = OinkScript(comm=mesh, screen=False, logfile=None)
    run = drive_script(device, tri_script(scale), kernels, interp=s)
    peaks = peak_bytes()
    if not same_triangles_on_card(p1_run["interp"].obj.named["mrt"],
                                  s.obj.named["mrt"], scale):
        raise AssertionError(f"graph-p4: tri_find at scale {scale} differs "
                             f"from P = 1")
    if run["screens"] != p1_run["screens"]:
        raise AssertionError("graph-p4: the tri script printed other lines")
    s.obj.cleanup()
    s = OinkScript(comm=mesh, screen=False, logfile=None)
    small_run = drive_script(device, tri_script(small) + [
        ("tri_find -i mru -o NULL mrtc", "composed")], kernels, interp=s)
    named = s.obj.named
    if not same_triangles_on_card(named["mrt"], named["mrtc"], small):
        raise AssertionError(f"graph-p4: composed tri_find at scale {small} "
                             f"differs from fused")
    launches = {k: run["launches"][k] + small_run["launches"][k]
                for k in run["launches"]}
    return {"scale": scale, "command_s": run["seconds"],
            "p1_command_s": p1_run["seconds"],
            "peak_bytes_by_command": run["peak_bytes"],
            "max_memory_allocated": peaks,
            "message": run["screens"]["tri_find"][0],
            "composed_scale": small,
            "composed_command_s": small_run["seconds"],
            "composed_equals_fused": True, "launches": launches}


def graph_check_script(scale: int, small: int, texts, docs: str) -> list:
    """Every registered OINK command on one graph, into files under the
    cwd: at ``scale`` the commands on their fused engines and cc_find,
    luby_find, tri_find and sssp on their composed ones too (tagged with
    their engine); neighbor and neigh_tri at ``small``; wordfreq over the
    ``texts`` files and invertedindex over the ``docs`` directory."""
    a, b, c, d = GRAPH_ABCD
    rmat = f"{GRAPH_EDGEFACTOR} {a} {b} {c} {d} 0.0 {GRAPH_SEED}"
    return [
        f"rmat {scale} {rmat} -o tmp.rmat mre",
        "edge_upper -i mre -o tmp.upper mru",
        f"rmat2 {scale - 2} 4 {a} {b} {c} {d} 0.1 7 -o tmp.rmat2 NULL",
        "degree 0 -i mre -o tmp.deg NULL", "degree_stats 1 -i mre",
        "degree_weight -i tmp.upper.* tmp.deg.* -o tmp.dw NULL",
        "vertex_extract -i mre -o tmp.vx NULL",
        f"pagerank {GRAPH_TOL} {GRAPH_MAXITER} {GRAPH_DAMPING} -i mre "
        f"-o tmp.pr NULL",
        "cc_find 0 -i mru -o tmp.cc mrc", "cc_stats -i mrc",
        ("cc_find 0 -i mru -o tmp.ccc NULL", "composed"),
        "mr mrv", "mrv map/mr mre edge_to_vertices",
        "histo -i mrv -o tmp.histo NULL",
        f"luby_find {LUBY_SEED} -i mru -o tmp.luby NULL",
        (f"luby_find {LUBY_SEED} -i mru -o tmp.lubyc NULL", "composed"),
        "tri_find -i mru -o tmp.tri NULL",
        ("tri_find -i mru -o tmp.tric NULL", "composed"),
        "mre map/mr mre add_weight",
        f"sssp {SSSP_SOURCES} {SSSP_SEED} -i mre -o tmp.sssp NULL",
        (f"sssp {SSSP_SOURCES} {SSSP_SEED} -i mre -o tmp.ssspc NULL",
         "composed"),
        f"rmat {small} {rmat} -o NULL mre",
        "edge_upper -i mre -o tmp.supper NULL",
        "neighbor -i tmp.supper.* -o tmp.snb NULL",
        "tri_find -i tmp.supper.* -o tmp.stri NULL",
        "neigh_tri tmp.snt -i tmp.snb.* tmp.stri",
        f"variable files index {' '.join(texts)}",
        "wordfreq 10 -i v_files -o tmp.wf NULL",
        f"variable docs index {docs}",
        "invertedindex -i v_docs -o tmp.ii NULL"]


def graph_check_files(devices, lines, tmp: str) -> dict:
    """``lines`` on a mesh over ``devices`` in a fresh directory under
    ``tmp``: the screen lines and {path: bytes} of every file the script
    wrote."""
    import io
    from gpu_mapreduce_tpu_torch import OinkScript
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    d = tempfile.mkdtemp(prefix="chip_smoke_graph_check_", dir=tmp)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        buf = io.StringIO()
        s = OinkScript(comm=make_mesh(len(devices), devices=devices),
                       screen=buf, logfile=None)
        for line in lines:
            line, eng = (line, None) if isinstance(line, str) else line
            with engine(line.split()[0], eng) if eng \
                    else contextlib.nullcontext():
                s.one(line)
        s.obj.cleanup()
        out = {"screen": buf.getvalue().encode()}
        for root, _, names in os.walk("."):
            for n in names:
                path = os.path.relpath(os.path.join(root, n))
                if path.startswith("tmp."):
                    with open(path, "rb") as f:
                        out[path] = f.read()
        return out
    finally:
        os.chdir(cwd)
        shutil.rmtree(d, ignore_errors=True)


def _pagerank_file_close(a: bytes, b: bytes) -> bool:
    import numpy as np
    ra, rb = ([ln.split() for ln in x.decode().splitlines()] for x in (a, b))
    return [v for v, _ in ra] == [v for v, _ in rb] and np.allclose(
        [float(r) for _, r in ra], [float(r) for _, r in rb], rtol=1e-5,
        atol=GRAPH_TOL)


def run_graph_check(tmp: str, smi: str, scale: int = COMPOSED_CHECK_SCALE,
                    small: int = GRAPH_CHECK_SMALL_SCALE,
                    devices=None, cpu_devices=None) -> dict:
    """graph-p4's card-vs-CPU check: :func:`graph_check_script` at P = 3
    on the card and on CPU shards, with wordfreq on two files of the
    zipf generator and invertedindex on the 2 MB skewed corpus (the
    mesh-check's), every file equal byte for byte (PageRank's ranks
    within rtol 1e-5), per shard."""
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    t0 = time.perf_counter()
    d = os.path.join(tmp, "graph-check")
    docs = os.path.join(d, "docs")
    os.makedirs(docs)
    make_corpus(docs, MESH_CHECK_MB, skew=True)
    texts = zipf_corpus(d, 1, nfiles=2, nvocab=1 << 14)[0]
    lines = graph_check_script(scale, small, texts, docs)
    got, seconds = {}, {}
    for name, devs in (("card", devices or mesh_devices(GRAPH_CHECK_P)),
                       ("cpu", cpu_devices or ["cpu"] * GRAPH_CHECK_P)):
        t1 = time.perf_counter()
        got[name] = graph_check_files(devs, lines, d)
        seconds[name] = time.perf_counter() - t1
    card, cpu = got["card"], got["cpu"]
    if sorted(card) != sorted(cpu):
        raise AssertionError(f"graph-check: the card wrote "
                             f"{sorted(set(card) ^ set(cpu))} where the "
                             f"CPU did not, or the other way")
    for name in card:
        if name == "tmp.pr":
            same = _pagerank_file_close(card[name], cpu[name])
        elif name == "screen":
            same = _screens_close(card[name], cpu[name])
        else:
            same = card[name] == cpu[name]
        if not same:
            raise AssertionError(f"graph-check: {name} differs between "
                                 f"the card and the CPU")
    shards = sorted(n for n in card if n.startswith("tmp.deg."))
    if shards != [f"tmp.deg.{p}" for p in range(GRAPH_CHECK_P)]:
        raise AssertionError(f"graph-check: degree wrote {shards}")
    shutil.rmtree(d)
    return {"p": GRAPH_CHECK_P, "scale": scale, "small_scale": small,
            "script": [ln if isinstance(ln, str) else f"{ln[0]} [{ln[1]}]"
                       for ln in lines],
            "files": len(card) - 1, "card_equals_cpu": True,
            "messages": card["screen"].decode().splitlines(),
            "seconds": seconds, "total_s": time.perf_counter() - t0}


def _screens_close(a: bytes, b: bytes) -> bool:
    """Two scripts' screens equal, PageRank's step count within one."""
    la, lb = (x.decode().splitlines() for x in (a, b))
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.startswith("PageRank:") and y.startswith("PageRank:"):
            wx, wy = x.split(), y.split()
            if wx[:-2] != wy[:-2] or abs(int(wx[-2]) - int(wy[-2])) > 1:
                return False
        elif x != y:
            return False
    return True


# ---------------------------------------------------------------------------
# 11. mesh — the data plane over P shards driven by one process
# ---------------------------------------------------------------------------

MESH_P = 4                     # the reference's four ranks
MESH_CHECK_MB = 2              # the card-vs-CPU InvertedIndex check
MESH_CHECK_KEYS = 1 << 16      # the card-vs-CPU IntCount check
MESH_CHECK_P = 3


def mesh_devices(ndev: int = MESH_P) -> list:
    """``ndev`` shards on the first card, as a one-card machine holds
    them."""
    import torch
    return [torch.device("cuda", 0)] * ndev


def sync_all() -> None:
    """Wait for every card's queued work (a mesh may span several)."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def reset_peaks() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def peak_bytes() -> list:
    """Peak bytes allocated on each card since :func:`reset_peaks`."""
    import torch
    return [torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count())]


def mesh_rounds(idx, paths, P: int) -> int:
    """Batch rounds of a mesh InvertedIndex run: the most batches any
    shard's file slice takes."""
    from gpu_mapreduce_tpu_torch.parallel.ingest import balance_by_bytes
    return max((len(idx._file_batches(files, sizes))
                for _, files, sizes in balance_by_bytes(paths, P) if files),
               default=0)


def run_mesh_main(paths, nref: int, nuniq: int, one_device: dict, kernels,
                  smi: str, devices=None) -> dict:
    """main-p4: InvertedIndex(comm=mesh).run() on the main cell's corpus,
    one file a shard: warm-up, then one timed run with every launch count
    set to 0 just before it.  Pairs and unique URLs must equal the
    generator's, and mark_words must launch once a shard a pass (each
    batch round, cap retry and wide fallback)."""
    from gpu_mapreduce_tpu_torch import InvertedIndex
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(MESH_P, devices=devices or mesh_devices())
    InvertedIndex(comm=mesh).run(paths)
    for k in kernels:
        k.launches = 0
    sync_all()
    reset_peaks()
    idx = InvertedIndex(comm=mesh)
    t0 = time.perf_counter()
    got = idx.run(paths)
    sync_all()
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    if got != (nref, nuniq):
        raise AssertionError(f"main-p4 gave {got}, the generator "
                             f"{(nref, nuniq)}")
    rounds = mesh_rounds(idx, paths, MESH_P)
    passes = rounds + idx.stats["cap_retries"] + idx.stats["wide_fallbacks"]
    if launches["mark_words"] != MESH_P * passes or \
            launches["mark_words"] < MESH_P:
        raise AssertionError(f"main-p4: mark_words launched "
                             f"{launches['mark_words']} times, not "
                             f"{MESH_P} x {passes} passes")
    times = idx.timer.times
    ex = idx.mr.last_exchange
    keys = ("map_device", "aggregate", "convert", "reduce")
    return {"phase": "mesh-main-p4", "card": smi, "p": MESH_P,
            "devices": [str(d) for d in mesh.devices],
            "npairs": got[0], "nunique": got[1], "rounds": rounds,
            "passes": passes, "stats": idx.stats, "launches": launches,
            "end_to_end_s": dt, "stages_s": times,
            "seconds": {k: times.get(k) for k in keys},
            "p1_seconds": {**{k: one_device["stages_s"].get(k)
                              for k in keys},
                           "end_to_end": one_device["end_to_end_s"]},
            "exchange": vars(ex) if ex is not None else None,
            "max_memory_allocated": peak_bytes()}


@contextlib.contextmanager
def exchange_spans():
    """Every exchange of the block (aggregate's and gather's) with its
    stats and its seconds between two synchronises of every card, into
    the list the block yields."""
    from gpu_mapreduce_tpu_torch.parallel import collectives, shuffle
    out = []
    saved = [(m, m.exchange) for m in (shuffle, collectives)]

    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            sync_all()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            sync_all()
            out.append({**vars(res.exchange_stats),
                        "seconds": time.perf_counter() - t0})
            return res
        return timed

    for m, fn in saved:
        m.exchange = wrap(fn)
    try:
        yield out
    finally:
        for m, fn in saved:
            m.exchange = fn


def lookup3_u64(keys):
    """hashlittle(key, 8, 0) of each u64 key's little-endian bytes by
    numpy: the reference's lookup3 (src/hash.cpp) for an 8-byte key is
    a = low word, b = high word over 0xdeadbeef + 8, then the final mix;
    the aggregate's destination is this % P."""
    import numpy as np
    k = np.asarray(keys, np.uint64)
    a = np.full(len(k), 0xDEADBEEF + 8, np.uint32)
    b, c = a.copy(), a.copy()
    a += (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b += (k >> np.uint64(32)).astype(np.uint32)

    def rot(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))
    for x, y, r in (("c", "b", 14), ("a", "c", 11), ("b", "a", 25),
                    ("c", "b", 16), ("a", "c", 4), ("b", "a", 14),
                    ("c", "b", 24)):
        v = {"a": a, "b": b, "c": c}
        v[x] ^= v[y]
        v[x] -= rot(v[y], r)
    return c


def intcount_oracle_mesh(keys_u32, ntop: int, P: int):
    """intcount_oracle for a mesh of P shards: the same (nints, nunique)
    and top counts; among equal counts the top-N takes them in the mesh
    layout's reverse row order — the gather to shard 0 lays the groups
    out by destination shard, each shard's keys ascending, and the
    descending value sort reverses ties — so destination descending,
    then key descending."""
    import numpy as np
    uk, c = np.unique(keys_u32, return_counts=True)
    dest = lookup3_u64(uk.astype(np.uint64)) % np.uint32(P)
    order = np.lexsort((-uk.astype(np.int64), -dest.astype(np.int64),
                        -c))[:ntop]
    return len(keys_u32), len(uk), [(int(uk[i]), int(c[i])) for i in order]


def split_files(keys_u32, d: str, nfiles: int) -> list:
    """The keys in ``nfiles`` contiguous files (the same keys, one file a
    shard)."""
    import numpy as np
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, part in enumerate(np.array_split(keys_u32, nfiles)):
        paths.append(os.path.join(d, f"part-{i}.bin"))
        part.tofile(paths[-1])
    return paths


def run_mesh_intcount(cell: str, keys_u32, tmp: str, kernels, smi: str,
                      devices=None) -> dict:
    """intcount-p4: the intcount cell's keys as four files, one a shard,
    through intcount(paths, ntop=10, comm=mesh) eagerly; (nints, nunique,
    top) must equal the numpy oracle and seg_table must not launch.  A
    second run times each exchange between device synchronises."""
    from gpu_mapreduce_tpu_torch import intcount
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    devices = devices or mesh_devices()
    mesh = make_mesh(len(devices), devices=devices)
    paths = split_files(keys_u32, os.path.join(tmp, f"mesh-{cell}"),
                        mesh.size)
    want = intcount_oracle_mesh(keys_u32, 10, mesh.size)
    saved = os.environ.pop("MRTPU_FUSE", None)
    try:
        for k in kernels:
            k.launches = 0
        sync_all()
        reset_peaks()
        t0 = time.perf_counter()
        got = intcount(paths, ntop=10, comm=mesh)
        sync_all()
        dt = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        peak = peak_bytes()
        if got != want:
            raise AssertionError(f"intcount-p4-{cell}: {got[:2]} top "
                                 f"{got[2][:3]} != oracle {want[:2]} top "
                                 f"{want[2][:3]}")
        if launches["segment_table"] != 0:
            raise AssertionError(f"intcount-p4-{cell}: seg_table "
                                 f"launched {launches['segment_table']}")
        with exchange_spans() as ex, op_seconds() as stages:
            if intcount(paths, ntop=10, comm=mesh) != want:
                raise AssertionError(f"intcount-p4-{cell}: timed rerun "
                                     f"differs")
    finally:
        if saved is not None:
            os.environ["MRTPU_FUSE"] = saved
    shutil.rmtree(os.path.dirname(paths[0]))
    agg = ex[0]
    moved = agg["sent_bytes"]
    return {"phase": f"mesh-intcount-p4-{cell}", "card": smi,
            "p": mesh.size, "devices": [str(d) for d in mesh.devices],
            "cards": len(set(mesh.devices)), "nints": want[0],
            "nunique": want[1], "top3": want[2][:3], "end_to_end_s": dt,
            "launches": launches, "max_memory_allocated": peak,
            "stages_s": stages,
            "count_matrix": {"min": agg["bucket_min"],
                             "max": agg["bucket_max"]},
            "rows": agg["rows"], "cssize": moved, "cspad": agg["pad_bytes"],
            "exchange_s": agg["seconds"],
            "exchange_bound_ms": 2 * moved / HBM_BYTES_PER_S * 1e3,
            "exchange": agg, "gather_exchange": ex[1:]}


def run_mesh_wordfreq(paths, oracle: dict, kernels, smi: str,
                      devices=None) -> dict:
    """wordfreq-p4: wordfreq_interned(paths, 10, comm=mesh) over the
    wordfreq-zipf cell's four files, one a shard: words, distinct words
    and the top 10 must equal the generator's counts.  The same call on
    one device first, for the P = 1 seconds beside it."""
    from gpu_mapreduce_tpu_torch import wordfreq_interned
    from gpu_mapreduce_tpu_torch.parallel import shuffle
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(MESH_P, devices=devices or mesh_devices())
    sync_all()
    t0 = time.perf_counter()
    one = wordfreq_interned(paths, WF_NTOP, device=mesh.devices[0])
    sync_all()
    p1_s = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    before = dict(shuffle._SPEC_CACHE)
    sync_all()
    reset_peaks()
    t0 = time.perf_counter()
    nwords, nunique, top = wordfreq_interned(paths, WF_NTOP, comm=mesh)
    sync_all()
    dt = time.perf_counter() - t0
    # the plans its exchanges ran under the codec (the speculative
    # cache's new entries): full-entropy u64 ids ship raw
    plans = [{"rows": key[3][0], "key_dtype": key[4],
              "value_dtype": key[6], "plan": json.loads(json.dumps(plan))}
             for key, plan in shuffle._SPEC_CACHE.items()
             if key[0] == mesh and before.get(key) != plan]
    for got in (one, (nwords, nunique, top)):
        if (got[0], got[1]) != (oracle["nwords"], oracle["nunique"]) or \
                sorted(got[2]) != sorted(oracle["top"]) or \
                [c for _, c in got[2]] != [c for _, c in oracle["top"]]:
            raise AssertionError(
                f"wordfreq-p4: {got[0]} words, {got[1]} unique, top "
                f"{got[2][:3]} != the generator's {oracle['nwords']}, "
                f"{oracle['nunique']}, {oracle['top'][:3]}")
    return {"phase": "mesh-wordfreq-p4", "card": smi, "p": MESH_P,
            "nwords": nwords, "nunique": nunique, "end_to_end_s": dt,
            "p1_end_to_end_s": p1_s,
            "tokens_per_s": nwords / dt,
            "launches": {k.__name__: k.launches for k in kernels},
            "max_memory_allocated": peak_bytes(), "wire_plans": plans}


def mesh_intcount_frames(paths, devices) -> dict:
    """The 2^16-key IntCount chain on a mesh over ``devices``, each
    frame after aggregate, convert+reduce, gather(1), broadcast(0) and
    sort_keys(-1) as host arrays."""
    from gpu_mapreduce_tpu_torch import MapReduce, interop
    from gpu_mapreduce_tpu_torch.apps.intcount import _map_file
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    mr = MapReduce(comm=make_mesh(len(devices), devices=devices))
    mr.map_files(paths, _map_file)
    out = {}
    for name, op in (("aggregate", mr.aggregate),
                     ("reduce", lambda: (mr.convert(),
                                         mr.reduce(count, batch=True))),
                     ("gather", lambda: mr.gather(1)),
                     ("broadcast", lambda: mr.broadcast(0)),
                     ("sort_keys", lambda: mr.sort_keys(-1))):
        op()
        (frame,) = list(mr.kv.frames())
        out[name] = {k: v.tolist() for k, v in
                     interop.to_numpy(frame).items()}
    return out


def run_mesh_check(tmp: str, smi: str, devices=None,
                   cpu_devices=None) -> dict:
    """mesh-check: the 2 MB skewed corpus at P = 4 with outdir on the
    card and on CPU shards (the four part files byte-identical; their
    lines the P = 1 part file's), and a 2^16-key IntCount at P = 3
    through gather(1), broadcast(0) and sort_keys(-1) (every frame equal
    on the card and on the CPU)."""
    import numpy as np
    from gpu_mapreduce_tpu_torch import InvertedIndex
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    d = os.path.join(tmp, "mesh-check")
    os.makedirs(d)
    paths, nref, nuniq = make_corpus(d, MESH_CHECK_MB, skew=True)
    card = devices or mesh_devices()
    cpu = cpu_devices or ["cpu"] * MESH_P
    parts = {}
    for name, devs in (("card", card), ("cpu", cpu)):
        out = os.path.join(d, f"out-{name}")
        got = InvertedIndex(comm=make_mesh(MESH_P, devices=devs)).run(
            paths, outdir=out)
        if got != (nref, nuniq):
            raise AssertionError(f"mesh-check/{name}: {got}")
        parts[name] = {f: open(os.path.join(out, f), "rb").read()
                       for f in sorted(os.listdir(out))}
    if list(parts["card"]) != [f"part-{p:05d}" for p in range(MESH_P)]:
        raise AssertionError(f"mesh-check: part files {list(parts['card'])}")
    if parts["card"] != parts["cpu"]:
        raise AssertionError("mesh-check: part files differ between the "
                             "card and the CPU")
    one = os.path.join(d, "out-one")
    InvertedIndex(device=card[0]).run(paths, outdir=one)
    with open(os.path.join(one, "part-00000"), "rb") as f:
        one_lines = sorted(f.read().splitlines())
    mesh_lines = sorted(line for body in parts["card"].values()
                        for line in body.splitlines())
    if mesh_lines != one_lines:
        raise AssertionError("mesh-check: the part files' lines are not "
                             "the P = 1 part file's")
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 12, MESH_CHECK_KEYS).astype(np.uint32)
    kpaths = split_files(keys, os.path.join(d, "keys"), 6)
    frames = {name: mesh_intcount_frames(kpaths, devs[:1] * MESH_CHECK_P)
              for name, devs in (("card", card), ("cpu", cpu))}
    for op in frames["card"]:
        if frames["card"][op] != frames["cpu"][op]:
            raise AssertionError(f"mesh-check: IntCount at P = "
                                 f"{MESH_CHECK_P} differs after {op}")
    uk, c = np.unique(keys, return_counts=True)
    final = frames["card"]["sort_keys"]
    n0 = final["counts"][0]
    if final["counts"] != [len(uk)] * MESH_CHECK_P or \
            final["key"][0][:n0] != uk[::-1].tolist() or \
            final["value"][0][:n0] != c[::-1].tolist():
        raise AssertionError("mesh-check: IntCount differs from "
                             "np.unique")
    shutil.rmtree(d)
    return {"phase": "mesh-check", "card": smi, "mb": MESH_CHECK_MB,
            "npairs": nref, "nunique": nuniq,
            "part_files": len(parts["card"]), "card_equals_cpu": True,
            "union_equals_p1": True, "intcount_keys": MESH_CHECK_KEYS,
            "intcount_p": MESH_CHECK_P, "intcount_ops": list(frames["card"]),
            "seconds": time.perf_counter() - t0}


@contextlib.contextmanager
def fused_exchanges():
    """Every fused exchange group of the block with its mode, its
    exchange telemetry and its seconds between two synchronises of every
    card, into the list the block yields."""
    from gpu_mapreduce_tpu_torch.plan import fuser
    out = []
    fn = fuser._exec_exchange_group

    @functools.wraps(fn)
    def timed(mr, *args, **kw):
        sync_all()
        t0 = time.perf_counter()
        mode, table = fn(mr, *args, **kw)
        sync_all()
        out.append({"mode": mode, "table": table,
                    "seconds": time.perf_counter() - t0,
                    **vars(mr.last_exchange)})
        return mode, table

    fuser._exec_exchange_group = timed
    try:
        yield out
    finally:
        fuser._exec_exchange_group = fn


@contextlib.contextmanager
def first_table_rows():
    """The first group-table call of the block: its keys (widened, on
    their device), T and gcap — shard 0's received rows in a fused
    exchange group — into the dict the block yields."""
    from gpu_mapreduce_tpu_torch.ops.bits import widen64
    from gpu_mapreduce_tpu_torch.ops.cuda import group
    got = {}
    fn = group.segment_group_reduce

    @functools.wraps(fn)
    def wrapper(key, value, nrecv, gcap, reduce_op, cfg, key_dtype,
                value_dtype):
        if not got:
            got.update(keys=widen64(key[:nrecv], key_dtype).contiguous(),
                       T=cfg[1], gcap=gcap)
        return fn(key, value, nrecv, gcap, reduce_op, cfg, key_dtype,
                  value_dtype)

    group.segment_group_reduce = wrapper
    try:
        yield got
    finally:
        group.segment_group_reduce = fn


def check_time_mesh_table(keys, T: int, gcap: int) -> dict:
    """The group table at one shard's shape of the warm fused IntCount
    at P = 4: exactly its plain version's groups (through the epilogue),
    then timed beside its bound and torch.unique (``time_seg_table``)."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.ops.cuda.group import (segment_table,
                                                        segment_table_ref)
    from gpu_mapreduce_tpu_torch.ops.segment import table_to_groups
    got = table_to_groups(segment_table(keys, None, T), T, gcap, "count",
                          np.uint64, None)
    ref = table_to_groups(segment_table_ref(keys, None, T), T, gcap,
                          "count", np.uint64, None)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            and got[2] == ref[2] and got[3] == ref[3] == 0):
        raise AssertionError(f"seg_table at the P = 4 shard shape differs "
                             f"from its plain version: g {got[2]} vs "
                             f"{ref[2]}, overflow {got[3]} vs {ref[3]}")
    del got, ref
    rec = time_seg_table(keys, T, gcap)
    rec.pop("group_device_ms")
    return {**rec, "gcap": gcap, "max_abs_err": 0}


def run_mesh_fuse(cell: str, keys_u32, tmp: str, kernels, smi: str,
                  devices=None, table_check: bool = False) -> dict:
    """mesh-fuse: the intcount cell's keys as four files through
    intcount(paths, ntop=10, comm=mesh) under MRTPU_FUSE=1, cold (the
    exchange group on the sort path) then warm (the cached plan and gcap
    on the group table, one launch a shard), each against
    intcount_oracle_mesh with every launch count set to 0 just before
    it; seg_table must launch 0 times cold and once a shard warm.  Each
    run is repeated with every op and the fused group between device
    synchronises (``op_seconds``, ``fused_exchanges``).  Then the same
    chain once inside ``with mr.pipeline():``.  With ``table_check``,
    shard 0's received rows of the warm run hold the kernel against its
    plain version and time it (``check_time_mesh_table``)."""
    from gpu_mapreduce_tpu_torch import MapReduce, intcount
    from gpu_mapreduce_tpu_torch.apps.common import top_n
    from gpu_mapreduce_tpu_torch.apps.intcount import _map_file
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.plan import fuser, plan_cache
    devices = devices or mesh_devices()
    mesh = make_mesh(len(devices), devices=devices)
    P = mesh.size
    paths = split_files(keys_u32, os.path.join(tmp, f"mesh-fuse-{cell}"), P)
    want = intcount_oracle_mesh(keys_u32, 10, P)
    saved = os.environ.get("MRTPU_FUSE")
    runs, capture = {}, {}
    try:
        os.environ["MRTPU_FUSE"] = "1"
        plan_cache().clear()
        for run in ("cold", "warm"):
            for k in kernels:
                k.launches = 0
            sync_all()
            reset_peaks()
            with contextlib.ExitStack() as stack:
                if table_check and run == "warm":
                    capture = stack.enter_context(first_table_rows())
                ex = stack.enter_context(fused_exchanges())
                t0 = time.perf_counter()
                got = intcount(paths, ntop=10, comm=mesh)
                sync_all()
                dt = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in kernels}
            if got != want:
                raise AssertionError(f"mesh-fuse-{cell} {run}: {got[:2]} "
                                     f"top {got[2][:3]} != oracle "
                                     f"{want[:2]} top {want[2][:3]}")
            expect = 0 if run == "cold" else P
            mode = "exchange" if run == "cold" else "exchange1"
            if launches["segment_table"] != expect or len(ex) != 1 or \
                    ex[0]["mode"] != mode or ex[0]["table"] != (run == "warm"):
                raise AssertionError(
                    f"mesh-fuse-{cell} {run}: seg_table launched "
                    f"{launches['segment_table']} (want {expect}), groups "
                    f"{[(e['mode'], e['table']) for e in ex]}")
            runs[run] = {"end_to_end_s": dt, "launches": launches,
                         "max_memory_allocated": peak_bytes(),
                         "group_s": ex[0]["seconds"],
                         **{k: ex[0][k] for k in (
                             "mode", "speculative", "pad_bytes",
                             "wire_bytes", "wire_ratio")},
                         "sent_bytes": ex[0]["sent_bytes"],
                         "exchange_bound_ms":
                             2 * ex[0]["sent_bytes"] / HBM_BYTES_PER_S * 1e3,
                         "cap_out": ex[0]["cap_out"], "rows": ex[0]["rows"]}
        for run in ("cold", "warm"):
            # the stage seconds: the same run with every op between syncs
            if run == "cold":
                plan_cache().clear()
            with op_seconds([(fuser, "_exec_exchange_group",
                              "exchange_group")]) as stages:
                if intcount(paths, ntop=10, comm=mesh) != want:
                    raise AssertionError(f"mesh-fuse-{cell} {run}: timed "
                                         f"rerun differs")
            runs[run]["stages_s"] = stages
    finally:
        if saved is None:
            os.environ.pop("MRTPU_FUSE", None)
        else:
            os.environ["MRTPU_FUSE"] = saved
    mr = MapReduce(comm=mesh, fuse=0)
    mr.map_files(paths, _map_file)
    sync_all()
    t0 = time.perf_counter()
    with fused_exchanges() as ex:
        with mr.pipeline():
            mr.aggregate()
            mr.convert()
            mr.reduce(count, batch=True)
    top = [(int(k), int(v)) for k, v in top_n(mr, 10)]
    sync_all()
    pipe_s = time.perf_counter() - t0
    if (mr.kv.nkv, top) != (want[1], want[2]) or len(ex) != 1:
        raise AssertionError(f"mesh-fuse-{cell} pipeline: {mr.kv.nkv} "
                             f"groups, top {top[:3]}")
    shutil.rmtree(os.path.dirname(paths[0]))
    rec = {"phase": f"mesh-fuse-{cell}", "card": smi, "p": P,
           "devices": [str(d) for d in mesh.devices],
           "cards": len(set(mesh.devices)), "nints": want[0],
           "nunique": want[1], "top3": want[2][:3], **runs,
           "pipeline": {"end_to_end_s": pipe_s, "mode": ex[0]["mode"],
                        "table": ex[0]["table"]}}
    if capture:
        rec["table"] = check_time_mesh_table(capture["keys"], capture["T"],
                                             capture["gcap"])
    return rec


def ds_rows(mr) -> list:
    """mr's dataset frame by frame, shard by shard, as host rows: a KV
    shard's keys and values in order, a KMV shard's group keys, sizes and
    each group's values as a sorted multiset; with each frame's type and
    cap."""
    import numpy as np
    from gpu_mapreduce_tpu_torch.core.frame import KMVFrame, KVFrame
    ds = mr.kv if mr.kv is not None else mr.kmv
    out = []
    for fr in ds.frames():
        rec = []
        for s in getattr(fr, "shards", [fr]):
            h = s if isinstance(s, (KVFrame, KMVFrame)) else s.to_host()
            if isinstance(h, KVFrame):
                rec.append((h.key.tolist(), h.value.tolist()))
            else:
                rec.append((h.key.tolist(), np.asarray(h.nvalues).tolist(),
                            [sorted(h.group_values(i).tolist())
                             for i in range(len(h))]))
        out.append((type(fr).__name__,
                    getattr(fr, "cap", getattr(fr, "gcap", None)), rec))
    return out


MESH_OPS_SCRIPT = """\
mr a
a map/file tmp.e read_edge
a aggregate NULL
a copy c
c clone
mr k
k map/mr a edge_to_vertices
k compress count
k save ck
mr r
r load ck
r aggregate NULL
r compress count
"""


def mesh_ops_frames(kpaths, epath: str, devices, d: str) -> dict:
    """The MapReduce ops beyond the data plane on a mesh, at P = 3 over
    ``devices``, each as :func:`ds_rows`: map_mr per pair and batch
    (``invert``, a device body shard by shard), clone, collapse, compress
    under fuse=0 and fuse=1 (cold and warm), the fused exchange group,
    open/close with another MR's adds, and a named-MR script (clone,
    compress, save, load) run in ``d``."""
    import io
    from gpu_mapreduce_tpu_torch import MapReduce, OinkScript
    from gpu_mapreduce_tpu_torch.apps.intcount import _map_file
    from gpu_mapreduce_tpu_torch.oink import kernels as okernels
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.plan import plan_cache
    mesh = make_mesh(MESH_CHECK_P, devices=devices)
    base = MapReduce(comm=mesh)
    base.map_files(kpaths, _map_file)
    base.aggregate()
    out = {"aggregate": ds_rows(base)}

    def derived(name, op, **settings):
        mr = MapReduce(comm=mesh, **settings)
        op(mr)
        out[name] = ds_rows(mr)

    derived("map_mr_pair", lambda mr: mr.map_mr(
        base, lambda i, k, v, kv, p: kv.add(k, v + i % 3)))
    derived("map_mr_batch", lambda mr: mr.map_mr(base, okernels.invert,
                                                 batch=True))
    for name, op in (("clone", lambda mr: mr.clone()),
                     ("collapse", lambda mr: mr.collapse(1)),
                     ("compress", lambda mr: mr.compress(count,
                                                         batch=True))):
        derived(name, lambda mr, op=op: (mr.add(base), op(mr)))
    plan_cache().clear()
    for run in ("cold", "warm"):
        derived(f"compress_fuse1_{run}", lambda mr: (
            mr.add(base), mr.set(fuse=1), mr.compress(count, batch=True)))
        derived(f"exchange_fuse1_{run}", lambda mr: (
            mr.map_files(kpaths, _map_file), mr.set(fuse=1), mr.aggregate(),
            mr.convert(), mr.reduce(count, batch=True)))

    def open_close(mr):
        kv = mr.open()
        MapReduce(comm=mesh).map_mr(
            base, lambda i, k, v, _kv, p: kv.add(k, v) if k % 5 == 0
            else None)
        mr.close()
        mr.aggregate()
    derived("open_close", open_close)
    cwd = os.getcwd()
    os.makedirs(d)
    shutil.copy(epath, os.path.join(d, "tmp.e"))
    os.chdir(d)
    try:
        s = OinkScript(comm=mesh, screen=io.StringIO())
        s.run_string(MESH_OPS_SCRIPT)
        for name, mr in sorted(s.obj.named.items()):
            out[f"script_{name}"] = ds_rows(mr)
    finally:
        os.chdir(cwd)
    return out


def run_mesh_ops_check(tmp: str, smi: str, devices=None,
                       cpu_devices=None) -> dict:
    """mesh-ops-check: :func:`mesh_ops_frames` on P = 3 shards of the
    card and on three CPU shards over the mesh-check's 2^16 keys and a
    seeded edge file; every op's frames equal shard by shard."""
    import numpy as np
    t0 = time.perf_counter()
    d = os.path.join(tmp, "mesh-ops-check")
    os.makedirs(d)
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 12, MESH_CHECK_KEYS).astype(np.uint32)
    kpaths = split_files(keys, os.path.join(d, "keys"), 6)
    edges = rng.integers(0, 1 << 10, (4096, 2))
    epath = os.path.join(d, "edges.txt")
    with open(epath, "w") as f:
        f.write("".join(f"{a} {b}\n" for a, b in edges))
    card = (devices or mesh_devices())[:1] * MESH_CHECK_P
    cpu = (cpu_devices or ["cpu"])[:1] * MESH_CHECK_P
    frames = {name: mesh_ops_frames(kpaths, epath, devs,
                                    os.path.join(d, name))
              for name, devs in (("card", card), ("cpu", cpu))}
    for op in frames["cpu"]:
        if frames["card"][op] != frames["cpu"][op]:
            raise AssertionError(f"mesh-ops-check: {op} at P = "
                                 f"{MESH_CHECK_P} differs between the card "
                                 f"and the CPU")
    shutil.rmtree(d)
    return {"phase": "mesh-ops-check", "card": smi, "p": MESH_CHECK_P,
            "keys": MESH_CHECK_KEYS, "edges": len(edges),
            "ops": list(frames["card"]), "card_equals_cpu": True,
            "seconds": time.perf_counter() - t0}


def sorted_pairs(mr):
    """A KV's (key, value) pairs as host arrays sorted by key."""
    import numpy as np
    k, v = kv_arrays(mr)
    order = np.argsort(k, kind="stable")
    return k[order], v[order]


def run_mesh_ooc(keys_u32, tmp: str, kernels, smi: str,
                 devices=None) -> dict:
    """mesh-ooc: the intcount-uniform keys at P = 4 through
    ``MapReduce(comm=mesh, outofcore=1, memsize=64, maxpage=2)`` — the
    host-path map_files (pages past the budget spilled), aggregate (the
    exchange onto the shards), convert (each shard block over the
    128 MB budget: demoted in shard order, sorted runs, a k-way merge)
    and reduce(count) — equal to the in-core P = 4 chain's pairs."""
    import numpy as np
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.apps.intcount import _map_file
    from gpu_mapreduce_tpu_torch.core import dataset, external
    from gpu_mapreduce_tpu_torch.core.runtime import global_counters
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    t_phase = time.perf_counter()
    mesh = make_mesh(MESH_P, devices=devices or mesh_devices())
    paths = split_files(keys_u32, os.path.join(tmp, "mesh-ooc"), MESH_P)
    spill = os.path.join(tmp, "mesh-ooc-spill")
    c = global_counters()
    for k in kernels:
        k.launches = 0
    sync_all()
    reset_peaks()
    w0, r0 = c.wsize, c.rsize
    mr = MapReduce(comm=mesh, outofcore=1, memsize=OOC_MEMSIZE,
                   maxpage=OOC_MAXPAGE, fpath=spill, fuse=0)
    with counting(external, "_write_run") as runs, \
            counting(dataset, "_write_spill") as spills:
        pages = {}

        def map_step():
            mr.map_files(paths, _map_file)
            pages["map"] = (mr.kv.nframes, len(os.listdir(spill)),
                            mr.last_ingest["mode"])

        def convert_step():
            pages["over_budget"] = mr._mesh_over_budget(mr.kv)
            mr.convert()

        ooc_s = timed_ops(mesh.devices[0], [
            ("map_files", map_step), ("aggregate", mr.aggregate),
            ("convert", convert_step),
            ("reduce", lambda: mr.reduce(count, batch=True))])
    launches = {k.__name__: k.launches for k in kernels}
    peak = peak_bytes()
    counters = {"wsize": c.wsize - w0, "rsize": c.rsize - r0}
    got = sorted_pairs(mr)
    result_pages = mr.kv.nframes
    mr.kv.free()
    incore = MapReduce(comm=mesh, fuse=0)
    core_s = timed_ops(mesh.devices[0], [
        ("map_files", lambda: incore.map_files(paths, _map_file)),
        ("aggregate", incore.aggregate), ("convert", incore.convert),
        ("reduce", lambda: incore.reduce(count, batch=True))])
    want = sorted_pairs(incore)
    if not (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        raise AssertionError("mesh-ooc: the out-of-core pairs differ from "
                             "the in-core P = 4 chain's")
    if not np.all(got[0][1:] > got[0][:-1]) or \
            int(got[1].sum()) != len(keys_u32):
        raise AssertionError("mesh-ooc: keys not distinct or counts do "
                             "not sum to the input")
    if pages["map"][2] != "host" or not pages["over_budget"] or \
            counters["wsize"] <= 0 or runs[0] < 2:
        raise AssertionError(f"mesh-ooc: the out-of-core path did not "
                             f"run ({pages}, {counters}, {runs[0]} runs)")
    shutil.rmtree(os.path.dirname(paths[0]))
    shutil.rmtree(spill, ignore_errors=True)
    return {"phase": "mesh-ooc", "card": smi, "p": MESH_P,
            "keys": len(keys_u32), "unique": len(got[0]),
            "settings": {"outofcore": 1, "memsize": OOC_MEMSIZE,
                         "maxpage": OOC_MAXPAGE},
            "op_s": ooc_s, "incore_op_s": core_s,
            "pages_after_map": pages["map"][0],
            "spill_files_after_map": pages["map"][1],
            "spill_files_written": spills[0], "runs": runs[0],
            "result_pages": result_pages, **counters,
            "max_memory_allocated": peak, "launches": launches,
            "seconds": time.perf_counter() - t_phase}


def run_mesh_checkpoint(keys_u32, tmp: str, kernels, smi: str,
                        devices=None) -> dict:
    """mesh-checkpoint: save the P = 4 IntCount KV right after the
    aggregate (2^25 pairs), load it at P = 1 and at P = 3 and count it
    there (convert + count; at P = 3 after an aggregate): the pairs equal
    the P = 4 chain's.  Then one value of writer shard 2's rows flipped
    in the frame file (its file digest restamped, so only the per-shard
    digest can see it): the load refuses, naming writer shard 2."""
    import json as _json
    import numpy as np
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.apps.intcount import _map_file
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.utils.integrity import (IntegrityError,
                                                         file_digest)
    t_phase = time.perf_counter()
    devices = devices or mesh_devices()
    mesh = make_mesh(MESH_P, devices=devices)
    paths = split_files(keys_u32, os.path.join(tmp, "mesh-ckpt-keys"),
                        MESH_P)
    ck = os.path.join(tmp, "mesh-ckpt")
    for k in kernels:
        k.launches = 0
    mr = MapReduce(comm=mesh, fuse=0)
    mr.map_files(paths, _map_file)
    mr.aggregate()
    sync_all()
    t0 = time.perf_counter()
    mr.save(ck)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(ck, f))
                 for f in os.listdir(ck))
    mr.convert()
    mr.reduce(count, batch=True)
    want = sorted_pairs(mr)
    del mr
    loads = {}
    for width in (1, MESH_CHECK_P):
        other = MapReduce(comm=make_mesh(width, devices=devices[:1] * width),
                          fuse=0)
        t0 = time.perf_counter()
        n = other.load(ck)
        load_s = time.perf_counter() - t0
        if width > 1:
            other.aggregate()
        other.convert()
        other.reduce(count, batch=True)
        sync_all()
        got = sorted_pairs(other)
        if n != len(keys_u32) or not (np.array_equal(got[0], want[0])
                                      and np.array_equal(got[1], want[1])):
            raise AssertionError(f"mesh-checkpoint: the load at P = "
                                 f"{width} counts differently")
        loads[width] = {"load_s": load_s,
                        "load_gb_per_s": nbytes / load_s / 1e9,
                        "count_s": time.perf_counter() - t0 - load_s}
    launches = {k.__name__: k.launches for k in kernels}
    with open(os.path.join(ck, "manifest.json")) as f:
        man = _json.load(f)
    fm = man["frames"][0]
    fpath = os.path.join(ck, fm["file"])
    with np.load(fpath) as z:
        arrs = {k: z[k].copy() for k in z.files}
    arrs["v_arr"][sum(fm["shards"][:2]) + 7] ^= 1      # writer shard 2
    np.savez(fpath, **arrs)
    del arrs
    fm["digest"] = file_digest(fpath)
    with open(os.path.join(ck, "manifest.json"), "w") as f:
        _json.dump(man, f)
    try:
        MapReduce(comm=make_mesh(2, devices=devices[:1] * 2)).load(ck)
    except IntegrityError as e:
        if "writer shard 2" not in str(e):
            raise AssertionError(f"mesh-checkpoint: the refusal names "
                                 f"another shard: {e}")
    else:
        raise AssertionError("mesh-checkpoint: a flipped value in writer "
                             "shard 2 loaded")
    shutil.rmtree(ck)
    shutil.rmtree(os.path.dirname(paths[0]))
    return {"phase": "mesh-checkpoint", "card": smi, "p": MESH_P,
            "pairs": len(keys_u32), "bytes": nbytes,
            "shards": fm["shards"], "save_s": save_s,
            "save_gb_per_s": nbytes / save_s / 1e9,
            "loads": {f"p{w}": rec for w, rec in loads.items()},
            "refused_writer_shard": 2, "launches": launches,
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# 12. dist — the process group: reshard, the exchange across ranks, launch
# ---------------------------------------------------------------------------

DIST_P = 4                     # ranks, as the mesh phase's shards
DIST_NARROW = 2                # reshard's narrow width
DIST_CHECK_KEYS = 1 << 16      # reshard card vs CPU
# the launcher's corpus: 32 MB, cut from the cell's cap of 64 MB once the
# smoke with the obs phase ran past 780 s on a slow machine
DIST_LAUNCH_MB = 32
DIST_LAUNCH_CHUNKS = 8
DIST_FAULTS = "site=dist.exchange;kind=peer_kill;rank=2;after=1;n=1"
DIST_TIMEOUT_S = 300           # a subprocess run's limit
LAUNCH_ARGS: list = []         # ["--device", "cpu"] in the CPU rehearsals


def _same_rows(a, b) -> bool:
    """Two mesh frames' valid rows in global order (shard by shard)
    byte for byte, compared on the first's first device."""
    import torch
    (ka, va), (kb, vb) = a.valid_rows(), b.valid_rows()
    return (ka.shape == kb.shape and va.shape == vb.shape
            and torch.equal(ka, kb.to(ka.device))
            and torch.equal(va, vb.to(va.device)))


def _kmv_host(fr) -> list:
    """A mesh KMV frame's shards as host rows: (gcap, vcap, gcounts,
    vcounts, per shard (keys, sizes, value multisets))."""
    import numpy as np
    out = [fr.gcap, fr.vcap, fr.gcounts.tolist(), fr.vcounts.tolist()]
    for s in fr.shards:
        h = s.to_host()
        out.append((np.asarray(h.key.data).tolist(),
                    np.asarray(h.nvalues).tolist(),
                    [sorted(h.group_values(i).tolist())
                     for i in range(len(h))]))
    return out


def dist_reshard_check(keys_u32, cards: int) -> dict:
    """reshard at DIST_CHECK_KEYS keys on the card (one shard a card when
    there are DIST_P cards) and on CPU shards: a KV and a KMV through
    4 → 2 → 4, equal shard by shard after every step, and the KV's
    global rows after the round trip equal to where they started."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    keys = keys_u32[:DIST_CHECK_KEYS]

    def kv_rows(mr):
        fr = next(mr.kv.frames())
        return fr.cap, fr.counts.tolist(), [
            (np.asarray(h.key.data).tobytes(),
             np.asarray(h.value.data).tobytes())
            for h in (s.to_host() for s in fr.shards)]

    steps = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            devs = [torch.device("cpu")] * DIST_P
        elif cards >= DIST_P:
            devs = [torch.device("cuda", i) for i in range(DIST_P)]
        else:
            devs = [torch.device("cuda", 0)] * DIST_P
        meshes = [make_mesh(DIST_P, devices=devs),
                  make_mesh(DIST_NARROW, devices=devs[:DIST_NARROW]),
                  make_mesh(DIST_P, devices=devs)]
        kv = MapReduce(comm=meshes[0], fuse=0)
        kv.map(1, lambda i, out, p: out.add_batch(
            keys.astype(np.uint64), np.ones(len(keys), np.uint32)))
        kv.aggregate()
        kmv = MapReduce(comm=meshes[0], fuse=0)
        kmv.map(1, lambda i, out, p: out.add_batch(
            (keys % 4099).astype(np.uint64), keys))
        kmv.collate()
        got = [(kv_rows(kv), _kmv_host(next(kmv.kmv.frames())))]
        for m in meshes[1:]:
            kv.reshard(m)
            kmv.reshard(m)
            got.append((kv_rows(kv), _kmv_host(next(kmv.kmv.frames()))))
        steps[dev] = got
    for i, (a, b) in enumerate(zip(steps["cuda"], steps["cpu"])):
        if a != b:
            raise AssertionError(f"dist-reshard: step {i} differs between "
                                 f"the card and the CPU")
    def global_rows(step):
        return [b"".join(blk[c] for blk in step[0][2]) for c in (0, 1)]
    if global_rows(steps["cuda"][0]) != global_rows(steps["cuda"][-1]):
        raise AssertionError("dist-reshard: the small round trip changed "
                             "the global rows")
    return {"keys": len(keys), "steps": len(steps["cuda"]) - 1,
            "card_equals_cpu": True}


def run_dist_reshard(keys_u32, tmp: str, devices=None) -> dict:
    """reshard: the intcount-p4-uniform KV (2^25 pairs after the
    aggregate on make_mesh(4)) through mr.reshard to 2 shards and back to
    4: the round trip byte-identical (the valid rows in global order; the
    shards then hold the even split),
    each direction's seconds between device synchronises, the range
    exchange's rows and bytes."""
    import torch
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.apps.intcount import _map_file
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.parallel.reshard import even_counts
    devices = devices or mesh_devices(DIST_P)
    mesh4 = make_mesh(DIST_P, devices=devices)
    mesh2 = make_mesh(DIST_NARROW, devices=devices[:DIST_NARROW])
    paths = split_files(keys_u32, os.path.join(tmp, "dist-reshard"),
                        DIST_P)
    mr = MapReduce(comm=mesh4, fuse=0)
    mr.map_files(paths, _map_file)
    mr.aggregate()
    before = next(mr.kv.frames())
    rec = {"devices": [str(d) for d in devices], "pairs": len(before)}
    for label, mesh in (("narrow", mesh2), ("widen", mesh4)):
        sync_all()
        cs0 = mr.counters.cssize
        t0 = time.perf_counter()
        n = mr.reshard(mesh)
        sync_all()
        dt = time.perf_counter() - t0
        fr = next(mr.kv.frames())
        st = fr.exchange_stats
        if n != len(keys_u32) or fr.nprocs != mesh.size:
            raise AssertionError(f"dist-reshard {label}: {n} pairs on "
                                 f"{fr.nprocs} shards")
        rec[label] = {"from": mr.last_reshard["from"],
                      "to": mr.last_reshard["to"], "seconds": dt,
                      "cap": fr.cap, "counts": fr.counts.tolist(),
                      "rows": st.rows, "sent_bytes": st.sent_bytes,
                      "cssize": mr.counters.cssize - cs0,
                      "bound_ms": 2 * st.sent_bytes / HBM_BYTES_PER_S
                      * 1e3}
    after = next(mr.kv.frames())
    if not _same_rows(before, after):
        raise AssertionError("dist-reshard: the 4 -> 2 -> 4 round trip "
                             "changed the global rows")
    if after.counts.tolist() != even_counts(len(after), DIST_P).tolist():
        raise AssertionError(f"dist-reshard: the widened counts "
                             f"{after.counts.tolist()} are not the even "
                             f"split")
    rec["round_trip_identical"] = True
    del mr, before, after
    shutil.rmtree(os.path.dirname(paths[0]))
    return rec


def dist_rank_main(d: str) -> int:
    """One rank of the exchange across ranks (``chip_smoke.py --dist-rank
    DIR``, started by :func:`run_dist_exchange`): its file's keys as its
    block, one hash exchange (then a second, warm), and a JSON record of
    its received block's digests and sync seconds."""
    import hashlib
    import numpy as np
    from gpu_mapreduce_tpu_torch.core.runtime import synchronize
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    from gpu_mapreduce_tpu_torch.parallel import dist as D
    from gpu_mapreduce_tpu_torch.parallel.shuffle import exchange
    rt = D.init_from_env()
    kernels = [match.mark_words, group.segment_table, match.mark]
    with open(os.path.join(d, "counts.json")) as f:
        counts = json.load(f)
    keys = np.fromfile(os.path.join(d, f"part-{rt.rank}.bin"), np.uint32)
    frame = D.shard_local_rows(
        (keys.astype(np.uint64), np.ones(len(keys), np.uint32)), counts)
    runs = []
    for _ in range(2):
        synchronize(rt.device)
        t0 = time.perf_counter()
        out = exchange(frame, ("hash", None))
        synchronize(rt.device)
        runs.append({"seconds": time.perf_counter() - t0,
                     **out.sync_seconds})
    s = out.shard
    rec = {"rank": rt.rank, "device": str(rt.device),
           "backend": rt.backend, "transport": rt.transport,
           "cap": s.cap, "count": int(s.counts[0]),
           "key_sha": hashlib.sha256(
               s.key.cpu().numpy().tobytes()).hexdigest(),
           "value_sha": hashlib.sha256(
               s.value.cpu().numpy().tobytes()).hexdigest(),
           "cold": runs[0], "warm": runs[1],
           "launches": {k.__name__: k.launches for k in kernels}}
    with open(os.path.join(d, f"rank{rt.rank}.json"), "w") as f:
        json.dump(rec, f)
    rt.stop()
    sys.stdout.flush()
    os._exit(0)


def run_dist_exchange(keys_u32, tmp: str, devices=None) -> dict:
    """exchange across ranks: DIST_P rank processes each hold one of the
    intcount-p4-uniform files' keys on their device and run one hash
    exchange (then a second, warm); each rank's received block (cap,
    count, padded keys and values by sha256) must equal shard d of the
    one-controller make_mesh(4) exchange of the same blocks on
    ``devices``, whose warm exchange is timed beside the ranks'."""
    import hashlib
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.launch import pick_port
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.parallel.sharded import mesh_kv
    from gpu_mapreduce_tpu_torch.parallel.shuffle import exchange
    d = os.path.join(tmp, "dist-exchange")
    paths = split_files(keys_u32, d, DIST_P)
    counts = [os.path.getsize(p) // 4 for p in paths]
    with open(os.path.join(d, "counts.json"), "w") as f:
        json.dump(counts, f)
    devices = devices or mesh_devices(DIST_P)
    mesh = make_mesh(DIST_P, devices=devices)
    blocks = [np.fromfile(p, np.uint32) for p in paths]
    src = mesh_kv(
        mesh, [torch.from_numpy(b.astype(np.uint64).view(np.int64)).to(dev)
               for b, dev in zip(blocks, devices)],
        [torch.ones(len(b), dtype=torch.int32, device=dev)
         for b, dev in zip(blocks, devices)],
        counts, np.uint64, np.uint32)
    exchange(src, ("hash", None))
    sync_all()
    t0 = time.perf_counter()
    ref = exchange(src, ("hash", None))      # warm: the timed reference
    sync_all()
    mesh_s = time.perf_counter() - t0
    want = [{"cap": s.cap, "count": int(s.counts[0]),
             "key_sha": hashlib.sha256(
                 s.key.cpu().numpy().tobytes()).hexdigest(),
             "value_sha": hashlib.sha256(
                 s.value.cpu().numpy().tobytes()).hexdigest()}
            for s in ref.shards]
    del ref, src, blocks
    port = pick_port()
    procs = []
    t0 = time.perf_counter()
    for r in range(DIST_P):
        env = dict(os.environ, MRTPU_DIST_WORLD=str(DIST_P),
                   MRTPU_DIST_RANK=str(r),
                   MRTPU_DIST_COORD=f"localhost:{port}",
                   MRTPU_DIST_RUNDIR=os.path.join(d, "run"),
                   MRTPU_DIST_GEN="0")
        env.pop("MRTPU_FAULTS", None)
        log = open(os.path.join(d, f"rank{r}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank", d],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        codes = [p.wait(timeout=DIST_TIMEOUT_S) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    wall = time.perf_counter() - t0
    if any(codes):
        tails = {}
        for r in range(DIST_P):
            with open(os.path.join(d, f"rank{r}.log"), "rb") as f:
                tails[r] = f.read()[-1500:].decode(errors="replace")
        raise AssertionError(f"dist-exchange: rank exit codes {codes}: "
                             f"{tails}")
    ranks = []
    for r in range(DIST_P):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            rec = json.load(f)
        got = {k: rec[k] for k in ("cap", "count", "key_sha", "value_sha")}
        if got != want[r]:
            raise AssertionError(f"dist-exchange: rank {r}'s block {got} "
                                 f"!= the mesh's shard {r} {want[r]}")
        ranks.append(rec)
    shutil.rmtree(d)
    return {"ranks": DIST_P, "keys": int(sum(counts)),
            "bytes_per_rank": [c * 4 for c in counts],
            "backend": ranks[0]["backend"],
            "transport": ranks[0]["transport"],
            "devices": [r["device"] for r in ranks],
            "equals_mesh_shards": True, "wall_s": wall,
            "mesh_devices": [str(dev) for dev in devices],
            "mesh_exchange_s": mesh_s,
            "cap": want[0]["cap"], "counts": [w["count"] for w in want],
            "count_sync_s": {run: [r[run]["count_sync"] for r in ranks]
                             for run in ("cold", "warm")},
            "exchange_s": {run: [r[run]["exchange"] for r in ranks]
                           for run in ("cold", "warm")},
            "seconds": {run: [r[run]["seconds"] for r in ranks]
                        for run in ("cold", "warm")},
            "launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in ranks[0]["launches"]}}


def _launch(args, rundir: str, env=None) -> dict:
    """One launcher run; returns its ``mrlaunch:`` summary and the
    device, backend and transport each rank's log names."""
    e = dict(os.environ)
    e.pop("MRTPU_FAULTS", None)
    e.update(env or {})
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "gpu_mapreduce_tpu_torch.launch",
                        "--rundir", rundir] + LAUNCH_ARGS + args, env=e,
                       cwd=root, capture_output=True,
                       timeout=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"launch {args[:2]}: rc {r.returncode}\n"
                             f"{r.stdout.decode()[-2000:]}\n"
                             f"{r.stderr.decode()[-2000:]}")
    summary = json.loads(r.stdout.decode().split("mrlaunch: ", 1)[1]
                         .splitlines()[0])
    ranks = {}
    for name in sorted(os.listdir(rundir)):
        if not name.endswith(".log"):
            continue
        with open(os.path.join(rundir, name), "rb") as f:
            m = re.search(rb"launch: rank (\d+) of (\d+), gen (\d+), "
                          rb"device (\S+), backend (\w+), transport (\S+)",
                          f.read())
        if m:
            ranks[name[:-4]] = {"device": m.group(4).decode(),
                                "backend": m.group(5).decode(),
                                "transport": m.group(6).decode()}
    return {"wall_s": wall, "summary": summary, "ranks": ranks}


def launch_oracle(paths) -> bytes:
    """The launcher's output from collections.Counter: 'word count' lines,
    count descending, then word."""
    from collections import Counter
    c = Counter()
    for p in paths:
        with open(p, "rb") as f:
            c.update(f.read().split())
    rows = sorted(c.items(), key=lambda wc: (-wc[1], wc[0]))
    return b"".join(w + b" %d\n" % n for w, n in rows)


def run_dist_launch(tmp: str) -> dict:
    """launcher: launch --np 4, then --np 2, over the zipf generator's
    files at DIST_LAUNCH_MB, both equal to the Counter oracle; then --np 4
    with rank 2 killed at its second exchange: it must end at width 2
    after 2 generations, history[0].dead == [2], the output byte-equal to
    the --np 2 run's."""
    d = os.path.join(tmp, "dist-launch")
    os.makedirs(d)
    t0 = time.perf_counter()
    paths, _, _, _ = zipf_corpus(d, DIST_LAUNCH_MB)
    gen_s = time.perf_counter() - t0
    want = launch_oracle(paths)
    runs, outs = {}, {}
    for label, nproc, env in (
            ("np4", DIST_P, None), ("np2", DIST_NARROW, None),
            ("chaos", DIST_P, {"MRTPU_FAULTS": DIST_FAULTS})):
        out = os.path.join(d, f"{label}.txt")
        runs[label] = _launch(
            ["--np", str(nproc), "wordfreq", "--files", *paths, "--out", out,
             "--chunks", str(DIST_LAUNCH_CHUNKS)],
            os.path.join(d, f"run-{label}"), env)
        with open(out, "rb") as f:
            outs[label] = f.read()
    for label in ("np4", "np2"):
        if outs[label] != want:
            raise AssertionError(f"dist-launch {label}: the output differs "
                                 f"from the Counter oracle")
    s = runs["chaos"]["summary"]
    if not (s["final_width"] == DIST_NARROW and s["generations"] == 2
            and s["history"][0]["dead"] == [2]
            and s["recover_seconds"] is not None):
        raise AssertionError(f"dist-launch chaos: {s}")
    if outs["chaos"] != outs["np2"]:
        raise AssertionError("dist-launch chaos: the shrunk run's output "
                             "differs from the --np 2 run's")
    nbytes = sum(os.path.getsize(p) for p in paths)
    # the trace shards, rank dumps, sync records and flight dumps each
    # run left (the obs phase's line carries them)
    obs = {label: dist_obs_files(os.path.join(d, f"run-{label}"),
                                 DIST_NARROW if label == "np2" else DIST_P,
                                 label == "chaos")
           for label in runs}
    shutil.rmtree(d)
    return {"corpus_bytes": nbytes, "files": len(paths), "obs": obs,
            "cut": f"the zipf generator at {DIST_LAUNCH_MB} MB (cut from "
                   f"the wordfreq-zipf cell's 256 MB, under the launcher "
                   f"cell's cap of 64 MB, to keep the smoke under 780 s)",
            "corpus_s": gen_s,
            "chunks": DIST_LAUNCH_CHUNKS, "faults": DIST_FAULTS,
            "outputs_equal_oracle": True, "chaos_equals_np2": True,
            "recover_seconds": s["recover_seconds"],
            "final_width": s["final_width"],
            "generations": s["generations"],
            "dead": s["history"][0]["dead"],
            "codes": s["history"][0]["codes"],
            **{f"{label}_wall_s": rec["wall_s"]
               for label, rec in runs.items()},
            **{f"{label}_launcher_s": rec["summary"]["wall_seconds"]
               for label, rec in runs.items()},
            "ranks": {label: rec["ranks"] for label, rec in runs.items()}}


def run_dist(keys_u32, tmp: str, kernels, smi: str) -> dict:
    """The dist phase: reshard (and its card-vs-CPU check), the exchange
    across ranks and the launcher, every launch count set to 0 just
    before it; with DIST_P cards or more, reshard again with one shard a
    card (the ranks are then one a card already, on NCCL)."""
    import torch
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    for k in kernels:
        k.launches = 0
    rec = {"phase": "dist", "card": smi, "p": DIST_P, "cards": cards}
    rec["reshard"] = run_dist_reshard(keys_u32, tmp)
    if cards >= DIST_P:
        rec["reshard_cards"] = run_dist_reshard(
            keys_u32, tmp, devices=[torch.device("cuda", i)
                                    for i in range(DIST_P)])
    rec["reshard_check"] = dist_reshard_check(keys_u32, cards)
    # the one-process reference on the same cards as the ranks
    rec["exchange"] = run_dist_exchange(
        keys_u32, tmp, devices=[torch.device("cuda", i)
                                for i in range(DIST_P)]
        if cards >= DIST_P else None)
    rec["launch"] = run_dist_launch(tmp)
    # this process's launches and the exchange ranks'; the launcher's
    # workers call no kernel wrapper
    rec["launches"] = {k.__name__: k.launches
                       + rec["exchange"]["launches"][k.__name__]
                       for k in kernels}
    rec["seconds"] = time.perf_counter() - t0
    return rec


WIRE_CHECK_KEYS = 1 << 16      # the card-vs-CPU check's rows
WIRE_ON_RUNS = 3               # the first cold, the next speculative hits


def wire_frame(keys_u32, mesh):
    """The intcount-p4 cells' rows as a mesh frame: (u64 key, u32 1)
    pairs, a contiguous quarter of the keys a shard."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.parallel.sharded import mesh_kv
    blocks = np.array_split(keys_u32, mesh.size)
    return mesh_kv(
        mesh, [torch.from_numpy(b.astype(np.uint64).view(np.int64)).to(dev)
               for b, dev in zip(blocks, mesh.devices)],
        [torch.ones(len(b), dtype=torch.int32, device=dev)
         for b, dev in zip(blocks, mesh.devices)],
        [len(b) for b in blocks], np.uint64, np.uint32)


def same_frames(a, b) -> bool:
    """Two mesh frames equal shard by shard: caps, counts, padded keys
    and values (compared on their devices)."""
    import torch
    return (a.cap == b.cap and a.counts.tolist() == b.counts.tolist()
            and all(torch.equal(x.key, y.key.to(x.key.device))
                    and torch.equal(x.value, y.value.to(x.value.device))
                    for x, y in zip(a.shards, b.shards)))


@contextlib.contextmanager
def wire_env(value: str):
    """``MRTPU_WIRE`` set to ``value`` for the block."""
    saved = os.environ.get("MRTPU_WIRE")
    os.environ["MRTPU_WIRE"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MRTPU_WIRE", None)
        else:
            os.environ["MRTPU_WIRE"] = saved


def timed_exchange(frame, dest=("hash", None)):
    """One exchange between synchronises of every card: (frame, CUDA-event
    ms on card 0, its stats)."""
    import torch
    from gpu_mapreduce_tpu_torch.parallel.shuffle import exchange
    sync_all()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    out = exchange(frame, dest)
    sync_all()
    ev1.record()
    ev1.synchronize()
    return out, ev0.elapsed_time(ev1), vars(out.exchange_stats)


def wire_plan_of(frame, wire_on: bool, dest=("hash", None)):
    """The plan the speculative cache holds for ``frame``'s exchange: the
    plan that ran last."""
    from gpu_mapreduce_tpu_torch.parallel import shuffle
    return shuffle._SPEC_CACHE.get(
        shuffle._spec_key(frame, dest, 1, wire_on))


def run_wire_exchange(cell: str, keys_u32, devices) -> dict:
    """wire-p4-<cell>: the eager hash exchange of the cell's 2^25 rows on
    four shards, WIRE_ON_RUNS times with the codec on (the first cold,
    the rest speculative hits), then as many with MRTPU_WIRE=0; every
    output byte-equal to the first.  The plan's pack widths,
    wire_ratio, wire_bytes against sent + pad bytes, the hits, and the
    exchange's ms on and off (median of the warm runs)."""
    from gpu_mapreduce_tpu_torch.parallel import shuffle
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(len(devices), devices=devices)
    frame = wire_frame(keys_u32, mesh)
    shuffle._SPEC_CACHE.clear()
    runs, first = {"on": [], "off": []}, None
    for label, value in (("on", "1"), ("off", "0")):
        with wire_env(value):
            for _ in range(WIRE_ON_RUNS):
                out, ms, stats = timed_exchange(frame)
                if first is None:
                    first = out
                elif not same_frames(first, out):
                    raise AssertionError(f"wire-p4-{cell}: the codec-{label} "
                                         f"exchange differs from the first")
                runs[label].append({"ms": ms, **stats})
        del out
    plan = wire_plan_of(frame, True)
    if plan is None or plan[0] != "wire":
        raise AssertionError(f"wire-p4-{cell}: the codec did not engage: "
                             f"{plan}")
    on, off = runs["on"], runs["off"]
    hits = [r["speculative"] for r in on]
    if hits != [False] + [True] * (WIRE_ON_RUNS - 1):
        raise AssertionError(f"wire-p4-{cell}: speculative hits {hits}")
    s = on[-1]
    return {"cell": f"wire-p4-{cell}", "p": mesh.size,
            "devices": [str(d) for d in mesh.devices],
            "rows": s["rows"], "bytes_on_card": frame.nbytes(),
            "plan": {"tiers": list(plan[1]), "cap_out": plan[2],
                     "kpack": plan[3], "vpack": plan[4]},
            "wire_ratio": s["wire_ratio"], "wire_bytes": s["wire_bytes"],
            "sent_bytes": s["sent_bytes"], "pad_bytes": s["pad_bytes"],
            "sent_plus_pad": s["sent_bytes"] + s["pad_bytes"],
            "speculative_hits": sum(hits), "speculative": hits,
            "off_speculative": [r["speculative"] for r in off],
            "ms_on": [r["ms"] for r in on], "ms_off": [r["ms"] for r in off],
            "ms_on_cold": on[0]["ms"], "ms_off_cold": off[0]["ms"],
            "ms_on_warm_median": statistics.median(r["ms"] for r in on[1:]),
            "ms_off_warm_median": statistics.median(r["ms"]
                                                    for r in off[1:]),
            "equal_on_off": True}


def run_mesh2(keys_u32, tmp: str, devices) -> dict:
    """mesh2-2x2: make_mesh2(2, 2) over ``devices`` (a slice is two
    cards where four are present): the hash exchange of the cell's rows
    byte-equal to make_mesh(4)'s on the same devices, then aggregate and
    gather(1) through MapReduce, and a per-shard InvertedIndex output
    (four part files) equal to make_mesh(4)'s."""
    import numpy as np
    from gpu_mapreduce_tpu_torch import InvertedIndex, MapReduce
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh, make_mesh2
    m2 = make_mesh2(2, 2, devices=devices)
    m1 = make_mesh(4, devices=devices)
    hier, ms2, st2 = timed_exchange(wire_frame(keys_u32, m2))
    flat, ms1, st1 = timed_exchange(wire_frame(keys_u32, m1))
    if not same_frames(flat, hier):
        raise AssertionError("mesh2-2x2: the hierarchical exchange differs "
                             "from make_mesh(4)'s")
    del hier, flat
    blocks = np.array_split(keys_u32.astype(np.uint64), 4)
    gathered = []
    for mesh in (m2, m1):
        mr = MapReduce(comm=mesh)
        mr.map(4, lambda itask, kv, ptr: kv.add_batch(
            blocks[itask], np.ones(len(blocks[itask]), np.uint32)))
        mr.aggregate()
        mr.gather(1)
        gathered.append(mr.kv.one_frame())
    if not same_frames(*gathered):
        raise AssertionError("mesh2-2x2: gather(1) differs from "
                             "make_mesh(4)'s")
    d = os.path.join(tmp, "mesh2")
    os.makedirs(d)
    paths, nref, nuniq = make_corpus(d, MESH_CHECK_MB, skew=True)
    parts = []
    for mesh, tag in ((m2, "m2"), (m1, "m1")):
        out = os.path.join(d, f"out-{tag}")
        if InvertedIndex(comm=mesh).run(paths, outdir=out) != (nref, nuniq):
            raise AssertionError(f"mesh2-2x2: InvertedIndex on {tag}")
        parts.append({f: open(os.path.join(out, f), "rb").read()
                      for f in sorted(os.listdir(out))})
    if parts[0] != parts[1] or len(parts[0]) != 4:
        raise AssertionError("mesh2-2x2: the part files differ from "
                             "make_mesh(4)'s")
    shutil.rmtree(d)
    return {"cell": "mesh2-2x2", "shape": m2.shape,
            "devices": [str(x) for x in m2.devices],
            "cards": len(set(m2.devices)), "equals_flat": True,
            "exchange_ms": ms2, "flat_exchange_ms": ms1,
            "wire_ratio": st2["wire_ratio"],
            "gather_counts": gathered[0].counts.tolist(),
            "part_files": len(parts[0]), "parts_equal_flat": True}


def dist_local_rank_main(d: str) -> int:
    """One rank of dist-local-2x2 (``chip_smoke.py --dist-local-rank
    DIR``): its two shards' keys as its blocks, one hash exchange, and a
    JSON record of each received block's digests."""
    import hashlib
    import numpy as np
    from gpu_mapreduce_tpu_torch.core.runtime import synchronize
    from gpu_mapreduce_tpu_torch.parallel import dist as D
    from gpu_mapreduce_tpu_torch.parallel.shuffle import exchange
    rt = D.init_from_env()
    with open(os.path.join(d, "counts.json")) as f:
        counts = json.load(f)
    L = len(rt.devices)
    blocks = []
    for p in range(rt.rank * L, (rt.rank + 1) * L):
        keys = np.fromfile(os.path.join(d, f"part-{p}.bin"), np.uint32)
        blocks.append((keys.astype(np.uint64), np.ones(len(keys),
                                                         np.uint32)))
    frame = D.shard_local_rows(blocks, counts)
    for dev in rt.devices:
        synchronize(dev)
    t0 = time.perf_counter()
    out = exchange(frame, ("hash", None))
    for dev in rt.devices:
        synchronize(dev)
    rec = {"rank": rt.rank, "devices": [str(x) for x in rt.devices],
           "backend": rt.backend, "transport": rt.transport,
           "seconds": time.perf_counter() - t0, **out.sync_seconds,
           "wire_bytes": out.exchange_stats.wire_bytes,
           "shards": [{"cap": s.cap, "count": int(s.counts[0]),
                       "key_sha": hashlib.sha256(
                           s.key.cpu().numpy().tobytes()).hexdigest(),
                       "value_sha": hashlib.sha256(
                           s.value.cpu().numpy().tobytes()).hexdigest()}
                      for s in out.shards]}
    with open(os.path.join(d, f"rank{rt.rank}.json"), "w") as f:
        json.dump(rec, f)
    rt.stop()
    sys.stdout.flush()
    os._exit(0)


def run_dist_local(keys_u32, tmp: str, devices, cpu: bool = False) -> dict:
    """dist-local-2x2: two rank processes holding two shards each
    (``MRTPU_DIST_LOCAL_DEVICES=2``; gloo on one card, NCCL with one card
    a shard where four are present; with ``cpu`` gloo on the CPU), the
    hash exchange of the cell's rows; each rank's two blocks (cap, count,
    sha256 of the padded keys and values) equal to make_mesh(4)'s shards
    2r and 2r + 1 of the same blocks on ``devices``, cold."""
    import hashlib
    import numpy as np
    from gpu_mapreduce_tpu_torch.launch import pick_port
    from gpu_mapreduce_tpu_torch.parallel import shuffle
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    W, L = 2, 2
    d = os.path.join(tmp, "dist-local")
    paths = split_files(keys_u32, d, W * L)
    counts = [os.path.getsize(p) // 4 for p in paths]
    with open(os.path.join(d, "counts.json"), "w") as f:
        json.dump(counts, f)
    shuffle._SPEC_CACHE.clear()
    ref = shuffle.exchange(wire_frame(keys_u32, make_mesh(
        W * L, devices=devices)), ("hash", None))
    want = [{"cap": s.cap, "count": int(s.counts[0]),
             "key_sha": hashlib.sha256(
                 s.key.cpu().numpy().tobytes()).hexdigest(),
             "value_sha": hashlib.sha256(
                 s.value.cpu().numpy().tobytes()).hexdigest()}
            for s in ref.shards]
    del ref
    port = pick_port()
    procs = []
    for r in range(W):
        env = dict(os.environ, MRTPU_DIST_WORLD=str(W),
                   MRTPU_DIST_RANK=str(r), MRTPU_DIST_LOCAL_DEVICES=str(L),
                   MRTPU_DIST_COORD=f"localhost:{port}",
                   MRTPU_DIST_RUNDIR=os.path.join(d, "run"),
                   MRTPU_DIST_GEN="0")
        env.pop("MRTPU_FAULTS", None)
        if cpu:
            env["MRTPU_DIST_DEVICE"] = "cpu"
        log = open(os.path.join(d, f"rank{r}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-local-rank",
             d], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        codes = [p.wait(timeout=DIST_TIMEOUT_S) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(codes):
        tails = {}
        for r in range(W):
            with open(os.path.join(d, f"rank{r}.log"), "rb") as f:
                tails[r] = f.read()[-1500:].decode(errors="replace")
        raise AssertionError(f"dist-local: rank exit codes {codes}: {tails}")
    ranks = []
    for r in range(W):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            rec = json.load(f)
        if rec["shards"] != want[r * L:(r + 1) * L]:
            raise AssertionError(f"dist-local: rank {r}'s blocks "
                                 f"{rec['shards']} != the mesh's shards "
                                 f"{want[r * L:(r + 1) * L]}")
        ranks.append(rec)
    shutil.rmtree(d)
    return {"cell": "dist-local-2x2", "ranks": W, "shards_per_rank": L,
            "keys": int(sum(counts)), "backend": ranks[0]["backend"],
            "devices": [r["devices"] for r in ranks],
            "equals_mesh_shards": True,
            "seconds": [r["seconds"] for r in ranks],
            "count_sync_s": [r["count_sync"] for r in ranks],
            "exchange_s": [r["exchange"] for r in ranks],
            "wire_bytes": ranks[0]["wire_bytes"],
            "counts": [w["count"] for w in want]}


def wire_cpu_check(keys_u32, tmp: str, card=None) -> dict:
    """The wire cells at WIRE_CHECK_KEYS rows on the card and on CPU
    shards, byte-equal: the exchange with the codec on (cold, then a
    speculative hit) and off, the hierarchical exchange of make_mesh2(2,
    2), the fused group cold and warm; and dist-local-2x2 with its ranks
    on the CPU against the CPU mesh."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    from gpu_mapreduce_tpu_torch.parallel import shuffle
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh, make_mesh2
    from gpu_mapreduce_tpu_torch.plan import plan_cache
    keys = keys_u32[:WIRE_CHECK_KEYS]
    card = torch.device("cuda", 0) if card is None else torch.device(card)
    got = {}
    for dev in ("cuda", "cpu"):
        devs = [card if dev == "cuda" else torch.device("cpu")] * 4
        shuffle._SPEC_CACHE.clear()
        rec = []
        for value in ("1", "1", "0"):
            with wire_env(value):
                out = shuffle.exchange(
                    wire_frame(keys, make_mesh(4, devices=devs)),
                    ("hash", None))
                rec.append((out, vars(out.exchange_stats)))
        rec.append((shuffle.exchange(wire_frame(keys, make_mesh2(
            2, 2, devices=devs)), ("hash", None)), None))
        saved = os.environ.get("MRTPU_FUSE")
        os.environ["MRTPU_FUSE"] = "1"
        try:
            plan_cache().clear()
            blocks = np.array_split(keys.astype(np.uint64), 4)
            for _ in range(2):
                mr = MapReduce(comm=make_mesh(4, devices=devs))
                mr.map(4, lambda itask, kv, ptr: kv.add_batch(
                    blocks[itask], np.ones(len(blocks[itask]), np.uint32)))
                mr.aggregate()
                mr.convert()
                mr.reduce(count, batch=True)
                rec.append((mr.kv.one_frame(), vars(mr.last_exchange)))
        finally:
            if saved is None:
                os.environ.pop("MRTPU_FUSE", None)
            else:
                os.environ["MRTPU_FUSE"] = saved
        got[dev] = rec
    for i, ((a, sa), (b, sb)) in enumerate(zip(got["cuda"], got["cpu"])):
        if not same_frames(b, a) or sa != sb:
            raise AssertionError(f"wire check: output {i} differs between "
                                 f"the card and the CPU: {sa} vs {sb}")
    local = run_dist_local(keys, tmp, [torch.device("cpu")] * 4, cpu=True)
    return {"rows": len(keys), "compared": len(got["cpu"]),
            "card_equals_cpu": True,
            "speculative": [s["speculative"] for _, s in got["cpu"][:3]],
            "fused_modes_speculative": [s["speculative"]
                                        for _, s in got["cpu"][4:]],
            "dist_local_cpu": local["equals_mesh_shards"]}


def run_wire(int_keys: dict, tmp: str, kernels, smi: str, mesh_wf: dict,
             mesh_fuse: dict) -> dict:
    """The wire phase: wire-p4-uniform and -zipf (the eager exchange with
    the codec on and off; the fused group under it is the mesh phase's
    mesh-fuse run, ``mesh_fuse``, whose exchange must have taken a wire
    plan), wordfreq-p4's plans (from the text phase), mesh2-2x2,
    dist-local-2x2 and the card-vs-CPU check, every launch count set to
    0 just before it."""
    import torch
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(MESH_P)] \
        if cards >= MESH_P else mesh_devices()
    for k in kernels:
        k.launches = 0
    rec = {"phase": "wire", "card": smi, "p": MESH_P, "cards": cards,
           "devices": [str(d) for d in devices]}
    for cell, keys in int_keys.items():
        rec[f"wire-p4-{cell}"] = run_wire_exchange(cell, keys, devices)
        emit({"phase": "wire", "card": smi, **rec[f"wire-p4-{cell}"]})
        fused = {run: {k: r[k] for k in (
            "mode", "speculative", "group_s", "sent_bytes", "pad_bytes",
            "wire_bytes", "wire_ratio", "launches")}
            for run, r in mesh_fuse[cell].items() if run in ("cold", "warm")}
        if not all(r["wire_bytes"] for r in fused.values()):
            raise AssertionError(f"wire-fuse-{cell}: the fused group took "
                                 f"no wire plan: {fused}")
        rec[f"wire-p4-{cell}"]["fused"] = fused
        emit({"phase": "wire", "card": smi, "cell": f"wire-fuse-{cell}",
              "from": f"mesh-fuse-{cell}", **fused})
    rec["wordfreq-p4"] = {"plans": mesh_wf["wire_plans"]}
    emit({"phase": "wire", "card": smi, "cell": "wordfreq-p4",
          "plans": mesh_wf["wire_plans"]})
    rec["mesh2-2x2"] = run_mesh2(int_keys["uniform"], tmp, devices)
    emit({"phase": "wire", "card": smi, **rec["mesh2-2x2"]})
    rec["dist-local-2x2"] = run_dist_local(
        int_keys["uniform"], tmp, devices, cpu=devices[0].type == "cpu")
    emit({"phase": "wire", "card": smi, **rec["dist-local-2x2"]})
    rec["check"] = wire_cpu_check(int_keys["uniform"], tmp, devices[0])
    rec["launches"] = {k.__name__: k.launches for k in kernels}
    rec["seconds"] = time.perf_counter() - t0
    return rec


# -- the ft phase: fault tolerance on the card ---------------------------------

FT_BACKOFF_S = "0.002"         # MRTPU_RETRY_BACKOFF in the phase: the
#                                rerun work is timed, not the sleep
FT_CKPT_EVERY = 3              # the journaled graph script: 3 sets
FT_SEED = 11                   # tests/test_ft.py's _arm_all_sites
FT_BUDGET = 3
FT_CPU = False                 # --ft-rehearse: CPU shards, small sizes


def ft_devices(n: int) -> list:
    """The phase's ``n`` shards: on the first card (CPU shards in a
    rehearsal)."""
    return ["cpu"] * n if FT_CPU else mesh_devices(n)


@contextlib.contextmanager
def ft_armed(arm: bool = True, sites=None):
    """The JAX golden's schedule (tests/test_ft.py:223-227) for the block:
    every registered site (or ``sites``), rate 1, seed 11, one fault a
    site, budget 3; ft/ state reset before and after, the backoff base a
    few ms."""
    from gpu_mapreduce_tpu_torch import ft
    saved = os.environ.get("MRTPU_RETRY_BACKOFF")
    os.environ["MRTPU_RETRY_BACKOFF"] = FT_BACKOFF_S
    ft.reset()
    if arm:
        for site in sites or ft.SITES:
            ft.schedule(site=site, rate=1.0, seed=FT_SEED, max_faults=1)
            ft.set_budget(site, FT_BUDGET)
    try:
        yield ft
    finally:
        ft.reset()
        if saved is None:
            os.environ.pop("MRTPU_RETRY_BACKOFF", None)
        else:
            os.environ["MRTPU_RETRY_BACKOFF"] = saved


def ft_counts() -> dict:
    """Faults injected by site, retry outcomes by site, quarantines."""
    from gpu_mapreduce_tpu_torch import ft
    return {"faults": ft.fault_counts(),
            "retries": {f"{s} {o}": n
                        for (s, o), n in sorted(ft.retries_snapshot().items())},
            "quarantined": ft.quarantine_snapshot()["count"]}


def ft_recovered(rec: dict, site: str) -> bool:
    return rec["faults"].get(site, 0) >= 1 and \
        rec["retries"].get(f"{site} recovered", 0) >= 1


def ft_main(paths, nref: int, nuniq: int, tmp: str, kernels) -> dict:
    """ft-main: InvertedIndex over the main corpus, comm=make_mesh(1),
    onfault=retry (MRTPU_ONFAULT), clean then under the schedule, each
    writing its part file.  At P = 1 neither package exchanges (the
    reference's nprocs == 1 early-out), so the map task's ingest sites
    are the ones that fire."""
    from gpu_mapreduce_tpu_torch import InvertedIndex
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    runs, parts = {}, {}
    os.environ["MRTPU_ONFAULT"] = "retry"
    mesh = make_mesh(1, devices=ft_devices(1))
    try:
        for run in ("clean", "faulted"):
            with ft_armed(run == "faulted"):
                out = os.path.join(tmp, f"ft-main-{run}")
                for k in kernels:
                    k.launches = 0
                sync_all()
                t0 = time.perf_counter()
                got = InvertedIndex(comm=mesh).run(paths, outdir=out)
                sync_all()
                dt = time.perf_counter() - t0
                runs[run] = {"seconds": dt, "npairs": got[0],
                             "nunique": got[1],
                             "launches": {k.__name__: k.launches
                                          for k in kernels},
                             **ft_counts()}
                with open(os.path.join(out, "part-00000"), "rb") as f:
                    parts[run] = f.read()
                shutil.rmtree(out)
    finally:
        os.environ.pop("MRTPU_ONFAULT", None)
    bad = [run for run, r in runs.items()
           if (r["npairs"], r["nunique"]) != (nref, nuniq)]
    f = runs["faulted"]
    if bad or parts["clean"] != parts["faulted"] or \
            not ft_recovered(f, "ingest.tokenize") or \
            f["faults"].get("ingest.read", 0) < 1 or \
            (f["launches"]["mark_words"] < 1 and not FT_CPU):
        raise AssertionError(f"ft-main: {runs} (part files equal: "
                             f"{parts['clean'] == parts['faulted']})")
    return {"case": "ft-main", **runs, "part_bytes": len(parts["clean"]),
            "part_equal": True}


def ft_wordfreq_job(paths, mesh, ckpt: str, onfault: str = "fail"):
    """The JAX golden's job shape (tests/test_ft.py:229-252) on the card:
    map_files (the words split and interned on each shard's device) →
    collate → reduce count → save → load.  Returns (rows, reloaded rows,
    seconds)."""
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.oink.kernels import read_words
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    sync_all()
    t0 = time.perf_counter()
    mr = MapReduce(comm=mesh, onfault=onfault)
    mr.map_files(list(paths), read_words)
    mr.collate()
    mr.reduce(count, batch=True)
    mr.save(ckpt)
    mr2 = MapReduce(comm=mesh)
    mr2.load(ckpt)
    sync_all()
    dt = time.perf_counter() - t0
    rows, rows2 = ds_rows(mr), ds_rows(mr2)
    stats = mr.stats()["ft"]
    shutil.rmtree(ckpt)
    return rows, rows2, dt, stats


def word_counts(rows) -> dict:
    """{word: count} of a wordfreq job's rows (ds_rows)."""
    out: dict = {}
    for _kind, _cap, shards in rows:
        for keys, values in shards:
            for k, v in zip(keys, values):
                out[k] = out.get(k, 0) + int(v)
    return out


def ft_wordfreq(zpaths, tmp: str, kernels) -> dict:
    """ft-wordfreq-p4: the job shape over the zipf cell's four files at
    P = 4, clean then under the schedule: rows byte-equal shard by shard
    (caps included), the reloaded rows equal, faults at ingest.read,
    ingest.tokenize, shuffle.exchange and checkpoint.save, and
    ``stats()["ft"]`` the same faults as ``fault_counts()``."""
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(MESH_P, devices=ft_devices(MESH_P))
    runs, got = {}, {}
    for run in ("clean", "faulted"):
        with ft_armed(run == "faulted") as ft:
            for k in kernels:
                k.launches = 0
            rows, rows2, dt, stats = ft_wordfreq_job(
                zpaths, mesh, os.path.join(tmp, f"ft-wf-{run}"))
            got[run] = (rows, rows2)
            runs[run] = {"seconds": dt, **ft_counts(),
                         "launches": {k.__name__: k.launches
                                      for k in kernels},
                         "stats_ft_equal_fault_counts":
                             stats["faults_injected"] == ft.fault_counts()}
    f = runs["faulted"]
    sites = ("ingest.read", "ingest.tokenize", "shuffle.exchange",
             "checkpoint.save")
    if got["clean"][0] != got["faulted"][0] or \
            got["clean"][1] != got["faulted"][1] or \
            any(f["faults"].get(s, 0) < 1 for s in sites) or \
            not ft_recovered(f, "shuffle.exchange") or \
            not f["stats_ft_equal_fault_counts"]:
        raise AssertionError(f"ft-wordfreq-p4: {runs} (rows equal "
                             f"{got['clean'][0] == got['faulted'][0]}, "
                             f"reloaded equal "
                             f"{got['clean'][1] == got['faulted'][1]})")
    counts = word_counts(got["clean"][0])
    return {"case": "ft-wordfreq-p4", "p": MESH_P, **runs,
            "nunique": len(counts), "nwords": sum(counts.values()),
            "rows_equal": True, "reloaded_equal": True}


def ft_quarantine(zpaths, oracle: dict, tmp: str) -> dict:
    """ft-quarantine: the wordfreq-p4 job under onfault=skip with the
    third file replaced by a link to nowhere: one quarantine record
    naming it, and the counts of a Counter over the other three (the
    generator's counts less the skipped file's)."""
    from collections import Counter
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    d = os.path.join(tmp, "ft-quarantine")
    os.makedirs(d)
    paths = []
    for i, p in enumerate(zpaths):
        q = os.path.join(d, os.path.basename(p))
        os.symlink(p if i != 2 else os.path.join(d, "gone"), q)
        paths.append(q)
    t0 = time.perf_counter()
    want = Counter()
    for line in oracle["out_lines"]:
        w, c = line.rsplit(" ", 1)
        want[w.encode()] = int(c)
    with open(zpaths[2], "rb") as f:
        want.subtract(Counter(f.read().split()))
    want = {w: c for w, c in want.items() if c}
    oracle_s = time.perf_counter() - t0
    with ft_armed(False) as ft:
        rows, _rows2, dt, _st = ft_wordfreq_job(
            paths, make_mesh(MESH_P, devices=ft_devices(MESH_P)),
            os.path.join(tmp, "ft-q-ckpt"), onfault="skip")
        rec = ft_counts()
        q = ft.quarantine_snapshot()
    got = word_counts(rows)
    shutil.rmtree(d)
    if got != want or q["count"] != 1 or \
            q["records"][0]["file"] != paths[2]:
        raise AssertionError(f"ft-quarantine: {len(got)} words against "
                             f"{len(want)}, quarantine {q}")
    return {"case": "ft-quarantine", "seconds": dt, **rec,
            "record": q["records"][0], "nunique": len(got),
            "oracle_s": oracle_s, "counts_equal_oracle": True}


def same_valid_frames(a, b) -> bool:
    """Two MRs' KVs equal frame by frame, shard by shard: caps, counts
    and the valid rows (compared on their devices)."""
    import torch
    fa, fb = list(a.kv.frames()), list(b.kv.frames())
    if len(fa) != len(fb):
        return False
    for x, y in zip(fa, fb):
        if getattr(x, "cap", None) != getattr(y, "cap", None):
            return False
        for s, t in zip(getattr(x, "shards", [x]), getattr(y, "shards",
                                                            [y])):
            n, m = int(s.counts[0]), int(t.counts[0])
            if n != m or not (torch.equal(s.key[:n], t.key[:m])
                              and torch.equal(s.value[:n], t.value[:m])):
                return False
    return True


def ft_fuse(keys_u32, tmp: str, kernels) -> dict:
    """ft-fuse-p4: the mesh-fuse-uniform chain (MRTPU_FUSE=1: map_files,
    aggregate, convert, reduce count as one exchange group) cold then
    warm, clean, then under the schedule, re-armed before the warm run
    so its first exchange attempt is the faulted one: equal to the clean
    run shard by shard; seg_table launches 0 in the faulted attempt (the
    fault comes before phase 1) and once a shard in the successful
    one."""
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.apps.intcount import _map_file
    from gpu_mapreduce_tpu_torch.ft import inject
    from gpu_mapreduce_tpu_torch.ops.cuda import group
    from gpu_mapreduce_tpu_torch.ops.reduces import count
    from gpu_mapreduce_tpu_torch.parallel import shuffle
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.plan import plan_cache, plan_history
    mesh = make_mesh(MESH_P, devices=ft_devices(MESH_P))
    paths = split_files(keys_u32, os.path.join(tmp, "ft-fuse"), MESH_P)
    out, runs = {}, {}
    at_fault = []
    real_fp = inject.fault_point

    def fault_point(site, **detail):
        # the table's launches in this run when an exchange attempt faults
        try:
            real_fp(site, **detail)
        except BaseException:
            if site == "shuffle.exchange":
                at_fault.append(group.segment_table.launches)
            raise
    inject.fault_point = fault_point
    try:
        for tag in ("clean", "faulted"):
            plan_cache().clear()
            shuffle._SPEC_CACHE.clear()
            for run in ("cold", "warm"):
                with ft_armed(tag == "faulted"):
                    for k in kernels:
                        k.launches = 0
                    del at_fault[:]
                    sync_all()
                    t0 = time.perf_counter()
                    mr = MapReduce(comm=mesh, fuse=1)
                    mr.map_files(paths, _map_file)
                    mr.aggregate()
                    mr.convert()
                    mr.reduce(count, batch=True)
                    _ = mr.kv
                    sync_all()
                    dt = time.perf_counter() - t0
                    group_rec = plan_history()[-1]["groups"][0]
                    runs[f"{tag}_{run}"] = {
                        "seconds": dt, "mode": group_rec["mode"],
                        "table": group_rec["table"], **ft_counts(),
                        "launches": {k.__name__: k.launches
                                     for k in kernels},
                        "seg_table_launches_at_fault": list(at_fault)}
                    out[f"{tag}_{run}"] = mr
    finally:
        inject.fault_point = real_fp
    shutil.rmtree(os.path.dirname(paths[0]))
    fw = runs["faulted_warm"]
    equal = same_valid_frames(out["clean_warm"], out["faulted_warm"]) and \
        same_valid_frames(out["clean_cold"], out["faulted_cold"])
    on_card = not FT_CPU
    if not equal or fw["mode"] != "exchange1" or \
            (on_card and not fw["table"]) or \
            (on_card and fw["launches"]["segment_table"] != MESH_P) or \
            fw["seg_table_launches_at_fault"] != [0] or \
            not ft_recovered(fw, "shuffle.exchange"):
        raise AssertionError(f"ft-fuse-p4: equal {equal}, {runs}")
    return {"case": "ft-fuse-p4", "p": MESH_P, **runs,
            "rows_equal": True}


def ft_ooc(keys_u32, tmp: str, device, kernels) -> dict:
    """ft-ooc: the ooc cell's descending external sort (the 2^25 keys,
    outofcore=1, memsize=64, maxpage=2; map_files then sort_keys(-1))
    clean, then with spill.write and spill.read armed: the rows equal."""
    import numpy as np
    from gpu_mapreduce_tpu_torch import MapReduce
    path = os.path.join(tmp, "ft-ooc-keys.bin")
    keys_u32.tofile(path)
    got, runs = {}, {}
    for run in ("clean", "faulted"):
        spill = os.path.join(tmp, f"ft-ooc-{run}")
        with ft_armed(run == "faulted", ("spill.write", "spill.read")):
            for k in kernels:
                k.launches = 0
            mr = MapReduce(device=device, outofcore=1, memsize=OOC_MEMSIZE,
                           maxpage=OOC_MAXPAGE, fpath=spill, fuse=0)
            t0 = time.perf_counter()
            mr.map_files([path], read_u32_keys)
            mr.sort_keys(-1)
            got[run] = kv_arrays(mr)
            dt = time.perf_counter() - t0
            mr.kv.free()
            runs[run] = {"seconds": dt, **ft_counts(),
                         "launches": {k.__name__: k.launches
                                      for k in kernels}}
        shutil.rmtree(spill, ignore_errors=True)
    os.remove(path)
    f = runs["faulted"]
    equal = all(np.array_equal(a, b) for a, b in zip(got["clean"],
                                                     got["faulted"]))
    if not equal or not ft_recovered(f, "spill.write") or \
            not ft_recovered(f, "spill.read"):
        raise AssertionError(f"ft-ooc: equal {equal}, {runs}")
    return {"case": "ft-ooc", "keys": len(keys_u32), **runs,
            "rows_equal": True}


def ft_graph_lines() -> list:
    """The graph phase's script as the journaled run takes it: its
    checkpoint lines left out (the journal's checkpoints stand in)."""
    skip = set(checkpoint_lines()) | {"mrb delete"}
    return [ln for ln in graph_script(GRAPH_SCALE, GRAPH_EDGEFACTOR)
            if ln not in skip]


def ft_graph_child(d: str, mode: str) -> int:
    """``chip_smoke.py --ft-graph-child DIR run|resume``: the journaled
    graph script (``run``, under MRTPU_JOURNAL=DIR/journal) or ``resume
    DIR/journal`` in a fresh process, on the card, from DIR.  Every
    command's seconds and screen lines, and every checkpoint set's
    seconds, go to DIR/times.<mode>.jsonl as they end; the resume then
    writes the cc and PageRank MRs to DIR/out.npz."""
    import io
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch import OinkScript
    from gpu_mapreduce_tpu_torch.ft import journal
    from gpu_mapreduce_tpu_torch.interop import mapreduce_to_numpy
    if os.environ.get("FT_REHEARSE"):
        ft_rehearse_sizes()
    os.chdir(d)
    log = open(os.path.join(d, f"times.{mode}.jsonl"), "w", buffering=1)
    real_exec = OinkScript._execute
    real_ckpt = journal.Journal.checkpoint
    in_ckpt = [0.0]

    def execute(self, command, args):
        skipped = self._ft_skip > 0 and command not in self._BUILTINS
        screen, self.screen = self.screen, io.StringIO()
        in_ckpt[0] = 0.0
        t0 = time.perf_counter()
        try:
            real_exec(self, command, args)
            sync_all()
        finally:
            text, self.screen = self.screen.getvalue(), screen
        # the command's own seconds: its journal records in, the
        # checkpoint set it triggered out (timed apart)
        log.write(json.dumps({"cmd": " ".join([command] + args),
                              "seconds": time.perf_counter() - t0
                              - in_ckpt[0],
                              "skipped": skipped,
                              "screen": text.splitlines()}) + "\n")

    def checkpoint(self, obj):
        sync_all()
        t0 = time.perf_counter()
        ok = real_ckpt(self, obj)
        in_ckpt[0] = time.perf_counter() - t0
        log.write(json.dumps({"ckpt": self.cmd_seq, "ok": ok,
                              "seconds": in_ckpt[0]}) + "\n")
        return ok
    OinkScript._execute = execute
    journal.Journal.checkpoint = checkpoint
    device = torch.device("cpu" if FT_CPU else "cuda")
    s = OinkScript(device=device, screen=False)
    t0 = time.perf_counter()
    if mode == "run":
        s.run_string("\n".join(ft_graph_lines()) + "\n")
    else:
        s.run_string(f"resume {os.path.join(d, 'journal')}\n")
    sync_all()
    log.write(json.dumps({"total_s": time.perf_counter() - t0}) + "\n")
    if mode == "resume":
        cc = mapreduce_to_numpy(s.obj.named["mrc"])
        pr = mapreduce_to_numpy(s.obj.named["mrpr"])
        np.savez(os.path.join(d, "out.npz"), cc_k=cc[0], cc_v=cc[1],
                 pr_k=pr[0], pr_v=pr[1])
    log.close()
    return 0


def _read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def ft_resume(tmp: str, graph: dict) -> dict:
    """ft-resume: the graph script journaled in a child process
    (MRTPU_JOURNAL, MRTPU_CKPT_EVERY=3), SIGKILLed once the journal holds
    the checkpoint taken after pagerank, then ``resume`` in a fresh
    child: cc labels, the degree_stats and cc_stats lines exactly the
    graph phase's, PageRank within rtol 1e-5 and ±1 step, and the journal
    showing the resume and only the tail re-run."""
    import numpy as np
    from gpu_mapreduce_tpu_torch.ft import journal
    keep = GRAPH_KEEP
    d = os.path.join(tmp, "ft-resume")
    os.makedirs(d)
    jdir = os.path.join(d, "journal")
    lines = ft_graph_lines()
    cmds = [ln for ln in lines if not ln.startswith("mr ")]
    pr_seq = 1 + next(i for i, ln in enumerate(cmds)
                      if ln.startswith("pagerank"))
    env = dict(os.environ, MRTPU_JOURNAL=jdir,
               MRTPU_CKPT_EVERY=str(FT_CKPT_EVERY))
    me = os.path.abspath(__file__)
    t0 = time.perf_counter()
    out = open(os.path.join(d, "run.out"), "wb")
    child = subprocess.Popen([sys.executable, me, "--ft-graph-child", d,
                              "run"], env=env, stdout=out,
                             stderr=subprocess.STDOUT)
    killed_at = None
    try:
        while child.poll() is None:
            time.sleep(0.05)
            try:
                recs = journal.read_journal(jdir)
            except Exception:
                continue
            if any(r.get("kind") == "ckpt" and r.get("seq", 0) >= pr_seq
                   for r in recs):
                child.kill()             # SIGKILL
                killed_at = time.perf_counter() - t0
                break
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    out.close()
    with open(os.path.join(d, "run.out"), "rb") as f:
        run_out = f.read().decode(errors="replace")
    if killed_at is None:
        raise AssertionError(f"ft-resume: the journaled run ended before "
                             f"its checkpoint after pagerank "
                             f"(rc {child.returncode}):\n{run_out[-3000:]}")
    env.pop("MRTPU_JOURNAL")
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, me, "--ft-graph-child", d,
                        "resume"], env=env, capture_output=True, text=True,
                       timeout=600)
    resume_wall = time.perf_counter() - t1
    if r.returncode != 0:
        raise AssertionError(f"ft-resume: the resume failed (rc "
                             f"{r.returncode}):\n{r.stdout[-3000:]}"
                             f"{r.stderr[-3000:]}")
    first = _read_jsonl(os.path.join(d, "times.run.jsonl"))
    second = _read_jsonl(os.path.join(d, "times.resume.jsonl"))
    recs = journal.read_journal(jdir)
    kinds = [rec["kind"] for rec in recs]
    res = recs[kinds.index("resume")]
    tail = [rec["seq"] for rec in recs[kinds.index("resume"):]
            if rec["kind"] == "cmd"]
    ran = [t for t in second if "cmd" in t and not t["skipped"]
           and not t["cmd"].startswith(("mr ", "resume"))]
    screens = {t["cmd"].split()[0]: t["screen"]
               for t in first + ran if "cmd" in t}
    z = np.load(os.path.join(d, "out.npz"))
    cc_ok = _same_sorted(z["cc_k"], z["cc_v"], *keep["cc"])
    pk, pv = z["pr_k"], z["pr_v"]
    gk, gv = keep["pagerank"][:2]
    pa, ga = np.argsort(pk, kind="stable"), np.argsort(gk, kind="stable")
    pr_ok = np.array_equal(pk[pa], gk[ga]) and np.allclose(
        pv[pa], gv[ga], rtol=1e-5, atol=GRAPH_TOL)
    steps = int(screens["pagerank"][0].split()[-2])
    checks = {
        "cc_labels_equal": cc_ok,
        "degree_stats_equal":
            screens["degree_stats"] == keep["screens"]["degree_stats"],
        "cc_stats_equal":
            screens["cc_stats"] == keep["screens"]["cc_stats"],
        "pagerank_close": pr_ok,
        "pagerank_steps": [steps, keep["pagerank"][2]],
        "resume_from_seq": res["from_seq"],
        "cmds_done_before_kill": res["cmds_done_before_crash"],
        "tail_seqs": tail}
    if not (cc_ok and pr_ok and checks["degree_stats_equal"]
            and checks["cc_stats_equal"]
            and abs(steps - keep["pagerank"][2]) <= 1
            and res["from_seq"] >= pr_seq
            and tail == list(range(res["from_seq"] + 1, len(cmds) + 1))):
        raise AssertionError(f"ft-resume: {checks}")
    shutil.rmtree(d)
    cmd_s = [{"cmd": t["cmd"], "seconds": t["seconds"]}
             for t in first + ran if "cmd" in t
             and not t["cmd"].startswith(("mr ", "resume"))]
    return {"case": "ft-resume", "ckpt_every": FT_CKPT_EVERY,
            "killed_after_s": killed_at, "resume_wall_s": resume_wall,
            "resume_s": next(t["total_s"] for t in second
                             if "total_s" in t),
            # the skipped commands' seconds: the checkpoint's restore
            "restore_s": sum(t["seconds"] for t in second
                             if t.get("skipped")),
            "command_s": cmd_s,
            "graph_command_s": graph["command_s"],
            "ckpt_s": [{"seq": t["ckpt"], "ok": t["ok"],
                        "seconds": t["seconds"]}
                       for t in first + second if "ckpt" in t],
            **checks}


def _cmd_label(line: str) -> str:
    """A script line's label in drive_script's records."""
    words = line.split()
    return " ".join(words[:2]) if len(words) > 1 and (
        words[1].startswith("map/")
        or words[1] in ("save", "load", "delete")) else words[0]


def _same_sorted(ka, va, kb, vb) -> bool:
    """Two (key, value) array pairs equal as rows sorted by key."""
    import numpy as np
    if len(ka) != len(kb):
        return False
    a, b = np.argsort(ka, kind="stable"), np.argsort(kb, kind="stable")
    return np.array_equal(ka[a], kb[b]) and np.array_equal(va[a], vb[b])


FT_PARTITION_SCRIPT = """\
variable w world 0 1
shell mkdir out$w
wordfreq 10 -i zw$w -o out$w/wf NULL
"""


def ft_partition(zpaths, oracle: dict, tmp: str) -> dict:
    """ft-partition: ``-partition 2x2`` over four shards through the OINK
    command line; world w runs the wordfreq command over two of the zipf
    files (a directory of links a world, picked by a world variable) and
    a ``shell mkdir``: the worlds' counts summed equal the generator's,
    and screen.0/1 and log.oink.0/1 are written."""
    import io
    from gpu_mapreduce_tpu_torch.oink.script import main as oink_main
    d = os.path.join(tmp, "ft-partition")
    os.makedirs(d)
    for w in (0, 1):
        os.makedirs(os.path.join(d, f"zw{w}"))
        for p in zpaths[2 * w:2 * w + 2]:
            os.symlink(p, os.path.join(d, f"zw{w}", os.path.basename(p)))
    with open(os.path.join(d, "in.partition"), "w") as f:
        f.write(FT_PARTITION_SCRIPT)
    cwd = os.getcwd()
    os.chdir(d)
    banner = io.StringIO()
    try:
        sync_all()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(banner):
            rc = oink_main(["-in", "in.partition", "-partition", "2x2"]
                           + (["-device", "cpu"] if FT_CPU else []))
        sync_all()
        dt = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    files = sorted(os.listdir(d))
    got: dict = {}
    for w in (0, 1):
        for name in sorted(os.listdir(os.path.join(d, f"out{w}"))):
            with open(os.path.join(d, f"out{w}", name)) as f:
                for line in f:
                    word, c = line.rsplit(" ", 1)
                    got[word] = got.get(word, 0) + int(c)
    want = {}
    for line in oracle["out_lines"]:
        word, c = line.rsplit(" ", 1)
        want[word] = int(c)
    outs = {w: sorted(os.listdir(os.path.join(d, f"out{w}")))
            for w in (0, 1)}
    shutil.rmtree(d)
    expect = {"screen.0", "screen.1", "log.oink.0", "log.oink.1"}
    if rc != 0 or got != want or not expect <= set(files):
        raise AssertionError(f"ft-partition: rc {rc}, {len(got)} words "
                             f"against {len(want)}, files {files}")
    return {"case": "ft-partition", "worlds": 2, "procs_per_world": 2,
            "seconds": dt, "files": sorted(expect), "out_files": outs,
            "universe": banner.getvalue().splitlines(),
            "counts_equal_oracle": True}


def run_ft(paths, nref: int, nuniq: int, zpaths, zoracle: dict, keys_u32,
           tmp: str, device, kernels, smi: str, graph: dict) -> dict:
    """The ft phase: every case fault-free and then under the JAX
    golden's schedule (ft_armed), each with its gate."""
    t0 = time.perf_counter()
    cases = {}
    for name, fn in (
            ("ft-main", lambda: ft_main(paths, nref, nuniq, tmp, kernels)),
            ("ft-wordfreq-p4", lambda: ft_wordfreq(zpaths, tmp, kernels)),
            ("ft-fuse-p4", lambda: ft_fuse(keys_u32, tmp, kernels)),
            ("ft-ooc", lambda: ft_ooc(keys_u32, tmp, device, kernels)),
            ("ft-quarantine", lambda: ft_quarantine(zpaths, zoracle, tmp)),
            ("ft-resume", lambda: ft_resume(tmp, graph)),
            ("ft-partition", lambda: ft_partition(zpaths, zoracle, tmp))):
        c0 = time.perf_counter()
        cases[name] = fn()
        cases[name]["case_s"] = time.perf_counter() - c0
        emit({"phase": "ft-case", "card": smi, **cases[name]})
    launches = {k.__name__: {
        "ft-main": cases["ft-main"]["faulted"]["launches"][k.__name__],
        "ft-wordfreq-p4":
            cases["ft-wordfreq-p4"]["faulted"]["launches"][k.__name__],
        "ft-fuse-p4-warm":
            cases["ft-fuse-p4"]["faulted_warm"]["launches"][k.__name__],
        "ft-ooc": cases["ft-ooc"]["faulted"]["launches"][k.__name__]}
        for k in kernels}
    summary = {}
    for name, c in cases.items():
        # a case's fault-free and faulted runs: the warm ones for the
        # fused chain; ft-resume's journaled run to its kill plus the
        # resume's wall time beside the graph phase's same commands;
        # ft-quarantine and ft-partition run once
        faulted = c.get("faulted") or c.get("faulted_warm") or c
        clean = c.get("clean") or c.get("clean_warm")
        if name == "ft-resume":
            clean_s = sum(c["graph_command_s"][_cmd_label(t["cmd"])]
                          for t in c["command_s"])
            faulted_s = c["killed_after_s"] + c["resume_wall_s"]
        else:
            clean_s = clean["seconds"] if clean else \
                (c["seconds"] if name == "ft-partition" else None)
            faulted_s = faulted["seconds"] if name != "ft-partition" \
                else None
        summary[name] = {
            "clean_s": clean_s, "faulted_s": faulted_s,
            "faults": faulted.get("faults", {}),
            "retries": faulted.get("retries", {}),
            "quarantined": faulted.get("quarantined", 0),
            "case_s": c["case_s"]}
    return {"phase": "ft", "card": smi, "backoff_s": float(FT_BACKOFF_S),
            "schedule": {"sites": "all", "rate": 1.0, "seed": FT_SEED,
                         "faults_a_site": 1, "budget": FT_BUDGET},
            "cases": summary, "launches": launches,
            "seconds": time.perf_counter() - t0}


def ft_rehearse_sizes() -> None:
    """The rehearsal's sizes: pages that spill at a few MB, a small
    graph."""
    global FT_CPU, OOC_MEMSIZE, OOC_MAXPAGE, GRAPH_SCALE
    FT_CPU = True
    OOC_MEMSIZE, OOC_MAXPAGE, GRAPH_SCALE = 1, 1, 10


def ft_alone(card: bool) -> int:
    """``chip_smoke.py --ft-rehearse``: the ft phase on four CPU shards at
    a small size (a 2 MB main corpus, 2 MB of zipf text, 2^18 IntCount
    keys, the graph script at scale 10), every gate but the kernels'
    launch counts (the plain versions launch nothing): a rehearsal of the
    phase's code without a card.  ``--ft-alone``: the phase alone on the
    card at its full size, its inputs made here (the graph script's run
    standing in for the graph phase's).  Prints the ft lines."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.interop import mapreduce_to_numpy
    from gpu_mapreduce_tpu_torch.ops import cuda as kcuda
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    if card:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 2
        kcuda.build_all()
        smi = nvidia_smi()
        device = torch.device("cuda", 0)
        main_mb, wf_mb, nkeys = MAIN_MB, WF_MB, INTCOUNT_KEYS
    else:
        ft_rehearse_sizes()
        os.environ["FT_REHEARSE"] = "1"
        smi = "cpu rehearsal"
        device = torch.device("cpu")
        main_mb, wf_mb, nkeys = 2, 2, 1 << 18
    kernels = [match.mark_words, group.segment_table, match.mark]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    cwd = os.getcwd()
    try:
        os.makedirs(os.path.join(tmp, "main"))
        paths, nref, nuniq = make_corpus(os.path.join(tmp, "main"),
                                         main_mb)
        zdir = os.path.join(tmp, "zipf")
        os.makedirs(zdir)
        zpaths, counts, vbuf, voffs = zipf_corpus(zdir, wf_mb)
        words = [vbuf[voffs[i]:voffs[i + 1]].tobytes()
                 for i in range(len(voffs) - 1)]
        zoracle = wordfreq_oracle(words, counts, len(zpaths))
        del vbuf, voffs, words
        keys = np.random.default_rng(7).integers(0, 1 << 32, nkeys,
                                                 dtype=np.uint32)
        gdir = os.path.join(tmp, "graph")
        os.makedirs(gdir)
        os.chdir(gdir)
        run = drive_script(device, ft_graph_lines(), ())
        os.chdir(cwd)
        named = run["interp"].obj.named
        run_s = run["seconds"]
        pr = mapreduce_to_numpy(named["mrpr"])
        GRAPH_KEEP.update(
            cc=mapreduce_to_numpy(named["mrc"]),
            pagerank=(pr[0], pr[1],
                      int(run["screens"]["pagerank"][0].split()[-2])),
            screens={k: run["screens"][k] for k in ("degree_stats",
                                                    "cc_stats")})
        del run, named
        rec = run_ft(paths, nref, nuniq, zpaths, zoracle, keys, tmp,
                     device, kernels, smi, {"command_s": run_s})
        emit(rec)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


# ---------------------------------------------------------------------------
# obs: the port's own spans, profiler ranges, metrics and dist files
# ---------------------------------------------------------------------------

# traced / untraced runs of each cell: 9, not 5, because the main run's
# read varies by about 10% on an H100's host, and at 5 one slow read moved
# the median ratio to 1.095x
OBS_REPEATS = 9
OBS_SPANS = 100_000            # empty spans timed for the cost of one
OBS_OVERHEAD_MAX = 1.10        # traced / untraced end-to-end gate
OBS_STAGE_TOL = (0.02, 1e-3)   # a stage span against StageTimer: 2% or 1 ms
OBS_SCRAPE_S = 0.05            # /metrics polled this often during a run
BYTE_ARGS = ("npairs", "shuffle_sent_bytes", "shuffle_pad_bytes",
             "spill_write_bytes", "spill_read_bytes")


@contextlib.contextmanager
def traced(jsonl=None):
    """The port's process tracer on for the block (its ring, and a JSONL
    file when given), then off with its sinks dropped."""
    from gpu_mapreduce_tpu_torch.obs import get_tracer
    tr = get_tracer()
    tr.reset()
    tr.enable(jsonl=jsonl)
    try:
        yield tr
    finally:
        tr.reset()


def span_tree(events) -> list:
    """Each span as (thread, name, cat, depth, parent name) and its byte
    attributes, in emission order: what must not depend on the device."""
    byid = {e["id"]: e for e in events}
    tids: dict = {}
    out = []
    for e in events:
        depth, p = 0, e["parent"]
        parent = byid[p]["name"] if p in byid else None
        while p in byid:
            depth += 1
            p = byid[p]["parent"]
        out.append((tids.setdefault(e["tid"], len(tids)), e["name"],
                    e["cat"], depth, parent)
                   + tuple(e["args"].get(k) for k in BYTE_ARGS))
    return out


def stage_spans_vs_timer(events, times: dict) -> dict:
    """Each ``stage.<name>`` span's summed seconds beside StageTimer's:
    within OBS_STAGE_TOL, or raise."""
    spans: dict = {}
    for e in events:
        if e["name"].startswith("stage."):
            name = e["name"][len("stage."):]
            spans[name] = spans.get(name, 0.0) + e["dur"] / 1e6
    if set(spans) != set(times):
        raise AssertionError(f"obs: stage spans {sorted(spans)} != timer "
                             f"stages {sorted(times)}")
    rel, floor = OBS_STAGE_TOL
    out = {}
    for name, secs in times.items():
        diff = abs(spans[name] - secs)
        if diff > max(rel * secs, floor):
            raise AssertionError(f"obs: stage.{name} span {spans[name]} s, "
                                 f"StageTimer {secs} s")
        out[name] = {"span_s": spans[name], "timer_s": secs,
                     "diff_s": diff}
    return out


def _union_ms(intervals) -> float:
    """Total length of a set of (start, end) µs intervals, in ms."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e3


def profile_main(paths, device) -> dict:
    """One traced main run under torch.profiler: the mark_words kernel
    must be launched inside the ``stage.map_device`` range (its wrapper's
    call marked by a ``launch.mark_words`` range for the run); each
    top-level span's device ms (the union of the device events inside its
    range) and the run's idle share (1 - busy / wall over the top-level
    spans)."""
    import torch
    from torch.autograd import DeviceType
    from gpu_mapreduce_tpu_torch import InvertedIndex
    from gpu_mapreduce_tpu_torch.apps import invertedindex as ii_mod
    acts = [torch.profiler.ProfilerActivity.CPU]
    card = device.type == "cuda"
    if card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    wrapper = ii_mod.mark_words

    @functools.wraps(wrapper)
    def marked(*args, **kw):
        with torch.profiler.record_function("launch.mark_words"):
            return wrapper(*args, **kw)
    ii_mod.mark_words = marked
    try:
        with traced() as tr, \
                torch.profiler.profile(activities=acts) as prof:
            InvertedIndex(device=device).run(paths)
            if card:
                torch.cuda.synchronize()
            top = [e["name"] for e in tr.events() if not e["parent"]]
            names = {e["name"] for e in tr.events()} | {"launch.mark_words"}
    finally:
        ii_mod.mark_words = wrapper
    evs = prof.events()
    # the device's kernels and copies (a span's own range on the device
    # timeline, its gpu_user_annotation, is not work)
    dev = [(e.time_range.start, e.time_range.end) for e in evs
           if e.device_type == DeviceType.CUDA and e.name not in names]
    ranges = {}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name in top:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    spans_ms = {}
    for name, rs in ranges.items():
        spans_ms[name] = {
            "wall_ms": sum(b - a for a, b in rs) / 1e3,
            "device_ms": _union_ms([(max(a, s), min(b, t))
                                    for a, b in dev for s, t in rs
                                    if a < t and b > s])}
    lo = min(a for rs in ranges.values() for a, _ in rs)
    hi = max(b for rs in ranges.values() for _, b in rs)
    busy = _union_ms([(max(a, lo), min(b, hi)) for a, b in dev
                      if a < hi and b > lo])
    # the word mark's launches (its wrapper's calls) inside the
    # stage.map_device range; its kernel records where CUPTI delivers
    # them (each inside the range: the stage starts after the h2d
    # stage's synchronise and ends with its own)
    stage = [(e.time_range.start, e.time_range.end) for e in evs
             if e.device_type == DeviceType.CPU
             and e.name == "stage.map_device"]
    launches = [(e.time_range.start, e.time_range.end) for e in evs
                if e.device_type == DeviceType.CPU
                and e.name == "launch.mark_words"]
    kernels = [(e.time_range.start, e.time_range.end) for e in evs
               if e.device_type == DeviceType.CUDA
               and "mark_words" in e.name
               and e.name != "launch.mark_words"]

    def inside(iv):
        return [k for k in iv if any(s <= k[0] and k[1] <= t
                                     for s, t in stage)]
    if not launches or len(inside(launches)) != len(launches):
        raise AssertionError(f"obs: mark_words launches {launches}, "
                             f"stage.map_device ranges {stage}")
    if len(inside(kernels)) != len(kernels):
        raise AssertionError(f"obs: mark_words kernel records {kernels} "
                             f"outside stage.map_device {stage}")
    return {"top_spans": spans_ms, "wall_ms": (hi - lo) / 1e3,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy * 1e3 / (hi - lo) if hi > lo else None,
            "mark_words_launches_inside_map_device": len(launches),
            "mark_words_kernel_records": len(kernels),
            "device_events": len(dev)}


def span_cost_us(nspans: int = OBS_SPANS) -> dict:
    """µs a span for ``nspans`` empty spans on a private tracer: with the
    profiler and NVTX ranges (NVTX where CUDA is available), with the
    profiler range only, and with neither."""
    from gpu_mapreduce_tpu_torch.obs.tracer import Tracer
    out = {}
    for label, nvtx, annot in (("nvtx", True, True),
                               ("profiler_range", False, True),
                               ("plain", False, False)):
        tr = Tracer().enable(ring=1024)
        tr.annotations = annot
        tr.nvtx = nvtx and tr.nvtx
        if label == "nvtx" and not tr.nvtx:
            out[label] = None          # no card: no NVTX
            continue
        t0 = time.perf_counter()
        for _ in range(nspans):
            with tr.span("x"):
                pass
        out[label] = (time.perf_counter() - t0) / nspans * 1e6
    return out


def _scraper(port: int, stop, got: list) -> None:
    import urllib.request
    while not stop.is_set():
        try:
            got.append(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5).read()
                .decode())
        except OSError:
            pass
        stop.wait(OBS_SCRAPE_S)


def catalog_names() -> set:
    """The metric names of doc/observability.md's catalog table."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "doc", "observability.md")) as f:
        rows = [ln for ln in f if ln.startswith("| `mrtpu_")]
    return {m for ln in rows
            for m in re.findall(r"`(mrtpu_[a-z0-9_]*[a-z0-9])", ln)}


def exchange_bytes(snap) -> dict:
    fam = snap.get("mrtpu_exchange_bytes_total", {"samples": []})
    return {s["labels"]["kind"]: s["value"] for s in fam["samples"]}


def obs_metrics(int_path, keys_u32, tmp: str, kernels, device,
                devices) -> dict:
    """The warm fused IntCount (uniform) with the metrics endpoint up
    (``ensure_server(0)``): seg_table once, /metrics scraped during the
    run and after it; then the P = 4 mesh-fuse warm run, whose exchange
    byte counters must equal the cumulative counters' deltas
    (``mr.stats()``), and every metric name must be in the catalog."""
    import threading
    from gpu_mapreduce_tpu_torch import intcount
    from gpu_mapreduce_tpu_torch.core.runtime import global_counters
    from gpu_mapreduce_tpu_torch.obs import httpd, metrics
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.plan import plan_cache
    card = device.type == "cuda"
    want = intcount_oracle(keys_u32, 10)
    port = httpd.ensure_server(0)
    os.environ["MRTPU_FUSE"] = "1"
    plan_cache().clear()
    if intcount([int_path], ntop=10, device=device) != want:
        raise AssertionError("obs: the cold fused IntCount differs")
    for k in kernels:
        k.launches = 0
    stop, scrapes = threading.Event(), []
    th = threading.Thread(target=_scraper, args=(port, stop, scrapes),
                          daemon=True)
    th.start()
    t0 = time.perf_counter()
    got = intcount([int_path], ntop=10, device=device)
    if card:
        sync_all()
    warm_s = time.perf_counter() - t0
    stop.set()
    th.join()
    launches = {k.__name__: k.launches for k in kernels}
    if got != want:
        raise AssertionError("obs: the warm fused IntCount differs")
    if card and launches["segment_table"] != 1:
        raise AssertionError(f"obs: seg_table launched "
                             f"{launches['segment_table']} times warm")
    import urllib.request
    after = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                   timeout=10).read().decode()
    for name in ("mrtpu_op_latency_seconds", "mrtpu_plan_cache_hit_ratio",
                 "mrtpu_hbm_hiwater_bytes"):
        if f"# TYPE {name} " not in after:
            raise AssertionError(f"obs: {name} missing from /metrics")
    mesh = make_mesh(len(devices), devices=devices)
    mpaths = split_files(keys_u32, os.path.join(tmp, "obs-fuse"), mesh.size)
    mwant = intcount_oracle_mesh(keys_u32, 10, mesh.size)
    if intcount(mpaths, ntop=10, comm=mesh) != mwant:     # cold
        raise AssertionError("obs: the P = 4 cold fused IntCount differs")
    c0, m0 = global_counters().snapshot(), exchange_bytes(metrics.snapshot())
    if intcount(mpaths, ntop=10, comm=mesh) != mwant:     # warm
        raise AssertionError("obs: the P = 4 warm fused IntCount differs")
    c1, m1 = global_counters().snapshot(), exchange_bytes(metrics.snapshot())
    os.environ.pop("MRTPU_FUSE", None)
    shutil.rmtree(os.path.dirname(mpaths[0]))
    deltas = {"metrics_sent": m1.get("sent", 0) - m0.get("sent", 0),
              "metrics_pad": m1.get("pad", 0) - m0.get("pad", 0),
              "metrics_wire": m1.get("wire", 0) - m0.get("wire", 0),
              "stats_cssize": c1["cssize"] - c0["cssize"],
              "stats_cspad": c1["cspad"] - c0["cspad"]}
    if (deltas["metrics_sent"], deltas["metrics_pad"]) != \
            (deltas["stats_cssize"], deltas["stats_cspad"]) \
            or deltas["metrics_sent"] <= 0:
        raise AssertionError(f"obs: exchange counters {deltas}")
    names = set(metrics.snapshot())
    stray = names - catalog_names()
    if stray:
        raise AssertionError(f"obs: metrics outside the catalog: {stray}")
    return {"port": port, "warm_s": warm_s, "launches": launches,
            "scrapes_during_run": len(scrapes),
            "scrape_bytes_after": len(after), "p4_exchange": deltas,
            "metric_names": sorted(names)}


def obs_overhead(paths, int_path, device, kernels) -> dict:
    """Traced against untraced end to end, interleaved (the order flips
    every repeat), OBS_REPEATS each: the main run and the warm fused
    IntCount (uniform).  Traced: the process tracer's ring, the profiler
    ranges and NVTX."""
    from gpu_mapreduce_tpu_torch import InvertedIndex, intcount
    from gpu_mapreduce_tpu_torch.obs import get_tracer
    from gpu_mapreduce_tpu_torch.plan import plan_cache
    card = device.type == "cuda"
    tr = get_tracer()
    tr.reset()

    def main_run():
        InvertedIndex(device=device).run(paths)
        if card:
            sync_all()

    def int_run():
        intcount([int_path], ntop=10, device=device)
        if card:
            sync_all()
    os.environ["MRTPU_FUSE"] = "1"
    plan_cache().clear()
    int_run()                                  # the warm plan
    times = {c: {"traced": [], "untraced": []} for c in ("main", "intcount")}
    spans = {}
    for i in range(OBS_REPEATS):
        for cell, fn in (("main", main_run), ("intcount", int_run)):
            order = ("untraced", "traced") if i % 2 == 0 \
                else ("traced", "untraced")
            for mode in order:
                if mode == "traced":
                    tr.enable()
                    tr.clear()
                t0 = time.perf_counter()
                fn()
                times[cell][mode].append(time.perf_counter() - t0)
                if mode == "traced":
                    spans[cell] = len(tr.events())
                    tr.disable()
    os.environ.pop("MRTPU_FUSE", None)
    tr.reset()
    out = {}
    for cell, t in times.items():
        med = {m: statistics.median(v) for m, v in t.items()}
        ratio = med["traced"] / med["untraced"]
        out[cell] = {"traced_s": t["traced"], "untraced_s": t["untraced"],
                     "median_traced_s": med["traced"],
                     "median_untraced_s": med["untraced"],
                     "ratio": ratio, "spans": spans[cell]}
        if card and ratio > OBS_OVERHEAD_MAX:
            raise AssertionError(f"obs: traced {cell} {ratio:.3f}x the "
                                 f"untraced run")
    return out


def run_obs(paths, nref: int, nuniq: int, main_launches: dict, int_path,
            keys_u32, tmp: str, kernels, smi: str, device) -> dict:
    """The obs phase (the port's own spans, profiler ranges and metrics;
    the dist files are checked in the dist phase's launcher runs): the
    traced main run, its stage spans against StageTimer, the span tree
    on the card against the CPU's, the profiled main run, the metrics
    endpoint over the warm fused IntCount, traced against untraced, and
    the cost of one span."""
    import torch
    from gpu_mapreduce_tpu_torch import InvertedIndex
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.obs import (chrome_trace, flight, httpd,
                                             metrics, read_jsonl)
    card = device.type == "cuda"
    t_phase = time.perf_counter()
    d = os.path.join(tmp, "obs")
    os.makedirs(d)
    saved_flight = os.environ.get("MRTPU_FLIGHT")
    os.environ["MRTPU_FLIGHT"] = os.path.join(d, "flight")
    rec = {"phase": "obs", "card": smi}
    try:
        # the traced main run
        jsonl = os.path.join(d, "main.jsonl")
        for k in kernels:
            k.launches = 0
        with traced(jsonl) as tr:
            if card:
                torch.cuda.synchronize()
            idx = InvertedIndex(device=device)
            t0 = time.perf_counter()
            got = idx.run(paths)
            if card:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            events = tr.events()
        launches = {k.__name__: k.launches for k in kernels}
        if got != (nref, nuniq):
            raise AssertionError(f"obs: traced main run {got}")
        if card and launches != main_launches:
            raise AssertionError(f"obs: traced main run launched "
                                 f"{launches}, untraced {main_launches}")
        if len(read_jsonl(jsonl)) != len(events) or \
                len(chrome_trace(events)["traceEvents"]) != len(events):
            raise AssertionError("obs: the JSONL trace differs from the ring")
        rec["main"] = {"end_to_end_s": dt, "spans": len(events),
                       "launches": launches,
                       "stages": stage_spans_vs_timer(events,
                                                      idx.timer.times),
                       "trace_id": events[0].get("trace")}
        # the span tree: card against CPU on the 2 MB skewed corpus
        sk = os.path.join(d, "skew")
        os.makedirs(sk)
        skew, _, _ = make_corpus(sk, 2, skew=True)
        trees = {}
        for dev in ((device, torch.device("cpu")) if card else (device,)):
            with traced() as tr:
                InvertedIndex(device=dev).run(skew)
                trees[dev.type] = span_tree(tr.events())
        if card and trees["cuda"] != trees["cpu"]:
            raise AssertionError(f"obs: the card's span tree differs from "
                                 f"the CPU's: {trees['cuda'][:8]} ... vs "
                                 f"{trees['cpu'][:8]} ...")
        rec["tree"] = {"spans": len(trees[device.type]),
                       "card_equals_cpu": card,
                       "names": sorted({t[1] for t in trees[device.type]})}
        shutil.rmtree(sk)
        rec["profile"] = profile_main(paths, device)
        rec["overhead"] = obs_overhead(paths, int_path, device, kernels)
        rec["span_cost_us"] = span_cost_us()
        rec["metrics"] = obs_metrics(
            int_path, keys_u32, d, kernels, device,
            mesh_devices() if card else [torch.device("cpu")] * MESH_P)
    finally:
        httpd.stop_server()
        metrics.reset()
        flight.reset()
        from gpu_mapreduce_tpu_torch.obs import get_tracer
        get_tracer().reset()
        if saved_flight is None:
            os.environ.pop("MRTPU_FLIGHT", None)
        else:
            os.environ["MRTPU_FLIGHT"] = saved_flight
        shutil.rmtree(d, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def dist_obs_files(rundir: str, width: int, chaos: bool) -> dict:
    """What a launcher run left for observability: one trace id across
    ``launch.json``, every trace shard, every rank's metrics dump and
    every flight dump; the sync records' spreads; in a chaos run the
    survivors' flight dumps with the lease table naming the dead rank."""
    import glob
    from gpu_mapreduce_tpu_torch.obs.fleetobs import (read_rank_dumps,
                                                      read_sync_records,
                                                      read_trace_dir)
    with open(os.path.join(rundir, "launch.json")) as f:
        tid = json.load(f)["trace_id"]
    events, nshards = read_trace_dir(rundir)
    dumps = read_rank_dumps(rundir)
    syncs = read_sync_records(rundir)
    flights = []
    for p in sorted(glob.glob(os.path.join(rundir, "mr_flight.*.json"))):
        with open(p) as f:
            flights.append(json.load(f))
    ids = ({e.get("trace") for e in events}
           | {doc.get("trace_id") for doc in dumps.values()}
           | {doc.get("trace_id") for doc in flights})
    spreads = [r["spread_s"] for r in syncs if r.get("kind") == "spread"]
    if ids != {tid} or nshards != width or sorted(dumps) != \
            list(range(width)) or not spreads:
        raise AssertionError(f"obs: {rundir}: trace ids {ids} (launch "
                             f"{tid}), {nshards} shards, dumps "
                             f"{sorted(dumps)}, {len(spreads)} spreads")
    lost = [doc for doc in flights
            if str(doc.get("reason", "")).startswith("peer_lost")]
    if chaos and not any("2" in (doc.get("dist") or {}).get("dead", ())
                         for doc in lost):
        raise AssertionError(f"obs: no survivor's flight dump names rank "
                             f"2 dead: {[d.get('reason') for d in flights]}")
    return {"trace_id": tid, "trace_shards": nshards, "spans": len(events),
            "rank_dumps": {r: doc["reason"] for r, doc in dumps.items()},
            "sync_records": len(syncs), "spreads": len(spreads),
            "max_spread_s": max(spreads),
            "flight_dumps": [doc.get("reason") for doc in flights],
            "lease_tables": sum(1 for doc in lost if doc.get("dist"))}


def obs_alone(card: bool) -> int:
    """``chip_smoke.py --obs-alone``: the obs phase alone on the card at
    its full size (the main corpus, the intcount-uniform file, the
    untraced main run's launches for the gate), then the dist phase's
    launcher runs for their files.  ``--obs-rehearse``: the same on the
    CPU at a small size (a 2 MB corpus, 2^18 keys, CPU ranks), every gate
    but the launch counts.  Prints the obs line."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch import InvertedIndex
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.ops import cuda as kcuda
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    global DIST_LAUNCH_MB
    if card:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 2
        kcuda.build_all()
        smi = nvidia_smi()
        device = torch.device("cuda", 0)
        main_mb, nkeys = MAIN_MB, INTCOUNT_KEYS
    else:
        smi = "cpu rehearsal"
        device = torch.device("cpu")
        main_mb, nkeys = 2, 1 << 18
        DIST_LAUNCH_MB = 2
        LAUNCH_ARGS[:] = ["--device", "cpu"]
    kernels = [match.mark_words, group.segment_table, match.mark]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(tmp, "main"))
        paths, nref, nuniq = make_corpus(os.path.join(tmp, "main"), main_mb)
        keys = np.random.default_rng(7).integers(0, 1 << 32, nkeys,
                                                 dtype=np.uint32)
        int_path = os.path.join(tmp, "uniform.bin")
        keys.tofile(int_path)
        InvertedIndex(device=device).run(paths)            # warm-up
        for k in kernels:
            k.launches = 0
        InvertedIndex(device=device).run(paths)
        launches = {k.__name__: k.launches for k in kernels}
        rec = run_obs(paths, nref, nuniq, launches, int_path, keys, tmp,
                      kernels, smi, device)
        rec["dist_files"] = run_dist_launch(tmp)["obs"]
        rec["alone_seconds"] = time.perf_counter() - t0
        emit(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


# ---------------------------------------------------------------------------
# 16. cache — the content store, the persistent plan tier, the native host
#     runtime and a standing query on the card
# ---------------------------------------------------------------------------

CACHE_CPU = False              # --cache-rehearse: CPU shards, small sizes
CACHE_STREAM_WRITES = 8        # the stream's appends, one batch each
# the stream's text: the first quarter of the first wordfreq-zipf file,
# cut from the whole file (the phase 100.9 s on one H100) and then from
# its half (the phase 90.7 s, the smoke 776.9 s), so one write a batch
# takes a 2 MB cut
CACHE_STREAM_SHARE = 4
CACHE_STREAM_BYTES = 2_000_000  # the cut's bytes trigger (2 MB)
CACHE_STREAM_ROWS = 1 << 30    # never the rows trigger
CACHE_WINDOW = 2
CACHE_KILL_AFTER = 4           # the child dies once batch 4 is committed


def cache_device():
    import torch
    return torch.device("cpu") if CACHE_CPU else torch.device("cuda", 0)


def cache_mesh_devices() -> list:
    return ["cpu"] * MESH_P if CACHE_CPU else mesh_devices()


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def cache_env(**env):
    """Set environment variables for the block's length."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cache_native(paths, nref: int, nuniq: int, tmp: str, kernels,
                 device) -> dict:
    """native-main: InvertedIndex(engine="native") on the main corpus
    against the default engine's run on the card (hits, unique URLs,
    part-00000 byte for byte), the library the port's own, no kernel
    launched by the native map; then ``_parse_cols``' native route on the
    composed-check graph written as an edge file, equal to its numpy
    route."""
    import filecmp
    import io
    import numpy as np
    from gpu_mapreduce_tpu_torch import InvertedIndex, OinkScript, native
    from gpu_mapreduce_tpu_torch.oink import kernels as okernels
    if not native.available():
        raise AssertionError(f"native-main: the native runtime did not "
                             f"build: {native.build_error()}")
    lib = native.library_path()
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(native.__file__))), "_build")
    if os.path.dirname(lib) != build or \
            os.sep + "gpu_mapreduce_tpu" + os.sep in lib:
        raise AssertionError(f"native-main: loaded {lib}, not the port's "
                             f"build")
    runs = {}
    for eng in ("cuda", "native"):
        out = os.path.join(tmp, f"native-{eng}")
        for k in kernels:
            k.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        idx = InvertedIndex(device=device, engine=eng)
        got = idx.run(paths, outdir=out)
        _sync(device)
        runs[eng] = {"npairs": got[0], "nunique": got[1],
                     "seconds": time.perf_counter() - t0,
                     "stages_s": dict(idx.timer.times),
                     "launches": {k.__name__: k.launches for k in kernels},
                     "part": os.path.join(out, "part-00000")}
    for eng, rec in runs.items():
        if (rec["npairs"], rec["nunique"]) != (nref, nuniq):
            raise AssertionError(f"native-main/{eng}: {rec['npairs']}, "
                                 f"{rec['nunique']} != {(nref, nuniq)}")
    if not filecmp.cmp(runs["cuda"]["part"], runs["native"]["part"],
                       shallow=False):
        raise AssertionError("native-main: part-00000 differs from the "
                             "card's default engine's")
    if any(runs["native"]["launches"].values()):
        raise AssertionError(f"native-main: the native map launched "
                             f"{runs['native']['launches']}")
    # the composed-check graph as an edge file
    gdir = os.path.join(tmp, "native-graph")
    os.makedirs(gdir)
    a, b, c, d = GRAPH_ABCD
    edge_file = os.path.join(gdir, "edges.txt")
    OinkScript(device=device, screen=io.StringIO()).one(
        f"rmat {COMPOSED_CHECK_SCALE} {GRAPH_EDGEFACTOR} {a} {b} {c} {d} "
        f"0.0 {GRAPH_SEED} -o {edge_file} NULL")
    t0 = time.perf_counter()
    nat = okernels._parse_cols(edge_file, (np.uint64, np.uint64))
    nat_s = time.perf_counter() - t0
    saved = native.available
    native.available = lambda: False
    try:
        t0 = time.perf_counter()
        ref = okernels._parse_cols(edge_file, (np.uint64, np.uint64))
        ref_s = time.perf_counter() - t0
    finally:
        native.available = saved
    if not (len(nat[0]) > 0 and all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(nat, ref))):
        raise AssertionError("native-main: parse_table's edges differ from "
                             "the numpy route's")
    lines = sum(1 for _ in open(runs["native"]["part"]))
    shutil.rmtree(gdir)
    for rec in runs.values():
        shutil.rmtree(os.path.dirname(rec.pop("part")))
    return {"library": os.path.relpath(lib, os.path.dirname(build)),
            "npairs": nref, "nunique": nuniq, "part_lines": lines,
            "part_equal": True, "native": runs["native"],
            "cuda": runs["cuda"],
            "parse_cols": {"edges": int(len(nat[0])), "native_s": nat_s,
                           "numpy_s": ref_s, "equal": True}}


def cache_persist_child(cas: str, dev: str, p1: str, p4s) -> int:
    """``chip_smoke.py --cache-persist-child``: a fresh process's first
    fused IntCount at P = 1, then its second, and the same at P = 4,
    under the store ``cas`` (the caller's ``MRTPU_PLAN_PERSIST`` arms the
    persistent tier or not): one JSON line with each run's result,
    seconds, fused-group mode, table flag, launches and the persistent
    tier's counts.  The process's first CUDA use (the context, a first
    allocation) comes before the runs and is timed apart
    (``cuda_init_s``); the second run, warm in memory, holds neither the
    plan tier's load nor the process's first use of each kernel."""
    import torch
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    os.environ.update(MRTPU_CAS_DIR=cas, MRTPU_FUSE="1")
    device = torch.device(dev)
    t0 = time.perf_counter()
    torch.ones(1, device=device).sum().item()
    out = {"cuda_init_s": time.perf_counter() - t0}
    kernels = [match.mark_words, group.segment_table, match.mark]
    for P, paths in ((1, [p1]), (MESH_P, p4s)):
        for run in ("", "_again"):
            out[f"p{P}{run}"] = cache_intcount(paths, P, device,
                                               [device] * MESH_P, kernels)
    print(json.dumps(out), flush=True)
    return 0


def cache_intcount(paths, P, device, devs, kernels) -> dict:
    """One fused IntCount run over ``devs[:P]`` (``device`` at P = 1),
    its launches counted from 0."""
    from gpu_mapreduce_tpu_torch import intcount
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.plan import plan_history
    from gpu_mapreduce_tpu_torch.plan.cache import cache_stats
    for k in kernels:
        k.launches = 0
    before = cache_stats()["persistent"]
    comm = make_mesh(P, devices=devs) if P > 1 else None
    _sync(device)
    t0 = time.perf_counter()
    res = intcount(paths, ntop=10, device=device if P == 1 else None,
                   comm=comm)
    _sync(device)
    dt = time.perf_counter() - t0
    group = next(g for e in reversed(plan_history()) for g in e["groups"]
                 if g["fused"])
    after = cache_stats()["persistent"]
    return {"result": res, "seconds": dt, "mode": group["mode"],
            "table": group["table"],
            "launches": {k.__name__: k.launches for k in kernels},
            "persistent_hits": after["hits"] - before["hits"],
            "persistent_entries": after["entries"]}


def cache_persist_fresh(store: str, device, p1: str, p4s,
                        persist: bool) -> tuple:
    """A fresh process's runs (``cache_persist_child``) under ``store``,
    the persistent tier armed or not: (its JSON line, its wall s)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--cache-persist-child", store, device.type, p1,
                        *p4s], capture_output=True, text=True,
                       timeout=DIST_TIMEOUT_S,
                       env={**os.environ,
                            "MRTPU_PLAN_PERSIST": "1" if persist else "0"})
    child_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"persist-intcount: a fresh process failed "
                             f"({r.returncode}): {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1]), child_s


def cache_persist(keys_u32, tmp: str, kernels, device) -> dict:
    """persist-intcount: intcount-uniform under MRTPU_FUSE=1 with a store
    in the phase's directory.  Process A (this one, its plan caches
    cleared) runs the P = 1 and the P = 4 (mesh-fuse-uniform) chains
    cold and stores each plan; a fresh process B's first run of each
    takes the persisted entry: warm, seg_table once at P = 1 and once a
    shard at P = 4, the results A's.  A fresh process C with the tier
    off (``MRTPU_PLAN_PERSIST=0``) runs each first cold: C's first run
    against B's is what the tier saves at a restart, and each fresh
    process's second run (warm in memory) against its first is what the
    process's first use of each kernel costs."""
    import numpy as np
    from gpu_mapreduce_tpu_torch.parallel import shuffle
    from gpu_mapreduce_tpu_torch.plan import plan_cache
    from gpu_mapreduce_tpu_torch.utils import cas
    d = os.path.join(tmp, "persist")
    os.makedirs(d)
    p1 = os.path.join(d, "uniform.bin")
    np.asarray(keys_u32, np.uint32).tofile(p1)
    p4s = split_files(keys_u32, os.path.join(d, "p4"), MESH_P)
    store = os.path.join(d, "cas")
    a = {}
    with cache_env(MRTPU_CAS_DIR=store, MRTPU_FUSE="1"):
        cas.reset_store()
        plan_cache().clear()
        shuffle._SPEC_CACHE.clear()
        for P, paths in ((1, [p1]), (MESH_P, p4s)):
            a[P] = cache_intcount(paths, P, device, cache_mesh_devices(),
                                  kernels)
    b, b_s = cache_persist_fresh(store, device, p1, p4s, True)
    c, c_s = cache_persist_fresh(store, device, p1, p4s, False)
    keys = ("seconds", "mode", "table", "launches", "persistent_hits",
            "persistent_entries")
    launch = "segment_table"
    out = {}
    for P in (1, MESH_P):
        fused = "local" if P == 1 else "exchange"
        # (the run, its fused group's mode, seg_table launches, whether
        # the persistent tier must have answered it)
        runs = {"a_cold": (a[P], fused, 0, False),
                "b_warm": (b[f"p{P}"], fused + "1", P, True),
                "b_again": (b[f"p{P}_again"], fused + "1", P, False),
                "c_cold": (c[f"p{P}"], fused, 0, False),
                "c_again": (c[f"p{P}_again"], fused + "1", P, False)}
        for run, (r, mode, n, hit) in runs.items():
            got = (r["result"][0], r["result"][1],
                   [tuple(t) for t in r["result"][2]])
            if got != a[P]["result"]:
                raise AssertionError(f"persist-intcount P = {P}: {run} "
                                     f"{got[:2]} != A {a[P]['result'][:2]}")
            if r["mode"] != mode or (hit and (r["persistent_hits"] < 1
                                              or not r["table"])):
                raise AssertionError(f"persist-intcount P = {P}: {run} "
                                     f"{r['mode']} (expected {mode}) with "
                                     f"{r['persistent_hits']} persistent "
                                     f"hits")
            if not CACHE_CPU and r["launches"][launch] != n:
                raise AssertionError(f"persist-intcount P = {P}: seg_table "
                                     f"{r['launches'][launch]} in {run}, "
                                     f"expected {n}")
        if c[f"p{P}"]["persistent_hits"] != 0:
            raise AssertionError(f"persist-intcount P = {P}: the tier "
                                 f"answered with MRTPU_PLAN_PERSIST=0")
        out[f"p{P}"] = {run: {k: r[k] for k in keys if k in r}
                        for run, (r, *_) in runs.items()}
    cas.reset_store()
    plan_cache().clear()
    shutil.rmtree(d)
    return {"nints": a[1]["result"][0], "nunique": a[1]["result"][1], **out,
            "process_b_s": b_s, "process_b_cuda_init_s": b["cuda_init_s"],
            "process_c_s": c_s, "process_c_cuda_init_s": c["cuda_init_s"]}


def cache_checkpoint(keys_u32, tmp: str, kernels) -> dict:
    """cas-checkpoint: the P = 4 IntCount KV right after the aggregate
    saved without a store, then into two directories under one store:
    both frame files hardlink one store object (one copy), both loads
    verify and equal the KV, and a byte flipped in the object is refused
    on load."""
    import numpy as np
    from gpu_mapreduce_tpu_torch import MapReduce
    from gpu_mapreduce_tpu_torch.apps.intcount import _map_file
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.utils import cas
    from gpu_mapreduce_tpu_torch.utils.integrity import IntegrityError
    d = os.path.join(tmp, "cas-ckpt")
    paths = split_files(keys_u32, os.path.join(d, "keys"), MESH_P)
    for k in kernels:
        k.launches = 0
    mr = MapReduce(comm=make_mesh(MESH_P, devices=cache_mesh_devices()),
                   fuse=0)
    mr.map_files(paths, _map_file)
    mr.aggregate()
    sync_all()
    want = kv_arrays(mr)
    save_s = {}
    t0 = time.perf_counter()
    mr.save(os.path.join(d, "plain"))
    save_s["plain"] = time.perf_counter() - t0
    store = os.path.join(d, "cas")
    with cache_env(MRTPU_CAS_DIR=store):
        cas.reset_store()
        st = cas.cas_store()
        for name in ("a", "b"):
            t0 = time.perf_counter()
            mr.save(os.path.join(d, name))
            save_s[name] = time.perf_counter() - t0
        stats = st.stats()
        frames = sorted(f for f in os.listdir(os.path.join(d, "a"))
                        if f.startswith("frame-"))
        nbytes = sum(os.path.getsize(os.path.join(d, "a", f))
                     for f in os.listdir(os.path.join(d, "a")))
        objects = {}
        for f in frames:
            ino = {os.stat(os.path.join(d, x, f)).st_ino for x in "ab"}
            digest = cas.sha256_file(os.path.join(d, "a", f))
            if len(ino) != 1 or os.stat(st._opath(digest)).st_ino \
                    not in ino or st.refcount(digest) != 2:
                raise AssertionError(f"cas-checkpoint: {f} was not "
                                     f"linked to one store object")
            objects[f] = digest
        if stats["chunks"] != len(frames):
            raise AssertionError(f"cas-checkpoint: the store holds "
                                 f"{stats['chunks']} objects for "
                                 f"{len(frames)} frames")
        loads = {}
        for name in ("a", "b"):
            other = MapReduce(comm=make_mesh(MESH_P,
                                             devices=cache_mesh_devices()),
                              fuse=0)
            t0 = time.perf_counter()
            n = other.load(os.path.join(d, name))
            loads[name] = time.perf_counter() - t0
            got = kv_arrays(other)
            if n != len(keys_u32) or not all(
                    np.array_equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"cas-checkpoint: load {name} differs "
                                     f"from the saved KV")
            del other, got
        opath = st._opath(objects[frames[0]])
        with open(opath, "r+b") as f:
            f.seek(os.path.getsize(opath) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x40]))
        try:
            MapReduce(comm=make_mesh(MESH_P, devices=cache_mesh_devices()),
                      fuse=0).load(os.path.join(d, "b"))
        except IntegrityError as e:
            refused = str(e)[:160]
        else:
            raise AssertionError("cas-checkpoint: a flipped byte in the "
                                 "store object loaded")
        cas.reset_store()
    launches = {k.__name__: k.launches for k in kernels}
    del mr, want
    shutil.rmtree(d)
    return {"pairs": len(keys_u32), "bytes": nbytes, "frames": len(frames),
            "store_objects": stats["chunks"], "store_bytes": stats["bytes"],
            "shared_inodes": True, "save_s": save_s, "load_s": loads,
            "dedup_extra_s": (save_s["a"] + save_s["b"]) / 2
            - save_s["plain"], "flipped_refused": refused,
            "launches": launches}


def stream_parts(path: str, n: int, share: int = 1) -> list:
    """The first 1/``share`` of a file's bytes (cut after a newline) as
    ``n`` pieces of about equal size, each ending at a newline (the last
    takes the rest)."""
    with open(path, "rb") as f:
        data = f.read()
    if share > 1:
        data = data[:data.find(b"\n", len(data) // share) + 1]
    cuts, start = [], 0
    for i in range(1, n):
        j = data.find(b"\n", max(start, len(data) * i // n)) + 1
        cuts.append(data[start:j])
        start = j
    cuts.append(data[start:])
    return cuts


def stream_snapshot_oracle(text: bytes) -> str:
    """A ``Stream.snapshot()`` from ``collections.Counter`` of the
    whitespace-split bytes."""
    from collections import Counter
    c = Counter(text.split())
    return "".join(f"{k.decode('utf-8', 'replace')} {c[k]}\n"
                   for k in sorted(c))


def stream_stages(events: list) -> dict:
    """Seconds of one stream batch's stages, read from the tracer's spans
    under its ``stream.batch`` span (the host's clock; nothing
    synchronises the card between stages, so its queued work lands in the
    stage that waits for it): ``parse`` (the delta's map: bytes.split and
    the column build), ``intern`` and ``delta_group`` (the delta's fused
    chain: its aggregate, which places the words on the card and interns
    them, and its group), ``merge_aggregate`` and ``merge_group`` (the
    merge into the resident, the batch's second plan), ``checkpoint``
    (the commit's saves, the merge they force aside) and ``other`` (the
    rest of the batch, the journal record among it)."""
    byid = {e["id"]: e for e in events}
    batch = next(e for e in events if e["name"] == "stream.batch")

    def within(e) -> bool:
        while e["parent"] in byid:
            e = byid[e["parent"]]
            if e is batch:
                return True
        return False

    def secs(es) -> float:
        return sum(e["dur"] for e in es) / 1e6

    mine = sorted((e for e in events if within(e)), key=lambda e: e["ts"])
    plans = [e for e in mine if e["name"] == "plan.execute"]
    if len(plans) != 2:
        raise AssertionError(f"stream-zipf: {len(plans)} plans in a batch, "
                             f"expected the delta's and the merge's")
    out = {"parse": secs(e for e in mine if e["name"] == "map"
                         and e["parent"] == batch["id"])}
    for plan, (agg, grp) in zip(plans, (("intern", "delta_group"),
                                        ("merge_aggregate", "merge_group"))):
        kids = [e for e in mine if e["parent"] == plan["id"]]
        out[agg] = secs(e for e in kids if e["name"] == "aggregate")
        out[grp] = secs(e for e in kids if e["name"] == "plan.group")
    ckpt = [e for e in mine if e["name"] == "stream.checkpoint"]
    out["checkpoint"] = secs(ckpt) - secs(
        e for e in plans if e["parent"] in {c["id"] for c in ckpt})
    out["other"] = batch["dur"] / 1e6 - sum(out.values())
    return out


def stream_settings(parts) -> dict:
    return {"settings": {"fuse": 1}, "rows": CACHE_STREAM_ROWS,
            "nbytes": min(CACHE_STREAM_BYTES, min(len(p) for p in parts)),
            "wait_s": 3600.0}


def cache_stream_child(sdir: str, src: str, parts_dir: str, mode: str,
                       dev: str) -> int:
    """``chip_smoke.py --cache-stream-child``: the stream-zipf stream in a
    fresh process, appending the parts from ``parts_dir`` one write a
    batch, SIGKILLed once batch CACHE_KILL_AFTER is committed
    (``after``) or, in batch CACHE_KILL_AFTER + 1, between the
    checkpoint's rename and the journal record (``between``)."""
    import signal
    import torch
    from gpu_mapreduce_tpu_torch.stream import Stream
    parts = [open(os.path.join(parts_dir, n), "rb").read()
             for n in sorted(os.listdir(parts_dir))]
    s = Stream(sdir, [src], device=torch.device(dev), **stream_settings(parts))
    for i, part in enumerate(parts):
        with open(src, "ab") as f:
            f.write(part)
        if mode == "between" and i == CACHE_KILL_AFTER:
            s._journal.append = \
                lambda rec: os.kill(os.getpid(), signal.SIGKILL)
        s.poll_once(final=i == len(parts) - 1)
        if mode == "after" and s.seq == CACHE_KILL_AFTER:
            os.kill(os.getpid(), signal.SIGKILL)
    return 3                          # unreachable: SIGKILL fired


def cache_stream_kill(parts, tmp: str, mode: str, device):
    """Start the stream in a child process that will be killed as
    ``mode`` says; returns (its directory, the Popen, its start time)."""
    d = os.path.join(tmp, f"kill-{mode}")
    pdir = os.path.join(d, "parts")
    os.makedirs(pdir)
    for i, p in enumerate(parts):
        with open(os.path.join(pdir, f"{i:02d}"), "wb") as f:
            f.write(p)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cache-stream-child",
         os.path.join(d, "st"), os.path.join(d, "log.txt"), pdir, mode,
         device.type], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return d, proc, time.perf_counter()


def cache_stream_resume(parts, started, mode: str, device, want: str,
                        rows_total: int) -> dict:
    """Wait for the killed child, resume its stream here and append the
    rest: the snapshot must be the uninterrupted run's, and no row
    counted twice."""
    from gpu_mapreduce_tpu_torch.stream import Stream
    d, proc, t0 = started
    _, err = proc.communicate(timeout=DIST_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    if proc.returncode != -9:
        raise AssertionError(f"stream kill-{mode}: the child exited "
                             f"{proc.returncode}: {err[-2000:]}")
    src, sdir = os.path.join(d, "log.txt"), os.path.join(d, "st")
    t0 = time.perf_counter()
    s = Stream(sdir, [src], device=device, **stream_settings(parts))
    seq0 = s.seq
    if seq0 != CACHE_KILL_AFTER or not s.status()["resumed"]:
        raise AssertionError(f"stream kill-{mode}: resumed at batch "
                             f"{seq0}, expected {CACHE_KILL_AFTER}")
    appended = os.path.getsize(src)
    done = next(i for i in range(len(parts) + 1)
                if sum(len(p) for p in parts[:i]) >= appended)
    s.poll_once(force=True)                  # the bytes already there
    for i in range(done, len(parts)):
        with open(src, "ab") as f:
            f.write(parts[i])
        s.poll_once(final=i == len(parts) - 1)
    s.drain(final=True)
    got = s.snapshot()
    st = s.status()
    s.close()
    if got != want or st["rows"] != rows_total:
        raise AssertionError(f"stream kill-{mode}: the resumed snapshot "
                             f"differs ({st['rows']} rows against "
                             f"{rows_total})")
    shutil.rmtree(d)
    return {"killed_at_batch": seq0, "writes_before_kill": done,
            "child_s": child_s, "resume_s": time.perf_counter() - t0,
            "batches_after_resume": st["batches"] - seq0,
            "byte_identical": True, "rows": st["rows"]}


def cache_stream(zpath: str, tmp: str, kernels, device) -> dict:
    """stream-zipf: the first quarter of the first wordfreq-zipf file
    appended to a tailed file in CACHE_STREAM_WRITES writes, one
    micro-batch each, through
    ``Stream(parser="words", reduce="count", fuse=1)`` on the card, a
    ``window=2`` stream beside it; the snapshot against a one-shot
    wordfreq on the card and a Counter, the window against the last two
    writes' Counter, the plan misses, two kill -9 resumes."""
    from gpu_mapreduce_tpu_torch.obs import get_tracer
    from gpu_mapreduce_tpu_torch.plan import (clear_history, plan_cache,
                                              plan_history)
    from gpu_mapreduce_tpu_torch.plan.cache import cache_stats
    from gpu_mapreduce_tpu_torch.stream import Stream
    plan_cache().clear()          # the streams start cold
    d = os.path.join(tmp, "stream")
    os.makedirs(d)
    parts = stream_parts(zpath, CACHE_STREAM_WRITES, CACHE_STREAM_SHARE)
    text = b"".join(parts)
    src = os.path.join(d, "log.txt")
    open(src, "wb").close()
    kw = stream_settings(parts)
    s = Stream(os.path.join(d, "st"), [src], device=device, **kw)
    win = Stream(os.path.join(d, "win"), [src], device=device,
                 window=CACHE_WINDOW, **kw)
    name = "segment_table"
    batches, keys_seen = [], set()
    tracer = get_tracer()
    traced = tracer.enabled
    tracer.enable()
    try:
        for i, part in enumerate(parts):
            with open(src, "ab") as f:
                f.write(part)
            lag_before = s.status()["lag_s"]
            for k in kernels:
                k.launches = 0
            tracer.clear()
            clear_history()           # it keeps the last 64 plans only
            m0 = cache_stats()["plan"]["misses"]
            t0 = time.perf_counter()
            rows = s.poll_once(final=i == len(parts) - 1)
            _sync(device)
            dt = time.perf_counter() - t0
            stages = stream_stages(tracer.events())
            launches = {k.__name__: k.launches for k in kernels}
            runs = plan_history()
            groups = [(g["mode"], g["table"], e["cache_key"] in keys_seen)
                      for e in runs for g in e["groups"] if g["fused"]]
            new_keys = {e["cache_key"] for e in runs} - keys_seen
            keys_seen |= new_keys
            if s.seq != i + 1 or rows <= 0:
                raise AssertionError(f"stream-zipf: write {i + 1} cut "
                                     f"{s.seq} batches")
            batches.append({
                "rows": rows, "bytes": len(part), "seconds": dt,
                "rows_per_s": rows / dt,
                "stages_s": stages,
                "groups": [g[:2] for g in groups],
                "speculation_misses": sum(1 for g in groups
                                          if g[2] and g[0] != "local1"),
                "plan_misses": cache_stats()["plan"]["misses"] - m0,
                "new_plan_keys": len(new_keys),
                "launches": launches, "lag_s_before": lag_before,
                "lag_s_after": s.status()["lag_s"]})
            # a plan key seen in an earlier batch never misses the plan
            # cache again; its group runs warm (on the card, on the group
            # table) unless the cached gcap no longer holds the groups
            # (the speculation check sends it back cold)
            if batches[-1]["plan_misses"] > len(new_keys) or any(
                    g[0] == "local1" and not (g[2] and g[1])
                    for g in groups):
                raise AssertionError(f"stream-zipf: batch {i + 1}: "
                                     f"{batches[-1]['plan_misses']} misses "
                                     f"for {len(new_keys)} new keys, "
                                     f"groups {groups}")
            # every group whose key ran before tries its cached gcap on
            # the table: one launch each, kept or thrown away
            if not CACHE_CPU and launches[name] != sum(
                    1 for g in groups if g[2]):
                raise AssertionError(f"stream-zipf: batch {i + 1}: "
                                     f"seg_table {launches[name]} for "
                                     f"groups {groups}")
            # the window stream's plans share the process's plan cache
            clear_history()
            win.poll_once(final=i == len(parts) - 1)
            keys_seen |= {e["cache_key"] for e in plan_history()}
    finally:
        if not traced:
            tracer.disable()
    t0 = time.perf_counter()
    got = s.snapshot()
    snapshot_s = time.perf_counter() - t0
    st = s.status()
    want = stream_snapshot_oracle(text)
    if got != want:
        raise AssertionError("stream-zipf: the snapshot differs from the "
                             "Counter oracle")
    # a one-shot wordfreq of the same bytes on the card
    full = os.path.join(d, "full.txt")
    with open(full, "wb") as f:
        f.write(text)
    t0 = time.perf_counter()
    _, wf_out = run_wordfreq_script(device, [full], os.path.join(d, "wf.out"),
                                    fuse=1)
    one_shot_s = time.perf_counter() - t0
    if sorted(wf_out.splitlines()) != sorted(got.splitlines()):
        raise AssertionError("stream-zipf: the snapshot differs from the "
                             "one-shot wordfreq on the card")
    wgot = win.snapshot()
    if wgot != stream_snapshot_oracle(b"".join(parts[-CACHE_WINDOW:])) \
            or win.status()["buckets"] != CACHE_WINDOW:
        raise AssertionError("stream-zipf: window=2 differs from the merge "
                             "of the last two deltas")
    s.close()
    win.close()
    # the two kill -9 children run side by side, then resume here
    started = {mode: cache_stream_kill(parts, tmp, mode, device)
               for mode in ("after", "between")}
    kills = {mode: cache_stream_resume(parts, started[mode], mode, device,
                                       got, st["rows"])
             for mode in started}
    shutil.rmtree(d)
    return {"bytes": len(text), "writes": len(parts),
            "nbytes_trigger": kw["nbytes"], "rows": st["rows"],
            "unique": got.count("\n"), "batches": batches,
            "plan_keys": len(keys_seen),
            "warm_groups": sum(1 for b in batches for g in b["groups"]
                               if g[0] == "local1"),
            "groups": sum(len(b["groups"]) for b in batches),
            "snapshot_s": snapshot_s, "one_shot_wordfreq_s": one_shot_s,
            "equals_counter_and_one_shot": True,
            "window": {"n": CACHE_WINDOW, "equals_last_two": True,
                       "unique": wgot.count("\n")},
            "kill9": kills,
            "launches": {k.__name__: [b["launches"][k.__name__]
                                      for b in batches] for k in kernels}}


def run_cache(paths, nref: int, nuniq: int, keys_u32, zpath: str, tmp: str,
              kernels, smi: str, device) -> dict:
    """The cache phase: native-main, persist-intcount, cas-checkpoint and
    stream-zipf, a line each, then the phase's line (seconds, launches
    and what each cell held)."""
    t_phase = time.perf_counter()
    cells, secs = {}, {}
    for cell, fn in (
            ("native_main", lambda: cache_native(paths, nref, nuniq, tmp,
                                                 kernels, device)),
            ("persist_intcount", lambda: cache_persist(keys_u32, tmp,
                                                       kernels, device)),
            ("cas_checkpoint", lambda: cache_checkpoint(keys_u32, tmp,
                                                        kernels)),
            ("stream_zipf", lambda: cache_stream(zpath, tmp, kernels,
                                                 device))):
        t0 = time.perf_counter()
        cells[cell] = fn()
        secs[cell] = time.perf_counter() - t0
        emit({"phase": "cache-" + cell.replace("_", "-"), "card": smi,
              **cells[cell], "seconds": secs[cell]})
    p, st = cells["persist_intcount"], cells["stream_zipf"]
    launches = {
        k.__name__: {
            "native_main": cells["native_main"]["native"]["launches"][
                k.__name__],
            **{f"persist_p{P}_{run}": p[f"p{P}"][run]["launches"][
                k.__name__] for P in (1, MESH_P)
               for run in ("a_cold", "b_warm", "c_cold")},
            "cas_checkpoint": cells["cas_checkpoint"]["launches"][
                k.__name__],
            "stream_batches": st["launches"][k.__name__]}
        for k in kernels}
    return {"phase": "cache", "card": smi, "cell_s": secs,
            "native_s": {e: cells["native_main"][e]["seconds"]
                         for e in ("native", "cuda")},
            "persist_first_run_s": {
                f"p{P}": {r: p[f"p{P}"][r]["seconds"]
                          for r in ("a_cold", "b_warm", "b_again",
                                    "c_cold", "c_again")}
                for P in (1, MESH_P)},
            "checkpoint_save_s": cells["cas_checkpoint"]["save_s"],
            "stream_batch_s": [b["seconds"] for b in st["batches"]],
            "stream_warm_groups": st["warm_groups"],
            "launches": launches,
            "seconds": time.perf_counter() - t_phase}


def cache_alone(card: bool) -> int:
    """``chip_smoke.py --cache-alone``: the cache phase alone on the card
    at its full size, its inputs made here (the main corpus, the
    intcount-uniform keys, the first wordfreq-zipf file: the zipf
    generator at a quarter of its size and one file writes the same
    bytes).  ``--cache-rehearse``: the same on the CPU at a small size
    (2 MB corpora, 2^18 keys), every gate but the launch counts.  Prints
    the cache line."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.ops import cuda as kcuda
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    global CACHE_CPU
    if card:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 2
        kcuda.build_all()
        smi = nvidia_smi()
        main_mb, zipf_mb, nkeys = MAIN_MB, WF_MB // 4, INTCOUNT_KEYS
    else:
        CACHE_CPU = True
        os.environ["MRTPU_PALLAS_GROUP"] = "1"   # the plain table on CPU
        smi = "cpu rehearsal"
        main_mb, zipf_mb, nkeys = 2, 2, 1 << 18
    device = cache_device()
    kernels = [match.mark_words, group.segment_table, match.mark]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(tmp, "main"))
        paths, nref, nuniq = make_corpus(os.path.join(tmp, "main"), main_mb)
        keys = np.random.default_rng(7).integers(0, 1 << 32, nkeys,
                                                 dtype=np.uint32)
        zdir = os.path.join(tmp, "zipf")
        os.makedirs(zdir)
        zpaths = zipf_corpus(zdir, zipf_mb, 1)[0]
        inputs_s = time.perf_counter() - t0
        rec = run_cache(paths, nref, nuniq, keys, zpaths[0], tmp, kernels,
                        smi, device)
        rec["inputs_s"] = inputs_s
        rec["alone_seconds"] = time.perf_counter() - t0
        emit(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


SERVE_CPU = False              # --serve-rehearse: the CPU, small sizes
SERVE_TOKENS = "ta=tok-a,tb=tok-b,*=tok-admin"
SERVE_GRAPH_SCALE = 20         # serve-recover's graph: 2^20 vertices
SERVE_GRAPH_EDGEFACTOR = 16
SERVE_SLO = "tenant=*;p99_ms=60000;err_pct=50;windows=60,600"
SERVE_WAIT_S = 600.0           # every poll's deadline
SERVE_DELETE_AFTER_S = 0.2     # the DELETE's delay after `running`


def serve_device():
    import torch
    return torch.device("cpu") if SERVE_CPU else torch.device("cuda", 0)


def serve_ii_script(paths, out: str = "ii", times: int = 1) -> str:
    """ta's job: the invertedindex command over the main corpus, its part
    file under the session's out/<out>/ (``out`` None: no file)."""
    o = f"-o {out} NULL" if out else "-o NULL NULL"
    return (f"variable files index {' '.join(paths)}\n" +
            f"invertedindex -i v_files {o}\n" * times)


def serve_wf_script(zpaths) -> str:
    """tb's job: the fused wordfreq over the wordfreq-zipf corpus."""
    return ("set fuse 1\n"
            f"variable files index {' '.join(zpaths)}\n"
            f"wordfreq {WF_NTOP} -i v_files -o wf.out NULL\n")


def serve_graph_script(scale: int) -> str:
    """serve-recover's session: exact commands only (no PageRank, whose
    float sums are not bit-reproducible), three of them writing files."""
    a, b, c, d = GRAPH_ABCD
    return "\n".join([
        f"rmat {scale} {SERVE_GRAPH_EDGEFACTOR} {a} {b} {c} {d} 0.0 "
        f"{GRAPH_SEED} -o NULL mre",
        "degree 0 -i mre -o deg.out mrd",
        "edge_upper -i mre -o NULL mru",
        "cc_find 0 -i mru -o cc.out mrc",
        "mr mrv",
        "mrv map/mr mre edge_to_vertices",
        "histo -i mrv -o histo.out NULL"]) + "\n"


def serve_batches(paths, scale: int) -> list:
    """serve-recover's two op batches, queued behind the graph session."""
    a, b, c, d = GRAPH_ABCD
    return [[f"variable files index {paths[0]}",
             f"wordfreq {WF_NTOP} -i v_files -o b1.out NULL"],
            [f"rmat {max(8, scale - 4)} 8 {a} {b} {c} {d} 0.0 {LUBY_SEED} "
             f"-o NULL e", "degree 0 -i e -o b2.out NULL"]]


def _part_urls(path: str) -> dict:
    """One file's distinct URLs with their u64 ids (a spawned worker of
    :func:`oracle_part_file_parallel`)."""
    from gpu_mapreduce_tpu_torch.ops.hash import hash_bytes64
    with open(path, "rb") as f:
        urls = set(re.findall(rb'<a href="([^"]{0,255})"', f.read()))
    return {u: hash_bytes64(u) for u in urls}


def oracle_part_file_parallel(paths):
    """:func:`oracle_part_file` with each file's URLs hashed in a spawned
    process (never forked: this process has touched CUDA).  Returns a
    future-like callable giving the text."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(4, len(paths)),
        mp_context=multiprocessing.get_context("spawn"))
    futs = [pool.submit(_part_urls, p) for p in paths]

    def result() -> str:
        try:
            refs, ids = {}, {}
            for p, fut in zip(paths, futs):
                for u, h in fut.result().items():
                    refs.setdefault(u, set()).add(p)
                    ids[u] = h
        finally:
            pool.shutdown(cancel_futures=True)
        lines = sorted((ids[u], u.decode(errors="replace"),
                        " ".join(sorted(fs))) for u, fs in refs.items())
        return "".join(f"{u}\t{fs}\n" for _, u, fs in lines)
    return result


def _wait_all(client, sids, t_ref: float) -> dict:
    """Poll the sessions at 10 ms until each is terminal: {sid: seconds
    from t_ref to the poll that first saw it finished}."""
    from gpu_mapreduce_tpu_torch.serve.session import TERMINAL
    done = {}
    deadline = time.perf_counter() + SERVE_WAIT_S
    while len(done) < len(sids):
        if time.perf_counter() > deadline:
            raise AssertionError(f"serve: sessions {sids} not finished "
                                 f"after {SERVE_WAIT_S} s: "
                                 f"{[client.status(s) for s in sids]}")
        for sid in sids:
            if sid not in done and client.status(sid)["state"] in TERMINAL:
                done[sid] = time.perf_counter() - t_ref
        time.sleep(0.01)
    return done


def _session_file(srv, sid: str, rel: str) -> str:
    return os.path.join(srv.session_dir(sid), "out", rel)


def _file_sha(res: dict) -> dict:
    return {k: v["sha256"] for k, v in res["files"].items()}


def _wf_lines(output: str) -> list:
    return [ln for ln in output.splitlines()
            if ln.startswith(("WordFreq:", "  "))]


def _launches(kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def _zero(kernels) -> None:
    for k in kernels:
        k.launches = 0


def serve_direct(text: str, device, d: str) -> dict:
    """The same job run directly (no daemon) under its own request
    account, its -o files under ``d``: (wall seconds, dispatches, the
    screen)."""
    import io
    from gpu_mapreduce_tpu_torch.obs import context as obs_context
    from gpu_mapreduce_tpu_torch.oink.script import OinkScript
    os.makedirs(d, exist_ok=True)
    screen = io.StringIO()
    s = OinkScript(device=device, screen=screen)
    s._path_prepend = d
    req = obs_context.RequestAccount(label="serve-direct")
    _sync(device)
    t0 = time.perf_counter()
    with obs_context.use(req):
        s.run_string(text)
        s.obj.cleanup()
        for name in list(s.obj.named):
            s.obj.delete_mr(name)
    _sync(device)
    return {"wall_s": time.perf_counter() - t0,
            "dispatches": req.profile()["dispatches"],
            "output": screen.getvalue()}


def _check_ii(srv, res: dict, nref: int, nuniq: int, oracle) -> None:
    if res["status"] != "done":
        raise AssertionError(f"serve: ta's session {res['status']}: "
                             f"{res['error']}")
    msg = f"InvertedIndex: 4 files, {nref} pairs, {nuniq} unique urls"
    if msg not in res["output"]:
        raise AssertionError(f"serve: ta's output {res['output'][:300]!r}"
                             f" lacks {msg!r}")
    with open(_session_file(srv, res["id"], "ii/part-00000")) as f:
        if f.read() != oracle:
            raise AssertionError("serve: ta's part-00000 differs from the "
                                 "regex oracle")


def _check_wf(srv, res: dict, zoracle: dict, who: str) -> None:
    if res["status"] != "done":
        raise AssertionError(f"serve: {who} {res['status']}: "
                             f"{res['error']}")
    if _wf_lines(res["output"]) != zoracle["message"]:
        raise AssertionError(f"serve: {who}'s message lines "
                             f"{_wf_lines(res['output'])[:3]} != oracle "
                             f"{zoracle['message'][:3]}")
    with open(_session_file(srv, res["id"], "wf.out")) as f:
        if sorted(f.read().splitlines()) != zoracle["out_lines"]:
            raise AssertionError(f"serve: {who}'s -o file differs from "
                                 f"the oracle")


def serve_main(paths, nref, nuniq, zpaths, zoracle, tmp, kernels,
               device, oracle_part) -> dict:
    """serve-main and serve-control on one in-process daemon with tenant
    tokens armed: ta's invertedindex and tb's fused wordfreq at once, tb
    again (warm), each beside the same job run directly; then the
    control plane's refusals, a deadline and a DELETE mid-run, the SLO
    surfaces; then a paused daemon's full queue."""
    import torch
    from gpu_mapreduce_tpu_torch.obs import slo as obs_slo
    from gpu_mapreduce_tpu_torch.plan import plan_cache
    from gpu_mapreduce_tpu_torch.serve import ServeClient, ServeError, Server
    rec = {}
    plan_cache().clear()                 # tb's first session is cold
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with cache_env(MRTPU_SERVE_TOKENS=SERVE_TOKENS, MRTPU_CAS_DIR=None,
                   MRTPU_SLO=None):
        t_start = time.perf_counter()
        srv = Server(port=0, workers=2, device=device,
                     state_dir=os.path.join(tmp, "serve-main"))
        srv.start()
        rec["serving_s"] = time.perf_counter() - t_start
        rec["warm_build_s"] = getattr(srv, "warm", {}).get("seconds")
        try:
            ta = ServeClient.local(srv.port, token="tok-a", timeout=120)
            tb = ServeClient.local(srv.port, token="tok-b", timeout=120)
            admin = ServeClient.local(srv.port, token="tok-admin",
                                      timeout=120)
            # (a) the pair, at once
            _zero(kernels)
            t0 = time.perf_counter()
            ra = ta.submit(script=serve_ii_script(paths))
            rb = tb.submit(script=serve_wf_script(zpaths))
            rt_submit = time.perf_counter() - t0
            fin = _wait_all(admin, [ra["id"], rb["id"]], t0)
            _sync(device)
            pair_launches = _launches(kernels)
            rec["first_result_s"] = rec["serving_s"] + min(fin.values())
            res_a, res_b = ta.result(ra["id"]), tb.result(rb["id"])
            _check_ii(srv, res_a, nref, nuniq, oracle_part())
            _check_wf(srv, res_b, zoracle, "tb")
            if not SERVE_CPU and (pair_launches["mark_words"] < 1 or
                                  pair_launches["segment_table"] != 0):
                raise AssertionError(f"serve: the pair launched "
                                     f"{pair_launches} (mark_words >= 1, "
                                     f"seg_table 0 expected)")
            # tb again: warm plans, the group table once
            _zero(kernels)
            t1 = time.perf_counter()
            rb2 = tb.submit(script=serve_wf_script(zpaths))
            fin2 = _wait_all(admin, [rb2["id"]], t1)
            _sync(device)
            warm_launches = _launches(kernels)
            res_b2 = tb.result(rb2["id"])
            _check_wf(srv, res_b2, zoracle, "tb (warm)")
            if res_b2["meta"]["plan_cache"]["plan"]["misses"] != 0:
                raise AssertionError(f"serve: tb's resubmit missed the "
                                     f"plan cache: "
                                     f"{res_b2['meta']['plan_cache']}")
            if _file_sha(res_b2) != _file_sha(res_b):
                raise AssertionError("serve: tb's resubmit wrote other "
                                     "files")
            if not SERVE_CPU and warm_launches["segment_table"] != 1:
                raise AssertionError(f"serve: tb's warm resubmit launched "
                                     f"{warm_launches}")
            peak = {"max_memory_allocated":
                    torch.cuda.max_memory_allocated()
                    if device.type == "cuda" else None,
                    "memory_reserved": torch.cuda.memory_reserved()
                    if device.type == "cuda" else None,
                    "tenants_hi_water": {t: s["hi_water"] for t, s in
                                         srv.budgets.snapshot().items()}}
            # the same jobs run directly (tb's cold, as its first session)
            d_a = serve_direct(serve_ii_script(paths), device,
                               os.path.join(tmp, "direct-a"))
            plan_cache().clear()
            d_b = serve_direct(serve_wf_script(zpaths), device,
                               os.path.join(tmp, "direct-b"))
            d_b2 = serve_direct(serve_wf_script(zpaths), device,
                                os.path.join(tmp, "direct-b2"))
            for who, res, d in (("ta", res_a, d_a), ("tb", res_b, d_b),
                                ("tb warm", res_b2, d_b2)):
                if res["meta"]["dispatches"] != d["dispatches"]:
                    raise AssertionError(
                        f"serve: {who}'s meta.dispatches "
                        f"{res['meta']['dispatches']} != the job alone's "
                        f"{d['dispatches']}")
                if _wf_lines(res["output"]) != _wf_lines(d["output"]):
                    raise AssertionError(f"serve: {who}'s screen differs "
                                         f"from the direct run's")
            sessions = {}
            for who, r, res, d, f in (
                    ("ta", ra, res_a, d_a, fin[ra["id"]]),
                    ("tb", rb, res_b, d_b, fin[rb["id"]]),
                    ("tb_warm", rb2, res_b2, d_b2, fin2[rb2["id"]])):
                sessions[who] = {
                    "wall_s": res["meta"]["wall_s"],
                    "queue_s": f - res["meta"]["wall_s"],
                    "round_trip_s": f,
                    "direct_s": d["wall_s"],
                    "overhead_s": f - d["wall_s"],
                    "dispatches": res["meta"]["dispatches"],
                    "plan": res["meta"]["plan_cache"]["plan"],
                    "pages": res["meta"]["pages"]}
            rec.update(sessions=sessions, submit_s=rt_submit,
                       launches_pair=pair_launches,
                       launches_warm=warm_launches, memory=peak,
                       tb_files=_file_sha(res_b))
            rec["control"] = serve_control(srv, ta, tb, admin, paths,
                                           zpaths, kernels, device)
            # the SLO surfaces
            os.environ["MRTPU_SLO"] = SERVE_SLO
            obs_slo.reset()
            slo = admin.slo()
            if not slo["objectives"]:
                raise AssertionError(f"serve: /v1/slo lists no objective: "
                                     f"{slo}")
            import urllib.request
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics", timeout=60) as r:
                text = r.read().decode()
            if "mrtpu_slo_burn_ratio" not in text:
                raise AssertionError("serve: /metrics lacks "
                                     "mrtpu_slo_burn_ratio")
            rec["control"]["slo_burn"] = slo["burn"]
        finally:
            srv.shutdown()
            obs_slo.reset()
        # the same pair on one worker, one session after the other
        rec["pair_one_worker"] = serve_pair_one_worker(paths, zpaths, tmp,
                                                       device)
        # a paused daemon with a full queue answers 429 + Retry-After
        p = Server(port=0, workers=0, paused=True, queue_cap=2,
                   device=device, state_dir=os.path.join(tmp, "serve-p"))
        p.start()
        try:
            c = ServeClient.local(p.port, token="tok-a")
            for _ in range(2):
                c.submit(ops=["mr x"])
            try:
                c.submit(ops=["mr x"])
                raise AssertionError("serve: a full queue admitted")
            except ServeError as e:
                if e.code != 429 or not e.retry_after:
                    raise AssertionError(f"serve: a full queue answered "
                                         f"{e.code}, Retry-After "
                                         f"{e.retry_after}")
                rec["control"]["full_queue"] = [e.code, e.retry_after]
        finally:
            p.shutdown()
    return rec


def serve_pair_one_worker(paths, zpaths, tmp, device) -> dict:
    """serve-main's pair (tb cold again) on a one-worker daemon: each
    session's round trip, beside the two-worker run's."""
    from gpu_mapreduce_tpu_torch.plan import plan_cache
    from gpu_mapreduce_tpu_torch.serve import ServeClient, Server
    plan_cache().clear()
    srv = Server(port=0, workers=1, device=device,
                 state_dir=os.path.join(tmp, "serve-one-worker"))
    srv.start()
    try:
        c = ServeClient.local(srv.port, token="tok-admin", timeout=120)
        t0 = time.perf_counter()
        ra = c.submit(script=serve_ii_script(paths), tenant="ta")
        rb = c.submit(script=serve_wf_script(zpaths), tenant="tb")
        fin = _wait_all(c, [ra["id"], rb["id"]], t0)
        res = {who: c.result(r["id"]) for who, r in (("ta", ra), ("tb", rb))}
    finally:
        srv.shutdown()
    if any(x["status"] != "done" for x in res.values()):
        raise AssertionError(f"serve: the one-worker pair "
                             f"{[(x['status'], x['error']) for x in res.values()]}")
    return {"ta": {"round_trip_s": fin[ra["id"]],
                   "wall_s": res["ta"]["meta"]["wall_s"]},
            "tb": {"round_trip_s": fin[rb["id"]],
                   "wall_s": res["tb"]["meta"]["wall_s"]},
            "both_s": max(fin.values())}


def serve_control(srv, ta, tb, admin, paths, zpaths, kernels,
                  device) -> dict:
    """serve-control: 401 with the journal unchanged, a tenant's drain
    403, a foreign id 404, a 1 ms deadline on wordfreq cancelled with
    the tenant's pages back at 0, a DELETE of a running invertedindex
    cancelled at a barrier (its latency)."""
    from gpu_mapreduce_tpu_torch.serve import ServeClient, ServeError
    out = {}
    jpath = os.path.join(srv.state_dir, "journal.jsonl")
    size = os.path.getsize(jpath)
    codes = {}
    for name, call in (
            ("no_token", lambda: ServeClient.local(srv.port).submit(
                ops=["mr x"])),
            ("bad_token", lambda: ServeClient.local(
                srv.port, token="nope").submit(ops=["mr x"])),
            ("tenant_drain", lambda: ta.drain()),
            ("foreign_id", lambda: tb.status("s000001")),
            ("foreign_cancel", lambda: tb.cancel("s000001"))):
        try:
            call()
            codes[name] = 200
        except ServeError as e:
            codes[name] = e.code
    if codes != {"no_token": 401, "bad_token": 401, "tenant_drain": 403,
                 "foreign_id": 404, "foreign_cancel": 404}:
        raise AssertionError(f"serve: control codes {codes}")
    if os.path.getsize(jpath) != size:
        raise AssertionError("serve: a refused request wrote the journal")
    out["codes"] = codes
    # a 1 ms deadline
    r = tb.submit(script=serve_wf_script(zpaths), deadline_ms=1)
    res = tb.wait(r["id"], timeout=SERVE_WAIT_S, poll_s=0.01)
    if res["status"] != "cancelled" or \
            res["meta"]["cancel_reason"] != "deadline":
        raise AssertionError(f"serve: the 1 ms deadline gave "
                             f"{res['status']} ({res.get('error')})")
    pages = srv.budgets.snapshot()["tb"]["bytes_in_use"]
    if pages != 0:
        raise AssertionError(f"serve: tb holds {pages} bytes after the "
                             f"deadline")
    out["deadline"] = {"status": res["status"],
                       "wall_s": res["meta"]["wall_s"], "tb_bytes": pages}
    # DELETE of a running invertedindex
    r = ta.submit(script=serve_ii_script(paths, out=None, times=4))
    deadline = time.perf_counter() + SERVE_WAIT_S
    while ta.status(r["id"])["state"] == "queued":
        if time.perf_counter() > deadline:
            raise AssertionError("serve: the DELETE's session never ran")
        time.sleep(0.005)
    # land the DELETE inside the first invertedindex command (≈ 0.4 s
    # on the card), so the latency is the wait for its next barrier
    time.sleep(SERVE_DELETE_AFTER_S)
    t0 = time.perf_counter()
    ack = ta.cancel(r["id"])
    fin = _wait_all(admin, [r["id"]], t0)
    res = ta.result(r["id"])
    if res["status"] != "cancelled" or \
            res["meta"]["cancel_reason"] != "client":
        raise AssertionError(f"serve: DELETE gave {res['status']} "
                             f"({res.get('error')})")
    out["cancel"] = {"ack": ack["state"], "latency_s": fin[r["id"]],
                     "wall_s": res["meta"]["wall_s"],
                     "ta_bytes": srv.budgets.snapshot()["ta"][
                         "bytes_in_use"]}
    return out


def serve_memo(zpaths, zoracle, tmp, kernels, device, want: dict) -> dict:
    """serve-memo: with a content store armed, one daemon computes tb's
    script and stores its record; a second daemon serves it as a hit: 0
    launches, 0 dispatches, a ``cache_hit`` journal record, the files
    serve-main wrote."""
    from gpu_mapreduce_tpu_torch.ft.journal import read_journal
    from gpu_mapreduce_tpu_torch.serve import ServeClient, Server
    from gpu_mapreduce_tpu_torch.utils.cas import reset_store
    out = {}
    with cache_env(MRTPU_CAS_DIR=os.path.join(tmp, "serve-cas"),
                   MRTPU_SERVE_TOKENS=None, MRTPU_MEMOIZE=None):
        reset_store()
        try:
            for name in ("compute", "hit"):
                state = os.path.join(tmp, f"serve-memo-{name}")
                srv = Server(port=0, workers=1, device=device,
                             state_dir=state)
                srv.start()
                try:
                    c = ServeClient.local(srv.port, timeout=120)
                    _zero(kernels)
                    t0 = time.perf_counter()
                    r = c.submit(script=serve_wf_script(zpaths),
                                 tenant="tb")
                    fin = _wait_all(c, [r["id"]], t0)
                    _sync(device)
                    res = c.result(r["id"])
                finally:
                    srv.shutdown()
                memo = res["meta"]["memo"]
                if res["status"] != "done" or \
                        memo["hit"] != (name == "hit"):
                    raise AssertionError(f"serve-memo {name}: "
                                         f"{res['status']}, memo {memo}")
                if _file_sha(res) != want:
                    raise AssertionError(f"serve-memo {name}: other files")
                if _wf_lines(res["output"]) != zoracle["message"]:
                    raise AssertionError(f"serve-memo {name}: the message "
                                         f"lines differ from the oracle")
                kinds = [x["kind"] for x in read_journal(state)]
                out[name] = {"round_trip_s": fin[r["id"]],
                             "wall_s": res["meta"]["wall_s"],
                             "dispatches": res["meta"]["dispatches"],
                             "launches": _launches(kernels),
                             "journal": kinds}
            hit = out["hit"]
            if hit["dispatches"] != 0 or any(hit["launches"].values()) or \
                    hit["journal"] != ["serve_submit", "cache_hit",
                                       "serve_done"]:
                raise AssertionError(f"serve-memo: the hit ran work: {hit}")
        finally:
            reset_store()
    return out


def _spawn_serve(state: str, workers: int, env: dict, log: str):
    """``python -m gpu_mapreduce_tpu_torch.serve`` in a fresh interpreter
    (never a fork of this process): (process, port, seconds to its
    ``serving`` line)."""
    import json as _json
    root = os.path.dirname(os.path.abspath(__file__))
    args = [sys.executable, "-m", "gpu_mapreduce_tpu_torch.serve", "--port",
            "0", "--state", state, "--workers", str(workers)]
    if SERVE_CPU:
        args += ["--device", "cpu"]
    t0 = time.perf_counter()
    p = subprocess.Popen(args, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=open(log, "ab"))
    line = p.stdout.readline()
    if not line:
        p.wait(timeout=60)
        with open(log, errors="replace") as f:
            raise AssertionError(f"serve-recover: the daemon exited "
                                 f"{p.returncode}:\n{f.read()[-3000:]}")
    return p, int(_json.loads(line)["serving"]), time.perf_counter() - t0


def serve_recover(paths, tmp, device, scale: int) -> dict:
    """serve-recover: the graph script and two op batches through an
    in-process daemon (the golden), then through ``python -m
    gpu_mapreduce_tpu_torch.serve`` on one worker, SIGKILLed once the
    graph session's journal holds a checkpointed command, and restarted
    on the same state directory: the session resumes, every file equals
    the golden's, the batches replay in admission order."""
    from gpu_mapreduce_tpu_torch.ft.journal import read_journal
    from gpu_mapreduce_tpu_torch.serve import ServeClient, Server
    script = serve_graph_script(scale)
    batches = serve_batches(paths, scale)
    out = {}
    with cache_env(MRTPU_SERVE_TOKENS=None, MRTPU_CAS_DIR=None):
        g = Server(port=0, workers=1, device=device,
                   state_dir=os.path.join(tmp, "serve-golden"))
        g.start()
        try:
            c = ServeClient.local(g.port, timeout=120)
            t0 = time.perf_counter()
            sids = [c.submit(script=script)["id"]] + \
                [c.submit(ops=b)["id"] for b in batches]
            _wait_all(c, sids, t0)
            golden = [c.result(s) for s in sids]
            out["golden_s"] = time.perf_counter() - t0
        finally:
            g.shutdown()
        if any(r["status"] != "done" for r in golden):
            raise AssertionError(f"serve-recover: the golden run "
                                 f"{[(r['status'], r['error']) for r in golden]}")
        state = os.path.join(tmp, "serve-recover")
        log = os.path.join(tmp, "serve-recover.log")
        env = dict(os.environ, MRTPU_CKPT_EVERY="1",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        p, port, first_s = _spawn_serve(state, 1, env, log)
        sjournal = os.path.join(state, "sessions", "s000001")
        try:
            c = ServeClient.local(port, timeout=120)
            sids = [c.submit(script=script)["id"]] + \
                [c.submit(ops=b)["id"] for b in batches]
            deadline = time.perf_counter() + SERVE_WAIT_S
            while True:
                try:
                    kinds = [x["kind"] for x in read_journal(sjournal)]
                except Exception:
                    kinds = []
                if "ckpt" in kinds:
                    break
                if p.poll() is not None or time.perf_counter() > deadline:
                    raise AssertionError("serve-recover: no checkpoint "
                                         "before the daemon ended")
                time.sleep(0.02)
            p.kill()                                # SIGKILL
            p.wait(timeout=60)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        done_before = [x.get("sid") for x in read_journal(state)
                       if x.get("kind") == "serve_done"]
        if done_before:
            raise AssertionError(f"serve-recover: {done_before} finished "
                                 f"before the kill")
        env.pop("MRTPU_CKPT_EVERY")
        t_restart = time.perf_counter()
        p, port, serving_s = _spawn_serve(state, 1, env, log)
        try:
            c = ServeClient.local(port, timeout=120)
            fin = _wait_all(c, sids, t_restart)
            got = [c.result(s) for s in sids]
            c.shutdown()
            p.wait(timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not got[0]["meta"]["resumed"]:
        raise AssertionError("serve-recover: the graph session was not "
                             "resumed")
    for g_res, res in zip(golden, got):
        if res["status"] != "done" or _file_sha(res) != _file_sha(g_res) \
                or res["files"].keys() != g_res["files"].keys():
            raise AssertionError(f"serve-recover: {res['id']} "
                                 f"{res['status']} ({res.get('error')}): "
                                 f"its files differ from the golden run")
    order = [x["sid"] for x in read_journal(state)
             if x.get("kind") == "serve_done"]
    if order != sids:
        raise AssertionError(f"serve-recover: replayed in order {order}")
    out.update(first_serving_s=first_s, restart_serving_s=serving_s,
               restart_first_result_s=min(fin.values()),
               restart_all_s=max(fin.values()),
               resumed_wall_s=got[0]["meta"]["wall_s"],
               golden_wall_s=golden[0]["meta"]["wall_s"],
               files={k: v["bytes"] for k, v in got[0]["files"].items()})
    return out


def run_serve(paths, nref: int, nuniq: int, zpaths, zoracle: dict,
              tmp: str, kernels, smi: str, device,
              scale: int = SERVE_GRAPH_SCALE) -> dict:
    """The serve phase: serve-main (with serve-control), serve-memo and
    serve-recover; the ``serve`` line."""
    t_phase = time.perf_counter()
    oracle_part = oracle_part_file_parallel(paths)
    secs = {}
    t0 = time.perf_counter()
    main = serve_main(paths, nref, nuniq, zpaths, zoracle, tmp, kernels,
                      device, oracle_part)
    secs["main"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    memo = serve_memo(zpaths, zoracle, tmp, kernels, device,
                      main.pop("tb_files"))
    secs["memo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recover = serve_recover(paths, tmp, device, scale)
    secs["recover"] = time.perf_counter() - t0
    launches = {k.__name__: {"pair": main["launches_pair"][k.__name__],
                             "warm_resubmit":
                                 main["launches_warm"][k.__name__],
                             "memo_hit": memo["hit"]["launches"][
                                 k.__name__]}
                for k in kernels}
    return {"phase": "serve", "card": smi, "device": str(device),
            "serving_s": main["serving_s"],
            "first_result_s": main["first_result_s"],
            "warm_build_s": main["warm_build_s"],
            "sessions": main["sessions"], "submit_s": main["submit_s"],
            "pair_one_worker": main["pair_one_worker"],
            "memory": main["memory"], "control": main["control"],
            "memo": memo, "recover": recover, "launches": launches,
            "part_seconds": secs,
            "seconds": time.perf_counter() - t_phase}


def serve_alone(card: bool) -> int:
    """``chip_smoke.py --serve-alone``: the serve phase alone on the card
    at its full size, its inputs made here (the 256 MB main corpus and
    the 256 MB wordfreq-zipf corpus with its oracle).
    ``--serve-rehearse``: the same on the CPU at 2 MB and a scale-10
    graph, every gate but the launch counts.  Prints the serve line."""
    import torch
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.ops import cuda as kcuda
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    global SERVE_CPU
    if card:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 2
        kcuda.build_all()
        smi = nvidia_smi()
        main_mb, zipf_mb, scale = MAIN_MB, WF_MB, SERVE_GRAPH_SCALE
    else:
        SERVE_CPU = True
        smi = "cpu rehearsal"
        main_mb, zipf_mb, scale = 2, 2, 10
    device = serve_device()
    kernels = [match.mark_words, group.segment_table, match.mark]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(tmp, "main"))
        paths, nref, nuniq = make_corpus(os.path.join(tmp, "main"), main_mb)
        zdir = os.path.join(tmp, "zipf")
        os.makedirs(zdir)
        zpaths, counts, vbuf, voffs = zipf_corpus(zdir, zipf_mb)
        words = [vbuf[voffs[i]:voffs[i + 1]].tobytes()
                 for i in range(len(voffs) - 1)]
        zoracle = wordfreq_oracle(words, counts, len(zpaths))
        del words, counts, vbuf, voffs
        inputs_s = time.perf_counter() - t0
        rec = run_serve(paths, nref, nuniq, zpaths, zoracle, tmp, kernels,
                        smi, device, scale=scale)
        rec["inputs_s"] = inputs_s
        rec["alone_seconds"] = time.perf_counter() - t0
        emit(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


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
    t_smoke = time.perf_counter()
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
        main_rec = {"phase": "main", "card": smi, "npairs": npairs,
              "nunique": nunique, "bytes": nbytes,
              "map_device_s": map_s,
              "map_device_pairs_per_s": npairs / map_s,
              "map_device_bytes_per_s": nbytes / map_s,
              "end_to_end_s": dt, "stages_s": idx.timer.times,
              "stats": idx.stats, "launches": launches,
              "max_memory_allocated": torch.cuda.max_memory_allocated()}
        emit(main_rec)
        t_mesh = time.perf_counter()
        mesh_main = run_mesh_main(paths, nref, nuniq, main_rec, kernels, smi)
        emit(mesh_main)
        mesh_s = time.perf_counter() - t_mesh


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
        ooc = run_ooc(int_paths["uniform"], int_keys["uniform"], tmp,
                      device, kernels)
        obs_rec = run_obs(paths, nref, nuniq, main_rec["launches"],
                          int_paths["uniform"], int_keys["uniform"], tmp,
                          kernels, smi, device)
        shutil.rmtree(int_dir)
        t_mesh = time.perf_counter()
        mesh_int = {}
        for cell, keys in int_keys.items():
            mesh_int[cell] = run_mesh_intcount(cell, keys, tmp, kernels,
                                               smi)
            emit(mesh_int[cell])
        if count >= 2:
            # one shard a card: the same cell across distinct cards
            cards = [torch.device("cuda", i) for i in range(min(4, count))]
            mesh_cards = run_mesh_intcount("uniform", int_keys["uniform"],
                                           tmp, kernels, smi, devices=cards)
            emit(mesh_cards)
        else:
            mesh_cards = {"cards": 1}
        mesh_fuse = {}
        for cell, keys in int_keys.items():
            mesh_fuse[cell] = run_mesh_fuse(cell, keys, tmp, kernels, smi,
                                            table_check=cell == "uniform")
            emit(mesh_fuse[cell])
        if count >= 2:
            # the warm fused group with one shard a card: each card
            # launches its own table
            mesh_cards_fuse = run_mesh_fuse("uniform", int_keys["uniform"],
                                            tmp, kernels, smi,
                                            devices=cards)
            emit(mesh_cards_fuse)
        else:
            mesh_cards_fuse = None
        mesh_ooc = run_mesh_ooc(int_keys["uniform"], tmp, kernels, smi)
        emit(mesh_ooc)
        mesh_ckpt = run_mesh_checkpoint(int_keys["uniform"], tmp, kernels,
                                        smi)
        emit(mesh_ckpt)
        mesh_s += time.perf_counter() - t_mesh

        wf, text_table, chunks, check, mesh_wf, zipf = run_text(
            paths, tmp, device, kernels, smi)
        mesh_s += mesh_wf["end_to_end_s"] + mesh_wf["p1_end_to_end_s"]
        mesh_check = run_mesh_check(tmp, smi)
        emit(mesh_check)
        mesh_s += mesh_check["seconds"]
        mesh_ops = run_mesh_ops_check(tmp, smi)
        emit(mesh_ops)
        mesh_s += mesh_ops["seconds"]

        graph = run_graph(device, smi, kernels, p4=True)
        graph_p4 = graph.pop("p4")
        emit(graph)
        tri = run_tri(device, smi, kernels, p4=True)
        tri_p4 = tri.pop("p4")
        emit(tri)
        emit(run_composed_check(device, smi))
        graph_check = run_graph_check(tmp, smi)
        p4_launches = {k: graph_p4["launches"][k] + tri_p4["launches"][k]
                       for k in graph_p4["launches"]}
        p4_s = graph_p4["seconds"] + tri_p4["seconds"] \
            + graph_check["total_s"]
        emit({"phase": "graph-p4", "card": smi, "p": MESH_P,
              "devices": [str(d) for d in mesh_devices()],
              "config": graph["config"],
              "reduced": [
                  "the graph script's checkpoint lines are left out at "
                  "P = 4 (mesh-checkpoint saves and loads at P = 4)",
                  f"fused tri_find at P = 4 runs at scale {TRI_SCALE} (the "
                  f"tri-rmat18 cell)",
                  f"composed tri_find at P = 4 runs only at scale "
                  f"{COMPOSED_CHECK_SCALE}",
                  f"card vs CPU at P = {GRAPH_CHECK_P}: neighbor and "
                  f"neigh_tri at scale {GRAPH_CHECK_SMALL_SCALE} (a file "
                  f"a vertex), the rest at {COMPOSED_CHECK_SCALE}"],
              **graph_p4, "launches": p4_launches, "tri": tri_p4,
              "check": graph_check, "seconds": p4_s})
        mesh_s += p4_s
        host = {"phase": "host", "card": smi, "ooc": ooc,
                "checkpoint": graph["checkpoint"],
                "text_check": {k: check[k] for k in (
                    "compared", "cross_loads", "host_s")},
                "wordfreq_chunks": chunks}
        host["seconds"] = (ooc["seconds"] + graph["checkpoint"]["save_s"]
                           + graph["checkpoint"]["load_s"]
                           + graph["checkpoint"]["flipped_refuse_s"]
                           + check["host_s"] + sum(chunks["op_s"].values()))
        emit(host)
        emit({"phase": "mesh", "card": smi, "p": MESH_P,
              "devices": mesh_main["devices"], "seconds": mesh_s,
              "main_p4": {k: mesh_main[k] for k in (
                  "npairs", "nunique", "rounds", "passes", "launches",
                  "seconds", "p1_seconds", "end_to_end_s",
                  "max_memory_allocated")},
              "intcount_p4": {cell: {k: rec[k] for k in (
                  "nints", "nunique", "end_to_end_s", "count_matrix",
                  "rows", "cssize", "cspad", "exchange_s",
                  "exchange_bound_ms", "max_memory_allocated",
                  "launches")} for cell, rec in mesh_int.items()},
              "intcount_p1_end_to_end_s": {
                  cell: int_runs[cell]["eager"]["end_to_end_s"]
                  for cell in mesh_int},
              "wordfreq_p4": {k: mesh_wf[k] for k in (
                  "nwords", "nunique", "end_to_end_s", "p1_end_to_end_s",
                  "tokens_per_s", "launches")},
              "check": {k: mesh_check[k] for k in (
                  "part_files", "card_equals_cpu", "union_equals_p1",
                  "intcount_ops")},
              "fuse_p4": {cell: {run: {k: rec[run][k] for k in (
                  "end_to_end_s", "group_s", "sent_bytes",
                  "exchange_bound_ms", "launches")}
                  for run in ("cold", "warm")}
                  for cell, rec in mesh_fuse.items()},
              "ops_check": {k: mesh_ops[k] for k in (
                  "ops", "card_equals_cpu", "seconds")},
              "graph_p4": {"seconds": p4_s, "launches": p4_launches,
                           "command_s": graph_p4["command_s"],
                           "p1_command_s": graph_p4["p1_command_s"],
                           "card_equals_cpu_p3": True},
              "ooc": {k: mesh_ooc[k] for k in (
                  "op_s", "incore_op_s", "spill_files_written", "runs",
                  "seconds")},
              "checkpoint": {k: mesh_ckpt[k] for k in (
                  "bytes", "save_s", "loads", "refused_writer_shard")},
              "several_cards": mesh_cards if "cards" in mesh_cards
              and len(mesh_cards) == 1 else {
                  **{k: mesh_cards[k] for k in ("devices", "cards",
                                                "end_to_end_s",
                                                "exchange_s", "launches")},
                  "fuse_warm": {k: mesh_cards_fuse["warm"][k] for k in (
                      "end_to_end_s", "group_s", "launches")}}})
        dist = run_dist(int_keys["uniform"], tmp, kernels, smi)
        emit(dist)
        # the obs phase's line, with the files the launcher runs left
        obs_rec["dist_files"] = dist["launch"]["obs"]
        emit(obs_rec)
        wire = run_wire(int_keys, tmp, kernels, smi, mesh_wf, mesh_fuse)
        emit({k: wire[k] for k in ("phase", "card", "p", "cards", "devices",
                                   "check", "launches", "seconds")})
        ft_rec = run_ft(paths, nref, nuniq, zipf[0], zipf[1],
                        int_keys["uniform"], tmp, device, kernels, smi,
                        graph)
        emit(ft_rec)
        cache_rec = run_cache(paths, nref, nuniq, int_keys["uniform"],
                              zipf[0][0], tmp, kernels, smi, device)
        emit(cache_rec)
        serve_rec = run_serve(paths, nref, nuniq, zipf[0], zipf[1], tmp,
                              kernels, smi, device)
        emit(serve_rec)
        shutil.rmtree(main_dir)
        shutil.rmtree(os.path.dirname(zipf[0][0]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    emit({"phase": "total", "seconds": time.perf_counter() - t_smoke})
    uni, zipf = table_timing["uniform"], table_timing["zipf"]
    # the graph and tri phases reach no hand-written kernel: their counts
    # (0 expected) ride beside each kernel's main-path count, the
    # composed engines' (graph and tri together) apart
    on_graph = {k: {"launches_graph": graph["launches"][k],
                    "launches_tri": tri["launches"][k],
                    "launches_composed": graph["launches_composed"][k]
                    + tri["launches_composed"][k],
                    # the host phase: the out-of-core chain and the
                    # chunk-map wordfreq
                    "launches_host": ooc["launches"][k]
                    + chunks["launches"][k],
                    # per wordfreq cell, per run (eager, cold, warm)
                    "launches_text": {
                        cell: {run: rec[run]["launches"][k]
                               for run in ("eager", "cold", "warm")}
                        for cell, rec in wf.items()},
                    # the mesh phase, per run
                    "launches_mesh": {
                        "main_p4": mesh_main["launches"][k],
                        **{f"intcount_p4_{cell}": rec["launches"][k]
                           for cell, rec in mesh_int.items()},
                        "wordfreq_p4": mesh_wf["launches"][k],
                        **{f"intcount_p4_fused_{cell}_{run}":
                           rec[run]["launches"][k]
                           for cell, rec in mesh_fuse.items()
                           for run in ("cold", "warm")},
                        "mesh_ooc": mesh_ooc["launches"][k],
                        "mesh_checkpoint": mesh_ckpt["launches"][k],
                        "graph_p4": p4_launches[k]},
                    # the dist phase: reshard, the exchange across ranks
                    "launches_dist": dist["launches"][k],
                    # the wire phase: mesh2's part files and the
                    # card-vs-CPU check's warm fused group
                    "launches_wire": wire["launches"][k],
                    # the ft phase's faulted runs, by case
                    "launches_ft": ft_rec["launches"][k],
                    # the obs phase: the traced main run and the warm
                    # fused IntCount with the metrics endpoint up
                    "launches_obs": {
                        "main_traced": obs_rec["main"]["launches"][k],
                        "intcount_warm_metrics":
                            obs_rec["metrics"]["launches"][k]},
                    # the cache phase: the native engine's map, the
                    # persisted plans' processes A (cold) and B (warm),
                    # the dedup'd checkpoint, each stream batch
                    "launches_stream": cache_rec["launches"][k],
                    # the serve phase: the pair at once (ta's
                    # invertedindex, tb's cold fused wordfreq), tb's warm
                    # resubmit, the memo hit
                    "launches_serve": serve_rec["launches"][k]}
                for k in ("mark_words", "segment_table", "mark")}
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
        "stack_frame_bytes": frames["mark_words"],
        **on_graph["mark_words"]}, {
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
                                      "epilogue_ms")},
        # at interned-id keys: the wordfreq-zipf ids, 0, 2^63, 2^64-1
        "text": {k: text_table[k] for k in ("n", "T", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms", "epilogue_ms")},
        # at shard 0's received rows of the warm fused IntCount at P = 4
        "mesh": {k: mesh_fuse["uniform"]["table"][k] for k in (
            "n", "T", "gcap", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "epilogue_ms", "max_abs_err")},
        **on_graph["segment_table"]}, {
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
        "ms_by_pattern_len": bytes_timing["ms_by_pattern_len"],
        **on_graph["mark"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dist-local-rank"]:
        sys.exit(dist_local_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ft-graph-child"]:
        sys.exit(ft_graph_child(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] in (["--ft-rehearse"], ["--ft-alone"]):
        sys.exit(ft_alone(sys.argv[1] == "--ft-alone"))
    if sys.argv[1:2] in (["--obs-rehearse"], ["--obs-alone"]):
        sys.exit(obs_alone(sys.argv[1] == "--obs-alone"))
    if sys.argv[1:2] == ["--cache-persist-child"]:
        sys.exit(cache_persist_child(sys.argv[2], sys.argv[3], sys.argv[4],
                                     sys.argv[5:]))
    if sys.argv[1:2] == ["--cache-stream-child"]:
        sys.exit(cache_stream_child(*sys.argv[2:7]))
    if sys.argv[1:2] in (["--cache-rehearse"], ["--cache-alone"]):
        sys.exit(cache_alone(sys.argv[1] == "--cache-alone"))
    if sys.argv[1:2] in (["--serve-rehearse"], ["--serve-alone"]):
        sys.exit(serve_alone(sys.argv[1] == "--serve-alone"))
    sys.exit(main())
