#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's map stage spends its time, on one GPU.

    python3 scripts/profile_torch_map.py [--mb 256]

Builds the benchmark corpus (``apps/corpus.make_corpus``, 4 files), warms
up with one ``InvertedIndex().run``, then on the corpus's device-resident
words:

* times each step of ``_extract_core`` on its own (host clock around
  work that ends in a device synchronise, median of 5): mark, compaction,
  64-byte windows + quote scan, the two seeded hash passes, doc ids +
  pack, collision count;
* profiles one whole ``_extract_core`` call with ``torch.profiler``: the
  wall time, the device-busy time (union of the kernels' intervals), the
  idle share, the number of kernel launches and the top kernels by
  device time.

Prints one JSON line per part, with the card's name and power limit.
Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def step_ms(fn, reps: int = 5) -> float:
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def busy_ms(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=256)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_map: no CUDA device", file=sys.stderr)
        return 2
    from gpu_mapreduce_tpu_torch import InvertedIndex
    from gpu_mapreduce_tpu_torch.apps import invertedindex as ii
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.ops.bits import to_torch
    from gpu_mapreduce_tpu_torch.ops.cuda import build_all
    from gpu_mapreduce_tpu_torch.ops.cuda.match import (
        bytes_view_u32, compact_word_matches, first_byte_pos, mark_words,
        mask_words_to_length, unaligned_words)
    from gpu_mapreduce_tpu_torch.ops.hash import hash_bytes64_masked

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    build_all()
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="profile_torch_map_")
    try:
        paths, nref, _ = make_corpus(tmp, args.mb)
        InvertedIndex().run(paths)                       # warm-up
        corpus, fstarts = ii._build_corpus(paths)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    w = bytes_view_u32(corpus)
    wp = np.zeros(ii._bucket_words(len(w)), np.uint32)
    wp[:len(w)] = w
    words, fst = to_torch(wp, dev), to_torch(fstarts, dev)
    m = words.shape[0]
    nbytes = 4 * m
    cap = max(8, 1 << (max(1, len(corpus) // 1024) - 1).bit_length())

    wmask = mark_words(words, ii.PATTERN)
    starts, nhits = compact_word_matches(wmask, nbytes, cap)
    ust = starts + len(ii.PATTERN)
    win = unaligned_words(words, ust, ii._W_SHORT)
    length = first_byte_pos(win, ii.QUOTE)
    l0 = length.clamp(min=0)
    wm = mask_words_to_length(win, l0)
    ids = hash_bytes64_masked(wm, l0)
    valid = (starts < nbytes) & (length >= 0)

    def pack():
        torch.searchsorted(fst, starts, right=True)
        order = torch.cat([torch.nonzero(valid, as_tuple=True)[0],
                           torch.nonzero(~valid, as_tuple=True)[0]])
        return ids[order]

    steps = {
        "mark": lambda: mark_words(words, ii.PATTERN),
        "compact": lambda: compact_word_matches(wmask, nbytes, cap),
        "windows_quote": lambda: first_byte_pos(
            unaligned_words(words, ust, ii._W_SHORT), ii.QUOTE),
        "hash_two_families": lambda: ii._hash2(win, length),
        "docs_pack": pack,
        "collisions": lambda: ii._count_collisions(
            ids, ids, torch.arange(cap, device=dev) < nhits),
        "extract_core": lambda: ii._extract_core(words, fst, cap=cap,
                                                 wide=False),
    }
    emit({"part": "steps_ms", "card": smi, "mb": args.mb, "m": m,
          "cap": cap, "nhits": nhits,
          "ms": {k: step_ms(f) for k, f in steps.items()}})

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ii._extract_core(words, fst, cap=cap, wide=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kern)
    rows = sorted(prof.key_averages(),
                  key=lambda r: -getattr(r, "device_time_total", 0))
    top = [{"name": r.key[:80], "count": r.count,
            "device_ms": getattr(r, "device_time_total", 0) / 1e3}
           for r in rows[:15] if getattr(r, "device_time_total", 0) > 0]
    emit({"part": "profile", "card": smi, "wall_ms": wall,
          "device_busy_ms": busy,
          "idle_share": (1 - busy / wall) if wall else None,
          "kernel_launches": len(kern), "top": top})
    return 0


if __name__ == "__main__":
    sys.exit(main())
