#!/usr/bin/env python3
"""Time the port's host tier on the card.

    python3 scripts/profile_torch_host.py [--mb 64] [--nmap 64]
    python3 scripts/profile_torch_host.py --around-ooc
    python3 scripts/profile_torch_host.py --wordfreq 3

The first form times the chunk map by mapstyle and callback work.

Generates ``--mb`` MB of chip_smoke's Zipf text, then runs
``map_file_char(nmap, files, 0, 0, "\\n", 80, cb)`` on the card under
mapstyle 0 and 2 with three callbacks — the split on the card
(``utils/io.split_words``), the split and lookup3 ids
(``ops/hash.hash_rows``), and the split and the intern
(``ops/hash.intern_packed``) — each at the interpreter's default GIL
switch interval and at 0.1 ms.  Prints one JSON line per run (seconds,
words, chunks) and last the card's name and power limit.

``--around-ooc`` runs chip_smoke's wordfreq-zipf cell (three runs: fuse
0, fused cold, fused warm; 256 MB) before and after chip_smoke's
out-of-core chain over the intcount-uniform keys, in one process, and
prints each run's end-to-end and stage seconds: whether the chain slows
what runs after it.  ``--wordfreq N`` runs only the wordfreq-zipf
cell: one warm-up, then N timed rounds (copy the script into another
checkout's ``scripts/`` to time that checkout's code the same way).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def callbacks():
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.ops.hash import hash_rows, intern_packed
    from gpu_mapreduce_tpu_torch.utils.io import split_words

    def add(kv, ids):
        kv.add_batch(ids, torch.ones_like(ids), key_dtype=np.uint64,
                     value_dtype=np.int64)

    def split(itask, chunk, kv, ptr):
        col = split_words(chunk, kv.device)
        add(kv, col.offsets[1:] - col.offsets[:-1])

    def split_hash(itask, chunk, kv, ptr):
        col = split_words(chunk, kv.device)
        st = col.offsets[:-1]
        add(kv, hash_rows(col.buf, st, col.offsets[1:] - st))

    def split_intern(itask, chunk, kv, ptr):
        col = split_words(chunk, kv.device)
        add(kv, intern_packed(col.buf, col.offsets)[0])

    return {"split": split, "split+hash": split_hash,
            "split+intern": split_intern}


def wordfreq_rounds(device, rounds: int) -> None:
    """The wordfreq-zipf cell: a warm-up round, then ``rounds`` rounds of
    its three runs, each printed."""
    import chip_smoke as cs
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    kernels = [match.mark_words, group.segment_table, match.mark]
    tmp = tempfile.mkdtemp(prefix="profile_host_")
    try:
        zpaths, counts, vbuf, voffs = cs.zipf_corpus(tmp, cs.WF_MB)
        words = [vbuf[voffs[i]:voffs[i + 1]].tobytes()
                 for i in range(len(voffs) - 1)]
        oracle = cs.wordfreq_oracle(words, counts, len(zpaths))
        del words
        for r in range(rounds + 1):
            rec = cs.run_wordfreq("wordfreq-zipf", zpaths, oracle, tmp,
                                  kernels, "", device)
            print(json.dumps({"round": r, "warmup": r == 0, **{
                run: {"end_to_end_s": rec[run]["end_to_end_s"],
                      "stages_s": rec[run]["stages_s"]}
                for run in ("eager", "cold", "warm")}}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def around_ooc(device) -> None:
    """wordfreq-zipf, the out-of-core chain, wordfreq-zipf again."""
    import chip_smoke as cs
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    kernels = [match.mark_words, group.segment_table, match.mark]
    tmp = tempfile.mkdtemp(prefix="profile_host_")
    try:
        zdir = os.path.join(tmp, "zipf")
        os.makedirs(zdir)
        zpaths, counts, vbuf, voffs = cs.zipf_corpus(zdir, cs.WF_MB)
        words = [vbuf[voffs[i]:voffs[i + 1]].tobytes()
                 for i in range(len(voffs) - 1)]
        oracle = cs.wordfreq_oracle(words, counts, len(zpaths))
        del words
        paths, keys = cs.intcount_files(tmp)
        for when in ("before", "after"):
            if when == "after":
                ooc = cs.run_ooc(paths["uniform"], keys["uniform"], tmp,
                                 device, kernels)
                print(json.dumps({"ooc_s": ooc["seconds"]}), flush=True)
            rec = cs.run_wordfreq("wordfreq-zipf", zpaths, oracle, tmp,
                                  kernels, "", device)
            print(json.dumps({"when": when, **{
                run: {"end_to_end_s": rec[run]["end_to_end_s"],
                      "stages_s": rec[run]["stages_s"]}
                for run in ("eager", "cold", "warm")}}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--nmap", type=int, default=64)
    ap.add_argument("--around-ooc", action="store_true")
    ap.add_argument("--wordfreq", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_host: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    if args.around_ooc or args.wordfreq:
        if args.around_ooc:
            around_ooc(torch.device("cuda", 0))
        else:
            wordfreq_rounds(torch.device("cuda", 0), args.wordfreq)
        print(chip_smoke.nvidia_smi(), flush=True)
        return 0
    from gpu_mapreduce_tpu_torch import MapReduce
    device = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="profile_host_")
    default_switch = sys.getswitchinterval()
    try:
        paths, counts, _, _ = chip_smoke.zipf_corpus(tmp, args.mb)
        nwords = int(counts.sum())
        for name, cb in callbacks().items():
            for switch in (default_switch, 1e-4):
                for style in (0, 2):
                    sys.setswitchinterval(switch)
                    mr = MapReduce(device=device, mapstyle=style, fuse=0)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    n = mr.map_file_char(args.nmap, paths, 0, 0, "\n", 80,
                                         cb)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    sys.setswitchinterval(default_switch)
                    if n != nwords:
                        raise AssertionError(f"{name}: {n} words, the "
                                             f"generator {nwords}")
                    print(json.dumps({
                        "callback": name, "mapstyle": style,
                        "switch_interval_s": switch, "seconds": dt,
                        "words": nwords, "nmap": args.nmap,
                        "mb": args.mb, "workers": os.cpu_count()}),
                        flush=True)
                    mr.kv.free()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
