#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (every failure raises and exits
nonzero):

1. device   — the card's name and count, and nvidia-smi's name and power
              limit;
2. build    — compile every kernel under gpu_mapreduce_tpu_torch/csrc/
              with nvcc (ptxas's register/spill report included);
3. kernels  — each kernel against its plain PyTorch version on the card,
              exactly, at the main path's shape and at edge shapes; then
              CUDA-event timings beside the kernel's bound;
4. main     — InvertedIndex().run() on the benchmark's 256 MB, 4-file
              corpus (warm-up, then one timed run, with every launch
              count set to 0 just before it): pairs and unique URLs must
              equal the generator's, and every kernel must have launched;
5. paths    — a dense corpus (must take a cap retry and the wide
              fallback), a skewed one, and an outdir run whose part file
              must equal a regex oracle and the port's CPU run byte for
              byte.

Then the ``kernels`` line, nvidia-smi's line, and last the result line
``{"ok": true, "device": {...}}``.  Exits nonzero without printing a
result when no CUDA device is present.  Imports nothing of JAX.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
NONTENSOR_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (data sheet)
MAIN_MB = 256                # bench.py's BENCH_MB default


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
    """mark_words vs mark_words_ref on the card, exactly."""
    import numpy as np
    import torch
    from gpu_mapreduce_tpu_torch.apps.invertedindex import PATTERN
    from gpu_mapreduce_tpu_torch.ops.bits import to_torch
    from gpu_mapreduce_tpu_torch.ops.cuda.match import (mark_words,
                                                        mark_words_ref)
    rng = np.random.default_rng(0)
    cases = {"main_path": words_main}
    # every alignment, each at a few places across thread-block seams
    offs = sorted(4 * (k + 10 * a) + a for a in range(4)
                  for k in (0, 250, 65530, 131070))
    cases["alignments"] = to_torch(planted_words(rng, 4 << 20, offs,
                                                 PATTERN), device)
    for m in (1, 2, 3, 1_000_003):       # m < nw, and not a block multiple
        cases[f"m={m}"] = to_torch(planted_words(
            rng, 4 * m, [0] if 4 * m >= len(PATTERN) else [], PATTERN),
            device)
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
        if name == "alignments":
            hits = torch.nonzero(got).flatten()
            starts = (4 * hits + got[hits].to(torch.int64) - 1).tolist()
            if starts != offs:
                raise AssertionError("mark_words missed planted matches")
    return {"cases": list(cases), "max_abs_err": err}


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from gpu_mapreduce_tpu_torch import InvertedIndex
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.ops import cuda as kcuda
    from gpu_mapreduce_tpu_torch.ops.cuda import match

    kernels = [match.mark_words]      # every kernel wrapper of the path
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    os.environ["MRTPU_TORCH_PTXAS_VERBOSE"] = "1"
    built = kcuda.build_all()
    emit({"phase": "build", "seconds": built["seconds"],
          "sources": kcuda.sources(), "nvcc_output": built["output"]})

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
        if min(launches.values()) <= 0:
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

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
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
