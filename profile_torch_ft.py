#!/usr/bin/env python3
"""What the fault-tolerance layer costs when nothing is armed, on the card.

    python3 profile_torch_ft.py [--root DIR] [--reps 5]

Imports ``gpu_mapreduce_tpu_torch`` from ``--root`` (default: this
checkout), so the same measurement runs against another tree of the port
(an older commit unpacked with ``git archive``); run the trees in turns
in one call (A, B, B, A) to compare them.  With ``MRTPU_FAULTS``,
``MRTPU_RETRY``, ``MRTPU_JOURNAL`` and ``MRTPU_ONFAULT`` unset, it times,
each ``--reps`` times after one warm-up run, between device synchronises:

* ``main``: the InvertedIndex main path over the 256 MB main corpus
  (``chip_smoke.make_corpus``'s cell), end to end and ``map_device``;
* ``intcount``: ``intcount`` eager over the 2^25-key uniform file;
* ``exchange``: the wire-p4-uniform hash exchange (2^25 rows, four
  shards on card 0, the codec at its default), CUDA-event ms;
* ``tasks``: ``MapReduce.map`` of 65,536 one-pair tasks on the card
  (every task through the ingest policy's disarmed check).

Prints one JSON line with the medians and every run's numbers, then the
card's name and power limit.  Exits nonzero without a card.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """This checkout's chip_smoke, whatever tree ``--root`` names."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_ft: no CUDA device is available",
              file=sys.stderr)
        return 2
    for k in ("MRTPU_FAULTS", "MRTPU_RETRY", "MRTPU_JOURNAL",
              "MRTPU_ONFAULT"):
        os.environ.pop(k, None)
    import gpu_mapreduce_tpu_torch as pkg
    from gpu_mapreduce_tpu_torch import InvertedIndex, MapReduce, intcount
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.ops import cuda as kcuda
    cs = _smoke()
    kcuda.build_all()
    smi = cs.nvidia_smi()
    device = torch.device("cuda", 0)
    runs = {"main_s": [], "map_device_s": [], "intcount_s": [],
            "exchange_ms": [], "tasks_s": []}
    with tempfile.TemporaryDirectory(prefix="profile_ft_") as tmp:
        os.makedirs(os.path.join(tmp, "main"))
        paths, nref, nuniq = make_corpus(os.path.join(tmp, "main"),
                                         cs.MAIN_MB)
        int_paths, int_keys = cs.intcount_files(tmp)
        from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(4, devices=[device] * 4)
        frame = cs.wire_frame(int_keys["uniform"], mesh)

        def one_task(itask, kv, ptr):
            kv.add(itask, itask)

        for rep in range(args.reps + 1):
            idx = InvertedIndex()
            cs.sync_all()
            t0 = time.perf_counter()
            got = idx.run(paths)
            cs.sync_all()
            dt = time.perf_counter() - t0
            if got != (nref, nuniq):
                raise AssertionError(f"main: {got} != {(nref, nuniq)}")
            t1 = time.perf_counter()
            intcount([int_paths["uniform"]], ntop=10)
            cs.sync_all()
            t2 = time.perf_counter()
            _out, ms, _st = cs.timed_exchange(frame)
            del _out
            mr = MapReduce(device=device)
            cs.sync_all()
            t3 = time.perf_counter()
            mr.map(1 << 16, one_task)
            cs.sync_all()
            t4 = time.perf_counter()
            if rep == 0:
                continue        # the warm-up run
            runs["main_s"].append(dt)
            runs["map_device_s"].append(idx.timer.times["map_device"])
            runs["intcount_s"].append(t2 - t1)
            runs["exchange_ms"].append(ms)
            runs["tasks_s"].append(t4 - t3)
    cs.emit({"root": os.path.abspath(args.root),
             "package": os.path.dirname(pkg.__file__),
             "has_ft_retry": os.path.exists(os.path.join(
                 os.path.dirname(pkg.__file__), "ft", "retry.py")),
             "card": smi, "reps": args.reps,
             "median": {k: statistics.median(v) for k, v in runs.items()},
             "runs": runs})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
