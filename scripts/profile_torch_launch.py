#!/usr/bin/env python3
"""The launcher's wall time against the size of its corpus.

    python3 scripts/profile_torch_launch.py [--mb 16,32,64] [--np 4]

For each size in ``--mb``, generates chip_smoke's zipf corpus (four
files, the smoke's seed) and runs one uninterrupted
``python -m gpu_mapreduce_tpu_torch.launch --np N ... wordfreq`` over it
at the smoke's chunk count, with the smoke's gate: the output equals the
``collections.Counter`` oracle.  Prints one JSON line per size (corpus
bytes and seconds to generate it, the run's wall seconds and the
launcher's own ``wall_seconds``, each rank's device, backend and
transport), then the card's name and power limit.  Exits nonzero
without a card or when a gate fails.
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_launch: no CUDA device is available",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", default="16,32,64")
    ap.add_argument("--np", type=int, default=4)
    args = ap.parse_args()

    import chip_smoke as cs
    smi = cs.nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="profile_launch_")
    try:
        for mb in (int(x) for x in args.mb.split(",")):
            d = os.path.join(tmp, f"mb{mb}")
            os.makedirs(d)
            t0 = time.perf_counter()
            paths = cs.zipf_corpus(d, mb)[0]
            corpus_s = time.perf_counter() - t0
            want = cs.launch_oracle(paths)
            out = os.path.join(d, "out.txt")
            rec = cs._launch(
                ["--np", str(args.np), "wordfreq", "--files", *paths,
                 "--out", out, "--chunks", str(cs.DIST_LAUNCH_CHUNKS)],
                os.path.join(d, "run"))
            with open(out, "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"launch at {mb} MB: the output "
                                         f"differs from the Counter oracle")
            print(json.dumps({
                "mb": mb, "np": args.np,
                "corpus_bytes": sum(os.path.getsize(p) for p in paths),
                "corpus_s": corpus_s, "wall_s": rec["wall_s"],
                "launcher_s": rec["summary"]["wall_seconds"],
                "generations": rec["summary"]["generations"],
                "ranks": rec["ranks"], "output_equals_oracle": True}),
                flush=True)
            shutil.rmtree(d)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
