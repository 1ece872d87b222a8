"""Readings that a cell's limits are set from, in one process on the card:
the system's checks on many seeds, then the control's (the plain
reference at the lower precision, or with the guarantee broken, in the
system's place) on a few, each at the cell's own size with a short
window.

    python3 -m mrbench.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3

Prints one JSON line a run ({"seed", "control", "correct", "checks"}),
then a summary: each check's largest reading over the system's seeds
(the lower reading) and smallest over the control's (the upper)."""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from mrbench import run
    p = argparse.ArgumentParser(prog="mrbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    run.fix_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("mrbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    runs = [(int(s), False) for s in a.seeds.split(",") if s] + \
        [(int(s), True) for s in a.control_seeds.split(",") if s]
    lower, upper = {}, {}
    for seed, control in runs:
        t = time.perf_counter()
        r = run.run_cell(a.workload, seed, a.seconds, False, control=control)
        vals = {k: c["value"] for k, c in r["checks"].items()}
        print(json.dumps({"seed": seed, "control": control,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": vals,
                          "seconds": time.perf_counter() - t}), flush=True)
        side = upper if control else lower
        for k, v in vals.items():
            side.setdefault(k, []).append(v)
        torch.cuda.empty_cache()
    print(json.dumps({"lower": {k: max(v) for k, v in lower.items()},
                      "upper": {k: min(v) for k, v in upper.items()},
                      "readings": lower, "control_readings": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
