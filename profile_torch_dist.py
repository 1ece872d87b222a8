#!/usr/bin/env python3
"""The exchange across ranks alone on the card, for comparing two trees.

    python3 profile_torch_dist.py [ROOT] [--label NAME]

Runs chip_smoke's rank exchange (``chip_smoke.run_dist_exchange``) from
the checkout at ``ROOT`` (default: this one): the intcount-uniform keys
(2^25 u32, seed 7) as four files, four rank processes on the card and
the one-process ``make_mesh(4)`` reference, with the smoke's gates.
Prints one JSON line: the label, the phase's seconds, and for each call
the tree's smoke runs (cold and warm, and where the tree has them its
later calls) every rank's seconds, count-gather seconds and
``all_to_all`` seconds, with the calls' ``cap_out`` and
``speculative``.  Run it on two ``git archive``d trees in one call to
the card, alternating (A, B, B, A).  Exits nonzero without a card.
"""

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_dist: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    keys = np.random.default_rng(7).integers(0, 1 << 32, cs.INTCOUNT_KEYS,
                                             dtype=np.uint32)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec = cs.run_dist_exchange(keys, tmp)
        out = {"label": args.label or root,
               "phase_s": time.perf_counter() - t0}
    for k in ("seconds", "count_sync_s", "exchange_s"):
        out[k] = rec[k]
    out["calls"] = {c: {k: v for k, v in r.items()
                        if k in ("cap_out", "speculative", "mesh_s")}
                    for c, r in rec.get("calls", {}).items()}
    print(json.dumps(out), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
