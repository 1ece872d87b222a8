#!/usr/bin/env python3
"""PageRank's step count and ranks from run to run on the card.

    python3 profile_torch_pagerank.py [ROOT] [--label NAME] [--reps N]
                                      [--scale S] [--device cpu]

Builds chip_smoke's graph-rmat22 edges (``rmat 22 16 0.57 0.19 0.19
0.05 0.0 20260``) through the port's OINK interpreter from the checkout
at ``ROOT`` (default: this one), once on one device and once on a mesh
of four shards of it, stages each as the pagerank command does and runs
that tree's ``models.pagerank.pagerank_sharded`` ``--reps`` times at the
smoke's tol 1e-8, 100 steps, damping 0.85.  Then 40 steps at tol 0 with
the tree's ``pagerank_step``, each step's largest rank change read: the
changes after step 10 are the noise floor that ``tol`` must stay above.
Prints one JSON line: per layout the step counts, how many distinct
rank vectors the repeats gave (by sha256 of their bytes), whether the
four-shard ranks equal one device's bit for bit, the first run's step
changes, the floor's least and largest change and the ms a step.  Run
it on two ``git archive``d trees in one call to the card, alternating
(A, B, B, A).  Exits nonzero without a card unless ``--device cpu``.
"""

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

TOL, MAXITER, DAMPING = 1e-8, 100, 0.85
FLOOR_STEPS, FLOOR_FROM = 40, 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_torch_pagerank: no CUDA device is available",
              file=sys.stderr)
        return 2
    from gpu_mapreduce_tpu_torch import OinkScript
    from gpu_mapreduce_tpu_torch.models import pagerank as pr
    from gpu_mapreduce_tpu_torch.parallel.collectives import (
        allreduce, per_device, replicate)
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.parallel.staging import stage_graph
    import chip_smoke as cs
    device = torch.device(args.device)
    a, b, c, d = cs.GRAPH_ABCD
    rmat = (f"rmat {args.scale} {cs.GRAPH_EDGEFACTOR} {a} {b} {c} {d} 0.0 "
            f"{cs.GRAPH_SEED} -o NULL mre")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def staged(comm):
        s = (OinkScript(comm=comm, screen=False, logfile=None) if comm
             else OinkScript(device=device, screen=False, logfile=None))
        s.one(rmat)
        sg = stage_graph(s.obj.named["mre"])
        s.obj.delete_mr("mre")
        return sg.n, [(sh.src, sh.dst) for sh in sg.shards]

    def floor(n, shards):
        deg = allreduce([pr.out_degrees(src, n) for src, _ in shards], "sum")
        inv = per_device(pr.inv_outdegrees, deg)
        steps = [(src, dst, i[src]) for (src, dst), i in zip(shards, inv)]
        r = replicate(torch.full((n,), 1.0 / n, dtype=torch.float32,
                                 device=deg[0].device),
                      [x.device for x in deg])
        deltas = []
        for _ in range(FLOOR_STEPS):
            r2 = pr.pagerank_step(r, steps, inv, DAMPING)
            deltas.append((r2[0] - r[0]).abs_().max().item())
            r = r2
        return deltas

    out = {"label": args.label or root, "scale": args.scale,
           "tol": TOL, "layouts": {}}
    first = {}
    for name, comm in (("p1", None),
                       ("p4", make_mesh(devices=[device] * 4))):
        n, shards = staged(comm)
        its, digests, secs = [], set(), []
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            ranks, it = pr.pagerank_sharded(shards, n, TOL, MAXITER, DAMPING)
            sync()
            secs.append((time.perf_counter() - t0) / it)
            host = ranks.cpu().numpy().tobytes()
            digests.add(hashlib.sha256(host).hexdigest())
            first.setdefault(name, host)
            its.append(it)
        deltas = floor(n, shards)
        tail = deltas[FLOOR_FROM:]
        out["n"], out["edges"] = n, sum(len(s) for s, _ in shards)
        out["layouts"][name] = {
            "iterations": its, "distinct_ranks": len(digests),
            "step_deltas": deltas[:max(its)],
            "floor_min": min(tail), "floor_max": max(tail),
            "floor_above_tol": sum(x > TOL for x in tail),
            "ms_a_step": statistics.median(secs) * 1e3}
        del shards
    out["p4_bits_equal_p1"] = first["p1"] == first["p4"]
    print(json.dumps(out), flush=True)
    print(cs.nvidia_smi() if device.type == "cuda" else "cpu", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
