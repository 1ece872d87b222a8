"""Judge of ``pagerank``: every vertex's rank in the sampled jobs' output
MRs against the plain float64 reference, and every job's step, vertex
and edge counts.

Checks (each at most its limit from the workload file):

* ``rank_gap`` — the largest |rank - reference rank| over the vertices,
  over the reference's largest rank (a vertex set that differs reads 1);
* ``step_gap`` — the largest |steps - reference steps| over the jobs;
* ``count_gap`` — the largest |vertices - n| + |edges - m| over the jobs.

The control is the reference computed in bfloat16, the precision below
the float32 ranks the system holds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..drivers.oink_graph import reference_shards
from ..ref import graph


def _params(wl):
    p = wl["params"]
    return float(p["tol"]), int(p["maxiter"]), float(p["alpha"])


def reference(inputs, cfg, wl, device) -> dict:
    verts, r, steps = graph.pagerank(reference_shards(inputs), *_params(wl))
    return {"verts": verts.cpu().numpy().astype(np.uint64),
            "ranks": r.cpu().numpy(), "steps": steps,
            "n": int(verts.numel()), "m": int(len(inputs["packed"]))}


def control(inputs, cfg, wl, device, ref) -> dict:
    verts, r, steps = graph.pagerank(reference_shards(inputs), *_params(wl),
                                     dtype=torch.bfloat16)
    return {"outputs": {0: (verts.cpu().numpy().astype(np.uint64),
                            r.double().cpu().numpy())},
            "jobs": [{"steps": steps, "vertices": int(verts.numel()),
                      "edges": int(len(inputs["packed"]))}]}


def rank_gap(keys, values, ref) -> float:
    order = np.argsort(keys, kind="stable")
    keys, values = keys[order], np.asarray(values, np.float64)[order]
    if len(keys) != len(ref["verts"]) or not np.array_equal(keys,
                                                            ref["verts"]):
        return 1.0
    return float(np.abs(values - ref["ranks"]).max() / ref["ranks"].max())


def compare(got, ref, wl):
    lim = wl["limits"]
    gaps = {i: rank_gap(k, v, ref) for i, (k, v) in got["outputs"].items()}
    wrong = {i for i, g in gaps.items() if g > lim["rank_gap"]}
    steps = counts = 0
    for i, c in enumerate(got["jobs"]):
        if c is None:
            continue
        s = abs(c.get("steps", -1) - ref["steps"])
        n = (abs(c.get("vertices", -1) - ref["n"])
             + abs(c.get("edges", -1) - ref["m"]))
        if s > lim["step_gap"] or n > lim["count_gap"]:
            wrong.add(i)
        steps, counts = max(steps, s), max(counts, n)
    checks = {"rank_gap": (max(gaps.values(), default=1.0), lim["rank_gap"]),
              "step_gap": (steps, lim["step_gap"]),
              "count_gap": (counts, lim["count_gap"])}
    return checks, wrong
