"""Judge of ``cc_find``: each vertex's component in the sampled jobs'
output MRs, as a partition named by least vertex ids, against the plain
reference run on the benchmark's edges through its own ``edge_upper``;
and every job's component count.

Checks (exact, limit 0):

* ``wrong_vertices`` — vertices whose component id differs from the
  reference's, plus vertices only one side has;
* ``component_gap`` — the largest |components - reference| over the
  jobs.

The system states no precision for the labels; the control breaks the
guarantee that every vertex carries its whole component's least id: the
reference stopped one round before its fixed point.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gen import graph500
from ..ref import graph


def reference(inputs, cfg, wl, device) -> dict:
    edges = graph500.unpack(inputs["packed"].to(device), inputs["scale"])
    upper = graph.edge_upper(edges)
    del edges
    verts, zones, rounds = graph.components(upper)
    return {"upper": upper, "verts": verts.cpu().numpy().astype(np.uint64),
            "zones": zones.cpu().numpy().astype(np.uint64),
            "rounds": rounds,
            "ncc": int(torch.unique(zones).numel())}


def control(inputs, cfg, wl, device, ref) -> dict:
    verts, zones, _ = graph.components(ref["upper"],
                                       max_rounds=max(ref["rounds"] - 2, 0))
    return {"outputs": {0: (verts.cpu().numpy().astype(np.uint64),
                            zones.cpu().numpy().astype(np.uint64))},
            "jobs": [{"components": int(torch.unique(zones).numel())}]}


def wrong_vertices(keys, values, ref) -> int:
    keys = np.asarray(keys, np.uint64)
    values = np.asarray(values, np.uint64)
    order = np.argsort(keys, kind="stable")
    keys, values = keys[order], values[order]
    common, gi, ri = np.intersect1d(keys, ref["verts"], assume_unique=True,
                                    return_indices=True)
    only = len(keys) + len(ref["verts"]) - 2 * len(common)
    return int(only + (values[gi] != ref["zones"][ri]).sum())


def compare(got, ref, wl):
    lim = wl["limits"]
    bad = {i: wrong_vertices(k, v, ref) for i, (k, v) in
           got["outputs"].items()}
    wrong = {i for i, b in bad.items() if b > lim["wrong_vertices"]}
    gap = 0
    for i, c in enumerate(got["jobs"]):
        if c is None:
            continue
        g = abs(c.get("components", -1) - ref["ncc"])
        if g > lim["component_gap"]:
            wrong.add(i)
        gap = max(gap, g)
    return {"wrong_vertices": (max(bad.values(), default=len(ref["verts"])),
                               lim["wrong_vertices"]),
            "component_gap": (gap, lim["component_gap"])}, wrong
