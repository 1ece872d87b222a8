"""Driver of the InvertedIndex cells: the configuration's HTML corpus,
written into a directory under ``TMPDIR`` (with ``"seed_gives":
"order"`` one corpus whose pages the seed orders, so every seed reads
and indexes the same bytes; else a corpus drawn from the seed); a job is
``InvertedIndex(device).run(files)``, its result the job's MR of counts
by URL id with the groups the counts were made from, and the numbers
its run and its stage timer report."""

from __future__ import annotations

import shutil
import tempfile

import torch

from ..gen import html

_TARGET = "gpu_mapreduce_tpu_torch.apps.invertedindex"


def setup(cfg: dict, wl: dict, seed: int, devices) -> dict:
    import importlib
    from gpu_mapreduce_tpu_torch.apps.invertedindex import InvertedIndex
    tmp = tempfile.mkdtemp(prefix="mrbench-html-")
    # "order": the configuration's one corpus (its corpus_seed), each
    # file's pages in the order the run's seed gives; "corpus": the seed
    # draws the corpus
    order_only = wl.get("seed_gives", "corpus") == "order"
    paths, info = html.make_corpus(
        tmp, cfg["corpus_seed"] if order_only else seed, cfg["total_bytes"],
        cfg["files"], cfg["vocab"], cfg["alpha"], cfg["long_every"],
        order_seed=seed if order_only else None)
    return {"tmp": tmp, "paths": paths, "device": devices[0],
            "cls": InvertedIndex, "mod": importlib.import_module(_TARGET),
            "sizes": {"corpus_bytes": info["bytes"], "refs": info["refs"],
                      "distinct": info["distinct"]}}


def job(state):
    """One run, its reduce's input groups kept for the check (the reduce
    is wrapped for the job's length only)."""
    mod, groups = state["mod"], []
    reduce = mod.reduce_sharded

    def capture(fr, op):
        groups.append(fr)
        return reduce(fr, op)
    mod.reduce_sharded = capture
    try:
        ii = state["cls"](state["device"])
        npairs, nurl = ii.run(state["paths"])
    finally:
        mod.reduce_sharded = reduce
    t = ii.timer.times
    counts = {"refs": npairs, "urls": nurl,
              "read_s": t.get("read", 0.0), "h2d_s": t.get("h2d", 0.0),
              "map_device_s": t.get("map_device", 0.0)}
    return (ii.mr, groups), counts


def drop(state, out) -> None:
    mr, groups = out
    for ds in (mr.kv, mr.kmv):
        if ds is not None:
            ds.free()
    groups.clear()


def collect(state, kept: dict) -> dict:
    """{job index: {url id: (count, file indices)}} on the host."""
    import numpy as np
    from gpu_mapreduce_tpu_torch.interop import mapreduce_to_numpy
    from ..ref.invindex import as_index
    out = {}
    for i, (mr, groups) in kept.items():
        ids, counts = mapreduce_to_numpy(mr)
        gids, gdocs = [], []
        for fr in groups:
            h = fr.to_host()
            vals = np.asarray(h.values.data)
            gids.append(np.asarray(h.key.data))
            gdocs += [vals[h.offsets[g]:h.offsets[g + 1]]
                      for g in range(len(h))]
        out[i] = as_index(ids, counts, np.concatenate(gids) if gids
                          else np.zeros(0, np.uint64), gdocs)
        drop(state, (mr, groups))
    return out


def release(state) -> dict:
    """Returns the inputs for the reference."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"paths": state["paths"], "tmp": state["tmp"]}


def cleanup(inputs) -> None:
    """The corpus goes once the reference has read it."""
    shutil.rmtree(inputs["tmp"], ignore_errors=True)
