"""Driver of the OINK graph cells: the configuration's Graph500 edges,
made on the card, handed to an ``OinkScript`` as a named MR; the
workload's set-up lines run once; a job is the workload's command line,
its result the named output MR and the numbers its message reports.

With ``"seed_gives": "order"`` every seed runs the configuration's one
graph (drawn from its ``graph_seed``), its edges in an order drawn from
the seed, so every seed does the same work (the same PageRank steps, the
same cc rounds); with ``"graph"`` (the default) the seed draws the graph.

A workload file gives ``input`` (the edge MR's name), ``setup_lines``,
``line`` (formatted with ``params``), ``output`` (the MR the line names)
and ``message`` (a regular expression whose named groups are the
counts a job reports)."""

from __future__ import annotations

import io
import re

import numpy as np
import torch

from ..gen import graph500


def free_mr(mr) -> None:
    for ds in (mr.kv, mr.kmv):
        if ds is not None:
            ds.free()


def shard_bounds(n: int, nshards: int):
    """Contiguous, near-equal [start, end) row ranges, one a shard."""
    return [(n * i // nshards, n * (i + 1) // nshards)
            for i in range(nshards)]


def setup(cfg: dict, wl: dict, seed: int, devices) -> dict:
    """The edges are made on the first card and culled there; on several
    cards each takes a contiguous share of them as its shard of a mesh
    frame (``make_mesh``, one shard a card)."""
    from gpu_mapreduce_tpu_torch import OinkScript
    from gpu_mapreduce_tpu_torch.parallel.sharded import (
        MeshKV, ShardedKV, pad_rows, round_cap)
    scale = cfg["scale"]
    # "order": the configuration's one graph (its graph_seed), its edges
    # in the order the run's seed gives; "graph": the seed draws the graph
    order_only = wl.get("seed_gives", "graph") == "order"
    packed, ndraw = graph500.generate_packed(
        cfg["graph_seed"] if order_only else seed, scale, cfg["edgefactor"],
        cfg["abcd"], device=devices[0])
    if order_only:
        packed = graph500.shuffle(packed, seed)
    n = int(packed.shape[0])
    inputs = {"packed": packed.cpu(), "scale": scale, "devices": devices}
    bounds = shard_bounds(n, len(devices))
    cap = round_cap(max(b - a for a, b in bounds))   # as kv.add_batch pads
    shards = []
    for (a, b), dev in zip(bounds, devices):
        key = graph500.unpack(packed[a:b].to(dev), scale)
        null = torch.zeros(b - a, dtype=torch.uint8, device=dev)
        shards.append(ShardedKV(pad_rows(key, cap), pad_rows(null, cap),
                                np.array([b - a], np.int32),
                                np.dtype(np.uint64), np.dtype(np.uint8)))
        del key, null
    del packed
    for dev in devices:              # the device peak is the system's
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
    if len(devices) > 1:
        from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(devices=devices)
        script = OinkScript(comm=mesh, screen=False, logfile=None)
        frame = MeshKV(mesh, shards)
    else:
        script = OinkScript(device=devices[0], screen=False, logfile=None)
        frame = shards[0]
    mr = script.obj.create_mr()
    mr.map(1, lambda itask, kv, ptr: kv.add_frame(frame))
    script.obj.name_mr(wl["input"], mr)
    del frame, shards
    for line in wl.get("setup_lines", ()):
        script.one(line)
    return {"script": script, "wl": wl, "inputs": inputs,
            "line": wl["line"].format(**wl.get("params", {})),
            "message": re.compile(wl["message"]),
            "sizes": {"edges": n, "draws": ndraw, "scale": scale}}


def reference_shards(inputs) -> list:
    """The benchmark's edges as [m, 2] ids, split over the cards as the
    system's shards are."""
    packed, devices = inputs["packed"], inputs["devices"]
    return [graph500.unpack(packed[a:b].to(dev), inputs["scale"])
            for (a, b), dev in zip(shard_bounds(len(packed), len(devices)),
                                   devices)]


def job(state):
    s = state["script"]
    s.screen = buf = io.StringIO()
    s.one(state["line"])
    m = state["message"].search(buf.getvalue())
    counts = {k: int(v) for k, v in m.groupdict().items()} if m else {}
    return s.obj.named.pop(state["wl"]["output"]), counts


def drop(state, mr) -> None:
    free_mr(mr)


def collect(state, kept: dict) -> dict:
    """{job index: (keys, values)} on the host; the MRs are freed."""
    from gpu_mapreduce_tpu_torch.interop import mapreduce_to_numpy
    out = {}
    for i, mr in kept.items():
        out[i] = mapreduce_to_numpy(mr)
        free_mr(mr)
    return out


def release(state) -> dict:
    """Free the script's MRs; returns the inputs for the reference."""
    s = state.pop("script")
    for name in list(s.obj.named):
        s.obj.delete_mr(name)
    s.obj.cleanup()
    del s
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return state["inputs"]
