"""Per-shard file ingest on a mesh: a ``MeshKV`` born at map time.

The counterpart of ``gpu_mapreduce_tpu/parallel/ingest.py``.  The
reference's map stage reads each rank's own files on its own node
(``src/mapreduce.cpp:1102-1225``); here, for ``map_files`` and
``map_file_char``/``map_file_str`` on a mesh of P > 1:

* the file list splits into P contiguous, byte-balanced slices
  (:func:`balance_by_bytes`), one a shard;
* every task's callback runs into a private sink that carries its
  shard's device (tasks numbered in global file order; under mapstyle 2
  on the MapReduce's thread pool), under the ft/ ingest policy
  (``ft.retry.ingest_task``: fault points, retries within the task's
  slot, quarantine under ``onfault="skip"``); a file that fails at the
  byte balance, or a chunk map's file read, gets the same disposition;
* each shard's sinks become one frame on that shard's device (a text
  column interns there), and the shards' frames become one mesh frame
  (:func:`build_sharded`) whose text tables are dest-sharded
  (``core.column.ShardTables``).

Rows stay on the shard whose files produced them, so a later aggregate
starts from the JAX package's source layout — except a lopsided ingest
(the fullest shard past twice the even share), which re-splits evenly.
Frames that cannot form one mesh frame (text on one shard and numbers on
another, dtypes that differ, ``add_frame``/``add_kv`` calls) raise
:class:`Unshardable`, and the recorded sinks replay into the host KV
instead: every callback still runs exactly once.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..core.column import ShardTables
from ..core.frame import KVFrame


class Unshardable(Exception):
    """Per-shard frames cannot form one mesh frame; the caller replays
    the sinks into the host KV."""


def balance_by_bytes(names: Sequence[str], P: int):
    """Split files into P contiguous slices of about equal bytes (the
    reference's consecutive per-proc file ranges); returns
    ``[(first_index, files, sizes)] * P`` (JAX ingest.py:53-72)."""
    sizes = np.array([os.path.getsize(f) for f in names], np.int64)
    total = max(int(sizes.sum()), 1)
    mid = np.cumsum(sizes) - sizes // 2
    assign = np.minimum((mid * P) // total, P - 1)   # non-decreasing
    out = []
    i = 0
    for p in range(P):
        j = i
        while j < len(names) and assign[j] == p:
            j += 1
        out.append((i, list(names[i:j]), sizes[i:j]))
        i = j
    return out


def run_sinks(mr, payloads, call: Callable, base: int, device,
              shard=None):
    """``call(base + i, payload, sink)`` for every payload into private
    sinks on ``device``, in task order, each task under
    ``ft.retry.ingest_task``; under mapstyle 2 the tasks run on the
    MapReduce's thread pool.  Returns the sinks."""
    from ..core.mapreduce import _TaskSink
    from ..ft.retry import ingest_active, ingest_task
    onfault = mr.settings.onfault
    active = ingest_active(onfault)
    sinks = [_TaskSink(device) for _ in payloads]
    if mr.settings.mapstyle == 2 and len(payloads) > 1:
        pool = mr._task_pool()
        futs = [pool.submit(ingest_task, call, base + i, p, sinks[i],
                            onfault=onfault, shard=shard, active=active)
                for i, p in enumerate(payloads)]
        for f in futs:
            f.result()          # a callback's exception surfaces here
    else:
        for i, p in enumerate(payloads):
            ingest_task(call, base + i, p, sinks[i], onfault=onfault,
                        shard=shard, active=active)
    return sinks


def _sink_frames(sinks) -> list:
    """A shard's sinks as frames, in task order: scalar adds as host
    frames, ``add_batch`` of host arrays as host frames and of tensors
    as frames on their device.  ``add_frame``/``add_kv`` are not a file
    callback's output: :class:`Unshardable`."""
    from ..core.dataset import _coerce_rows
    from .sharded import tensor_frame
    frames = []
    for s in sinks:
        buf_k: list = []
        buf_v: list = []
        for name, args, kw in s._calls:
            if name == "add":
                buf_k.append(args[0])
                buf_v.append(args[1])
                continue
            if buf_k:
                frames.append(KVFrame(_coerce_rows(buf_k),
                                      _coerce_rows(buf_v)))
                buf_k, buf_v = [], []
            if name != "add_batch":
                raise Unshardable(name)
            keys, values = args
            if isinstance(keys, torch.Tensor):
                fr = tensor_frame(keys, values, kw.get("key_dtype"),
                                  kw.get("value_dtype"))
            else:
                fr = KVFrame(keys, values)
            if len(fr):
                frames.append(fr)
        if buf_k:
            frames.append(KVFrame(_coerce_rows(buf_k), _coerce_rows(buf_v)))
    return frames


def _shard_frame(frames: list, device):
    """One shard's frames as one frame on its device (host pages copied
    in, text interned there), or None for a shard with no rows."""
    from .backend import DeviceBackend
    if not frames:
        return None
    try:
        return DeviceBackend(device).place_kv_frames(frames)
    except TypeError as e:       # byte rows beside numbers in one shard
        raise Unshardable(str(e))


def _align_side(shards: list, which: str, P: int):
    """One side's columns over the shards → (tensors, ShardTables or
    None).  All text or all numbers (else :class:`Unshardable`); a bytes
    table beside an object table moves to the pickle domain, so one
    logical row has one id on every shard."""
    from .devkernels import _reintern_pickle_domain
    cols = [getattr(s, which) for s in shards]
    tabs = [getattr(s, f"{which}_decode") for s in shards]
    if all(t is None for t in tabs):
        return cols, None
    if any(t is None for t in tabs):
        raise Unshardable("mixed byte and numeric rows across shards")
    kind = "object" if any(t.kind == "object" for t in tabs) else "bytes"
    tables = ShardTables(P, kind=kind)
    for i, t in enumerate(tabs):
        if kind == "object" and t.kind == "bytes":
            cols[i], t = _reintern_pickle_domain(cols[i], t)
        ids = np.fromiter(t.keys(), np.uint64, len(t))
        tables.absorb(ids, t.decode_batch(ids))
    return cols, tables


def build_sharded(frames: List[list], mesh):
    """Each shard's frames (``frames[p]``) → one mesh frame, rows on the
    shard that read them (JAX ingest.py:238-285); a lopsided ingest (the
    fullest shard past twice the even share) re-splits evenly, keeping
    row order.  Raises :class:`Unshardable` when the shards disagree."""
    from .sharded import mesh_kv
    P = mesh.size
    placed = [_shard_frame(f, dev) for f, dev in zip(frames, mesh.devices)]
    full = [s for s in placed if s is not None and len(s)]
    if not full:
        from .sharded import shard_frame_mesh
        from ..core.frame import empty_kv
        return shard_frame_mesh(empty_kv(), mesh)
    spec = {(s.key_dtype, tuple(s.key.shape[1:]), s.value_dtype,
             tuple(s.value.shape[1:])) for s in full}
    if len(spec) > 1:
        raise Unshardable(f"shard dtype/shape mismatch: {sorted(spec)}")
    ref = full[0]
    counts = [len(s) if s is not None else 0 for s in placed]
    live = [s if s is not None and len(s) else None for s in placed]
    keys, ktab = _align_side([s for s in live if s is not None], "key", P)
    values, vtab = _align_side([s for s in live if s is not None],
                               "value", P)
    kit, vit = iter(keys), iter(values)
    kcols, vcols = [], []
    for s, dev in zip(live, mesh.devices):
        if s is None:
            kcols.append(ref.key[:0].to(dev))
            vcols.append(ref.value[:0].to(dev))
        else:
            kcols.append(next(kit))
            vcols.append(next(vit))
    total = sum(counts)
    if P > 1 and max(counts) > 2 * (-(-total // P)):
        kcols, vcols, counts = _even_split(kcols, vcols, counts, mesh)
    return mesh_kv(mesh, kcols, vcols, counts, ref.key_dtype,
                   ref.value_dtype, ktab, vtab)


def _even_split(kcols, vcols, counts, mesh):
    """Rows of every shard, in shard order, re-split ``ceil(n/P)`` a
    shard; each piece copies straight to its new shard's device."""
    P = mesh.size
    total = sum(counts)
    per = -(-total // P)
    src_off = np.concatenate([[0], np.cumsum(counts)])
    nk, nv, nc = [], [], []
    for p, dev in enumerate(mesh.devices):
        lo, hi = min(p * per, total), min((p + 1) * per, total)
        kp, vp = [], []
        for s in range(P):
            a, b = max(lo, src_off[s]), min(hi, src_off[s + 1])
            if a < b:
                a, b = int(a - src_off[s]), int(b - src_off[s])
                kp.append(kcols[s][a:b].to(dev))
                vp.append(vcols[s][a:b].to(dev))
        nk.append(torch.cat(kp) if kp else kcols[0][:0].to(dev))
        nv.append(torch.cat(vp) if vp else vcols[0][:0].to(dev))
        nc.append(hi - lo)
    return nk, nv, nc


def _balanced(names: Sequence[str], P: int,
              onfault: str = "fail") -> List[List[str]]:
    """:func:`balance_by_bytes` under the ft/ discovery policy: a file
    that fails here gets the task-time disposition (``MRError`` naming
    it, or quarantined and dropped under ``onfault="skip"``)."""
    from ..ft.retry import quarantine_or_raise
    names = list(names)
    while True:
        try:
            return [files for _, files, _ in balance_by_bytes(names, P)]
        except OSError as e:
            bad = getattr(e, "filename", None)
            if bad in names:
                quarantine_or_raise(e, bad, onfault)
                names.remove(bad)
            else:
                quarantine_or_raise(e, bad, "fail")


def _finish(mr, kv, shard_sinks: List[list], stats: dict) -> dict:
    """The shards' sinks → one mesh frame in ``kv``, or (Unshardable)
    every sink replayed into the host KV in task order."""
    try:
        frames = [_sink_frames(sinks) for sinks in shard_sinks]
        skv = build_sharded(frames, mr.backend.mesh)
    except Unshardable as e:
        for sinks in shard_sinks:
            for s in sinks:
                s.replay(kv)
        stats["mode"] = "host"
        stats["fallback"] = str(e)[:200]
        return stats
    kv.add_frame(skv)
    stats["rows_per_shard"] = skv.counts.tolist()
    return stats


def mesh_map_files(mr, kv, names: Sequence[str], call: Callable) -> dict:
    """``map_files`` on a mesh: each shard maps its contiguous,
    byte-balanced slice of the files (tasks numbered in file order) into
    a frame on its device.  Returns the ingest record
    (``{"mode": "mesh" | "host", ...}``)."""
    mesh = mr.backend.mesh
    shards = _balanced(names, mesh.size, mr.settings.onfault)
    stats = {"mode": "mesh", "shards": mesh.size,
             "files_per_shard": [len(s) for s in shards]}
    sinks, base = [], 0
    for p, (files, dev) in enumerate(zip(shards, mesh.devices)):
        sinks.append(run_sinks(mr, files, call, base, dev, shard=p))
        base += len(files)
    return _finish(mr, kv, sinks, stats)


def mesh_map_chunks(mr, kv, names: Sequence[str], per_file: int,
                    sep: bytes, delta: int, call: Callable) -> dict:
    """``map_file_char``/``map_file_str`` on a mesh: files balance over
    the shards, each splits into its ~``per_file`` chunks as on the host
    path (so callbacks see the same payloads, tasks numbered file then
    chunk), and each shard's chunks map into a frame on its device."""
    from ..ft.retry import ingest_read
    from ..utils.io import file_chunks
    mesh = mr.backend.mesh
    onfault = mr.settings.onfault
    shards = _balanced(names, mesh.size, onfault)
    stats = {"mode": "mesh", "shards": mesh.size,
             "files_per_shard": [len(s) for s in shards],
             "chunks_per_shard": []}
    sinks, base = [], 0
    for p, (files, dev) in enumerate(zip(shards, mesh.devices)):
        # each file reads under the ft/ ingest.read policy (None: the
        # file was quarantined)
        payloads = []
        for fname in files:
            chunks = ingest_read(
                lambda f=fname: list(file_chunks(f, per_file, sep, delta)),
                file=fname, onfault=onfault, shard=p)
            if chunks is not None:
                payloads.extend(chunks)
        stats["chunks_per_shard"].append(len(payloads))
        sinks.append(run_sinks(mr, payloads, call, base, dev, shard=p))
        base += len(payloads)
    stats["ntasks"] = base
    return _finish(mr, kv, sinks, stats)
