"""Checkpoint / restore of MapReduce datasets (the port of
``gpu_mapreduce_tpu/core/checkpoint.py``; the reference persists only
through print-to-file text).

A KV or KMV round-trips through a directory of ``frame-NNNNN.npz`` files
(the npz fields of ``core/dataset._col_to_npz``) and a v2 JSON manifest:
``version``, ``kind``, ``nframes``, ``counts``, ``frames`` (``file``,
``n``, global ``rows``, the file's crc ``digest``, the writer's per-shard
row counts ``shards`` and per-shard row digests ``shard_digests``) and
``mesh``.  A device frame is written as its decoded host rows, so a
checkpoint written by either package loads in the other.  The save is
atomic at directory granularity (tmp sibling + rename, the previous
checkpoint kept when the swap and its undo both fail); the load checks
every frame file against its digest before it reads it (``MRTPU_VERIFY``)
and streams frames one at a time into the receiving MapReduce's page
budget.  v1 manifests (no ``frames``) still load.  With a content store
armed (``MRTPU_CAS_DIR``, ``utils/cas.py``) each frame file becomes a
hardlink to its content object after the swap, so saves of one dataset
hold one copy of its bytes.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from .dataset import _col_from_npz, _col_to_npz
from .frame import KMVFrame, KVFrame
from .runtime import MRError

_MANIFEST = "manifest.json"
_VERSION = 2


def _frame_shard_meta(fr) -> dict:
    """The writer's per-shard row counts of a device frame (None for a
    host frame)."""
    counts = getattr(fr, "gcounts", None)
    if counts is None:
        counts = getattr(fr, "counts", None)
    if counts is None:
        return {"shards": None, "nprocs": 1}
    return {"shards": [int(c) for c in counts],
            "nprocs": int(getattr(fr, "nprocs", len(counts)))}


def _shard_digests(payload: dict, shards) -> list:
    """Per-shard digests of a dense KV frame's rows (shard s owns rows
    [cum[s], cum[s+1]))."""
    from ..utils.integrity import array_digest
    k, v = payload.get("k_arr"), payload.get("v_arr")
    if k is None or v is None or shards is None:
        return []
    out, start = [], 0
    for c in shards:
        out.append(array_digest(k[start:start + c], v[start:start + c]))
        start += c
    return out


def _frame_payload(fr) -> dict:
    payload: dict = {}
    if isinstance(fr, KVFrame):
        _col_to_npz(fr.key, "k", payload)
        _col_to_npz(fr.value, "v", payload)
    elif isinstance(fr, KMVFrame):
        _col_to_npz(fr.key, "k", payload)
        _col_to_npz(fr.values, "v", payload)
        payload["nvalues"] = np.asarray(fr.nvalues)
        payload["offsets"] = np.asarray(fr.offsets)
    else:
        raise MRError(f"cannot checkpoint frame type {type(fr).__name__}")
    return payload


def save(mr, path: str) -> int:
    """Write mr's dataset (KV or KMV) to directory ``path``; returns the
    number of frames written.  The frames and manifest go to a temp
    sibling swapped in by rename, so a retried save (ft/
    ``checkpoint.save``, whose fault point comes first) never mixes
    generations."""
    from ..ft.inject import fault_point
    from ..utils.fsio import fsync_dir
    from ..utils.integrity import file_digest
    fault_point("checkpoint.save", path=path)
    path = os.path.normpath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    kind = "kv" if mr.kv is not None else ("kmv" if mr.kmv is not None
                                           else "none")
    nframes, counts, frames_meta = 0, [], []
    row_start, nprocs_max = 0, 1
    try:
        if kind != "none":
            ds = mr.kv if kind == "kv" else mr.kmv
            if kind == "kv" and (ds._buf_k or ds._batches):
                # an open() MR holds pairs only in its append buffers
                raise MRError("cannot checkpoint an MR with uncompleted "
                              "adds; close()/complete it first")
            for fr in ds.frames():
                smeta = _frame_shard_meta(fr)
                nprocs_max = max(nprocs_max, smeta["nprocs"])
                fr = fr.to_host()
                payload = _frame_payload(fr)
                fname = f"frame-{nframes:05d}.npz"
                fpath = os.path.join(tmp, fname)
                np.savez(fpath, **payload)
                counts.append(len(fr))
                frames_meta.append({
                    "file": fname, "n": len(fr),
                    "rows": [row_start, row_start + len(fr)],
                    "digest": file_digest(fpath),
                    "shards": smeta["shards"],
                    # KV only: a KMV's value rows do not align with its
                    # group counts
                    "shard_digests": (_shard_digests(payload,
                                                     smeta["shards"])
                                      if isinstance(fr, KVFrame) else []),
                })
                row_start += len(fr)
                nframes += 1
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"version": _VERSION, "kind": kind,
                       "nframes": nframes, "counts": counts,
                       "frames": frames_meta,
                       "mesh": {"nprocs": nprocs_max}}, f)
        if os.path.exists(path):
            if not os.path.isdir(path):
                raise MRError(f"checkpoint target {path!r} exists and is "
                              f"not a directory")
            foreign = [f for f in os.listdir(path)
                       if f != _MANIFEST and not f.startswith("frame-")]
            if foreign:
                raise MRError(
                    f"checkpoint target {path!r} holds non-checkpoint "
                    f"files {foreign[:3]!r}; refusing to replace the "
                    f"directory")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # the swap: after a crash the worst case is a missing checkpoint
    # (the old one renamed aside), never a manifest over mixed frames
    old = f"{path}.old.{os.getpid()}"
    shutil.rmtree(old, ignore_errors=True)
    try:
        if os.path.exists(path):
            os.rename(path, old)
        try:
            os.rename(tmp, path)
        except BaseException as swap_err:
            if not os.path.exists(path) and os.path.exists(old):
                try:
                    os.rename(old, path)       # put the previous one back
                except OSError as restore_err:
                    # both renames failed: `old` is the only copy left
                    raise MRError(
                        f"checkpoint swap failed ({swap_err!r}) and the "
                        f"previous checkpoint could not be restored "
                        f"({restore_err!r}); it survives at {old!r}"
                    ) from swap_err
            raise
    finally:
        if os.path.exists(path):
            shutil.rmtree(old, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)
    fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
    # chunk dedup (utils/cas.py, JAX :188-208): with a content store
    # armed every frame file becomes a hardlink to its content object,
    # so saves of the same dataset hold one copy of the bytes.  Same
    # bytes, manifest and digests; readers unchanged; any failure
    # leaves the plain file
    try:
        from ..utils.cas import cas_store
        store = cas_store()
        if store is not None:
            for fname in os.listdir(path):
                if fname.startswith("frame-"):
                    store.dedup_file(os.path.join(path, fname))
    except Exception:
        pass
    return nframes


def read_manifest(path: str) -> dict:
    """The checkpoint's manifest (v1 or v2), or MRError."""
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            man = json.load(f)
    except FileNotFoundError:
        raise MRError(f"no checkpoint manifest under {path!r}")
    if man.get("version") not in (1, _VERSION):
        raise MRError(f"unsupported checkpoint version {man.get('version')}")
    return man


def validate(path: str) -> bool:
    """Whether the manifest reads, every frame file is present and (under
    ``MRTPU_VERIFY``) every frame digest holds."""
    from ..utils.integrity import (file_digest, record_integrity_failure,
                                   verify_enabled)
    try:
        man = read_manifest(path)
    except MRError:
        return False
    frames = man.get("frames") or [
        {"file": f"frame-{i:05d}.npz", "digest": None}
        for i in range(man.get("nframes", 0))]
    for fm in frames:
        fpath = os.path.join(path, fm["file"])
        if not os.path.exists(fpath):
            return False
        exp = fm.get("digest")
        if exp is not None and verify_enabled():
            if file_digest(fpath) != exp:
                record_integrity_failure("checkpoint")
                return False
    return True


def _check_shard_digests(z, fm: dict, fpath: str) -> None:
    """The per-shard row digests of a dense KV frame: which writer shard
    a mismatch came from."""
    from ..utils.integrity import (IntegrityError, array_digest,
                                   record_integrity_failure)
    k, v, start = z["k_arr"], z["v_arr"], 0
    for s, (c, exp) in enumerate(zip(fm["shards"], fm["shard_digests"])):
        got = array_digest(k[start:start + c], v[start:start + c])
        if got != exp:
            record_integrity_failure("checkpoint")
            raise IntegrityError("checkpoint", f"{fpath} (writer shard {s})",
                                 exp, got)
        start += c


def load(mr, path: str) -> int:
    """Replace mr's dataset with the checkpoint at ``path``; returns the
    pair or group count.  Each frame file is checked against its digest
    before its rows are read, and frames stream one at a time into mr's
    page budget (spilling under ``outofcore=1``)."""
    from ..utils.integrity import verify_enabled, verify_file
    man = read_manifest(path)
    kind = man["kind"]
    frames_meta = man.get("frames") or []
    if mr.kv is not None:
        mr.kv.free()
        mr.kv = None
    if mr.kmv is not None:
        mr.kmv.free()
        mr.kmv = None
    if kind == "none":
        return 0
    ds = mr._new_kv() if kind == "kv" else mr._new_kmv()
    for i in range(man["nframes"]):
        fpath = os.path.join(path, f"frame-{i:05d}.npz")
        fm = frames_meta[i] if i < len(frames_meta) else {}
        if fm:
            verify_file(fpath, fm.get("digest"), "checkpoint")
        with np.load(fpath, allow_pickle=False) as z:
            if (verify_enabled() and kind == "kv" and fm.get("shards")
                    and fm.get("shard_digests") and "k_arr" in z
                    and "v_arr" in z):
                _check_shard_digests(z, fm, fpath)
            if kind == "kv":
                ds._push_frame(KVFrame(_col_from_npz(z, "k"),
                                       _col_from_npz(z, "v")))
            else:
                ds.push(KMVFrame(_col_from_npz(z, "k"), z["nvalues"],
                                 z["offsets"], _col_from_npz(z, "v")))
    if kind == "kv":
        mr.kv = ds
        ds.nkv = sum(ds._frame_n(f) for f in ds._frames)
        ds.complete_done = True
        return ds.nkv
    mr.kmv = ds
    return ds.complete()
