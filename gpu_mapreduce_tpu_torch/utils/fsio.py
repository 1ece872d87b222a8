"""Durable file primitives (the port's copy of
``gpu_mapreduce_tpu/utils/fsio.py``): a rename only survives a power cut
once the parent directory itself is fsync'd.

* :func:`fsync_dir` — fsync a directory (a no-op where the filesystem
  refuses);
* :func:`atomic_replace` — ``os.replace`` + parent-dir fsync;
* :func:`atomic_write_json` — tmp + fsync + replace + dir fsync;
* :func:`read_json` — a dict, or None for a missing or torn file.
"""

from __future__ import annotations

import json
import os


def fsync_dir(path: str) -> None:
    """fsync the directory at ``path`` so renames inside it are durable;
    best-effort where a filesystem rejects directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_replace(tmp: str, path: str) -> None:
    """``os.replace(tmp, path)``, durable when this returns."""
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_json(path: str, obj: dict) -> None:
    """Whole-file JSON write that a reader never sees torn and a crash
    right after return cannot undo."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    atomic_replace(tmp, path)


def read_json(path: str):
    """The parsed dict, or None on a missing, torn or non-dict file."""
    try:
        with open(path) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None
