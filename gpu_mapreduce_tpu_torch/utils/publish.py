"""Published records of the port's harnesses (the counterpart of
``gpu_mapreduce_tpu/utils/publish.py``): one implementation of the read,
merge and write of a JSON file of ``{"published": {key: record}}``, each
harness under a key of its own so none clobbers another's records.

The default file is the port's own, ``PUBLISHED_TORCH.json`` at the
repo root; the JAX package's ``BASELINE.json`` is never touched."""

from __future__ import annotations

import json
import os
from typing import Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_ROOT, "PUBLISHED_TORCH.json")


def read_published(key: str, path: Optional[str] = None):
    """The current ``published.<key>`` record, or ``{}`` (a missing or
    unparsable file included): how a harness merges partial runs."""
    try:
        with open(path or DEFAULT_PATH) as f:
            return json.load(f).get("published", {}).get(key, {})
    except (FileNotFoundError, ValueError):
        return {}


def publish(key: str, record, path: Optional[str] = None) -> None:
    """Merge ``record`` under ``published.<key>`` of the file (default
    :data:`DEFAULT_PATH`, whatever the working directory).

    A missing file starts empty.  A corrupt one must neither crash a
    harness at the end of a long run nor be silently overwritten with
    every earlier record lost: it is moved aside to ``<path>.corrupt``
    for repair first.  The write is tmp + rename, so a crash mid-write
    never leaves such a file."""
    path = path or DEFAULT_PATH
    try:
        with open(path) as f:
            base = json.load(f)
    except FileNotFoundError:
        base = {}
    except ValueError:
        os.replace(path, path + ".corrupt")   # kept for repair
        base = {}
    base.setdefault("published", {})[key] = record
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(base, f, indent=2)
    os.replace(tmp, path)
