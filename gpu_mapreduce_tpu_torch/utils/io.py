"""File discovery (the port's copy of ``gpu_mapreduce_tpu/utils/io.findfiles``,
reference findfiles, src/mapreduce.cpp:2812-2906)."""

from __future__ import annotations

import glob
import os
from typing import List, Sequence


def findfiles(paths: Sequence[str], recurse: bool = False,
              readflag: bool = False) -> List[str]:
    """Expand paths → flat file list: globs, directories (sorted; nested
    ones only with ``recurse``), and with ``readflag`` files of names."""
    out: List[str] = []
    for p in paths:
        if any(c in p for c in "*?[") and not os.path.exists(p):
            hits = sorted(glob.glob(p))
            if not hits:
                raise FileNotFoundError(p)
            out.extend(findfiles(hits, recurse, readflag))
            continue
        if os.path.isdir(p):
            for entry in sorted(os.listdir(p)):
                full = os.path.join(p, entry)
                if os.path.isdir(full):
                    if recurse:
                        out.extend(findfiles([full], recurse, readflag))
                elif os.path.isfile(full):
                    out.append(full)
        elif os.path.isfile(p):
            if readflag:
                with open(p) as f:
                    out.extend(ln.strip() for ln in f if ln.strip())
            else:
                out.append(p)
        else:
            raise FileNotFoundError(p)
    return out
