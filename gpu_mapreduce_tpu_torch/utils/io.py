"""File discovery and word splitting (the port's copy of
``gpu_mapreduce_tpu/utils/io.py``'s ``findfiles`` and ``read_words``,
reference findfiles, src/mapreduce.cpp:2812-2906, and the oink
read_words tokenizer), plus :func:`split_words`, the same split on a
device straight into a packed byte column."""

from __future__ import annotations

import glob
import os
from typing import List, Sequence

import numpy as np
import torch


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


WHITESPACE = b" \t\n\r\x0b\x0c"     # what bytes.split() splits on


def read_words(chunk: bytes, whitespace: bytes = b" \t\n\r\f\v"
               ) -> List[bytes]:
    """Whitespace tokenizer on the host (the oink read_words map callback,
    oink/map_read_words.cpp)."""
    table = bytes.maketrans(whitespace, b" " * len(whitespace))
    return chunk.translate(table).split()


def split_words(data, device):
    """The words of ``data`` (bytes or a uint8 array) split on the six
    ASCII whitespace bytes of :data:`WHITESPACE` — exactly
    ``bytes.split()``'s words, in order — as a packed ``BytesColumn`` on
    ``device``.  No Python object is built per word: the bytes go to the
    device once, word starts and ends are found there, and the word bytes
    are compacted into the column's buffer."""
    from ..core.column import BytesColumn
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, np.uint8)
    b = torch.from_numpy(np.require(data, np.uint8, "W")).to(device)
    # the separators are 0x20 and the run 0x09..0x0d
    keep = (b != 0x20) & ((b < 0x09) | (b > 0x0D))
    edge = torch.zeros(b.numel() + 1, dtype=torch.bool, device=b.device)
    edge[1:-1] = keep[1:] != keep[:-1]
    edge[0] = keep[0] if b.numel() else False
    edge[-1] = keep[-1] if b.numel() else False
    # edges alternate word start, word end (exclusive)
    bounds = torch.nonzero(edge).squeeze(1).view(-1, 2)
    del edge
    lengths = bounds[:, 1] - bounds[:, 0]
    del bounds
    offsets = torch.zeros(lengths.numel() + 1, dtype=torch.int64,
                          device=b.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    packed = b[keep]
    return BytesColumn.packed(packed, offsets, int(packed.numel()))
