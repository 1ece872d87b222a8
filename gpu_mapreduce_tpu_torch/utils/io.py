"""File discovery, chunked reads and word splitting (the port's copy of
``gpu_mapreduce_tpu/utils/io.py``'s ``findfiles``, ``file_chunks`` and
``read_words``: reference findfiles, src/mapreduce.cpp:2812-2906,
map_file_wrapper, src/mapreduce.cpp:1486-1552, and the oink read_words
tokenizer), plus :func:`split_words`, the same split on a device straight
into a packed byte column."""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Sequence

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


def file_chunks(filename: str, nchunks: int, sep: bytes = b"\n",
                delta: int = 80) -> Iterator[bytes]:
    """Split one file into ~``nchunks`` pieces, each ending just past a
    ``sep`` (one byte or several).  Each piece reads its slice plus a
    ``delta * 64``-byte lookahead and cuts at the first separator at or
    after the nominal boundary; when none is in the lookahead the search
    runs on to the end of the file.  No byte is lost or repeated."""
    size = os.path.getsize(filename)
    if size == 0 or nchunks <= 0:
        return
    chunksize = max(1, (size + nchunks - 1) // nchunks)
    with open(filename, "rb") as f:
        start = 0
        while start < size:
            f.seek(start)
            want = min(chunksize, size - start)
            buf = f.read(want + delta * 64)
            if start + len(buf) >= size:       # the last chunk: all of it
                yield buf[: size - start]
                break
            cut = buf.find(sep, want - 1)
            if cut < 0:
                buf += f.read()
                cut = buf.find(sep, want - 1)
                if cut < 0:
                    yield buf
                    break
            cut += len(sep)
            yield buf[:cut]
            start += cut


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
