"""wordfreq2 — the reference's second word-frequency driver
(``examples/wordfreq2.cpp:60-140``; the JAX package's
``examples/wordfreq2.py``): the map → collate → reduce(sum) pipeline of
wordfreq, with the top-N printed twice — once from the locally sorted
data (the reference's per-proc pass, flag=0) and once globally after
``gather(1)`` and a re-sort (flag=1).  On one device "local" is the
whole dataset; the two passes are the point of the example.

Usage: python -m gpu_mapreduce_tpu_torch.examples.wordfreq2
           [-device cpu] file1 [file2 ...]
"""

from __future__ import annotations

import sys
from typing import List, Optional

from . import split_device

LIMIT = 10
USAGE = ("usage: python -m gpu_mapreduce_tpu_torch.examples.wordfreq2 "
         "[-device cpu] file1 [file2 ...]")


def _print_top(mr, label: str) -> None:
    print(label)
    shown = [0]

    def output(key, value, ptr):
        if shown[0] < LIMIT:
            shown[0] += 1
            word = key.decode(errors="replace") if isinstance(key, bytes) \
                else key
            print(f"  {int(value)} {word}")

    mr.scan_kv(output)


def main(argv: Optional[List[str]] = None) -> int:
    device, files = split_device(list(sys.argv[1:] if argv is None
                                      else argv))
    if not files:
        raise SystemExit(USAGE)
    from ..apps.wordfreq import _fileread, _sum
    from ..core.mapreduce import MapReduce
    mr = MapReduce(device=device)
    nwords = mr.map_files(files, _fileread)
    mr.collate()
    nunique = mr.reduce(_sum)
    # pass 1: the top-N of the locally sorted KV (wordfreq2.cpp:79-90)
    mr.sort_values(-1)
    _print_top(mr, f"top {LIMIT} (local sort):")
    # pass 2: the global answer — gather to one proc, re-sort, print
    mr.gather(1)
    mr.sort_values(-1)
    _print_top(mr, f"top {LIMIT} (global, after gather):")
    print(f"{nwords} total words, {nunique} unique words "
          f"({len(files)} files)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
