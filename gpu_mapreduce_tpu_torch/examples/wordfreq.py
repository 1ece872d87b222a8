"""Word frequency through the Python API, by host callbacks (the
counterpart of the JAX package's ``examples/wordfreq.py`` and the
reference's examples/wordfreq.cpp).  As in the JAX driver, the summary
and the top 10 print twice: once from ``wordfreq(quiet=False)``, once
here.

Usage: python -m gpu_mapreduce_tpu_torch.examples.wordfreq [-device cpu]
           file1 [file2 ...]
"""

from __future__ import annotations

import sys
from typing import List, Optional

from . import split_device

USAGE = ("usage: python -m gpu_mapreduce_tpu_torch.examples.wordfreq "
         "[-device cpu] file1 [file2 ...]")


def main(argv: Optional[List[str]] = None) -> int:
    device, files = split_device(list(sys.argv[1:] if argv is None
                                      else argv))
    if not files:
        raise SystemExit(USAGE)
    from ..apps.wordfreq import wordfreq
    nwords, nunique, top = wordfreq(files, ntop=10, device=device,
                                    quiet=False)
    print(f"{nwords} total words, {nunique} unique words")
    for word, n in top:
        print(n, word.decode(errors="replace"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
