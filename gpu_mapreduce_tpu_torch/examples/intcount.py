"""IntCount — u32-key counting over binary files (the counterpart of the
JAX package's ``examples/intcount.py`` and the reference's
cpu/IntCount.cpp shuffle and group stress benchmark).

Usage: python -m gpu_mapreduce_tpu_torch.examples.intcount [-device cpu]
           file1 [file2 ...]
"""

from __future__ import annotations

import sys
from typing import List, Optional

from . import split_device

USAGE = ("usage: python -m gpu_mapreduce_tpu_torch.examples.intcount "
         "[-device cpu] file1 [file2 ...]")


def main(argv: Optional[List[str]] = None) -> int:
    device, files = split_device(list(sys.argv[1:] if argv is None
                                      else argv))
    if not files:
        raise SystemExit(USAGE)
    from ..apps.intcount import intcount
    nints, nunique, top = intcount(files, ntop=10, device=device)
    print(f"{nints} ints, {nunique} unique")
    for k, n in top:
        print(n, k)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
