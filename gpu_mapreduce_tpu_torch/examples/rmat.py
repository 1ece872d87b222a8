"""R-MAT generation and degree stats through the Python command API (the
counterpart of the JAX package's ``examples/rmat.py`` and the
reference's examples/rmat.py / examples/rmat.cpp).

Usage: python -m gpu_mapreduce_tpu_torch.examples.rmat [-device cpu]
           N Nz a b c d frac seed [outfile]
e.g.:  python -m gpu_mapreduce_tpu_torch.examples.rmat
           16 8 0.25 0.25 0.25 0.25 0.0 12345
"""

from __future__ import annotations

import sys
from typing import List, Optional

from . import split_device

USAGE = ("usage: python -m gpu_mapreduce_tpu_torch.examples.rmat "
         "[-device cpu] N Nz a b c d frac seed [outfile]")


def main(argv: Optional[List[str]] = None) -> int:
    device, args = split_device(list(sys.argv[1:] if argv is None
                                     else argv))
    if len(args) < 8:
        raise SystemExit(USAGE)
    from ..oink.command import run_command
    from ..oink.objects import ObjectManager
    obj = ObjectManager(device)
    outputs = [(args[8], "mre")] if len(args) > 8 else [(None, "mre")]
    run_command("rmat", args[:8], obj=obj, outputs=outputs)
    run_command("degree_stats", ["0"], obj=obj, inputs=["mre"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
