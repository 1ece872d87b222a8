"""Print the recorded plans (stages, fusion groups, cache key) of an OINK
script — the offline twin of the ``dump_plan`` script command (the
counterpart of the JAX package's ``scripts/plan_dump.py``)::

    python -m gpu_mapreduce_tpu_torch.plan examples/in.wordfreq \\
        -var files data.txt [-device cpu]

Runs the script with ``fuse`` defaulted on (every MR the script creates
records and fuses; an explicit ``-var fuse 0`` keeps the script's own
``set fuse ${fuse}`` line authoritative) and prints every plan that
executed: which stages fused into which groups, which fell back to the
eager path, and whether the plan cache hit.  The script runs on the card
unless ``-device cpu`` is given, as ``python -m
gpu_mapreduce_tpu_torch.oink.script`` does.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    infile, rest = argv[0], argv[1:]
    # the MR `fuse` setting on for every object the script makes ...
    os.environ.setdefault("MRTPU_FUSE", "1")
    # ... and the `fuse` script variable too, so a script's own `set fuse
    # ${fuse}` line (default 0) still records plans unless the caller
    # passed -var fuse
    if not any(rest[i] in ("-var", "-v") and rest[i + 1] == "fuse"
               for i in range(len(rest) - 1)):
        rest = rest + ["-var", "fuse", "1"]
    from ..oink.commands.dump_plan import format_plans
    from ..oink.script import main as oink_main
    from . import clear_history, plan_history

    clear_history()
    rc = oink_main(["-in", infile, "-log", "none"] + rest)
    print(format_plans(plan_history()))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
