"""InvertedIndex driver — the flagship app as a command-line example (the
counterpart of the JAX package's ``examples/invertedindex.py`` and the
reference's ``cuda/InvertedIndex.cu`` main): scan HTML files for
``<a href="..."`` URLs, build the url → documents index, write
``url \\t file file...`` lines.

Usage:
    python -m gpu_mapreduce_tpu_torch.examples.invertedindex OUTDIR
        file-or-dir [more...] [--engine cuda|native] [--mesh N]
        [-device cpu]

``--engine``: ``cuda`` (the default: the word mark kernel on the card,
its plain version under ``-device cpu``) or ``native`` (the host C++
scanner).  On a mesh (``--mesh N``) every shard ingests and extracts its
own slice of the corpus and writes its own ``part-<shard>`` file; one
device writes one ``part-00000``.  The mesh's shards are one a card where
there are N cards, else they share the one device: ``--mesh 4`` on one
card is a valid run, so the JAX driver's "only K devices available"
refusal has no counterpart here.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import split_device


def main(argv: Optional[List[str]] = None) -> int:
    device, rest = split_device(list(sys.argv[1:] if argv is None
                                     else argv))
    ap = argparse.ArgumentParser(
        prog="python -m gpu_mapreduce_tpu_torch.examples.invertedindex",
        description=__doc__.splitlines()[0])
    ap.add_argument("outdir")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--engine", default=None, choices=["cuda", "native"],
                    help="the card's kernels (default) or the host C++ "
                         "scanner")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run sharded over an N-shard mesh")
    args = ap.parse_args(rest)

    from ..apps.invertedindex import InvertedIndex
    from ..parallel.mesh import mesh_on
    comm = mesh_on(args.mesh, device) if args.mesh else None
    idx = InvertedIndex(device=device, comm=comm, engine=args.engine)
    npairs, nunique = idx.run(args.paths, outdir=args.outdir)
    print(f"{npairs} (url, doc) pairs, {nunique} unique urls "
          f"-> {args.outdir}/part-*")
    for stage, sec in sorted(idx.timer.times.items()):
        print(f"  {stage}: {sec:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
